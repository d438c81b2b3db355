"""Run one cell of the port's benchmark and print its result as one JSON line.

    python3 -m raybench.run --workload mesh100k.frame --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout that holds the port
(``unity_raytracer_tpu_torch``) beside this folder. The cell is an entry of
``workloads`` in ``BENCHMARK.json``; its configuration, traffic mix, check
and per-layer metrics are files found by name:

* ``raybench/configs/<config>.json`` (the file ``BENCHMARK.json`` names),
* ``raybench/traffic/<traffic>.json``, whose ``driver`` names the module
  under ``raybench/drivers`` that runs the cell,
* ``raybench/cells/<cell>.json``: the check's sample and limits, the
  length of the traced stretch,
* ``raybench/metrics/<metric>.py``: one reader per per-layer metric.

Python's bytecode cache goes to ``build/pycache`` in the checkout, so that
only the first run there compiles the modules it imports.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled stretch at the
end of the window. Either way the run checks the output of the frames it
timed against the plain reference and prints each number compared beside
its limit, last on standard error and last in the line (``checks``).

It exits non-zero and prints no result where there is no CUDA card (or
fewer than the cell asks for), where the port is missing, and where a JAX
module (``jax``, ``jaxlib``, ``flax``, ``unity_raytracer_tpu``) was
loaded in the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "unity_raytracer_tpu_torch"
PYCACHE = ROOT / "build" / "pycache"


class SpecError(RuntimeError):
    pass


def load_json(path: pathlib.Path) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError as e:
        raise SpecError(f"missing file {path}") from e


def cell_spec(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files loaded:
    ``workload``, ``config``, ``traffic``, ``cell``, ``end_to_end`` and
    ``per_layer`` (the metric entries that apply to the cell)."""
    bench = load_json(root / "BENCHMARK.json")
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; have "
                        f"{[w['name'] for w in bench['workloads']]}")
    work = work[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    applies = lambda m: name in m.get("workloads", [name])
    here = root / HERE.name
    return dict(
        workload=work, config=load_json(root / conf["file"]),
        traffic=load_json(here / "traffic" / f"{work['traffic']}.json"),
        cell=load_json(here / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read(ctx)`` function of ``raybench/metrics/<metric>.py``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    if not path.exists():
        raise SpecError(f"no reader {path} for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        f"raybench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_port(root: pathlib.Path = ROOT) -> None:
    if not (root / PORT / "__init__.py").exists():
        raise SpecError(f"the port {PORT} is not in {root}")


def execute(spec: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, driver_hook=None) -> dict:
    """Set up, run the window, check and gather the result of one run.
    ``driver_hook(driver)`` runs between the seed-free and the seeded
    set-up (tests break the program there)."""
    import torch

    from raybench import guard

    check_port()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    drv_mod = importlib.import_module(
        f"raybench.drivers.{spec['traffic']['driver']}")
    drv = drv_mod.Driver(spec["config"], spec["traffic"], spec["cell"],
                         device)
    drv.spans["before_setup_s"] = time.perf_counter() - t_start
    drv.setup()
    if driver_hook is not None:
        driver_hook(drv)
    drv.start(seed)
    setup_s = time.perf_counter() - t_start
    trace_s = min(float(spec["cell"]["trace_seconds"]), seconds / 2) \
        if trace else 0.0
    win = drv.window(seed, seconds, trace_s)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    guard.check()
    samples = drv.samples(seed, win)
    drv.free()
    t_check = time.perf_counter()
    values, failed = drv.check(samples)
    limits = spec["cell"]["check"]["limits"]
    print(f"raybench: set-up spans {drv.spans}; reference "
          f"{time.perf_counter() - t_check:.3f} s, per checked item "
          f"{drv.stats}", file=sys.stderr)

    ctx = dict(config=spec["config"], arrays=drv.arrays, spans=drv.spans,
               trace=win["trace"])
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(drv.end_to_end(win), setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": int(spec["workload"]["chips"]),
           "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = win["trace"]["busy_s"]
        dev["window_s"] = win["trace"]["window_s"]
    result = {"correct": failed == 0, "attempted": win["done"],
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = win["trace"]["breakdown"]
    result["checks"] = {k: {"value": v, "limit": float(limits[k])}
                        for k, v in values.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raybench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the bytecode of everything the run imports (the framework too), kept
    # at a fixed path inside the checkout: only a checkout's first run
    # compiles it
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    try:
        spec = cell_spec(args.workload)
        check_port()
    except SpecError as e:
        print(f"raybench: {e}", file=sys.stderr)
        return 2
    import torch
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"raybench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from raybench import guard
    try:
        result = execute(spec, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
        guard.check()
    except guard.ForbiddenModules as e:
        print(f"raybench: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
