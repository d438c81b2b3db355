"""Run one cell's ``--trace 1`` run with the program's spans recorded, and
read the stretch by span:

    python3 -m raybench.tools.span_trace --workload mesh100k.frame \\
        --seed 7 --seconds 30 [--out spans.json]

The run is ``raybench.run``'s (``run.execute`` with ``trace`` on), with
two additions: the profiled stretch is ``spans.Stretch`` (the same
profile, with the program's ``recording()`` over it and the raw trace
kept), and the driver's set-up runs inside a recording too. It prints
the run's JSON line with:

* in ``breakdown``, ``idle_gaps_by_span`` (s), ``launches_by_span`` (per
  unit) and ``host_self_s_by_span`` (s) (``spans.reduce``);
* ``span_metrics``: ``host_us_per_launch.frame`` or ``.fit`` (the fit's
  ``fit.grad_transform``, the driver's hook, left out),
  ``tree_live_lane_share`` and, in a frame cell, ``mega_segment_roofline``
  where the cell has what they read;
* ``span_checks``: the spans per unit, and how the ``*.sync`` spans
  enclose their synchronize calls (``spans.sync_margins``);
* ``launches_by_path`` (per unit): the launches under each chain of span
  names from the outermost down, a chunk's index kept;
* ``setup_spans_s``: the set-up's spans, seconds summed by name.

``--out`` also writes that line to a file.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from collections import defaultdict

T_START = time.perf_counter()

FIT_HOOK = ("fit.grad_transform",)


def _path(rec_spans: dict, i) -> str:
    parts = []
    while i is not None and i in rec_spans:
        s = rec_spans[i]
        idx = s["attrs"].get("i")
        parts.append(s["name"] + ("" if idx is None else f"[{idx}]"))
        i = s["parent"]
    return "/".join(reversed(parts))


def span_readings(spec: dict, stretch, setup_rec, arrays: dict) -> dict:
    """What ``main`` adds to a run's result, from its ``spans.Stretch``,
    its set-up's recording and the deployment's ``arrays``."""
    from raybench import spans
    rec = stretch.recording
    red = spans.reduce(stretch.events, stretch.base_ns, stretch.window_s,
                       rec.spans, stretch.units)
    if red is None:
        return {}
    unit = "fit" if "fit" in spec["traffic"]["driver"] else "frame"
    metrics = {
        f"host_us_per_launch.{unit}": spans.host_us_per_launch(
            red, FIT_HOOK if unit == "fit" else ()),
        "tree_live_lane_share": spans.tree_live_lane_share(
            rec.counts, stretch.t0_ns, stretch.t1_ns),
    }
    if unit == "frame":
        metrics["mega_segment_roofline"] = spans.segment_roofline(
            red, spec["config"], arrays, stretch.units)
    by_id = {s["id"]: s for s in rec.spans}
    paths = defaultdict(float)
    for i, s in red["per_span"].items():
        if s["launches"]:
            paths[_path(by_id, i)] += s["launches"] / stretch.units
    setup = defaultdict(float)
    for s in (setup_rec.spans if setup_rec else []):
        setup[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e9
    n_spans = sum(1 for s in rec.spans
                  if s["end_ns"] > stretch.t0_ns
                  and s["start_ns"] < stretch.t1_ns)
    return {
        "breakdown": {k: red[k] for k in ("idle_gaps_by_span",
                                          "launches_by_span",
                                          "host_self_s_by_span")},
        "span_metrics": {k: v for k, v in metrics.items() if v is not None},
        "span_checks": dict(
            spans_per_unit=n_spans / stretch.units,
            sync=spans.sync_margins(stretch.events, stretch.base_ns,
                                    rec.spans, red["lo"], red["hi"])),
        "launches_by_path": sorted(([k, v] for k, v in paths.items()),
                                   key=lambda kv: -kv[1]),
        "setup_spans_s": dict(setup),
    }


def traced(spec: dict, seed: int, seconds: float, device) -> dict:
    """``run.execute`` of ``spec`` with ``trace`` on, the stretch and the
    set-up recorded; its result with ``span_readings`` merged in."""
    from raybench import run, spans, trace as trc
    from unity_raytracer_tpu_torch.utils.profiling import recording

    drv_mod = importlib.import_module(
        f"raybench.drivers.{spec['traffic']['driver']}")
    kept, setup_recs, arrays = [], [], {}

    class Kept(spans.Stretch):
        def stop(self, units):
            out = super().stop(units)
            kept.append(self)
            return out

    base_setup = drv_mod.Driver.setup

    def setup(drv):
        with recording() as rec:
            base_setup(drv)
        setup_recs.append(rec)
        arrays.update(drv.arrays)

    base_stretch = trc.Stretch
    trc.Stretch, drv_mod.Driver.setup = Kept, setup
    try:
        result = run.execute(spec, seed, seconds, True, device, T_START)
    finally:
        trc.Stretch, drv_mod.Driver.setup = base_stretch, base_setup
    extra = span_readings(spec, kept[-1],
                          setup_recs[-1] if setup_recs else None, arrays)
    result["breakdown"].update(extra.pop("breakdown", {}))
    checks = result.pop("checks")
    result.update(extra)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raybench.tools.span_trace")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from raybench import run
    sys.pycache_prefix = str(run.PYCACHE)
    import torch
    spec = run.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("raybench.tools.span_trace: needs a CUDA card", file=sys.stderr)
        return 2
    result = traced(spec, args.seed, args.seconds, "cuda")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
