"""The readings a cell's check limit is set from, in one process on the card:

    python3 -m raybench.calibrate --workload mesh100k.frame \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 2

Set-up runs once. For each of ``--seeds`` a window of ``--seconds`` runs
on the program and its sampled frames are checked as a run checks them
(the lower reading: the largest any sound seed gives). For each of
``--control-seeds`` a window runs the same way and the reference in
bfloat16 stands in the program's place at the same pixels (the upper
reading: the smallest the control gives). The benchmark's runs never run
the control. Prints one JSON line per seed, then a summary line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch


def main(argv=None) -> int:
    from raybench import run

    ap = argparse.ArgumentParser(prog="raybench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="seeds of the planted faults (fit cells: 'half')")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("raybench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = run.cell_spec(args.workload)
    drv = importlib.import_module(
        f"raybench.drivers.{spec['traffic']['driver']}").Driver(
            spec["config"], spec["traffic"], spec["cell"], "cuda")
    drv.setup()
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    seen = {"program": [], "control": [], "half": []}
    for side, group in (("program", seeds(args.seeds)),
                        ("control", seeds(args.control_seeds)),
                        ("half", seeds(args.fault_seeds))):
        for seed in group:
            drv.start(seed)
            win = drv.window(seed, args.seconds)
            t0 = time.perf_counter()
            kw = {"control": True} if side == "control" else (
                {"fault": side} if side == "half" else {})
            values, _ = drv.check(drv.samples(seed, win), **kw)
            seen[side].append(values)
            print(json.dumps({"side": side, "seed": seed,
                              "done": win["done"], "values": values,
                              "stats": drv.stats,
                              "check_s": time.perf_counter() - t0}),
                  flush=True)
    names = spec["cell"]["check"]["limits"]
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max((v[k] for v in seen["program"]), default=None)
                  for k in names},
        "upper": {side: {k: min((v[k] for v in seen[side]), default=None)
                         for k in names} for side in ("control", "half")},
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
