"""Reduction of a profiler trace to the device's busy time, launches and gaps.

The traced stretch of a ``--trace 1`` run is profiled with
``torch.profiler`` on its CUDA activities alone (the device's kernels,
copies and sets, and the host's CUDA runtime calls, from CUPTI), so that
the host runs at its untraced pace: recording every host operation as
well slowed the fit's host-bound step twice over (PERF.md). The trace is
exported as a Chrome trace and ``summarize`` reads it. The stretch starts
at the trace's first event and lasts ``window_s``, the host clock of the
traced requests between two device synchronisations. Within it:

* ``busy_s``: the length of the union of device activity intervals;
* ``device_ops``: the number of device activities (launches, copies,
  sets);
* ``breakdown``: the device activities that took most time, summed by
  name, and the idle gaps (the stretch less the union) summed by what the
  host was doing at each gap's start: the innermost CUDA runtime call
  running then, or ``host: between calls`` (Python, the framework's
  dispatch) where none was.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def load(path: str) -> list:
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def union(intervals: list) -> list:
    """Merged, sorted ``[start, end]`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(merged: list, lo: float, hi: float) -> list:
    return [[max(s, lo), min(e, hi)] for s, e in merged
            if e > lo and s < hi]


def gaps(merged: list, lo: float, hi: float) -> list:
    """The parts of ``[lo, hi]`` that ``merged`` (clipped) leaves idle."""
    out, cur = [], lo
    for s, e in merged:
        if s > cur:
            out.append([cur, s])
        cur = max(cur, e)
    if hi > cur:
        out.append([cur, hi])
    return out


def _innermost(host: list, starts: list, at: float):
    """Name of the latest-starting host event that covers ``at``."""
    i = bisect.bisect_right(starts, at)
    for j in range(i - 1, max(i - 4000, -1), -1):
        s, e, name = host[j]
        if s <= at < e:
            return name
    return None


def summarize(events: list, window_s: float) -> dict:
    """``busy_s``, ``window_s``, ``device_ops`` and ``breakdown`` of the
    stretch of ``window_s`` seconds that starts at the first of
    ``events`` (Chrome trace events, microseconds)."""
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e
             and e.get("cat") in DEVICE_CATS + HOST_CATS]
    if not timed:
        return {"busy_s": 0.0, "window_s": window_s, "device_ops": 0,
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    lo = min(float(e["ts"]) for e in timed)
    hi = lo + window_s * 1e6
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e.get("name", "?")) for e in timed
           if e.get("cat") in DEVICE_CATS]
    dev = [x for x in dev if x[1] > lo and x[0] < hi]
    merged = clip(union([[s, e] for s, e, _ in dev]), lo, hi)
    busy = sum(e - s for s, e in merged)
    by_op = defaultdict(float)
    for s, e, name in dev:
        by_op[name] += (min(e, hi) - max(s, lo)) / 1e6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?")) for e in timed
                  if e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    by_gap = defaultdict(float)
    for s, e in gaps(merged, lo, hi):
        name = _innermost(host, starts, s) or "host: between calls"
        by_gap[name] += (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "device_ops": len(dev),
            "breakdown": {"device_ops": top(by_op),
                          "idle_gaps": top(by_gap)}}


class Stretch:
    """One profiled stretch: ``start()``, the work, ``stop(units)``. On the
    card it profiles CUDA activities alone, between two device
    synchronisations; elsewhere the host's operations (no device time is
    read from them)."""

    def __init__(self, on_card: bool, sync):
        self.on_card, self.sync = on_card, sync

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.on_card
                                        else ProfilerActivity.CPU])
        self.sync()
        self.prof.start()
        self.h0 = time.perf_counter()

    def stop(self, units: int) -> dict:
        """The stretch's ``summarize``, with ``units``: the frames or steps
        it held."""
        self.sync()
        window_s = time.perf_counter() - self.h0
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            summary = summarize(load(path), window_s)
        summary["units"] = units
        return summary


def idle_share(ctx: dict):
    """One minus the stretch's busy share; nothing without device
    activity."""
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]


def ops_per_unit(ctx: dict):
    """Device activities per frame or step of the stretch; nothing without
    device activity."""
    t = ctx["trace"]
    if not t or not t["units"] or t["device_ops"] == 0:
        return None
    return t["device_ops"] / t["units"]
