"""Reduction of a profiled stretch by the program's own spans and counters.

The port records spans and counters around its stages
(``unity_raytracer_tpu_torch.utils.profiling``: ``span``, ``count``,
``recording``), stamped with ``time.time_ns()``: the clock that
``torch.profiler``'s Chrome trace stamps its events on as ``ts``
(microseconds) after the trace's ``baseTimeNanoseconds``. So a span and
the runtime calls and device activities inside it share one timeline.

The stretch is ``trace.summarize``'s: ``window_s`` from the trace's first
host or device event. Spans are clipped to it. Within it:

* ``idle_gaps_by_span`` (s): each idle gap of the device (``trace.gaps``)
  summed under the innermost span open at the gap's start, else
  ``OUTSIDE`` ("outside program"); the list sums to the stretch's idle
  time;
* ``launches_by_span`` (per unit): each device activity (kernel, copy,
  set) counted under the innermost span open when the host made its
  runtime call, matched through ``args.correlation``; an activity whose
  call is outside every span, or not in the trace, counts under
  ``OUTSIDE``;
* ``host_self_s_by_span`` (s): each span's time less its child spans and
  less the runtime's synchronize calls made inside it (the host waiting
  on the device, not working).

``reduce`` returns these by name, and per span id the numbers the
metrics below are made of:

* ``host_us_per_launch``: host microseconds per launch over the spans of
  the stretch, less named subtrees (the fit's ``fit.grad_transform``, the
  caller's hook);
* ``tree_live_lane_share``: live lanes over lanes launched, over the
  fused tree's fork launches (``tree.live`` and ``tree.lanes``);
* ``segment_roofline``: the frame's least time (``yardstick``) over the
  device time, per frame, of the activities launched inside
  ``chain.segment`` spans (kernel #1's launches, by stage).

``Stretch`` is ``trace.Stretch`` with the program's recording over the
same stretch and the raw trace kept for these reductions.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

from raybench import trace as trc
from raybench import yardstick

OUTSIDE = "outside program"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def is_sync_call(name: str) -> bool:
    """A runtime call in which the host waits for the device."""
    return name.startswith("cuda") and name.endswith("Synchronize")


def bounds(events: list, window_s: float):
    """``(lo, hi)`` of the stretch in trace microseconds, as
    ``trace.summarize`` takes it; None without a timed event."""
    ts = [float(e["ts"]) for e in events if e.get("ph") == "X"
          and "ts" in e and e.get("cat") in trc.DEVICE_CATS + trc.HOST_CATS]
    if not ts:
        return None
    lo = min(ts)
    return lo, lo + window_s * 1e6


def clipped_spans(spans: list, base_ns: int, lo: float, hi: float) -> list:
    """The recorded spans that overlap ``[lo, hi]`` (trace microseconds),
    as dicts of ``name``, ``id``, ``parent``, ``s``, ``e`` (clipped) and
    ``depth`` (recorded ancestors), ordered by start."""
    by_id = {s["id"]: s for s in spans}
    depth = {}

    def depth_of(i):
        if i not in depth:
            p = by_id[i]["parent"]
            depth[i] = 0 if p is None or p not in by_id else depth_of(p) + 1
        return depth[i]

    out = []
    for s in spans:
        a = (s["start_ns"] - base_ns) / 1e3
        b = (s["end_ns"] - base_ns) / 1e3
        if b > lo and a < hi:
            out.append({"name": s["name"], "id": s["id"],
                        "parent": s["parent"], "s": max(a, lo),
                        "e": min(b, hi), "depth": depth_of(s["id"])})
    out.sort(key=lambda x: (x["s"], x["depth"]))
    return out


class _Innermost:
    """The innermost span open at each of a rising sequence of times."""

    def __init__(self, spans: list):
        self.spans, self.i, self.open = spans, 0, []

    def at(self, t: float):
        while self.i < len(self.spans) and self.spans[self.i]["s"] <= t:
            self.open.append(self.spans[self.i])
            self.i += 1
        self.open = [s for s in self.open if s["e"] > t]
        if not self.open:
            return None
        return max(self.open, key=lambda s: (s["depth"], s["s"]))


def _by_time(items: list, key, spans: list) -> list:
    """``[(item, innermost span or None)]`` for ``items``, each at the time
    ``key(item)``."""
    order = sorted(items, key=key)
    find = _Innermost(spans)
    return [(x, find.at(key(x))) for x in order]


def reduce(events: list, base_ns: int, window_s: float, spans: list,
           units: int) -> dict:
    """The by-span breakdown of a stretch: ``idle_gaps_by_span``,
    ``launches_by_span``, ``host_self_s_by_span`` (``[[name, value],
    ...]``, largest first) and ``per_span``: per span id its ``name``,
    ``parent``, ``self_us``, ``launches`` and ``device_us`` (the device
    time of the activities it launched, clipped to the stretch); with
    ``lo`` / ``hi``, the stretch in trace microseconds. Nothing (None)
    without a timed event."""
    b = bounds(events, window_s)
    if b is None:
        return None
    lo, hi = b
    sp = clipped_spans(spans, base_ns, lo, hi)
    per = {s["id"]: {"name": s["name"], "parent": s["parent"],
                     "self_us": s["e"] - s["s"], "launches": 0,
                     "device_us": 0.0} for s in sp}
    for s in sp:
        if s["parent"] in per:
            per[s["parent"]]["self_us"] -= s["e"] - s["s"]
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    iv = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
    runtime = [e for e in timed if e.get("cat") in RUNTIME_CATS]
    for e, owner in _by_time([e for e in runtime
                              if is_sync_call(e.get("name", ""))],
                             lambda e: iv(e)[0], sp):
        a, z = iv(e)
        if owner is not None and z > lo and a < hi:
            per[owner["id"]]["self_us"] -= min(z, hi) - max(a, lo)
    call_span = {}
    for e, owner in _by_time([e for e in runtime
                              if "correlation" in e.get("args", {})],
                             lambda e: iv(e)[0], sp):
        call_span[e["args"]["correlation"]] = owner
    launches = defaultdict(float)
    dev = [e for e in timed if e.get("cat") in trc.DEVICE_CATS]
    for e in dev:
        a, z = iv(e)
        if not (z > lo and a < hi):
            continue
        owner = call_span.get(e.get("args", {}).get("correlation"))
        launches[OUTSIDE if owner is None else owner["name"]] += 1
        if owner is not None:
            per[owner["id"]]["launches"] += 1
            per[owner["id"]]["device_us"] += min(z, hi) - max(a, lo)
    merged = trc.clip(trc.union([list(iv(e)) for e in dev]), lo, hi)
    idle = defaultdict(float)
    for (a, z), owner in _by_time(trc.gaps(merged, lo, hi),
                                  lambda g: g[0], sp):
        idle[OUTSIDE if owner is None else owner["name"]] += (z - a) / 1e6
    host = defaultdict(float)
    for s in per.values():
        host[s["name"]] += s["self_us"] / 1e6
    ranked = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                  key=lambda kv: -kv[1])]
    return {"idle_gaps_by_span": ranked(idle),
            "launches_by_span": ranked({k: v / max(units, 1)
                                        for k, v in launches.items()}),
            "host_self_s_by_span": ranked(host),
            "per_span": per, "lo": lo, "hi": hi}


def _excluded(per: dict, names: tuple) -> set:
    """Ids of the spans named in ``names`` and of their descendants."""
    out = set()
    for i in per:
        j = i
        while j in per:
            if per[j]["name"] in names:
                out.add(i)
                break
            j = per[j]["parent"]
    return out


def host_us_per_launch(red: dict, exclude: tuple = ()):
    """Host microseconds per launch over the spans of the stretch, the
    subtrees of spans named in ``exclude`` left out: their time less
    child spans and synchronize calls, over the device activities they
    launched. Nothing without a launch inside a span."""
    if not red:
        return None
    skip = _excluded(red["per_span"], exclude)
    keep = [s for i, s in red["per_span"].items() if i not in skip]
    n = sum(s["launches"] for s in keep)
    if n == 0:
        return None
    return sum(s["self_us"] for s in keep) / n


def tree_live_lane_share(counts: list, t0_ns: int, t1_ns: int):
    """Live lanes over lanes launched, over the fused tree's fork launches
    of frames whose counts all fall in ``[t0_ns, t1_ns]``: each frame's
    ``tree.lanes`` (the lanes of a launch) paired in order with its
    ``tree.live`` (the lanes entering that level live; at most the
    launch's lanes are live). A frame whose levels did not all compact
    (unequal counts) is left out; nothing without a frame."""
    by_unit = defaultdict(lambda: {"tree.lanes": [], "tree.live": []})
    seen = defaultdict(lambda: True)
    for c in counts:
        if c["name"] not in ("tree.lanes", "tree.live"):
            continue
        inside = t0_ns <= c["t_ns"] <= t1_ns
        seen[c["unit"]] = seen[c["unit"]] and inside
        by_unit[c["unit"]][c["name"]].append(c["value"])
    live = lanes = 0
    for u, v in by_unit.items():
        if not seen[u] or len(v["tree.lanes"]) != len(v["tree.live"]):
            continue
        lanes += sum(v["tree.lanes"])
        live += sum(min(a, b) for a, b in zip(v["tree.live"],
                                               v["tree.lanes"]))
    return live / lanes if lanes else None


def segment_roofline(red: dict, config: dict, arrays: dict, units: int,
                     name: str = "chain.segment"):
    """The frame's least time (``yardstick.least_frame_s`` of the
    configuration's frozen FP32 operations and its bytes, as
    ``frame_roofline`` reads it) over the device time per frame of the
    activities launched inside spans ``name``, in percent. Nothing
    without the frozen count or such an activity."""
    ops = config.get("yardstick", {}).get("frame_fp32_ops")
    if not red or ops is None or not units:
        return None
    dev_us = sum(s["device_us"] for s in red["per_span"].values()
                 if s["name"] == name)
    if dev_us <= 0:
        return None
    nbytes = yardstick.frame_bytes(arrays, config["width"], config["height"])
    least = yardstick.least_frame_s(ops, nbytes)
    return 100.0 * least / (dev_us / 1e6 / units)


def sync_margins(events: list, base_ns: int, spans: list, lo: float,
                 hi: float) -> dict:
    """How the clocks line up: for each span named ``*.sync`` inside the
    stretch, the runtime synchronize or copy calls it encloses. Returns
    ``n`` (such spans), ``missing`` (spans enclosing none) and
    ``worst_us`` (the least distance, over the spans, from an enclosed
    call's start or end to the span's edge)."""
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X" and "ts" in e
                   and e.get("cat") in RUNTIME_CATS
                   and (is_sync_call(e.get("name", ""))
                        or e.get("name") == "cudaMemcpyAsync"))
    n = missing = 0
    worst = None
    for s in spans:
        if not s["name"].endswith(".sync"):
            continue
        a = (s["start_ns"] - base_ns) / 1e3
        z = (s["end_ns"] - base_ns) / 1e3
        if a < lo or z > hi:
            continue
        n += 1
        inner = [min(c0 - a, z - c1) for c0, c1 in calls
                 if c0 >= a and c1 <= z]
        if not inner:
            missing += 1
            continue
        m = max(inner)
        worst = m if worst is None else min(worst, m)
    return {"n": n, "missing": missing, "worst_us": worst}


class Stretch(trc.Stretch):
    """``trace.Stretch`` with the program's ``recording()`` over the same
    stretch. ``stop`` returns the same summary and keeps ``events``,
    ``base_ns``, ``window_s``, the ``recording`` and the stretch's host
    clock in ``t0_ns`` / ``t1_ns``."""

    def start(self) -> None:
        from unity_raytracer_tpu_torch.utils.profiling import recording
        super().start()
        self._ctx = recording()
        self.recording = self._ctx.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self, units: int) -> dict:
        self.sync()
        self.t1_ns = time.time_ns()
        self.window_s = time.perf_counter() - self.h0
        self._ctx.__exit__(None, None, None)
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
        self.events = data["traceEvents"]
        self.base_ns = int(data.get("baseTimeNanoseconds", 0))
        summary = trc.summarize(self.events, self.window_s)
        summary["units"] = units
        self.units = units
        return summary
