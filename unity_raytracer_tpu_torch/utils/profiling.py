"""Timing, profiler traces and roofline accounting on the card.

Twin: ``unity_raytracer_tpu/utils/profiling.py`` — ``Timing``, ``timed``,
``trace``, ``device_hbm_gbps`` and ``roofline``, with the twin's
signatures, rewritten for PyTorch on an NVIDIA card:

* ``timed`` — best-of-N host clock, each run bracketed by
  ``torch.cuda.synchronize`` while CUDA is in use (on the CPU there is
  nothing to wait for);
* ``trace`` — ``torch.profiler`` over CPU and CUDA activities, written as
  a Chrome trace into a directory, with the program's spans and counters
  (below) written into the same file on the kernels' clock;
* ``device_hbm_gbps`` — the card's HBM bandwidth from NVIDIA's data
  sheets, by the name ``torch.cuda.get_device_name`` reports; a card not
  in the table (or no card) gets ``default``, which is None: no figure is
  assumed (the twin's default, 819 GB/s, is a TPU's);
* ``roofline`` — rays/s against the HBM-bandwidth bound; it raises where
  the bandwidth is unknown.

With no twin, the port's own measuring helpers, shared by the bench
(``unity_raytracer_tpu_torch/bench.py``) and ``chip_smoke.py``:

* ``call_times`` — a first call on a synchronized host clock, then the
  mean of back-to-back calls between CUDA events (optionally queued
  behind a spin kernel, over a ring of inputs), and ``events_mean_s``,
  its mean alone;
* ``HBM_BPS`` and ``FP32_OPS`` — the H100 SXM's peaks the bounds use;
* ``nvidia_smi`` — one ``nvidia-smi --query-gpu`` line of card 0;
* ``capture_segments`` and ``segment_work`` — the fused segment launches
  of a call, and the bytes and FP32 operations those launches must move
  and compute, read off the kernel's counting instance with
  ``OPS_PER_TEST``;
* ``span``, ``count`` and ``recording`` — the program's own stages and
  counters. The drivers (``ops/render``, ``ops/replay``, ``fit``,
  ``ops/bvh.prepare_bvh``) open a span around each stage and count live
  lanes; nothing is kept unless a ``recording()`` block is running. Off
  (the default) a span is one check of a module-level flag and returns a
  shared do-nothing context: no allocation, no clock read, no tensor op.
  On, each span keeps its name, start, end (``time.time_ns()``, the clock
  ``torch.profiler``'s Chrome trace stamps as ``ts`` + its
  ``baseTimeNanoseconds``), its parent, its attributes and a unit id
  shared by every span under one outermost span (a frame's ``render``, a
  fit's ``fit.step``); a count keeps a Python int, or a device tensor by
  reference, read once when the records are read (``Recording.counts``),
  so recording adds no launch and no sync inside the recorded work;
* ``collect_counts`` and ``recount`` — the counts made while a CUDA graph
  is captured, kept and counted again after each of its replays.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class Timing:
    wall_s: float
    runs: int

    @property
    def per_run_s(self) -> float:
        return self.wall_s / max(self.runs, 1)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, repeats: int = 3, warmup: int = 1,
          **kw) -> Timing:
    """Best-of-``repeats`` wall clock of ``fn(*args, **kw)`` after
    ``warmup`` runs, each run bracketed by a device sync."""
    for _ in range(warmup):
        fn(*args, **kw)
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return Timing(wall_s=best, runs=1)


@dataclass
class CallTimes:
    first_s: float   # the first call, on a synchronized host clock
    mean_s: float    # per timed call: CUDA events on the card, else host
    host_s: float    # host wall time per timed call of the enqueue loop


def call_times(fn: Callable, repeats: int, warmup: int = 1,
               inputs: Optional[list] = None, hold_cycles: int = 0,
               device="cuda") -> CallTimes:
    """Times of ``fn``: ``warmup`` (>= 1) calls, the first timed on a
    synchronized host clock, then ``repeats`` back-to-back calls between
    two CUDA events on the current stream (one synchronize, at the end;
    on a CPU ``device``, the host clock around them).

    ``inputs``: a list of argument tuples; the ``i``-th call, warm-up
    calls counted, is ``fn(*inputs[i % len(inputs)])`` and every result
    is held to the end of its loop, so a ring of inputs and results
    larger than the L2 makes each call read and write HBM (the warm-up
    leaves the results' blocks in the caching allocator). Otherwise
    ``fn()``, results dropped.
    ``hold_cycles``: a spin kernel (``torch.cuda._sleep``) ahead of the
    first event, so the timed calls queue up behind it and the events
    read device time rather than the host's enqueue."""
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    calls, held = itertools.count(), []

    def call():
        if inputs is None:
            fn()
        else:
            held.append(fn(*inputs[next(calls) % len(inputs)]))

    sync()
    t0 = time.perf_counter()
    call()
    sync()
    first_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        call()
    held.clear()
    if on_card:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        a.record()
    h0 = time.perf_counter()
    for _ in range(repeats):
        call()
    host_s = (time.perf_counter() - h0) / repeats
    if not on_card:
        return CallTimes(first_s, host_s, host_s)
    b.record()
    torch.cuda.synchronize()
    held.clear()
    return CallTimes(first_s, a.elapsed_time(b) / 1e3 / repeats, host_s)


def events_mean_s(fn: Callable, repeats: int, warmup: int = 1) -> float:
    """Mean seconds of ``repeats`` back-to-back calls of ``fn`` after
    ``warmup`` warm-up calls, between two CUDA events (``call_times``).
    A fused frame wants two (``ops/graphs``: its second captures)."""
    return call_times(fn, repeats, warmup=warmup).mean_s


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` of card 0,
    e.g. ``'name,power.limit'``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


# -- the program's spans and counters --------------------------------------
# Module state, not an object passed down: the stages sit deep inside
# render and fit, whose signatures are the twin's, and the off path must
# stay one check of one flag.
_on = False          # the one thing a span checks while nothing records
_rec = None          # the Recording being filled
_sink = None         # the list a collect_counts() block fills


class Recording:
    """What one ``recording()`` block kept. ``spans``: dicts of ``name``,
    ``id``, ``parent`` (the enclosing recorded span's id, or None),
    ``unit`` (the id of the outermost recorded span above it), ``start_ns``,
    ``end_ns`` (``time.time_ns()``; a span still open when the block ended
    ends there) and ``attrs``, in the order they closed. ``counts``
    (property): dicts of ``name``, ``value`` (an int), ``span``, ``unit``
    and ``t_ns``; device tensors are read on the first access, one copy per
    device for all of them."""

    __slots__ = ("spans", "_counts", "_read", "stack", "next_id")

    def __init__(self):
        self.spans, self._counts, self._read = [], [], False
        self.stack, self.next_id = [], 0

    @property
    def counts(self) -> list:
        if not self._read:
            held = [c for c in self._counts
                    if isinstance(c["value"], torch.Tensor)]
            by_dev: dict = {}
            for c in held:
                by_dev.setdefault(c["value"].device, []).append(c)
            for cs in by_dev.values():
                vals = torch.stack([c["value"].detach().reshape(())
                                    .to(torch.int64) for c in cs]).tolist()
                for c, v in zip(cs, vals):
                    c["value"] = int(v)
            self._read = True
        return self._counts


class _Null:
    """The context every span is while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "rec", "id", "parent", "unit", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        rec = self.rec = _rec
        self.id = rec.next_id
        rec.next_id += 1
        if rec.stack:
            top = rec.stack[-1]
            self.parent, self.unit = top.id, top.unit
        else:
            self.parent, self.unit = None, self.id
        rec.stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        if rec is _rec and rec.stack and rec.stack[-1] is self:
            rec.stack.pop()
            rec.spans.append(self._record(t1))
        return False

    def _record(self, t1: int) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "unit": self.unit, "start_ns": self.t0, "end_ns": t1,
                "attrs": self.attrs}


def span(name: str, **attrs):
    """A context manager around one stage of the program, named ``name``
    with ``attrs`` (ints or strings), kept while a ``recording()`` block
    runs; otherwise a shared do-nothing context."""
    if not _on:
        return _NULL
    return _Span(name, attrs)


def is_recording() -> bool:
    """Whether a ``recording()`` block runs."""
    return _on


def count(name: str, value) -> None:
    """Keep the counter ``name`` (a Python int, or a 0-dim device tensor
    held by reference and read when the records are read) under the
    innermost open span, while a ``recording()`` block runs; inside a
    ``collect_counts()`` block, hand it to that block instead."""
    if _sink is not None:
        _sink.append((name, value))
        return
    if not _on:
        return
    top = _rec.stack[-1] if _rec.stack else None
    _rec._counts.append({"name": name, "value": value,
                         "span": None if top is None else top.id,
                         "unit": None if top is None else top.unit,
                         "t_ns": time.time_ns()})


@contextlib.contextmanager
def recording():
    """Keep every span and count of the block; yields the ``Recording``.
    Spans opened before the block are not kept (their children become
    outermost); spans still open when it ends are kept as ending there.
    Not reentrant."""
    global _on, _rec
    if _on:
        raise RuntimeError("profiling.recording() is already running")
    rec = Recording()
    _rec, _on = rec, True
    try:
        yield rec
    finally:
        t1 = time.time_ns()
        _on, _rec = False, None
        rec.spans.extend(s._record(t1) for s in reversed(rec.stack))
        rec.stack.clear()


@contextlib.contextmanager
def collect_counts():
    """Divert every ``count`` of the block, recording or not, into the
    list it yields as ``(name, value)`` pairs: the counts a captured CUDA
    graph makes again at each replay, kept for ``recount``."""
    global _sink
    outer, _sink = _sink, []
    try:
        yield _sink
    finally:
        _sink = outer


def recount(counts: list) -> None:
    """``count`` each of ``counts`` (``collect_counts``' pairs) again,
    while a recording runs or a ``collect_counts`` block diverts them:
    ints as they are, the device tensors copied first (one ``stack``), so
    that the next replay of the graph that writes them does not change
    what this one counted."""
    if not (_on or _sink is not None) or not counts:
        return
    held = [v for _, v in counts if isinstance(v, torch.Tensor)]
    copies = iter(torch.stack([v.detach().reshape(()).to(torch.int64)
                               for v in held]).unbind(0) if held else ())
    for name, v in counts:
        count(name, next(copies) if isinstance(v, torch.Tensor) else v)


SPAN_CAT = "program"    # the Chrome trace category of the program's spans


def chrome_events(rec: Recording, base_ns: int, pid: int) -> list:
    """The spans of ``rec`` as Chrome trace complete events (``ph`` X,
    category ``SPAN_CAT``) and its counts as counter events (``ph`` C),
    stamped in microseconds after ``base_ns`` on a track of their own
    (``tid`` 0, named "program") of process ``pid``."""
    us = lambda ns: (ns - base_ns) / 1e3
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "program"}}]
    for s in rec.spans:
        out.append({"ph": "X", "cat": SPAN_CAT, "name": s["name"],
                    "pid": pid, "tid": 0, "ts": us(s["start_ns"]),
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                    "args": dict(s["attrs"], id=s["id"], parent=s["parent"],
                                 unit=s["unit"])})
    for c in rec.counts:
        out.append({"ph": "C", "cat": SPAN_CAT, "name": c["name"],
                    "pid": pid, "tid": 0, "ts": us(c["t_ns"]),
                    "args": {"value": c["value"]}})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and, where present, CUDA activities) and
    write its Chrome trace (``chrome://tracing``, Perfetto) into
    ``logdir`` as ``trace-<pid>-<ns>.json``, the block's spans and counts
    (``recording``) on the program's own track of the same timeline.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        with recording() as rec:
            try:
                yield prof
            finally:
                _sync()
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        data = json.load(fh)
    data["traceEvents"].extend(chrome_events(
        rec, int(data.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as fh:
        json.dump(data, fh)


# H100 SXM ("NVIDIA H100 80GB HBM3") peaks, NVIDIA data sheet: HBM
# bytes/s and dense FP32 operations/s (an FMA counts 2), the bounds that
# the bench's CUDA phases and the probes are held to
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# HBM bandwidth per card (GB/s), NVIDIA data sheets, matched in order on
# the lower-cased device name: H100 NVL (HBM3, 3.9 TB/s), H100 PCIe
# (HBM2e, 2.0 TB/s), H100 SXM
_HBM_GBPS = (
    ("h100 nvl", 3900.0),
    ("h100 pcie", 2000.0),
    ("h100", HBM_BPS / 1e9),
)


def _device_name() -> Optional[str]:
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else None


def device_hbm_gbps(default: Optional[float] = None) -> Optional[float]:
    """HBM GB/s of card 0 from ``_HBM_GBPS``, else ``default``."""
    name = (_device_name() or "").lower()
    for key, gbps in _HBM_GBPS:
        if name and key in name:
            return gbps
    return default


def roofline(rays_per_s: float, bytes_per_ray: float) -> dict:
    """How close a measured throughput comes to the HBM-bandwidth bound.

    ``bytes_per_ray``: the estimated HBM traffic per traced ray (scene
    reads amortize across the batch; per-ray state and the node and
    triangle reads of the walk dominate). Raises ``ValueError`` where
    the card's bandwidth is not known (``device_hbm_gbps``)."""
    gbps = device_hbm_gbps()
    if gbps is None:
        raise ValueError(
            f"no HBM bandwidth known for device {_device_name()!r}: "
            f"roofline needs a card listed in profiling._HBM_GBPS")
    bw = gbps * 1e9
    bound = bw / max(bytes_per_ray, 1e-9)
    return {
        "rays_per_s": rays_per_s,
        "hbm_gbps": gbps,
        "bytes_per_ray": bytes_per_ray,
        "hbm_bound_rays_per_s": bound,
        "fraction_of_roofline": rays_per_s / bound,
    }


# FP32 operations per test of the fused segment kernel, read off
# csrc/mega_segment.cu (a divide or a square root counts as one), in the
# order of the first four tallies of its counting instance
# (ops/kernels/mega.COUNTS): slab test 12 sub/mul + 10 min/max + clamp + 2
# compares; Baldwin-Weber slot 5 (n.d) + 2 (parallel) + 5 (n.o) + 2 (t) +
# 6 (hit point) + 12 (u, v) + 5 compares + the caller's t < best; sphere
# 3 + 5 + 5 + 3 + 2 (sqrt) + 4 (roots) + 5 compares + 1; MT 6 (edges) + 9
# (cross) + 5 (det) + 4 + 3 + 6 (u) + 9 (cross) + 6 (v) + 6 (t) + 6
# compares + 2 (caller)
OPS_PER_TEST = (25, 39, 28, 62)   # slab, leaf slot, sphere, MT


def capture_segments(fn: Callable) -> list:
    """Run ``fn`` with every fused-segment launch's inputs recorded: a
    list of (depth, (o, d, thr, tmax)) in launch order. The launches run
    (and count) as usual."""
    from unity_raytracer_tpu_torch.ops.kernels import mega
    seen, seg = [], mega.trace_segment

    def spy(packed, aux, depth, o, d, thr, tmax, **kw):
        seen.append((depth, (o, d, thr, tmax)))
        return seg(packed, aux, depth, o, d, thr, tmax, **kw)

    mega.trace_segment = spy
    try:
        fn()
    finally:
        mega.trace_segment = seg
    return seen


def segment_work(packed, aux: torch.Tensor, route_kw: dict, segs: list,
                 out_bytes: int, route: str) -> tuple:
    """(bytes, FP32 operations) of one launch per (depth, inputs) in
    ``segs`` on a route of the fused segment kernel: 40 B of inputs and
    ``out_bytes`` of outputs per lane, the route's tables (node rows, leaf
    rows, leafmeta, leaf-group boxes) and the aux block once per launch
    with a live lane; operations from the route's counting instance (its
    tests x ``OPS_PER_TEST``), on CUDA tensors. ``route_kw``: the
    ``trace_segment`` keywords of the launches."""
    from unity_raytracer_tpu_torch.ops.kernels import mega
    tables = aux.numel() * 4
    if route != "meshless":
        table, leaf = mega._tables(packed, route)
        tables += sum(t.numel() * 4 for t in (table, leaf, packed.leafmeta,
                                              packed.leafbox))
    counts = torch.zeros(len(mega.COUNTS), dtype=torch.int64,
                         device=aux.device)
    lanes = live_launches = 0
    for depth, ins in segs:
        mega.trace_segment(packed, aux, depth, *ins, counts=counts,
                           **route_kw)
        lanes += ins[0].shape[0]
        live_launches += bool((ins[3] >= 0).any())
    ops = sum(n * k for n, k in zip(counts.tolist(), OPS_PER_TEST))
    return lanes * (40 + out_bytes) + tables * live_launches, ops
