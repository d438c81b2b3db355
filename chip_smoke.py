#!/usr/bin/env python3
"""Smoke run of the PyTorch port (unity_raytracer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, it

1. prints the card (``nvidia-smi`` name and power limit), the PyTorch and
   CUDA versions and the ``nvcc`` path;
2. builds the port's native libraries from the checkout's sources, one
   compiler process per library started together (the BVH builder, the
   fused segment kernel's three libraries — BVH4 rows, BVH8 rows, binary
   rows and the meshless fork — the BVH walks, the brute-force nearest
   triangle) and times the build; prints ptxas' registers, stack and
   spill per kernel instance and fails if a fused Baldwin–Weber forward
   instance needs more than its own redesigned build did (FORWARD_PTXAS
   below), so that the other modes cannot cost the forward instances;
3. holds the fused segment kernel against its plain PyTorch version on
   the same inputs, in its three modes — forward (a), record (b) and
   record_soft (d): every segment of the ``mesh10k`` chain at 256x256,
   then a 16,384-ray slice of every segment of the flagship frame; it
   fails if more than 0.01% of lanes fall outside rtol = atol = 5e-4 (hit
   records: matid and occbits exactly, t sign exactly, st exactly _BIG
   where unoccluded) or if a record mode's base outputs differ at all
   from the forward mode's; the counting instance gives each mode's bound
   and, on the flagship frame's segments 0 and 1, the work split by phase
   (``counters`` lines: slab, leaf-group box and leaf-slot tests per live
   lane in the nearest and the shadow walks, active lanes per leaf-slot
   test, the deepest stack);
4. renders the flagship frame (``mesh100k``, 1920x1080, 4 bounces) on the
   fused kernel (``kernel='mega'``), checks that the frame went through 5
   kernel launches with no stack overflow and is finite and not flat,
   then times 1 warm-up + 3 frames with CUDA events, times each of the 5
   launches alone in each mode (the all-dead segments 2-4 beside their
   bytes bound), and profiles one frame;
5. renders a small ``mesh10k`` frame on the fused kernel on the card and
   with its plain version on the CPU and compares the two images;
6. runs the flagship hard fwd+bwd step (``ops/replay.
   replay_value_and_grad`` w.r.t. sphere centers, sphere diffuse and light
   intensities, target = replay radiance x 0.9) and the soft one
   (``soft_replay_value_and_grad``, chunks of 2^18 lanes): replay radiance
   against the fused forward render at rtol = atol = 2e-4, finite
   non-zero gradients, then 1 warm-up + 3 timed steps each, the records
   pass and the replay fwd+bwd alone, and peak memory;
7. fits the flagship for 3 steps with ``fit --replay``'s calls
   (``__main__.run_fit``), then ``mesh10k`` at 64x64 for 5 steps on the
   card and on the CPU from the same seeded start (losses and parameters
   at rtol 1e-3), and compares one ``mesh10k`` 64x64 fwd+bwd on the card
   with the CPU's;
8. the composed path (``ops/render._trace_chain``) on the flagship BVH:
   every traversal kernel (``traverse_packet4``, ``traverse_wide`` at
   arity 4 and 8, ``traverse_packet3``) against the plain version on
   16,384-ray slices of the composed frame's own launches — the primary
   rays (nearest), segment 0's light-major shadow rays (any-hit, t_max =
   light distance) and segment 1's mostly retired lanes (negative t_max):
   t equal on every nearest lane, the MeshSet row equal on every lane
   whose t does not tie (tied lanes counted), the occlusion predicate
   equal on every any-hit lane, culled lanes a miss, no stack overflow;
   the counting instance gives each kernel's bound and the work of each
   launch of each walk in its composed frame (``counters`` lines);
9. renders the flagship composed frame with ``kernel='pallas'`` (the
   traversal ``'auto'`` takes on the card), then ``'wide'`` (arity 4 and
   8) and ``'pallas3'``: each within rtol = atol = 5e-4 of the fused frame
   on at least 99.99% of lanes, timed (1 warm-up + 3 frames), each of its
   traversal launches timed alone, one profiled; the per-segment live
   lanes of ``trace_radiance_stats`` against the fused frame's;
10. runs bench.py's composed fwd+bwd unit (``fit.
    make_chunked_value_and_grad`` with remat, chunks of 2^18 lanes, hard
    visibility, target = composed radiance x 0.9) and holds its loss and
    gradients against the replay's hard step on the same target (loss
    rtol 1e-4, gradients rtol 5e-3, atol 5e-4 x the largest |g|), then
    times 1 warm-up + 3 steps, each of the step's 48 ``traverse_packet4``
    launches alone against their bound, and reads the peak memory;
11. holds the brute-force nearest-triangle kernel, which culls per
    block of 256 rays, against its plain version bit for bit ((t, index)
    on every lane) on the ``mesh10k`` launches of
    ``scripts/torch_nearest_census.nearest_launches``: every launch of
    the BVH-less 24x24, 64x64 and 128x128 frames, and the proxies that
    no path makes, (i) the whole 1024x1024 primary batch, (ii) every 16th
    of its rays, (iii) the mirror bounces that segment 1 of the composed
    frame traces, (iv) the primary batch in a seeded random order; its
    counting instance gives the triangles each block kept (held to the
    plain model of the cull on (ii) and a 128x128 frame launch), the
    exact tests per ray, the counted-work bound (bytes, or the kept
    pairs' exact tests), the cull stream's operations and the
    brute-force bound; times each launch; the kernels line's row is the
    24x24 frame's launches, which the main path below makes; renders
    that BVH-less ``mesh10k`` frame through the kernel on the card and
    with the plain version on the CPU;
12. fits on the composed path (``fit`` without ``--replay``) on the card
    and on the CPU from the same start, losses and parameters at rtol
    1e-3: the ``three_spheres`` toy (48x48, 5 steps, whole image) and
    ``mesh10k`` (32x32, 2 steps, depth 1, chunked with remat);
13. holds the fused kernel's fork mode (c) without a mesh against its
    plain version on every level's lanes of the ``cornell_box`` 512x512
    fused tree (delta, both children's weights and liveness on every live
    lane, origin and direction where the child is live; at most 0.01% of
    lanes outside rtol = atol = 5e-4), each level's launch timed alone;
14. the fork with a mesh walk: a mesh + glass scene (tests/torch_parity's
    small scene with cornell's glass sphere) at 256x256, depth 4, on the
    Baldwin–Weber BVH4 route and the Möller–Trumbore BVH4 and binary
    routes: every level's launch against the plain version, the fused
    tree frame against the composed tree (the twin's bounds below);
15. renders the 512x512 ``cornell_box`` frame on the fused tree
    (``kernel='mega'``: 5 fork launches) and the composed tree: the
    twin's bounds between them (tests/test_tree_mega.py: 99th percentile
    of the per-pixel error < 0.02 on the 0-255 scale, and max < 1.0 on
    all but 0.05% of the pixels: TREE_* below), 0 truncated lanes on both
    (``trace_radiance_tree_stats``), finite and not flat; 1 warm-up + 3
    frames each, live lanes per level, one profile each;
16. the fused kernel's mode (e): the Möller–Trumbore instances on BVH4,
    BVH8 and the binary layout in the three modes against the plain
    version on phase 3's flagship slices, then the flagship 1920x1080
    fused frame on each against the Baldwin–Weber frame (at most 0.01% of
    pixels outside 5e-4), timed, each launch alone, its bound from the
    counting instance;
17. the multi-device layer (``parallel/``) at world size 1: a one-rank
    NCCL group opened in this process through a file store (NCCL's
    bootstrap on the loopback), on the flagship frame: ``render_tiled``
    and ``render_auto`` on the fused kernel against ``render`` at rtol =
    atol = 1e-6; the chunked ``render`` (2^19 lanes per chunk, the last
    padded) bit for bit against the unchunked frame;
    ``render_tiled_orchestrated`` with 128-row bands against ``render``;
    ``scene_sharded_hit``, ``scene_sharded_hit_bvh`` (tp = 1) and
    ``nearest_hit_ring`` on the frame's primary rays, in the frame's
    block order and in the twin's row-major order, against
    ``nearest_hit`` on the same route (the nearest-triangle kernel
    without a BVH; the threaded walk on the shard's packed rows): t,
    kind, index and mesh index on every lane but the tied ones (equal t,
    another triangle: counted and printed); every launch of the
    nearest-triangle kernel and of the walk that these calls make, on
    65,536 of its lanes (whole 256-ray blocks from the middle of the
    frame), against the plain version on the same inputs (the nearest
    triangle bit for bit, the walk as phase 9 holds it; the run of lanes
    must hold hits); three ``make_sharded_train_
    step`` steps at depth 1 on ``'pallas'`` (soft, chunks of 2^18, remat),
    the loss falling and step 1 against ``fit``'s single-process composed
    step from the same start (loss at rtol 1e-4, parameters at rtol 1e-4,
    atol 1e-5); each item's launches of kernels #1, #3, #4 and #5 in one
    call (counts set to 0 just before it, read just after; each item must
    launch its kernel), its peak memory, and its time (CUDA events, 1
    warm-up + 3).

Every kernel's launch count is read from its main path's run alone: the
counts are set to 0 just before that run and read just after. Any failure
raises and the exit code is not 0. The last two lines are the
``nvidia-smi`` name/power-limit line and ``{"ok": true, "device":
{...}}``; the line before them is the JSON record of every kernel (the
fused kernel's rows: modes (a), (b), (d) on Baldwin–Weber BVH4, the fork
(c) meshless and on BVH4, and the forward (e) instances; the rows of #1
mode (a), #3, #4 and #5 also carry ``sharded_launches``, phase 17's
launches per call). Without
a CUDA card, or without the package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

TOL = dict(rtol=5e-4, atol=5e-4)
RAD_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_replay.py:75
MAX_BAD_FRACTION = 1e-4   # lanes outside TOL: FMA contraction / visit order
# fused vs composed tree frames (tests/test_tree_mega.py:29-33, 0-255
# scale): the 99th percentile of the per-pixel error below TREE_P99, and
# at most TREE_OVER_FRACTION of the pixels above TREE_MAX. The twin's test
# holds every pixel of its 24x24 frame below TREE_MAX; at 512x512 its own
# two routes differ by up to 4.4 on deep glass paths, where a 1e-5 change
# of a sphere normal sends a later bounce to another surface (PERF.md)
TREE_P99, TREE_MAX, TREE_OVER_FRACTION = 0.02, 1.0, 5e-4
SLICE = 16384
# phase 17: lanes of each sharded hit's kernel launches held against the
# plain version (a run of whole 256-ray blocks from the middle of the frame)
PLAIN_LANES = 65536
BIG = 3.0e38
KERNEL_SRC = "unity_raytracer_tpu_torch/csrc/mega_segment.cu"
REPLACES = "unity_raytracer_tpu/ops/pallas/mega.py:459"
TRAVERSE_SRC = "unity_raytracer_tpu_torch/csrc/traverse.cu"
NEAREST_SRC = "unity_raytracer_tpu_torch/csrc/nearest_tri.cu"
# the walks of the composed path: layout -> (name in the kernels line,
# frame kernel, BVH arity, the TPU kernel's pallas_call)
WALKS = {
    "mk4": ("traverse_packet4", "pallas", 4,
            "unity_raytracer_tpu/ops/pallas/traverse_mk4.py:225"),
    "wide4": ("traverse_wide/arity4", "wide", 4,
              "unity_raytracer_tpu/ops/pallas/traverse_wide.py:473"),
    "wide8": ("traverse_wide/arity8", "wide", 8,
              "unity_raytracer_tpu/ops/pallas/traverse_wide.py:473"),
    "mk3": ("traverse_packet3", "pallas3", 4,
            "unity_raytracer_tpu/ops/pallas/traverse_mk3.py:354"),
}
NEAREST_REPLACES = "unity_raytracer_tpu/ops/pallas/intersect_mk.py:145"
# tests/test_replay.py:106-108: gradient rtol, atol x max |g|
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-4
MODES = ("forward", "record", "record_soft")
ALL_MODES = MODES + ("fork",)
# ptxas' line for the Baldwin–Weber forward instances of the redesigned
# kernel (culled leaf groups, warp-pooled shadow queries), per BVH arity,
# built with the same command (nvcc 12.9 for sm_90a), as ``python -m
# unity_raytracer_tpu_torch.ops.kernels.ptxas`` prints it. Later modes
# added to the source must not cost the forward instances registers,
# stack or spill
FORWARD_PTXAS = {4: dict(registers=64, stack=2120, spill=104),
                 8: dict(registers=72, stack=2120, spill=116)}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 operations/s
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# FP32 operations per test, read off csrc/mega_segment.cu (a divide or a
# square root counts as one): slab test 12 sub/mul + 10 min/max + clamp
# + 2 compares; Baldwin-Weber slot 5 (n.d) + 2 (parallel) + 5 (n.o) + 2
# (t) + 6 (hit point) + 12 (u, v) + 5 compares + the caller's t < best;
# sphere 3 + 5 + 5 + 3 + 2 (sqrt) + 4 (roots) + 5 compares + 1; MT 6
# (edges) + 9 (cross) + 5 (det) + 4 + 3 + 6 (u) + 9 (cross) + 6 (v) + 6
# (t) + 6 compares + 2 (caller)
OPS_PER_TEST = (25, 39, 28, 62)   # slab, leaf slot, sphere, MT
# the walks' counting instance: slab tests, MT tests (csrc/traverse.cu
# computes both as the fused kernel does)
WALK_OPS = (25, 62)
# bytes a walk moves per lane: a live lane reads o, d, tmax and writes t,
# slot, leaf row; a culled lane (tmax < 0) reads tmax only
WALK_LIVE_BYTES, WALK_CULLED_BYTES = 24 + 4 + 12, 4 + 12
# the nearest-triangle kernel: bytes per ray (o, d in; t, index out) and
# per triangle (9 floats and the valid flag), and FP32 operations of one
# cull test (csrc/nearest_tri.cu: centre
# offset 3, axial 5, radial 9 + 6, distance 6, F 4, s 2, c.n 5, g 6, A 4,
# the margin 10, the threshold 4, the two compares)
NEAREST_RAY_BYTES, NEAREST_TRI_BYTES = 32, 40
CULL_OPS = 66
# bytes a walk reads per binary node row (three float4: box, leaf row,
# count, miss link, right child) and per leaf slot (one 9-float triangle);
# a wide row is read whole
NODE_ROW_BYTES, SLOT_BYTES = 48, 36


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def compare(got, want, torch):
    """(bad lanes, lanes, max abs err) between two segment outputs: delta
    everywhere, the continuation flag everywhere, and the continuing ray
    state where the plain version continues."""
    cont = want[4] >= 0
    close = lambda a, b: torch.isclose(a, b, **TOL).all(-1)
    bad = ~close(got[0], want[0]) | ((got[4] >= 0) != cont)
    err = (got[0] - want[0]).abs().max()
    for a, b in zip(got[1:4], want[1:4]):
        bad |= cont & ~close(a, b)
        if bool(cont.any()):
            err = torch.maximum(err, (a - b)[cont].abs().max())
    for i in torch.nonzero(bad).squeeze(1)[:3].tolist():
        log(f"  lane {i}: " + "; ".join(
            f"{k} {g[i].tolist()} vs {w[i].tolist()}" for k, g, w in zip(
                ("delta", "o'", "d'", "thr'", "tmax'"), got, want)))
    return int(bad.sum()), int(cont.numel()), float(err)


def compare_records(got, want, torch):
    """(bad lanes, max abs err) between two hit-record tuples: matid and
    occbits exactly, the sign of t exactly, t and n at TOL where the plain
    version hits, st at TOL below _BIG and exactly _BIG elsewhere."""
    hit = want[0] >= 0
    bad = (got[2] != want[2]) | (got[3] != want[3]) | ((got[0] >= 0) != hit)
    bad |= hit & ~torch.isclose(got[0], want[0], **TOL)
    bad |= hit & ~torch.isclose(got[1], want[1], **TOL).all(-1)
    err = torch.zeros((), device=hit.device)
    if bool(hit.any()):
        err = torch.maximum((got[0] - want[0])[hit].abs().max(),
                            (got[1] - want[1])[hit].abs().max())
    if len(want) > 4:
        fin = want[4] < BIG
        bad |= torch.where(fin, ~torch.isclose(got[4], want[4], **TOL),
                           got[4] != want[4]).any(-1)
        if bool(fin.any()):
            err = torch.maximum(err, (got[4] - want[4])[fin].abs().max())
    for i in torch.nonzero(bad).squeeze(1)[:3].tolist():
        log(f"  record lane {i}: " + "; ".join(
            f"{k} {g[i].tolist()} vs {w[i].tolist()}" for k, g, w in zip(
                ("t", "n", "matid", "occbits", "st"), got, want)))
    return int(bad.sum()), float(err)


def ptxas_table(log_text):
    """{(layout, leaf test, mode, counting): {registers, stack, spill}}
    from nvcc's -Xptxas -v output (instances named
    mega_segment_kernelILi<LAYOUT>ELb<MT>ELi<MODE>ELb<C>; layout 4 or 8
    wide rows, 1 binary, 0 meshless)."""
    from unity_raytracer_tpu_torch.ops.kernels.ptxas import entries
    out = {}
    for name, v in entries(log_text).items():
        m = re.search(r"mega_segment_kernelILi(\d)ELb(\d)ELi(\d)ELb(\d)E",
                      name)
        if m:
            out[int(m.group(1)), "mt" if m.group(2) == "1" else "bw",
                ALL_MODES[int(m.group(3))], bool(int(m.group(4)))] = v
    return out


def events_ms(fn, repeats):
    """Mean ms of ``repeats`` calls after one warm-up, by CUDA events."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(repeats):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / repeats


def bound(nbytes, ops):
    """(ms, 'bytes' | 'operations'): the larger of bytes / HBM rate and
    FP32 operations / FP32 rate."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def log_segment_counts(what, packed, aux, depth, ins, kw):
    """One counting launch of the fused kernel on a segment's inputs; logs
    its split by phase (the nearest walk, the shadow walks): slab tests,
    leaf-group box tests and leaf-slot tests per live lane, the mean
    active lanes per leaf-slot test, the deepest stack."""
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import mega
    counts = torch.zeros(len(mega.COUNTS), dtype=torch.int64,
                         device=aux.device)
    mega.trace_segment(packed, aux, depth, *ins, counts=counts, **kw)
    c = dict(zip(mega.COUNTS, counts.tolist()))
    live = max(c["live"], 1)
    for ph in ("nearest", "shadow"):
        slots = c[f"{ph}_slots"]
        log(f"counters {what}, {ph} phase: {c[f'{ph}_slab'] / live:.3f} "
            f"slab tests, {c[f'{ph}_groups'] / live:.3f} leaf-group box "
            f"tests, {slots / live:.3f} leaf-slot tests per live lane; "
            f"{slots / max(c[f'{ph}_issues'], 1):.2f} active lanes per "
            f"leaf-slot test; deepest stack {c[f'{ph}_depth']}")
    log(f"counters {what}: {c['live']} live lanes, {c['queries']} shadow "
        f"queries ({c['queries'] / live:.3f} per live lane)")


def log_walk_counts(what, layout, packed, ins):
    """One counting launch of a walk; logs slab tests, leaf-group box
    tests and MT tests per live lane (the sequential leaf test's, the work
    the walk needs), the mean active lanes per MT test (mk3 and wide: the
    lanes busy per cooperative pass, and of them the lanes doing needed
    work, with the slot tests the passes ran) and the deepest stack."""
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    table = packed.nodes if layout in ("mk3", "mk4") else packed.wide
    counts = torch.zeros(len(m3.COUNTS), dtype=torch.int64,
                         device=table.device)
    seen = tuple(torch.zeros(k, dtype=torch.uint8, device=table.device)
                 for k in (table.shape[0],
                           packed.tris.shape[0] * m3.PALLAS_LEAF))
    m3.walk_raw(layout, packed, *ins, counts=counts, seen=seen)
    c = dict(zip(m3.COUNTS, counts.tolist()))
    live, issues = max(c["live"], 1), max(c["issues"], 1)
    if layout == "mk4":
        lanes = f"{c['mt'] / issues:.2f} active lanes per MT test"
    else:
        lanes = (f"{c['pass_slots'] / issues:.2f} lanes busy per "
                 f"cooperative pass, {c['mt'] / issues:.2f} of them on "
                 f"needed tests ({c['pass_slots'] / live:.3f} slot tests "
                 f"run per live lane)")
    log(f"counters {what}: {c['live']} live lanes; {c['slab'] / live:.3f} "
        f"slab tests, {c['groups'] / live:.3f} leaf-group box tests, "
        f"{c['mt'] / live:.3f} MT tests per live lane; {lanes}; "
        f"deepest stack {c['depth']}")


def profile_once(fn, what, timed_ms, card):
    """Where one call's device time goes (torch.profiler's CUDA trace):
    busy share of the timed call, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # kernel rows only: an aten:: row repeats its kernels' device time
    ops = sorted((e for e in prof.key_averages()
                  if dev_us(e) > 0 and not e.key.startswith("aten::")),
                 key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in ops)
    if busy_us > 0:
        n_k = sum(e.count for e in ops)
        log(f"profile of {what}: device busy {busy_us / 1e3:.3f} ms "
            f"= {busy_us / 1e3 / timed_ms:.1%} of the timed "
            f"{timed_ms:.3f} ms, {n_k} kernel launches {card}")
        for e in ops[:8]:
            log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
                f"{e.key[:70]}")
    else:
        log(f"profile of {what}: no device time recorded (not measured)")


def capture_walks(fn):
    """Run ``fn`` with every traversal launch's inputs recorded: a list of
    (layout, o, d, tmax, any_hit) in launch order. The launches run (and
    count) as usual."""
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    seen, walk_raw = [], m3.walk_raw

    def spy(layout, packed, o, d, tmax, any_hit=False, **kw):
        seen.append((layout, o, d, tmax, any_hit))
        return walk_raw(layout, packed, o, d, tmax, any_hit, **kw)

    m3.walk_raw = spy
    try:
        fn()
    finally:
        m3.walk_raw = walk_raw
    return seen


def capture_launches(fn):
    """Run ``fn`` once with the inputs and outputs of every launch of the
    nearest-triangle kernel and of the walks recorded, in launch order:
    ``("nearest", (o, d, verts, valid), (t, index))`` and ``("walk",
    (layout, packed, o, d, tmax, any_hit), (t, slot, leaf row))``."""
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    seen, nearest, walk_raw = [], imk.nearest_triangle_pallas, m3.walk_raw

    def spy_nearest(o, d, verts, valid=None):
        out = nearest(o, d, verts, valid)
        seen.append(("nearest", (o, d, verts, valid),
                     tuple(x.clone() for x in out)))
        return out

    def spy_walk(layout, packed, o, d, tmax, any_hit=False, **kw):
        out = walk_raw(layout, packed, o, d, tmax, any_hit, **kw)
        seen.append(("walk", (layout, packed, o, d, tmax, any_hit),
                     tuple(x.clone() for x in out)))
        return out

    imk.nearest_triangle_pallas, m3.walk_raw = spy_nearest, spy_walk
    try:
        fn()
    finally:
        imk.nearest_triangle_pallas, m3.walk_raw = nearest, walk_raw
    return seen


def check_launch_lanes(launch, lo, hi, torch):
    """One recorded launch (``capture_launches``) on its lanes ``[lo,
    hi)`` against the plain version on the same inputs -> (lanes off,
    hits, tied lanes): the nearest-triangle kernel bit for bit (t, first
    index of the minimum), a walk as ``check_walk`` holds it."""
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    kind, ins, out = launch
    got = tuple(x[lo:hi] for x in out)
    if kind == "nearest":
        o, d, verts, valid = ins
        want = imk.nearest_triangle_plain(o[lo:hi], d[lo:hi], verts, valid)
        bad = (~(got[0] == want[0]) & ~(torch.isinf(got[0])
                                        & torch.isinf(want[0]))
               | (got[1] != want[1]))
        return int(bad.sum()), int((want[1] >= 0).sum()), 0
    layout, packed, o, d, tmax, any_hit = ins
    sl = (o[lo:hi], d[lo:hi], tmax[lo:hi], any_hit)
    plain = m3.traverse_plain(packed, *sl)
    bad, tie, _ = check_walk(layout, packed, sl, plain, torch, got=got)
    return bad, int((plain[1] >= 0).sum()), tie


def walk_work(layout, packed, launches):
    """(bytes, FP32 operations) the walk must move and compute for the
    launches ``[(o, d, tmax, any_hit)]``, each input read once and each
    output written once: 40 B per live lane and 16 B per culled lane, plus
    each node (or wide) row and each leaf slot that the launch's counting
    instance reads, once per launch; operations from the counting
    instance's slab and MT tests (those of the sequential leaf test: the
    cooperative leaf phase's extra tests are not work the walk needs)."""
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    table = packed.nodes if layout in ("mk3", "mk4") else packed.wide
    row_bytes = NODE_ROW_BYTES if layout in ("mk3", "mk4") else \
        table.shape[1] * 4
    counts = torch.zeros(len(m3.COUNTS), dtype=torch.int64,
                         device=table.device)
    nbytes = 0
    for o, d, tmax, any_hit in launches:
        seen = tuple(torch.zeros(k, dtype=torch.uint8, device=table.device)
                     for k in (table.shape[0],
                               packed.tris.shape[0] * m3.PALLAS_LEAF))
        m3.walk_raw(layout, packed, o, d, tmax, any_hit, counts=counts,
                    seen=seen)
        live = int((tmax >= 0).sum())
        nbytes += (live * WALK_LIVE_BYTES
                   + (o.shape[0] - live) * WALK_CULLED_BYTES
                   + int(seen[0].sum()) * row_bytes
                   + int(seen[1].sum()) * SLOT_BYTES)
    ops = sum(n * k for n, k in zip(counts.tolist(), WALK_OPS))
    return nbytes, ops


def check_walk(layout, packed, ins, plain, torch, got=None):
    """Kernel vs plain raw outputs on one slice -> (bad lanes, tied lanes,
    max abs err of t): nearest t equal on every lane, the MeshSet row
    equal unless the kernel's triangle ties the plain t, any-hit
    occlusion equal, culled lanes a miss with t = tmax. ``got``: the
    kernel's outputs on these lanes from an earlier launch (else it is
    launched on the slice)."""
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    from unity_raytracer_tpu_torch.ops.kernels.mega import _mt
    o, d, tmax, any_hit = ins
    t, slot, leaf = got if got is not None else m3.walk_raw(
        layout, packed, o, d, tmax, any_hit)
    culled = tmax < 0
    bad = culled & ((slot != -1) | (t != tmax))
    if any_hit:
        bad |= ~culled & ((t < 0) != (plain[0] < 0))
        return int(bad.sum()), 0, 0.0
    bad |= t != plain[0]
    hit = plain[1] >= 0
    row = lambda s, lf: packed.bvh.prim_index[packed.leaf_prim[
        lf.clamp_min(0).long(), s.clamp_min(0).long()].long()]
    other = hit & (row(slot, leaf) != row(plain[1], plain[2]))
    # a different triangle at exactly the plain t is a tie, not a fault
    i = torch.nonzero(other).squeeze(1)
    tie = torch.zeros_like(other)
    if i.numel():
        v = packed.tris[leaf[i].long(), :126].reshape(-1, 14, 9)[
            torch.arange(i.numel(), device=i.device), slot[i].long()]
        ok, t_k = _mt(tuple(c[i] for c in o.unbind(-1)),
                      tuple(c[i] for c in d.unbind(-1)), v.T)
        tie[i] = ok & (t_k == plain[0][i])
    bad |= other & ~tie
    err = float((t - plain[0])[hit].abs().max()) if bool(hit.any()) else 0.0
    return int(bad.sum()), int(tie.sum()), err


def nearest_work(o, d, verts, valid, kept):
    """(bytes, operations, exact pair tests, cull tests) of one
    nearest-triangle launch: rays and triangles read once, (t, index)
    written once, and the exact tests the culled kernel makes (every ray
    of a block tests each triangle its block kept: ``kept``, from the
    counting instance). The cull tests (every block with a ray that can
    hit tests each valid triangle's ball against its cone) are the
    design's own stream, not work the function needs: counted apart."""
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk
    n = o.shape[0]
    lanes = torch.full_like(kept, imk.BLOCK, dtype=torch.int64)
    lanes[-1] = n - imk.BLOCK * (kept.shape[0] - 1)
    pairs = int((kept.long() * lanes).sum())
    streaming = int(imk.block_bundles(o, d)["any_part"].sum())
    culls = streaming * int((valid >= 0.5).sum())
    nbytes = n * NEAREST_RAY_BYTES + verts.shape[0] * NEAREST_TRI_BYTES
    return nbytes, pairs * OPS_PER_TEST[3], pairs, culls


def nearest_phase(dev, card, failures):
    """Phase 11's checks of the kernel (module docstring): returns its
    kernels-line row (``launches`` is filled in by the caller)."""
    import torch
    from scripts.torch_nearest_census import nearest_launches
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk

    runs, v10, ok10 = nearest_launches(dev)
    n_t = int(ok10.sum())
    res = {}
    for what, (o, d) in runs.items():
        got = imk.nearest_triangle_pallas(o, d, v10, ok10)
        want = imk.nearest_triangle_plain(o, d, v10, ok10)
        bad = int((~(got[0] == want[0]) & ~(torch.isinf(got[0])
                                            & torch.isinf(want[0]))
                   | (got[1] != want[1])).sum())
        hits = int((want[1] >= 0).sum())
        both = torch.isfinite(got[0]) & torch.isfinite(want[0])
        err = float((got[0] - want[0])[both].abs().max()) if bool(
            both.any()) else 0.0
        t_c, i_c, kept = imk.nearest_triangle_survivors(o, d, v10, ok10)
        if not (torch.equal(t_c, got[0]) and torch.equal(i_c, got[1])):
            bad += 1
            failures.append(f"nearest_triangle {what}: the counting "
                            f"instance's bits differ from the kernel's")
        nb, ops, pairs, culls = nearest_work(o, d, v10, ok10, kept)
        cb = bound(nb, ops)
        bb = bound(nb, o.shape[0] * n_t * OPS_PER_TEST[3])
        stream = culls * CULL_OPS / FP32_OPS * 1e3
        k_ms = events_ms(lambda: imk.nearest_triangle_pallas(o, d, v10,
                                                             ok10), 5)
        kf = kept.double()
        res[what] = dict(ms=k_ms, err=err, counted=cb, brute=bb,
                         stream=stream, kept_mean=float(kf.mean()))
        log(f"nearest_triangle {what}: {o.shape[0]} rays x {n_t} "
            f"triangles: {bad} lanes off the plain version ({hits} hits); "
            f"kept per block of {imk.BLOCK} mean {float(kf.mean()):.3f}, "
            f"max {int(kf.max())}, none in "
            f"{float((kf == 0).double().mean()):.4f} of {kf.shape[0]} "
            f"blocks; {pairs / o.shape[0]:.3f} exact tests per ray; kernel "
            f"{k_ms:.4f} ms; counted-work bound {cb[0]:.4f} ms ({cb[1]}: "
            f"{nb} bytes, {ops:.6g} FP32 operations); the cull stream "
            f"{culls} tests, {stream:.4f} ms of operations; brute-force "
            f"work {bb[0]:.4f} ms ({bb[1]}) {card}")
        if bad or hits == 0:
            failures.append(f"nearest_triangle {what}: {bad} lanes off, "
                            f"{hits} hits")
    # the plain model of the cull against the counting instance
    for what in ("128x128 frame, launch 0",
                 "(ii) proxy: every 16th primary ray"):
        o, d = runs[what]
        model = imk.nearest_triangle_survivors_plain(
            o.cpu(), d.cpu(), v10.cpu(), ok10.cpu()).sum(1).to(torch.int32)
        kept = imk.nearest_triangle_survivors(o, d, v10, ok10)[2].cpu()
        log(f"nearest_triangle cull: the counting instance keeps per block "
            f"what the plain model keeps on {what}: "
            f"{torch.equal(model, kept)}")
        if not torch.equal(model, kept):
            failures.append(f"nearest_triangle: counting instance and "
                            f"plain model of the cull disagree on {what}")
    # the row: the main path's launches (phase 11's 24x24 frame), summed
    main = [k for k in runs if k.startswith("24x24 frame")]
    p_ms = sum(events_ms(lambda: imk.nearest_triangle_plain(
        *runs[k], v10, ok10), 3) for k in main)
    top = max(main, key=lambda k: res[k]["counted"][0])
    frames = {}
    for k, r in res.items():
        if "frame" in k:
            f = frames.setdefault(k.split(",")[0], dict(ms=0.0, bound_ms=0.0))
            f["ms"] += r["ms"]
            f["bound_ms"] += r["counted"][0]
    log("nearest_triangle BVH-less mesh10k frames, launches summed: "
        + "; ".join(f"{k} {f['ms']:.4f} ms, counted-work bound "
                    f"{f['bound_ms']:.4f} ms" for k, f in frames.items())
        + f" {card}")
    row = {key: sum(res[k][key] for k in main) for key in ("ms", "stream")}
    row.update({key: sum(res[k][key][0] for k in main)
                for key in ("counted", "brute")})
    return dict(
        name="nearest_triangle", route="cuda", source=NEAREST_SRC,
        replaces=NEAREST_REPLACES, launches=0,
        max_abs_err=max(r["err"] for r in res.values()),
        ms=row["ms"], plain_ms=p_ms, bound_ms=row["counted"],
        bound_by=res[top]["counted"][1], library_ms=None,
        brute_force_bound_ms=row["brute"], counted_bound_ms=row["counted"],
        cull_stream_ms=row["stream"],
        frames=frames,
        survivors_per_block={k: r["kept_mean"] for k, r in res.items()},
        launch_ms={k: r["ms"] for k, r in res.items()},
        launch_bound_ms={k: r["counted"][0] for k, r in res.items()},
        launch_cull_stream_ms={k: r["stream"] for k, r in res.items()})


def composed_phases(dev, card, failures, scene, cam, cfg, packed, packed8,
                    fused_img, fused_live, issued, names):
    """Phases 8-12 (module docstring); returns the kernels-line rows of
    the four walks and the nearest-triangle kernel."""
    import torch
    from unity_raytracer_tpu_torch.__main__ import run_fit
    from unity_raytracer_tpu_torch.fit import (
        get_params, make_chunked_value_and_grad)
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops import replay as rp
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    from unity_raytracer_tpu_torch.ops.render import (
        render, render_frame, trace_radiance, trace_radiance_stats)

    bvhs = {4: packed, 8: packed8}
    o, d = generate_rays_blocks(cam, cfg.block_size)
    rows = {}

    # ---- 8. the walks against their plain version on the frame's launches
    frame_walks = {}
    for layout, (name, kernel, arity, _) in WALKS.items():
        fcfg = cfg.with_(kernel=kernel)
        frame_walks[layout] = capture_walks(
            lambda: render_frame(scene, cam, fcfg, bvhs[arity]))
    seg0 = frame_walks["mk4"]
    pick = lambda n, k: torch.linspace(0, n - 1, k, device=dev).long()

    def take(launch, live_only):
        _, lo, ld, lt, any_hit = launch
        idx = torch.nonzero(lt >= 0).squeeze(1) if live_only else \
            torch.arange(lt.shape[0], device=dev)
        idx = idx[pick(idx.numel(), min(SLICE, idx.numel()))]
        return (lo[idx].contiguous(), ld[idx].contiguous(),
                lt[idx].contiguous(), any_hit)

    slices = {"primary rays, nearest": take(seg0[0], True),
              "segment-0 shadow rays, any-hit": take(seg0[1], True),
              "segment-1 rays, mostly culled": take(seg0[2], False)}
    plain = {}
    for what, ins in slices.items():
        plain[what] = m3.traverse_plain(bvhs[4], *ins)
        plain_ms = events_ms(lambda: m3.traverse_plain(bvhs[4], *ins), 1)
        plain[what] = (plain[what], plain_ms)
        log(f"walk slice {what}: {int((ins[2] >= 0).sum())} live of "
            f"{ins[0].shape[0]}; plain version {plain_ms:.3f} ms {card}")
    for layout, (name, kernel, arity, replaces) in WALKS.items():
        pk = bvhs[arity]
        ms = plain_ms = err = 0.0
        bad_all = ties = lanes = 0
        ovf = torch.zeros(1, dtype=torch.int32, device=dev)
        for what, ins in slices.items():
            bad, tie, e = check_walk(layout, pk, ins, plain[what][0], torch)
            kt = events_ms(lambda: m3.walk_raw(layout, pk, *ins,
                                               overflow=ovf), 5)
            ms, plain_ms = ms + kt, plain_ms + plain[what][1]
            bad_all, ties, err = bad_all + bad, ties + tie, max(err, e)
            lanes += ins[0].shape[0]
            log(f"{name} on {what}: {bad} lanes off, {tie} lanes tie, max "
                f"abs err of t {e:.3g}; kernel {kt:.4f} ms {card}")
            if bad:
                failures.append(f"{name} on {what}: {bad} lanes disagree "
                                f"with the plain version")
        m3.check_overflow(ovf, name)
        nb, ops = walk_work(layout, pk, list(slices.values()))
        b, by = bound(nb, ops)
        rows[layout] = dict(
            name=name, route="cuda", source=TRAVERSE_SRC, replaces=replaces,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=None, lanes_checked=lanes,
            tied_lanes=ties, slice_bytes=nb, slice_ops=ops)
        log(f"{name}: {bad_all} of {lanes} lanes off, {ties} tied; slices "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b:.4f} ms "
            f"({by}: {nb} bytes, {ops:.6g} FP32 operations) {card}")

    # step-0 counters of each walk's launches in its composed frame
    for layout, (_, _, arity, _) in WALKS.items():
        for k, x in enumerate(frame_walks[layout]):
            log_walk_counts(f"composed frame {layout} launch {k} "
                            f"({'any-hit' if x[4] else 'nearest'}, "
                            f"{x[1].shape[0]} lanes)", layout, bvhs[arity],
                            x[1:])

    # ---- 9. the composed frames: main path of each walk
    for layout, (name, kernel, arity, _) in WALKS.items():
        fcfg = cfg.with_(kernel=kernel)
        for k in m3.launches:
            m3.launches[k] = 0
        img = render(scene, cam, fcfg, bvh=bvhs[arity])
        torch.cuda.synchronize()
        launched = dict(m3.launches)
        rows[layout]["launches"] = launched[layout]
        if launched[layout] == 0 or sum(launched.values()) != \
                launched[layout]:
            failures.append(f"{kernel} frame made launches {launched}")
        fin = bool(torch.isfinite(img).all())
        std = float(img.std())
        bad = int((~torch.isclose(img, fused_img, **TOL).all(-1)).sum())
        err = float((img - fused_img).abs().max())
        f_ms = events_ms(lambda: render_frame(scene, cam, fcfg,
                                              bvh=bvhs[arity]), 3)
        launches = frame_walks[layout]
        ovf = torch.zeros(1, dtype=torch.int32, device=dev)
        per = [events_ms(lambda: m3.walk_raw(layout, bvhs[arity], *x[1:],
                                             overflow=ovf), 3)
               for x in launches]
        m3.check_overflow(ovf, name)
        nb, ops = walk_work(layout, bvhs[arity], [x[1:] for x in launches])
        fb, fby = bound(nb, ops)
        rows[layout].update(frame_ms=sum(per), frame_bound_ms=fb,
                            frame_bound_by=fby, frame_bytes=nb,
                            frame_ops=ops, composed_frame_ms=f_ms)
        log(f"composed frame kernel={kernel} arity {arity}: {f_ms:.3f} ms, "
            f"{issued / f_ms * 1e3:.4g} issued rays/s; {launched[layout]} "
            f"{name} launches ({', '.join(f'{m:.3f}' for m in per)} ms "
            f"alone, lanes {[x[1].shape[0] for x in launches]}); bound "
            f"{fb:.4f} ms ({fby}: {nb} bytes, {ops:.6g} FP32 operations); "
            f"vs the fused frame: {bad} of "
            f"{img.shape[0] * img.shape[1]} pixels outside rtol=atol=5e-4, "
            f"max abs err {err:.3g}; std {std:.4f} {card}")
        if not fin or std <= 0.01:
            failures.append(f"{kernel} frame not finite or flat")
        if bad > MAX_BAD_FRACTION * img.shape[0] * img.shape[1]:
            failures.append(f"{kernel} frame differs from the fused frame "
                            f"on {bad} pixels")
        if layout == "mk4":
            profile_once(lambda: render_frame(scene, cam, fcfg, bvhs[4]),
                         "one composed frame (kernel='pallas')", f_ms, card)
    cfg_p = cfg.with_(kernel="pallas")
    _, (live, shadow) = trace_radiance_stats(scene, o, d, cfg_p,
                                             bvh=packed)
    live, shadow = live.tolist(), shadow.tolist()
    off = max(abs(a - b) / max(b, 1) for a, b in zip(live, fused_live))
    log(f"trace_radiance_stats: live nearest lanes per segment {live} "
        f"(fused frame: {fused_live}), live shadow lanes {shadow}; "
        f"{sum(live) + sum(shadow)} live rays of {issued} issued")
    if off > 1e-4:
        failures.append(f"live lanes {live} differ from the fused frame's "
                        f"{fused_live}")

    # ---- 10. bench.py's composed fwd+bwd unit against the replay's step
    params = get_params(scene, names)
    cfg_g = cfg_p.with_(remat=True)
    with torch.no_grad():
        target = trace_radiance(scene, o, d, cfg_g, bvh=packed) * 0.9
    vg = make_chunked_value_and_grad(scene, cfg_g, o, d, target, bvh=packed,
                                     chunk=1 << 18)
    for k in m3.launches:
        m3.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    loss, grads = vg(params)
    torch.cuda.synchronize()
    step_launches = m3.launches["mk4"]
    peak = torch.cuda.max_memory_allocated()
    _, recs = rp.trace_records(scene, o, d, cfg, packed)
    r_loss, r_grads = rp.replay_value_and_grad(
        scene, params, o, d, target, cfg, packed,
        live_segments=rp.live_depth(recs))
    ok_loss = abs(float(loss) - float(r_loss)) <= 1e-4 * abs(float(r_loss))
    notes = []
    for n_, g in grads.items():
        want = r_grads[n_]
        scale = float(want.abs().max())
        close = bool(torch.isclose(g, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(scale, 1e-12)).all())
        notes.append(f"{n_} max |g| {float(g.abs().max()):.4g} (replay "
                     f"{scale:.4g}), max abs diff "
                     f"{float((g - want).abs().max()):.3g}"
                     f"{'' if close else ' OUTSIDE'}")
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            failures.append(f"composed fwd+bwd grad {n_} not finite or "
                            f"all zero")
        if not close:
            failures.append(f"composed fwd+bwd grad {n_} differs from the "
                            f"replay's")
    if not ok_loss:
        failures.append(f"composed fwd+bwd loss {float(loss)} vs replay "
                        f"{float(r_loss)}")
    step_ms = events_ms(lambda: vg(params), 3)
    # the step's mk4 launches, each timed alone, and their bound
    step_walks = capture_walks(lambda: vg(params))
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    per = [events_ms(lambda: m3.walk_raw("mk4", packed, *x[1:],
                                         overflow=ovf), 3)
           for x in step_walks]
    m3.check_overflow(ovf, "traverse_packet4")
    snb, sops = walk_work("mk4", packed, [x[1:] for x in step_walks])
    sb, sby = bound(snb, sops)
    rows["mk4"].update(step_launch_ms=sum(per), step_bound_ms=sb,
                       step_launches=len(step_walks))
    log(f"composed fwd+bwd step's {len(step_walks)} traverse_packet4 "
        f"launches: {sum(per):.3f} ms alone (each "
        f"{', '.join(f'{m:.3f}' for m in per)} ms; lanes "
        f"{sorted(set(x[1].shape[0] for x in step_walks))}); bound "
        f"{sb:.4f} ms ({sby}: {snb} bytes, {sops:.6g} FP32 operations); "
        f"loss {sum(per) - sb:.3f} ms per step {card}")
    log(f"composed fwd+bwd (8 chunks of 2^18, remat, hard): loss "
        f"{float(loss):.6g} vs replay {float(r_loss):.6g}; "
        + "; ".join(notes)
        + f"; {step_launches} traverse_packet4 launches; step "
        f"{step_ms:.3f} ms = {issued / step_ms * 1e3:.4g} issued rays/s "
        f"fwd+bwd; peak memory {peak / 2**30:.3f} GiB {card}")
    profile_once(lambda: vg(params), "one composed fwd+bwd step", step_ms,
                 card)

    # ---- 11. the brute-force nearest triangle (no-BVH big meshes)
    rows["nearest"] = nearest_phase(dev, card, failures)
    small = dict(width=24, height=24)
    sc, cc, cs = get_preset("mesh10k", device="cpu", **small)
    cs = cs.with_(use_bvh=False, kernel="pallas")
    img_cpu = render(sc, cc, cs).numpy()
    imk.launches["nearest_triangle"] = 0
    img_card = render(sc.to(dev), cc.to(dev), cs)
    torch.cuda.synchronize()
    n_launch = imk.launches["nearest_triangle"]
    img_card = img_card.cpu().numpy()
    bad_px = int((~np.isclose(img_card, img_cpu, **TOL).all(-1)).sum())
    log(f"mesh10k 24x24 without a BVH (kernel='pallas'): {n_launch} "
        f"nearest_triangle launches; card vs CPU plain: {bad_px} of "
        f"{24 * 24} pixels outside rtol=atol=5e-4, max abs err "
        f"{float(np.abs(img_card - img_cpu).max()):.3g}")
    if bad_px > max(1, MAX_BAD_FRACTION * 24 * 24) or n_launch == 0:
        failures.append("no-BVH mesh10k frame: card disagrees with the CPU "
                        "or made no nearest_triangle launch")
    rows["nearest"]["launches"] = n_launch

    # ---- 12. the composed fits, card vs CPU: the CLI's default toy (whole
    # image) and a BVH preset (depth 1, chunked, remat: fit.py's chunked
    # branch, through the walks on the card and the plain walk on the CPU)
    for preset, size, steps in (("three_spheres", 48, 5), ("mesh10k", 32, 2)):
        fits = {}
        for where in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            fits[where.type] = run_fit(preset, size, size, steps, 0.02, 0,
                                       where, replay=False)[0]
            if where.type == "cuda":
                torch.cuda.synchronize()
            fits[where.type + "_s"] = time.perf_counter() - t0
        a, b = fits["cuda"], fits["cpu"]
        ok = np.allclose(a.losses, b.losses, rtol=1e-3) and all(
            np.allclose(a.params[n_].cpu().numpy(), b.params[n_].numpy(),
                        rtol=1e-3, atol=1e-6) for n_ in a.params)
        log(f"{preset} {size}x{size} composed fit, {steps} steps, card vs "
            f"CPU: losses {[float(x) for x in a.losses]} vs "
            f"{[float(x) for x in b.losses]}: "
            f"{'agree' if ok else 'DISAGREE'} at rtol 1e-3; card "
            f"{fits['cuda_s']:.3f} s, CPU {fits['cpu_s']:.3f} s in all "
            f"{card}")
        if not ok or not a.losses[-1] < a.losses[0]:
            failures.append(f"composed {preset} fit: card disagrees with "
                            f"the CPU or the loss did not fall")
    return [rows[k] for k in ("mk4", "wide4", "wide8", "mk3", "nearest")]


def capture_segments(fn):
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


def reset_mega_counts():
    from unity_raytracer_tpu_torch.ops.kernels import mega
    for k in mega.launches:
        mega.launches[k] = 0
    for k in mega.route_launches:
        mega.route_launches[k] = 0


def compare_fork(got, want, live, torch):
    """(bad lanes, live lanes, max abs err) between two fork outputs on the
    live input lanes: delta, each child's liveness and weight, and its
    origin and direction where the plain version's child is live."""
    close = lambda a, b: torch.isclose(a, b, **TOL).all(-1)
    # the largest |difference| over the lanes of a mask
    top = lambda a, b, m: float((a - b)[m].abs().max()) if bool(m.any()) \
        else 0.0
    bad = ~close(got[0], want[0])
    err = top(got[0], want[0], live)
    for base in (1, 5):
        alive = want[base + 3] >= 0
        bad |= ((got[base + 3] >= 0) != alive) | ~close(got[base + 2],
                                                          want[base + 2])
        err = max(err, top(got[base + 2], want[base + 2], live))
        for k in (0, 1):
            bad |= alive & ~close(got[base + k], want[base + k])
            err = max(err, top(got[base + k], want[base + k], alive & live))
    bad &= live
    for i in torch.nonzero(bad).squeeze(1)[:3].tolist():
        log(f"  fork lane {i}: " + "; ".join(
            f"{k} {g[i].tolist()} vs {w[i].tolist()}" for k, g, w in zip(
                ("delta", "ro", "rd", "w_refl", "tm_refl", "to", "td",
                 "w_refr", "tm_refr"), got, want)))
    return int(bad.sum()), int(live.sum()), float(err)


def segment_work(packed, aux, route_kw, segs, out_bytes, route):
    """(bytes, FP32 operations) of one launch per (depth, inputs) in
    ``segs`` on a route: 40 B of inputs and ``out_bytes`` of outputs per
    lane, the route's tables (node rows, leaf rows, leafmeta, leaf-group
    boxes) and the aux
    block once per launch with a live lane; operations from the route's
    counting instance (its tests x OPS_PER_TEST)."""
    import torch
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


def glass_mesh_scene(dev, width, height):
    """tests/torch_parity.small_scene plus cornell_box's glass sphere
    (ior 1.5, transparency 0.95), through its camera: a mesh + dielectric
    scene, whose fused tree walks the mesh in every level."""
    from unity_raytracer_tpu_torch.models import meshgen
    from unity_raytracer_tpu_torch.models.camera import Camera
    from unity_raytracer_tpu_torch.models.scene import (
        SceneBuilder, make_material as mm)
    from unity_raytracer_tpu_torch.utils.config import RenderConfig
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=2.0, center=(0, 2, 8))
    b.add_mesh(v, f, mm(diffuse=(0.7, 0.5, 0.2), ambient=(0.7, 0.5, 0.2),
                        specular=(0.6, 0.6, 0.6), phong=40.0))
    b.add_sphere((-3, 1.5, 6), 1.5, mm(
        diffuse=(0.1, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
        specular=(1, 1, 1), phong=200.0, mirror=(0.9, 0.9, 0.9),
        is_mirror=True))
    b.add_sphere((4.5, 3.0, 9.0), 3.0, mm(
        specular=(0.6, 0.6, 0.6), phong=300.0,
        transparency=(0.95, 0.95, 0.95), ior=1.5, is_dielectric=True))
    g = 30.0
    gmat = mm(diffuse=(0.5, 0.5, 0.55), ambient=(0.5, 0.5, 0.55), phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 8, 0), 800.0)
    b.add_point_light((-6, 7, 10), 500.0)
    b.set_ambient((8, 8, 8))
    cam = Camera.make(position=(0, 3, -4), forward=(0, -0.15, 1), dist=1.0,
                      half_h=0.8, half_v=0.8, width=width, height=height,
                      device=dev)
    cfg = RenderConfig(max_bounces=4, background=(0.04, 0.05, 0.07),
                       use_bvh=True, bvh_leaf=14, mode="tree", tree_cap=2)
    return b.build(device=dev), cam, cfg


def tree_bounds(a, b):
    """tests/test_tree_mega.py:29-33 on two [..., 3] radiance arrays on the
    0-255 scale: (99th percentile, max, lanes above TREE_MAX, lanes) of
    the per-lane max error, and whether they are within TREE_P99 and
    TREE_OVER_FRACTION."""
    import torch
    diff = (a - b).abs().amax(-1).flatten()
    p99 = float(torch.quantile(diff.float(), 0.99))
    over = int((diff > TREE_MAX).sum())
    ok = p99 < TREE_P99 and over <= TREE_OVER_FRACTION * diff.numel()
    return p99, float(diff.max()), over, diff.numel(), ok


def tree_phases(dev, card, failures):
    """Phases 13-15 (module docstring): the fork kernel against its plain
    version on the cornell_box tree (meshless) and on a mesh + glass tree
    (Baldwin–Weber BVH4, Möller–Trumbore BVH4 and binary), the 512x512
    cornell frames on both tree routes. Returns the kernels-line rows of
    the meshless and the mesh fork."""
    import torch
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.render import (
        render, render_frame, resolve_mode, trace_radiance,
        trace_radiance_tree_stats)

    rows = {}
    scene, cam, cfg = get_preset("cornell_box", device=dev)
    cfg = resolve_mode(scene, cfg)
    cfg_m = cfg.with_(kernel="mega")
    o, d = generate_rays_blocks(cam, cfg.block_size)
    aux = mega.build_aux(scene, cfg.background)
    kw = dict(n_lights=scene.lights.positions.shape[0],
              n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
              max_bounces=cfg.max_bounces, fork=True, has_mesh=False,
              tri_isect="mt")

    # ---- 13. the meshless fork against its plain version, every level
    levels = capture_segments(lambda: trace_radiance(scene, o, d, cfg_m))
    bad_all = lanes_all = 0
    err = k_ms = p_ms = 0.0
    level_ms = []
    for depth, ins in levels:
        got = mega.trace_segment(None, aux, depth, *ins, **kw)
        want = mega.trace_segment_plain(None, aux, depth, *ins, **kw)
        bad, lanes, e = compare_fork(got, want, ins[3] >= 0, torch)
        kt = events_ms(lambda: mega.trace_segment(None, aux, depth, *ins,
                                                  **kw), 3)
        pt = events_ms(lambda: mega.trace_segment_plain(None, aux, depth,
                                                        *ins, **kw), 1)
        level_ms.append(kt)
        bad_all, lanes_all, err = bad_all + bad, lanes_all + lanes, max(err, e)
        k_ms, p_ms = k_ms + kt, p_ms + pt
        log(f"cornell 512x512 fork level {depth}: {lanes} live of "
            f"{ins[0].shape[0]}, {bad} lanes outside rtol=atol=5e-4, max "
            f"abs err {e:.3g}; kernel {kt:.4f} ms, plain {pt:.4f} ms {card}")
    if bad_all > MAX_BAD_FRACTION * lanes_all:
        failures.append(f"meshless fork: {bad_all} of {lanes_all} live lanes "
                        f"disagree with the plain version")
    nb, ops = segment_work(None, aux, kw, levels, 92, "meshless")
    b, by = bound(nb, ops)
    log(f"meshless fork, {len(levels)} levels: {bad_all} of {lanes_all} "
        f"live lanes off, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{b:.4f} ms ({by}: {nb} bytes, {ops:.6g} FP32 operations) {card}")
    rows["meshless"] = dict(
        name="mega_segment/fork/meshless", mode="fork", route="cuda",
        source=KERNEL_SRC, replaces=REPLACES, max_abs_err=err, ms=k_ms,
        plain_ms=p_ms, bound_ms=b, bound_by=by, library_ms=None,
        level_ms=level_ms)

    # ---- 15. the 512x512 cornell frame on the fused and the composed tree
    reset_mega_counts()
    img_f = render(scene, cam, cfg_m)
    torch.cuda.synchronize()
    rows["meshless"]["launches"] = mega.route_launches["fork", "meshless"]
    if rows["meshless"]["launches"] != cfg.max_bounces + 1 or sum(
            mega.launches.values()) != cfg.max_bounces + 1:
        failures.append(f"fused cornell frame made {dict(mega.launches)} "
                        f"launches")
    img_c = render(scene, cam, cfg)
    torch.cuda.synchronize()
    p99, mx, over, n_px, within = tree_bounds(img_f * 255.0, img_c * 255.0)
    trunc = [int(trace_radiance_tree_stats(scene, o, d, c)[1])
             for c in (cfg_m, cfg)]
    fin = bool(torch.isfinite(img_f).all() and torch.isfinite(img_c).all())
    std = float(img_f.std())
    f_ms = events_ms(lambda: render_frame(scene, cam, cfg_m), 3)
    c_ms = events_ms(lambda: render_frame(scene, cam, cfg), 3)
    live = [int((ins[3] >= 0).sum()) for _, ins in levels]
    log(f"cornell 512x512 depth {cfg.max_bounces} tree: fused "
        f"{f_ms:.3f} ms ({rows['meshless']['launches']} fork launches, "
        f"{sum(level_ms):.3f} ms alone: "
        f"{', '.join(f'{m:.3f}' for m in level_ms)}), composed {c_ms:.3f} "
        f"ms; live lanes per level {live}; truncated lanes fused "
        f"{trunc[0]}, composed {trunc[1]}; fused vs composed p99 {p99:.4g}, "
        f"max {mx:.4g}, {over} of {n_px} pixels above {TREE_MAX} (0-255 "
        f"scale); std {std:.4f} {card}")
    if not fin or std <= 0.01 or not within or any(trunc):
        failures.append(f"cornell frame: finite {fin}, std {std}, p99 "
                        f"{p99}, max {mx}, {over} pixels above {TREE_MAX}, "
                        f"truncated {trunc}")
    rows["meshless"].update(frame_ms=f_ms, composed_frame_ms=c_ms,
                            live_lanes=live)
    profile_once(lambda: render_frame(scene, cam, cfg_m),
                 "one fused cornell frame", f_ms, card)
    profile_once(lambda: render_frame(scene, cam, cfg),
                 "one composed cornell frame", c_ms, card)

    # ---- 14. the fork with a mesh walk: a mesh + glass tree at 256x256
    ms, mc, mcfg = glass_mesh_scene(dev, 256, 256)
    mo, md = generate_rays_blocks(mc, mcfg.block_size)
    maux = mega.build_aux(ms, mcfg.background)
    ref = trace_radiance(ms, mo, md, mcfg.with_(kernel="pallas"),
                         bvh=bvhmod.prepare_bvh(ms, mcfg.with_(
                             kernel="pallas"), dev))
    for route, (isect, arity) in (("bw/wide4", ("bw", 4)),
                                  ("mt/wide4", ("mt", 4)),
                                  ("mt/binary", ("mt", 0))):
        c = mcfg.with_(kernel="mega", tri_isect=isect, bvh_arity=arity)
        pk = bvhmod.prepare_bvh(ms, c, dev)
        mkw = dict(n_lights=2, n_spheres=2, n_tris=2,
                   max_bounces=c.max_bounces, fork=True, tri_isect=isect,
                   use_wide=arity != 0)
        reset_mega_counts()
        mlevels = capture_segments(lambda: trace_radiance(ms, mo, md, c,
                                                          bvh=pk))
        n_launch = mega.route_launches["fork", route]
        bad_all = lanes_all = 0
        err = k_ms = p_ms = 0.0
        for depth, ins in mlevels:
            got = mega.trace_segment(pk, maux, depth, *ins, **mkw)
            want = mega.trace_segment_plain(pk, maux, depth, *ins, **mkw)
            bad, lanes, e = compare_fork(got, want, ins[3] >= 0, torch)
            bad_all, lanes_all, err = bad_all + bad, lanes_all + lanes, \
                max(err, e)
            k_ms += events_ms(lambda: mega.trace_segment(
                pk, maux, depth, *ins, **mkw), 3)
            p_ms += events_ms(lambda: mega.trace_segment_plain(
                pk, maux, depth, *ins, **mkw), 1)
        fused = trace_radiance(ms, mo, md, c, bvh=pk)
        p99, mx, over, _, within = tree_bounds(fused, ref)
        log(f"mesh + glass 256x256 tree, fork on {route}: {n_launch} "
            f"launches, {bad_all} of {lanes_all} live lanes off the plain "
            f"version, max abs err {err:.3g}; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms; frame vs the composed tree p99 {p99:.4g}, max "
            f"{mx:.4g}, {over} lanes above {TREE_MAX} {card}")
        if bad_all > MAX_BAD_FRACTION * lanes_all or n_launch == 0 \
                or not within:
            failures.append(f"mesh fork on {route}: {bad_all} lanes off, "
                            f"{n_launch} launches, p99 {p99}, max {mx}")
        if route == "bw/wide4":
            nb, ops = segment_work(pk, maux, mkw, mlevels, 92, route)
            b, by = bound(nb, ops)
            rows["mesh"] = dict(
                name="mega_segment/fork/bw/wide4", mode="fork", route="cuda",
                source=KERNEL_SRC, replaces=REPLACES, launches=n_launch,
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b,
                bound_by=by, library_ms=None)
            log(f"  bound {b:.4f} ms ({by}: {nb} bytes, {ops:.6g} FP32 "
                f"operations) [H100 SXM peaks]")
    return [rows["meshless"], rows["mesh"]]


def mode_e_phases(dev, card, failures, scene, cam, cfg, packed4, packed8,
                  slice_segs, fused_img, fused_ms):
    """Phase 16 (module docstring): the Möller–Trumbore instances on BVH4,
    BVH8 and the binary layout against the plain version on the flagship
    slices in the three modes, then the flagship fused frame on each,
    against the Baldwin–Weber frame. Returns their kernels-line rows."""
    import torch
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.render import render, render_frame

    packs = {"mt/wide4": (packed4, 4), "mt/wide8": (packed8, 8),
             "mt/binary": (bvhmod.prepare_bvh(scene, cfg.with_(bvh_arity=0),
                                              dev), 0)}
    aux = mega.build_aux(scene, cfg.background)
    kw = dict(n_lights=scene.lights.positions.shape[0],
              n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
              max_bounces=cfg.max_bounces, light_cull=cfg.light_cull,
              tri_isect="mt")
    mode_kw = {"forward": {}, "record": dict(record=True),
               "record_soft": dict(record_soft=True)}
    st = {r: dict(bad=0, lanes=0, err=0.0, ms={m: 0.0 for m in MODES})
          for r in packs}
    plain_ms = {m: 0.0 for m in MODES}
    for mode in MODES:
        for depth, sl in slice_segs:
            want = mega.trace_segment_plain(packed4, aux, depth, *sl,
                                            **mode_kw[mode], **kw)
            plain_ms[mode] += events_ms(lambda: mega.trace_segment_plain(
                packed4, aux, depth, *sl, **mode_kw[mode], **kw), 1)
            for route, (pk, _) in packs.items():
                got = mega.trace_segment(pk, aux, depth, *sl, **mode_kw[mode],
                                         **kw)
                bad, lanes, e = compare(got[:5], want[:5], torch)
                if mode != "forward":
                    rb, re_ = compare_records(got[5], want[5], torch)
                    bad, e = bad + rb, max(e, re_)
                s_ = st[route]
                s_["bad"] += bad
                s_["lanes"] += lanes
                s_["err"] = max(s_["err"], e)
                s_["ms"][mode] += events_ms(lambda: mega.trace_segment(
                    pk, aux, depth, *sl, **mode_kw[mode], **kw), 3)
    rows = []
    for route, (pk, arity) in packs.items():
        s_ = st[route]
        rkw = dict(kw, use_wide=arity != 0)
        nb, ops = segment_work(pk, aux, rkw, slice_segs, 52, route)
        b, by = bound(nb, ops)
        log(f"{route} vs plain on the flagship slices: {s_['bad']} of "
            f"{s_['lanes']} lanes off (forward, record, record_soft), max "
            f"abs err {s_['err']:.3g}; kernel "
            + ", ".join(f"{m} {v:.4f} ms" for m, v in s_["ms"].items())
            + f"; plain " + ", ".join(f"{m} {v:.3f} ms"
                                      for m, v in plain_ms.items())
            + f"; forward bound {b:.4f} ms ({by}: {nb} bytes, {ops:.6g} FP32 "
            f"operations) {card}")
        if s_["bad"] > MAX_BAD_FRACTION * s_["lanes"]:
            failures.append(f"{route}: {s_['bad']} of {s_['lanes']} slice "
                            f"lanes disagree with the plain version")
        # the flagship frame on this route: the main path of the row
        fcfg = cfg.with_(kernel="mega", tri_isect="mt", bvh_arity=arity)
        reset_mega_counts()
        img = render(scene, cam, fcfg, bvh=pk)
        torch.cuda.synchronize()
        n_launch = mega.route_launches["forward", route]
        segs = capture_segments(lambda: render(scene, cam, fcfg, bvh=pk))
        bad_px = int((~torch.isclose(img, fused_img, **TOL).all(-1)).sum())
        f_ms = events_ms(lambda: render_frame(scene, cam, fcfg, pk), 3)
        ovf = torch.zeros(1, dtype=torch.int32, device=dev)
        seg_ms = [events_ms(lambda: mega.trace_segment(
            pk, aux, depth, *ins, overflow=ovf, **rkw), 3)
            for depth, ins in segs]
        mega.check_overflow(ovf)
        fnb, fops = segment_work(pk, aux, rkw, segs, 52, route)
        fb, fby = bound(fnb, fops)
        log(f"mesh100k 1920x1080 fused frame on {route}: {n_launch} "
            f"launches, {f_ms:.3f} ms (the Baldwin-Weber frame "
            f"{fused_ms:.3f} ms); its launches alone "
            f"{', '.join(f'{m:.3f}' for m in seg_ms)} ms, bound "
            f"{fb:.4f} ms ({fby}); vs the Baldwin-Weber frame {bad_px} of "
            f"{img.shape[0] * img.shape[1]} pixels outside rtol=atol=5e-4, "
            f"max abs err {float((img - fused_img).abs().max()):.3g} {card}")
        if n_launch != cfg.max_bounces + 1 or not bool(
                torch.isfinite(img).all()) or bad_px > MAX_BAD_FRACTION * \
                img.shape[0] * img.shape[1]:
            failures.append(f"{route} flagship frame: {n_launch} launches, "
                            f"{bad_px} pixels off the Baldwin-Weber frame")
        rows.append(dict(
            name=f"mega_segment/forward/{route}", mode="forward",
            route="cuda", source=KERNEL_SRC, replaces=REPLACES,
            launches=n_launch, max_abs_err=s_["err"],
            ms=s_["ms"]["forward"], plain_ms=plain_ms["forward"],
            bound_ms=b, bound_by=by, library_ms=None,
            record_ms=s_["ms"]["record"],
            record_soft_ms=s_["ms"]["record_soft"], frame_ms=sum(seg_ms),
            frame_bound_ms=fb, frame_bound_by=fby, fused_frame_ms=f_ms))
    return rows


def parallel_phase(dev, card, failures, scene, cam, cfg, packed):
    """Phase 17: the multi-device layer at world size 1 on the card — a
    one-rank NCCL group opened in this process through a file store — on
    the flagship frame. Returns ``{kernel: {call: launches per call}}``
    for kernels #1, #3, #4 and #5."""
    import tempfile

    import torch

    from unity_raytracer_tpu_torch.fit import FitConfig, fit, get_params
    from unity_raytracer_tpu_torch.models.camera import (
        generate_rays, generate_rays_blocks)
    from unity_raytracer_tpu_torch.ops import intersect as isect
    from unity_raytracer_tpu_torch.ops.kernels import (
        intersect_mk, mega, traverse_mk3)
    from unity_raytracer_tpu_torch.ops.render import render
    from unity_raytracer_tpu_torch.parallel import bootstrap
    from unity_raytracer_tpu_torch.parallel import shard as shardmod
    from unity_raytracer_tpu_torch.parallel.mesh import make_mesh
    from unity_raytracer_tpu_torch.utils.config import DiffConfig
    from unity_raytracer_tpu_torch.utils.orchestrator import (
        render_tiled_orchestrated)
    from unity_raytracer_tpu_torch.utils.swizzle import padded_dims

    def counts():
        return {"mega_segment/forward": mega.launches["forward"],
                "nearest_triangle": intersect_mk.launches["nearest_triangle"],
                "traverse_packet4": traverse_mk3.launches["mk4"],
                "traverse_packet3": traverse_mk3.launches["mk3"]}

    def reset():
        reset_mega_counts()
        intersect_mk.launches["nearest_triangle"] = 0
        for k in traverse_mk3.launches:
            traverse_mk3.launches[k] = 0

    per_call = {k: {} for k in counts()}

    def counted(name, fn, kernel):
        """One call with the counts set to 0 just before it and read just
        after (it must launch ``kernel``), and its peak memory: returns
        its result."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        for k, n in got.items():
            if n:
                per_call[k][name] = n
        if not got[kernel]:
            failures.append(f"sharded {name}: no {kernel} launch")
        log(f"sharded {name}: launches per call " + ", ".join(
            f"{k} {n}" for k, n in got.items() if n) + ", peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB "
            f"{card}")
        return out

    def item(name, fn, kernel, profiled=False):
        out = counted(name, fn, kernel)
        ms = events_ms(fn, 3)
        log(f"sharded {name}: {ms:.3f} ms (CUDA events, 1 warm-up + 3) "
            f"{card}")
        if profiled:
            profile_once(fn, f"sharded {name}", ms, card)
        return out

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: loopback
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    bootstrap.maybe_initialize(f"file://{store}/store", 1, 0, device="cuda",
                               timeout_s=300)
    try:
        mesh = make_mesh(device="cuda")
        log(f"phase 17: one-rank NCCL group {bootstrap.world()}, mesh "
            f"{tuple(mesh.mesh.shape)} {card}")
        cfg_m = cfg.with_(kernel="mega")
        ref = render(scene, cam, cfg_m, bvh=packed)
        for name, fn in (("render_tiled", shardmod.render_tiled),
                         ("render_auto", shardmod.render_auto)):
            img = item(name, lambda fn=fn: fn(scene, cam, cfg_m, mesh,
                                              bvh=packed),
                       "mega_segment/forward")
            off = int((~torch.isclose(img, ref, rtol=1e-6, atol=1e-6))
                      .sum())
            log(f"sharded {name} vs render: {off} values outside rtol = "
                f"atol = 1e-6, max abs diff "
                f"{float((img - ref).abs().max()):.3g}")
            if off:
                failures.append(f"sharded {name} differs from render")
        chunk = 1 << 19
        img = item("render chunked 2^19",
                   lambda: render(scene, cam, cfg_m.with_(ray_chunk=chunk),
                                  bvh=packed), "mega_segment/forward",
                   profiled=True)
        n_lanes = math.prod(padded_dims(cam.width, cam.height,
                                        cfg.block_size))
        log(f"chunked frame: {-(-n_lanes // chunk)} chunks of {chunk} "
            f"lanes, {(-n_lanes) % chunk} filler lanes in the last; "
            f"bitwise equal to the unchunked frame: "
            f"{bool(torch.equal(img, ref))}")
        if not torch.equal(img, ref):
            failures.append("chunked fused frame differs from the "
                            "unchunked one")
        img, reports = item(
            "render_tiled_orchestrated 128 rows",
            lambda: render_tiled_orchestrated(scene, cam, cfg_m, bvh=packed,
                                              rows_per_tile=128),
            "mega_segment/forward", profiled=True)
        off = int((~torch.isclose(img, ref, rtol=1e-6, atol=1e-6)).sum())
        log(f"orchestrated: {len(reports)} bands, all ok "
            f"{all(r.ok for r in reports)}, {off} values outside 1e-6")
        if off or not all(r.ok for r in reports):
            failures.append("orchestrated frame differs from render")

        # the hits, on the frame's primary rays in two orders: the
        # frame's block order (``generate_rays_blocks``; a 256-ray block
        # of the nearest-triangle kernel is a 32x8 tile), which the shard
        # functions ask their callers for, and the twin's row-major order
        # (a block is a strip of one image row, which the kernel's cull
        # keeps far more triangles for). Each call against nearest_hit on
        # the same route (the nearest-triangle kernel without a BVH, the
        # threaded walk on the shard's packed rows), and each launch of
        # #3 and #5 that the call makes held on a run of whole 256-ray
        # blocks of its own inputs against the plain version
        sb = shardmod.build_shard_bvhs(scene, 1)
        tris = (scene.meshes.verts, scene.meshes.valid)
        orders = {"block order": generate_rays_blocks(cam, cfg.block_size),
                  "row-major": generate_rays(cam)}
        for order, (o, d) in orders.items():
            ref_k = isect.nearest_hit(scene, o, d, kernel="pallas")
            ref_w = isect.nearest_hit(scene, o, d, bvh=sb["packed"][0],
                                      kernel="pallas3")
            lo = (o.shape[0] // 2) // intersect_mk.BLOCK * intersect_mk.BLOCK
            hi = lo + PLAIN_LANES
            for name, fn, want, kernel in (
                    ("scene_sharded_hit",
                     lambda: shardmod.scene_sharded_hit(scene, o, d, mesh),
                     ref_k, "nearest_triangle"),
                    ("scene_sharded_hit_bvh",
                     lambda: shardmod.scene_sharded_hit_bvh(scene, o, d,
                                                            mesh, sb),
                     ref_w, "traverse_packet3"),
                    ("nearest_hit_ring",
                     lambda: shardmod.nearest_hit_ring(scene, o, d, mesh),
                     ref_k, "nearest_triangle")):
                label = f"{name} ({order})"
                h = item(label, fn, kernel)
                same_t = h.t == want.t
                tied = same_t & (h.index != want.index)
                bad = ~same_t | (h.kind != want.kind) | (
                    (h.index != want.index) & ~tied) | (
                    (h.mesh_index != want.mesh_index) & ~tied)
                log(f"{label} vs nearest_hit on its route: "
                    f"{int(bad.sum())} of {o.shape[0]} lanes differ, "
                    f"{int(tied.sum())} tied lanes (equal t, another "
                    f"triangle), {int((h.kind == isect.KIND_MESH).sum())} "
                    f"mesh hits")
                if bool(bad.any()):
                    failures.append(f"{label} differs from nearest_hit")
                launches = capture_launches(fn)
                if not launches:
                    failures.append(f"{label}: no launch of #3 or #5")
                for k, launch in enumerate(launches):
                    off, hits, ties = check_launch_lanes(launch, lo, hi,
                                                         torch)
                    rays = launch[1][0 if launch[0] == "nearest" else 2]
                    log(f"{label} launch {k} ({launch[0]}, "
                        f"{rays.shape[0]} lanes x {scene.meshes.count} "
                        f"triangles): lanes "
                        f"[{lo}, {hi}) against the plain version: {off} "
                        f"off, {ties} tied, {hits} hits")
                    if off or not hits:
                        failures.append(f"{label} launch {k}: {off} lanes "
                                        f"off the plain version, {hits} "
                                        f"hits")
            # the brute-force fold alone on these rays
            k_ms = events_ms(lambda: intersect_mk.nearest_triangle_pallas(
                o, d, *tris), 3)
            kept = intersect_mk.nearest_triangle_survivors(o, d,
                                                           *tris)[2].float()
            log(f"nearest-triangle kernel alone, {o.shape[0]} primary rays "
                f"{order}: {k_ms:.3f} ms, triangles kept per block of "
                f"{intersect_mk.BLOCK} rays mean {float(kept.mean()):.1f}, "
                f"max {int(kept.max())} of {scene.meshes.count} {card}")

        # three sharded train steps at depth 1 on 'pallas' (the ordered
        # binary walk), against fit's single-process composed step
        names = ("sphere_centers", "sphere_diffuse")
        fcfg = FitConfig(param_names=names, learning_rate=0.02, steps=1,
                         soft_shadow_temp=1.0, soft_hit_temp=0.1,
                         log_every=0)
        cfg_t = cfg.with_(max_bounces=1, kernel="pallas", ray_chunk=1 << 18,
                          remat=True)
        target = render(scene, cam, cfg_t, bvh=packed)
        true_p = get_params(scene, names)
        gen = torch.Generator(device="cpu").manual_seed(0)
        noise = lambda lo, hi: (lo + (hi - lo) * torch.rand(
            true_p["sphere_centers"].shape, generator=gen)).to(dev)
        start = {"sphere_centers": true_p["sphere_centers"]
                 + noise(-0.4, 0.4),
                 "sphere_diffuse": torch.clamp(
                     true_p["sphere_diffuse"] + noise(-0.2, 0.2), 0, 1)}
        single = fit(scene, cam, cfg_t, target, fcfg, init_params=start,
                     bvh=packed)
        step = shardmod.make_sharded_train_step(
            scene, cam, cfg_t.with_(diff=DiffConfig(
                soft_shadow_temp=1.0, soft_hit_temp=0.1,
                straight_through=True)), target.reshape(-1, 3), mesh, names,
            lambda ps: torch.optim.Adam(ps, lr=fcfg.learning_rate),
            bvh=packed)
        o, d = orders["row-major"]  # the target's pixel order
        tgt = target.reshape(-1, 3)
        state = {"p": start, "opt": None}

        def one_step():
            state["p"], state["opt"], loss = step(state["p"], state["opt"],
                                                  o, d, tgt)
            return loss

        losses = [float(counted("make_sharded_train_step", one_step,
                                "traverse_packet4"))]
        p1 = state["p"]
        for _ in range(2):
            losses.append(float(one_step()))
        ok1 = np.isclose(losses[0], single.losses[0], rtol=1e-4) and all(
            bool(torch.allclose(p1[k], single.params[k], rtol=1e-4,
                                atol=1e-5)) for k in names)
        log(f"sharded train steps: losses {losses} (falls: "
            f"{losses[-1] < losses[0]}); step 1 vs fit's single-process "
            f"step: loss {float(single.losses[0])!r}, params max abs diff "
            + ", ".join(f"{k} {float((p1[k] - single.params[k]).abs().max()):.3g}"
                        for k in names) + f": {'agree' if ok1 else 'DISAGREE'}")
        if not ok1 or not losses[-1] < losses[0]:
            failures.append("sharded train step disagrees with fit or its "
                            "loss does not fall")
        log(f"sharded make_sharded_train_step: "
            f"{events_ms(one_step, 3):.3f} ms (CUDA events, 1 warm-up + 3) "
            f"{card}")
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return per_call


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from unity_raytracer_tpu_torch.__main__ import run_fit
    from unity_raytracer_tpu_torch.fit import get_params
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops import replay as rp
    from unity_raytracer_tpu_torch.ops.kernels import _lib, mega
    from unity_raytracer_tpu_torch.ops.render import (
        check_supported, render, render_frame, resolve_mode, trace_radiance)
    from unity_raytracer_tpu_torch.utils.config import DiffConfig

    dev = torch.device("cuda:0")
    smi = nvidia_smi("name,power.limit")
    card = f"[{smi}]"
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- build --------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _lib.build_all()   # one compiler process per library, together
    build_s = time.perf_counter() - t0
    mega_log = "".join(libs[f"mega_{g}"].build["log"]
                       for g in _lib.MEGA_GROUPS)
    log(f"build: {build_s:.3f} s wall, all at once ("
        + ", ".join(f"{k} {v.build['seconds']:.3f} s"
                    for k, v in libs.items()) + f") {card}")
    from unity_raytracer_tpu_torch.ops.kernels.ptxas import entries
    for name in ("traverse", "nearest_tri"):
        for entry, v in sorted(entries(libs[name].build["log"]).items()):
            m = re.search(r"(?:traverse|coop)_kernelILi(\d)ELb(\d)ELb(\d)E",
                          entry)
            nt = re.search(r"nearest_tri_kernelILb(\d)ELb(\d)E", entry)
            what = (f"{('mk3', 'mk4', 'wide4', 'wide8')[int(m.group(1))]} "
                    f"{'any-hit' if m.group(2) == '1' else 'nearest'}"
                    f"{' counting' if m.group(3) == '1' else ''}"
                    if m else
                    f"{name}{' counting' if nt.group(1) == '1' else ''} "
                    f"{'split' if nt.group(2) == '1' else 'whole'}"
                    if nt else f"{name} prep" if "prep" in entry else
                    f"{name} finalize" if "finalize" in entry else name)
            log(f"  ptxas: {what}: {v.get('registers')} registers, "
                f"{v.get('stack')} bytes stack, {v.get('spill')} bytes "
                f"spill")
    ptx = ptxas_table(mega_log)
    layouts = {0: "meshless", 1: "binary", 4: "wide4", 8: "wide8"}
    for (layout, isect, mode, counting), v in sorted(ptx.items()):
        log(f"  ptxas: {isect}/{layouts[layout]} {mode}"
            f"{' counting' if counting else ''}: {v.get('registers')} "
            f"registers, {v.get('stack')} bytes stack, {v.get('spill')} "
            f"bytes spill")
    fwd = {a: ptx.get((a, "bw", "forward", False), {}) for a in FORWARD_PTXAS}
    ptxas_worse = bool(mega_log) and any(
        fwd[a].get(k, 1 << 30) > v for a, line in FORWARD_PTXAS.items()
        for k, v in line.items())

    def segment_kw(scene, cfg):
        return dict(n_lights=scene.lights.positions.shape[0],
                    n_spheres=scene.spheres.count,
                    n_tris=scene.triangles.count,
                    max_bounces=cfg.max_bounces, light_cull=cfg.light_cull)

    def chain_inputs(scene, cam, cfg, packed, aux):
        """Per-segment kernel inputs of the bounce chain, on the card."""
        o, d = generate_rays_blocks(cam, cfg.block_size)
        n = o.shape[0]
        thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
        tmax = torch.full((n,), 3.0e38, dtype=torch.float32, device=dev)
        segs = []
        for depth in range(cfg.max_bounces + 1):
            segs.append((o, d, thr, tmax))
            _, o, d, thr, tmax = mega.trace_segment(
                packed, aux, depth, o, d, thr, tmax,
                **segment_kw(scene, cfg))
        return segs

    mode_kw = {"forward": {}, "record": dict(record=True),
               "record_soft": dict(record_soft=True)}

    def work(packed, aux, kw, segs):
        """(bytes, operations) one launch per segment in ``segs`` must
        move and compute, per mode (record's walk is forward's): inputs
        read once and outputs written once, the BVH arrays and the aux
        block read once per launch that has a live lane (a launch whose
        lanes are all dead reads none of them); operations from the
        counting instance."""
        tables = sum(t.numel() * 4 for t in (packed.wide, packed.tris_bw,
                                             packed.leafmeta, packed.leafbox,
                                             aux))
        lanes = sum(ins[0].shape[0] for _, ins in segs)
        live_launches = sum(bool((ins[3] >= 0).any()) for _, ins in segs)
        ops = {}
        for counted in ("forward", "record_soft"):
            counts = torch.zeros(len(mega.COUNTS), dtype=torch.int64,
                                 device=dev)
            for depth, ins in segs:
                mega.trace_segment(packed, aux, depth, *ins, counts=counts,
                                   **mode_kw[counted], **kw)
            ops[counted] = sum(n * k for n, k in zip(counts.tolist(),
                                                     OPS_PER_TEST))
        rec_bytes = {"forward": 0, "record": 24,
                     "record_soft": 24 + 4 * kw["n_lights"]}
        return {mode: (lanes * (40 + 52 + rec_bytes[mode])
                       + tables * live_launches,
                       ops["record_soft" if mode == "record_soft"
                           else "forward"]) for mode in MODES}

    stats = {m: dict(max_err=0.0, bad=0, lanes=0, ms=0.0, plain_ms=0.0)
             for m in MODES}
    failures = []  # checks that failed; raised after every phase has run
    if ptxas_worse:
        failures.append(f"forward instances need more than their own "
                        f"build's {FORWARD_PTXAS}: {fwd}")

    def check_modes(packed, aux, depth, ins, kw, name, plain_soft=None,
                    timed=False):
        """Kernel vs plain in modes (b) and (d) on one segment's inputs,
        and their base outputs against mode (a)'s, bitwise."""
        fwd = mega.trace_segment(packed, aux, depth, *ins, **kw)
        for mode in ("record", "record_soft"):
            got = mega.trace_segment(packed, aux, depth, *ins,
                                     **mode_kw[mode], **kw)
            want = plain_soft
            if want is None or timed:
                want = mega.trace_segment_plain(packed, aux, depth, *ins,
                                                **mode_kw[mode], **kw)
            bad, lanes, err = compare(got[:5], want[:5], torch)
            rbad = compare_records(got[5], want[5][:len(got[5])], torch)
            same = all(torch.equal(a, b) for a, b in zip(got[:5], fwd))
            st = stats[mode]
            st["max_err"] = max(st["max_err"], err, rbad[1])
            st["bad"] += int(bad + rbad[0])
            st["lanes"] += lanes
            note = ""
            if timed:
                kt = events_ms(lambda: mega.trace_segment(
                    packed, aux, depth, *ins, **mode_kw[mode], **kw), 5)
                pt = events_ms(lambda: mega.trace_segment_plain(
                    packed, aux, depth, *ins, **mode_kw[mode], **kw), 1)
                st["ms"] += kt
                st["plain_ms"] += pt
                note = f"; kernel {kt:.4f} ms, plain {pt:.4f} ms {card}"
            log(f"{name} {mode}: {bad} lanes outside rtol=atol=5e-4, "
                f"{rbad[0]} record lanes off, max abs err "
                f"{max(err, rbad[1]):.3g}, base outputs "
                f"{'equal' if same else 'DIFFER from'} mode (a){note}")
            if bad + rbad[0] > MAX_BAD_FRACTION * lanes:
                failures.append(f"{name} {mode}: {bad + rbad[0]} of {lanes} "
                                f"lanes disagree")
            if not same:
                failures.append(f"{name} {mode}: base outputs differ from "
                                f"the forward mode's")

    max_err, bad_total, lanes_total = 0.0, 0, 0

    # ---- kernel vs plain: mesh10k 256x256, every segment --------------------
    scene, cam, cfg = get_preset("mesh10k", width=256, height=256, device=dev)
    cfg = resolve_mode(scene, cfg)
    packed = bvhmod.prepare_bvh(scene, cfg, dev)
    aux = mega.build_aux(scene, cfg.background)
    kw = segment_kw(scene, cfg)
    for depth, ins in enumerate(chain_inputs(scene, cam, cfg, packed, aux)):
        got = mega.trace_segment(packed, aux, depth, *ins, **kw)
        want = mega.trace_segment_plain(packed, aux, depth, *ins, **kw)
        bad, lanes, err = compare(got, want, torch)
        live = int((ins[3] >= 0).sum())
        log(f"mesh10k 256x256 segment {depth}: {live} live of {lanes}, "
            f"{bad} lanes outside rtol=atol=5e-4, max abs err {err:.3g}")
        max_err, bad_total = max(max_err, err), bad_total + bad
        lanes_total += lanes
        if bad > MAX_BAD_FRACTION * lanes:
            failures.append(f"mesh10k segment {depth}: {bad} of {lanes} "
                            f"lanes disagree")
        # modes (b) and (d) against one plain record_soft run, whose base
        # outputs and first four records are mode (b)'s too
        plain_soft = mega.trace_segment_plain(packed, aux, depth, *ins,
                                              record_soft=True, **kw)
        check_modes(packed, aux, depth, ins, kw,
                    f"mesh10k 256x256 segment {depth}", plain_soft)

    # ---- flagship: BVH prepare, then kernel vs plain on ray slices ----------
    scene, cam, cfg = get_preset("mesh100k", device=dev)
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = bvhmod.prepare_bvh(scene, cfg, dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    log(f"mesh100k BVH prepare: {prep_s:.3f} s ({packed.wide.shape[0]} wide "
        f"rows, {packed.tris_bw.shape[0]} BW rows) {card}")
    aux = mega.build_aux(scene, cfg.background)
    kw = segment_kw(scene, cfg)
    k_ms = p_ms = 0.0
    frame_segs, slice_segs = [], []
    for depth, ins in enumerate(chain_inputs(scene, cam, cfg, packed, aux)):
        frame_segs.append((depth, ins))
        live_idx = torch.nonzero(ins[3] >= 0).squeeze(1)
        if live_idx.numel() >= SLICE:
            pick = live_idx[torch.linspace(0, live_idx.numel() - 1, SLICE,
                                           device=dev).long()]
        else:  # every live lane, topped up with dead ones
            dead_idx = torch.nonzero(ins[3] < 0).squeeze(1)
            pick = torch.cat([live_idx, dead_idx[:SLICE - live_idx.numel()]])
        sl = [x[pick].contiguous() for x in ins]
        slice_segs.append((depth, sl))
        got = mega.trace_segment(packed, aux, depth, *sl, **kw)
        want = mega.trace_segment_plain(packed, aux, depth, *sl, **kw)
        bad, lanes, err = compare(got, want, torch)
        kt = events_ms(lambda: mega.trace_segment(
            packed, aux, depth, *sl, **kw), 5)
        pt = events_ms(lambda: mega.trace_segment_plain(
            packed, aux, depth, *sl, **kw), 1)
        k_ms, p_ms = k_ms + kt, p_ms + pt
        log(f"mesh100k segment {depth} slice: {int((sl[3] >= 0).sum())} "
            f"live of {lanes}, {bad} lanes outside rtol=atol=5e-4, max abs "
            f"err {err:.3g}; kernel {kt:.4f} ms, plain {pt:.4f} ms {card}")
        max_err, bad_total = max(max_err, err), bad_total + bad
        lanes_total += lanes
        if bad > MAX_BAD_FRACTION * lanes:
            failures.append(f"mesh100k segment {depth}: {bad} of {lanes} "
                            f"lanes disagree")
        check_modes(packed, aux, depth, sl, kw,
                    f"mesh100k segment {depth} slice", timed=True)
    log(f"kernel vs plain: {bad_total} of {lanes_total} lanes outside "
        f"tolerance, max abs err {max_err:.6g}")
    for mode in ("record", "record_soft"):
        st = stats[mode]
        log(f"kernel vs plain, mode {mode}: {st['bad']} of {st['lanes']} "
            f"lanes off, max abs err {st['max_err']:.6g}; slices: kernel "
            f"{st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms {card}")
    stats["forward"].update(max_err=max_err, bad=bad_total,
                            lanes=lanes_total, ms=k_ms, plain_ms=p_ms)
    slice_work = work(packed, aux, kw, slice_segs)
    frame_work = work(packed, aux, kw, frame_segs)
    for mode in MODES:
        for what, wk in (("slices", slice_work), ("frame", frame_work)):
            nb, ops = wk[mode]
            b, by = bound(nb, ops)
            log(f"bound {mode} {what}: {nb} bytes, {ops:.6g} FP32 "
                f"operations -> {b:.4f} ms ({by}) [H100 SXM peaks]")

    # step-0 counters: the flagship frame's segments 0 and 1
    for depth in (0, 1):
        for mode in ("forward", "record_soft"):
            log_segment_counts(f"mesh100k segment {depth} {mode}", packed,
                               aux, depth, frame_segs[depth][1],
                               dict(kw, **mode_kw[mode]))

    # ---- the fused path: the flagship frame on the fused kernel --------------
    cfg_m = cfg.with_(kernel="mega")
    for m in mega.launches:
        mega.launches[m] = 0
    img = render(scene, cam, cfg_m, bvh=packed)
    torch.cuda.synchronize()
    launches = dict(mega.launches)
    n_segments = cfg.max_bounces + 1
    if launches["forward"] != n_segments or sum(launches.values()) \
            != n_segments:
        raise AssertionError(f"frame made {launches} kernel launches, "
                             f"expected {n_segments} forward")
    if tuple(img.shape) != (cam.height, cam.width, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("image has non-finite values")
    std = float(img.std())
    if std <= 0.01:
        raise AssertionError(f"image std {std} <= 0.01: nothing rendered")
    log(f"mesh100k {cam.width}x{cam.height} depth {cfg.max_bounces}: "
        f"{launches['forward']} launches, stack overflow 0, image std "
        f"{std:.4f}, mean {float(img.mean()):.4f}")

    fused_img = img
    frame_ms = events_ms(lambda: render_frame(scene, cam, cfg_m, packed), 3)
    # the five launches of one frame alone, in each mode, on one shared
    # overflow counter (no host sync between the timed launches)
    seg_ms = {m: [] for m in MODES}
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    for depth, ins in frame_segs:
        for mode in MODES:
            seg_ms[mode].append(events_ms(lambda: mega.trace_segment(
                packed, aux, depth, *ins, overflow=ovf, **mode_kw[mode],
                **kw), 3))
    mega.check_overflow(ovf)
    n_lights = int(scene.lights.valid.sum())
    issued = cam.width * cam.height * n_segments * (1 + n_lights)
    log(f"mesh100k frame: {frame_ms:.3f} ms, {issued / frame_ms * 1e3:.4g} "
        f"issued rays/s ({issued} = pixels x {n_segments} segments x "
        f"(1 + {n_lights} lights)) {card}")
    log("mesh100k frame live lanes per segment: " + ", ".join(
        str(int((ins[3] >= 0).sum())) for _, ins in frame_segs)
        + f" of {frame_segs[0][1][0].shape[0]}")
    for mode in MODES:
        nb, ops = frame_work[mode]
        b, by = bound(nb, ops)
        log(f"fused kernel per frame, mode {mode}: {sum(seg_ms[mode]):.3f} "
            f"ms (segments {', '.join(f'{m:.3f}' for m in seg_ms[mode])} "
            f"ms); bound {b:.4f} ms ({by}) {card}")
    dead = [k for k, (_, ins) in enumerate(frame_segs)
            if not bool((ins[3] >= 0).any())]
    n_lanes = frame_segs[0][1][0].shape[0]
    db, _ = bound(n_lanes * (40 + 52), 0)
    log(f"all-dead segments {dead} of the fused frame: forward "
        + ", ".join(f"{seg_ms['forward'][k]:.4f}" for k in dead)
        + f" ms alone; bound {db:.4f} ms each (bytes: {n_lanes} lanes x 92 "
        f"B in and out) {card}")
    profile_once(lambda: render_frame(scene, cam, cfg_m, packed),
                 "one fused frame", frame_ms, card)
    log(f"clocks/power after timing: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # ---- small frame: card vs the plain version on the CPU ------------------
    s_cpu, c_cpu, cfg_s = get_preset("mesh10k", width=64, height=64,
                                     device="cpu")
    cfg_s = cfg_s.with_(kernel="mega")
    img_cpu = render(s_cpu, c_cpu, cfg_s).numpy()
    img_card = render(s_cpu.to(dev), c_cpu.to(dev), cfg_s).cpu().numpy()
    bad_px = int((~np.isclose(img_card, img_cpu, **TOL).all(-1)).sum())
    log(f"mesh10k 64x64 card vs CPU plain: {bad_px} of {64 * 64} pixels "
        f"outside rtol=atol=5e-4, max abs err "
        f"{float(np.abs(img_card - img_cpu).max()):.3g}")
    if bad_px > max(1, MAX_BAD_FRACTION * 64 * 64):
        failures.append("card image disagrees with the CPU image")

    # ---- flagship fwd+bwd: hard, then soft ----------------------------------
    names = ("sphere_centers", "sphere_diffuse", "light_intensities")
    params = get_params(scene, names)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    fwd_rad = trace_radiance(scene, o, d, cfg_m, bvh=packed)
    soft_cfg = cfg.with_(diff=DiffConfig(soft_shadow_temp=1.0,
                                         soft_hit_temp=0.1,
                                         straight_through=True))
    chunk = 1 << 18
    steps = {
        "hard": dict(cfg=cfg, soft=False, vg=lambda tgt, k: (
            rp.replay_value_and_grad(scene, params, o, d, tgt, cfg, packed,
                                     live_segments=k))),
        "soft": dict(cfg=soft_cfg, soft=True, vg=lambda tgt, k: (
            rp.soft_replay_value_and_grad(scene, params, o, d, tgt,
                                          soft_cfg, packed, live_segments=k,
                                          chunk=chunk)))}
    path_launches = {}
    for kind, sp in steps.items():
        _, recs = rp.trace_records(scene, o, d, sp["cfg"], packed,
                                   soft=sp["soft"])
        k = rp.live_depth(recs)
        with torch.no_grad():
            rad = (rp.trace_radiance_replay_soft(scene, o, d, soft_cfg,
                                                 packed, chunk=chunk)
                   if sp["soft"] else
                   rp.replay_radiance(scene, o, d, recs, cfg))
        bad = int((~torch.isclose(rad, fwd_rad, **RAD_TOL).all(-1)).sum())
        err = float((rad - fwd_rad).abs().max())
        log(f"mesh100k {kind} replay radiance vs forward render: {bad} of "
            f"{o.shape[0]} lanes outside rtol=atol=2e-4, max abs err "
            f"{err:.3g}; live segments {k}")
        if bad > MAX_BAD_FRACTION * o.shape[0]:
            failures.append(f"{kind} replay radiance disagrees with the "
                            f"forward render on {bad} lanes")
        target = rad * 0.9
        # the main path: one fwd+bwd step, counts read just after
        for m in mega.launches:
            mega.launches[m] = 0
        torch.cuda.reset_peak_memory_stats()
        loss, grads = sp["vg"](target, k)
        torch.cuda.synchronize()
        path_launches[kind] = dict(mega.launches)
        peak = torch.cuda.max_memory_allocated()
        mode = "record_soft" if sp["soft"] else "record"
        if path_launches[kind][mode] != n_segments:
            failures.append(f"{kind} fwd+bwd made {path_launches[kind]} "
                            f"launches, expected {n_segments} {mode}")
        if not bool(torch.isfinite(loss)):
            failures.append(f"{kind} fwd+bwd loss {float(loss)}")
        for n_, g in grads.items():
            if not bool(torch.isfinite(g).all()) or not bool(
                    (g != 0).any()):
                failures.append(f"{kind} fwd+bwd grad {n_} not finite or "
                                f"all zero")
        step_ms = events_ms(lambda: sp["vg"](target, k), 3)
        rec_ms = events_ms(lambda: rp.trace_records(
            scene, o, d, sp["cfg"], packed, soft=sp["soft"]), 3)
        log(f"mesh100k {kind} fwd+bwd: loss {float(loss):.6g}, "
            f"{path_launches[kind][mode]} {mode} launches, grad max |g| "
            + ", ".join(f"{n_} {float(g.abs().max()):.4g}"
                        for n_, g in grads.items())
            + f"; step {step_ms:.3f} ms = {issued / step_ms * 1e3:.4g} "
            f"issued rays/s fwd+bwd; records pass {rec_ms:.3f} ms, replay "
            f"fwd+bwd ~{step_ms - rec_ms:.3f} ms (step minus records); "
            f"peak memory {peak / 2**30:.3f} GiB {card}")
        profile_once(lambda: sp["vg"](target, k),
                     f"one {kind} fwd+bwd step", step_ms, card)
        if not sp["soft"]:
            # the replay fwd+bwd alone, on fixed records
            leaves = {n_: v.detach().clone().requires_grad_(True)
                      for n_, v in params.items()}
            from unity_raytracer_tpu_torch.fit import set_params

            def replay_only():
                r = rp.replay_radiance(set_params(scene, leaves), o, d,
                                       recs, cfg, live_segments=k)
                ((r - target) ** 2).mean().backward()
            log(f"mesh100k hard replay fwd+bwd alone: "
                f"{events_ms(replay_only, 3):.3f} ms {card}")

    # ---- fit --replay: the flagship, then mesh10k card vs CPU ---------------
    for m in mega.launches:
        mega.launches[m] = 0
    times = {}
    for n_steps in (1, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, _, _ = run_fit("mesh100k", 1920, 1080, n_steps, 0.02, 0, dev)
        torch.cuda.synchronize()
        times[n_steps] = time.perf_counter() - t0
        if len(res.losses) != n_steps or not np.isfinite(res.losses).all():
            failures.append(f"mesh100k fit losses {res.losses}")
    fit_launches = dict(mega.launches)
    log(f"mesh100k 1920x1080 fit --replay 3 steps: losses "
        f"{[float(x) for x in res.losses]}, {fit_launches} launches over "
        f"both fits; {times[3]:.3f} s in all, step "
        f"{(times[3] - times[1]) / 2 * 1e3:.3f} ms (3-step minus 1-step "
        f"fit, /2) {card}")
    if fit_launches["record_soft"] == 0:
        failures.append("fit made no record_soft launch")
    fits = {}
    for where in (dev, torch.device("cpu")):
        fits[where.type] = run_fit("mesh10k", 64, 64, 5, 0.02, 0, where)[0]
    a, b = fits["cuda"], fits["cpu"]
    ok = np.allclose(a.losses, b.losses, rtol=1e-3) and all(
        np.allclose(a.params[n_].cpu().numpy(), b.params[n_].numpy(),
                    rtol=1e-3, atol=1e-6) for n_ in a.params)
    diff = {n_: float((a.params[n_].cpu() - b.params[n_]).abs().max())
            for n_ in a.params}
    log(f"mesh10k 64x64 fit 5 steps card vs CPU: losses "
        f"{[float(x) for x in a.losses]} vs {[float(x) for x in b.losses]}, "
        f"loss_ratio {a.losses[-1] / a.losses[0]:.4f} vs "
        f"{b.losses[-1] / b.losses[0]:.4f}, params max abs diff "
        + ", ".join(f"{n_} {v:.3g}" for n_, v in diff.items())
        + f": {'agree' if ok else 'DISAGREE'} at rtol 1e-3")
    if not ok:
        failures.append("mesh10k fit on the card disagrees with the CPU")
    # one hard fwd+bwd, card vs CPU
    out = []
    for where in ("cpu", dev):
        s, c = s_cpu.to(where), c_cpu.to(where)
        pk = bvhmod.prepare_bvh(s, cfg_s)
        o_, d_ = generate_rays_blocks(c, cfg_s.block_size)
        tgt = rp.trace_radiance_replay(s, o_, d_, cfg_s, pk) * 0.9
        p_ = {n_: v * 1.01 for n_, v in get_params(s, names).items()}
        loss, g = rp.replay_value_and_grad(s, p_, o_, d_, tgt, cfg_s, pk)
        out.append((float(loss), {n_: v.cpu() for n_, v in g.items()}))
    (l_cpu, g_cpu), (l_card, g_card) = out
    ok = np.isclose(l_card, l_cpu, rtol=1e-4) and all(
        np.allclose(g_card[n_], g_cpu[n_], rtol=5e-3,
                    atol=5e-4 * max(float(g_cpu[n_].abs().max()), 1e-6))
        for n_ in names)
    log(f"mesh10k 64x64 fwd+bwd card vs CPU: loss {l_card:.6g} vs "
        f"{l_cpu:.6g}, grads "
        + ", ".join(f"{n_} max abs diff "
                    f"{float((g_card[n_] - g_cpu[n_]).abs().max()):.3g}"
                    for n_ in names)
        + f": {'agree' if ok else 'DISAGREE'}")
    if not ok:
        failures.append("mesh10k fwd+bwd on the card disagrees with the CPU")
    # ---- the composed path: phases 8-12 --------------------------------------
    fused_live = [int((ins[3] >= 0).sum()) for _, ins in frame_segs]
    packed8 = bvhmod.prepare_bvh(scene, cfg.with_(bvh_arity=8), dev)
    walk_rows = composed_phases(dev, card, failures, scene, cam, cfg, packed,
                                packed8, fused_img, fused_live, issued, names)
    # ---- the tree and mode (e): phases 13-16 ---------------------------------
    new_rows = tree_phases(dev, card, failures)
    new_rows += mode_e_phases(dev, card, failures, scene, cam, cfg, packed,
                              packed8, slice_segs, fused_img, frame_ms)
    # ---- the multi-device layer at world size 1: phase 17 --------------------
    sharded = parallel_phase(dev, card, failures, scene, cam, cfg, packed)
    if failures:
        raise AssertionError("; ".join(failures))

    main_launches = {"forward": launches["forward"],
                     "record": path_launches["hard"]["record"],
                     "record_soft": path_launches["soft"]["record_soft"]}
    kernels = []
    for mode in MODES:
        st = stats[mode]
        b, by = bound(*slice_work[mode])
        fb, fby = bound(*frame_work[mode])
        kernels.append({
            "name": f"mega_segment/{mode}", "mode": mode, "route": "cuda",
            "source": KERNEL_SRC, "replaces": REPLACES,
            "launches": main_launches[mode], "max_abs_err": st["max_err"],
            "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": b,
            "bound_by": by, "library_ms": None,
            "frame_ms": sum(seg_ms[mode]), "frame_bound_ms": fb,
            "frame_bound_by": fby})
    rows = kernels + walk_rows + new_rows
    for row in rows:  # launches per call of phase 17's sharded paths
        if row["name"] in sharded:
            row["sharded_launches"] = sharded[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
