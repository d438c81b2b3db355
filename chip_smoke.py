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
    warm-up + 3);
18. the port's last modules: (a) the flagship (``mesh100k``, 1920x1080,
    4 bounces) on an SBVH-presplit tree (``bvh_presplit`` = 0.3, the
    numpy builder; prepare timed, references, nodes, wide rows and stack
    depths printed), its fused frame on #1 modes (a) (Baldwin–Weber BVH4)
    and (e) (Möller–Trumbore BVH4): every launch on 65,536 of its lanes
    against the plain version (phase 3's gate), the frame against the
    unsplit frame of the same route (at most 0.01% of pixels outside
    rtol = atol = 5e-4), both timed in turns (``TURNS``), frame and
    launches alone; (b) ``debug_maps`` on the flagship
    with its packed BVH: every walk launch (#4) on 65,536 lanes against
    the plain version (``check_walk``), finite maps, shadow in [0, 1], a
    hit fraction in (0.05, 1], time and peak memory, then ``mesh10k``
    64x64 card vs CPU (normal and depth to 1e-4, hit kind and id equal on
    99.99% of pixels); (c) ``utils/profiling``: ``timed`` on the fused
    flagship frame within 20% of CUDA events, ``roofline`` with the
    card's HBM figure, ``trace`` writing a non-empty file; (d) the
    ``cornell_box`` 16x16 fused tree at depth 4 against the port's scalar
    oracle at tests/test_render_golden.py's tolerance; (e) the mesh-vertex
    fit of ``FIT_r05_mesh.json`` (``MESH_FIT_STEPS`` steps), held to a
    falling loss and a falling dented-face normal error. Each call that
    launches #1 or #4 has its counts set to 0 just before it and read
    just after (the kernels line's ``phase18_launches``);
19. the probes and the bench: (a) the probes' main path,
    ``scripts/torch_probes.run_probes`` (the dead kernels at tiles 1024,
    8192 and 65536 with and without the tables, the persistent grid, the
    FMA chain at the twin's [131072, 1024]; warm-up launches, then 6
    launches each, queued behind a spin kernel and taking their inputs
    from a ring beyond the L2, device and host time per launch, blocks
    and threads a block — for the persistent grid also its float4 words
    a thread and tiles a block — and ``torch.mul`` on the same ring per
    tile),
    with the counts set to 0 just before it and read just after; then
    each probe against its plain version on seeded inputs: the dead
    kernels bit for bit on every lane of every tile (the persistent grid
    on all 2,073,600), ``fma_chain`` on
    ``FMA_CHECK_ROWS`` rows at rtol ``FMA_RTOL``, and its SASS read for
    fused multiply-adds (``cuobjdump``, missing is a failure); each beside
    its bound (bytes over 3.35 TB/s, FP32 operations over 67 TFLOP/s); (b)
    ``bench.run_once('mesh100k')`` with gradients at full size, its record
    printed and held to the twin's keys, finite positive times and rates,
    41,472,000 issued rays, phase 9's live rays, phase 4's frame timed
    again just before it within 1.5x and every roofline fraction at or
    below 1.05, with the
    launches of #1 (a), (b), (d), #4 and the FMA chain in the call
    (counts set to 0 just before it; the kernels line's
    ``bench_launches``); (c) the ``--all`` presets without gradients,
    ``cornell_box`` losing no lane to ``tree_cap``; (d)
    ``bench.run_sharded('mesh100k', counts=(1,))`` twice, as the CLI runs
    it (a spawned one-rank NCCL group) and on a one-rank group this process
    joins: one row each, efficiency 1.0;
20. the walks' widened boxes (ROADMAP Queue C #14): 16,384 rays aimed
    near ``mesh100k``'s triangle corners and edges (``corner_rays``, the
    recipe of tests/test_torch_walk.py): walks #4, #5 and #2 (arity 4 and
    8), nearest and any-hit, and kernel #1's forward mode (Baldwin–Weber
    BVH4, Möller–Trumbore binary) against their brute-force plain
    versions, 0 lanes off apart from the counted tie lanes; then the
    scene-box gates (Queue C #15): 16,384 rays aimed at ``mesh100k``'s
    scene box (``utils/boxes.box_rays``, as tests/test_torch_gates.py
    makes them: its corners, edges, face-setting vertices and face
    planes):
    ``nearest_hit`` on the composed routes 'auto', 'pallas', 'pallas3'
    and 'wide' (BVH4, BVH8) with the widened gate box, and kernel #1's
    forward mode (BW BVH4, MT binary), against the gate-free brute force
    (an infinite gate box, the walks' plain version), 0 lanes off apart
    from the counted tie lanes, with the lanes the exact box culls
    counted;
21. the single-device entry (``graft_entry.entry()``, the twin of
    ``__graft_entry__.entry``): its inputs on the card, its step launching
    walk #4 (counts set to 0 just before, read just after: the #4 row's
    ``entry_launches``), its radiance against ``entry("cpu")``'s at
    rtol = atol = 5e-4 on every ray, timed;
22. the BVH refit of a mesh-geometry fit (``ops/bvh.refit``) on the
    ``mesh10k`` tree (98-triangle leaves, Baldwin–Weber BVH4): the main
    path's own run, ``fit --params mesh_positions``'s calls
    (``__main__.run_fit``, composed, depth 1, chunked, remat) for
    ``REFIT_FIT_STEPS`` steps at ``REFIT_FIT_SIZE`` squared from the
    seeded start, with the refit's record kernel's launches counted (set
    to 0 just before, read just after; one a step) and the loss falling;
    then at the fit's last vertices the refit on the card against the
    CPU's refit, every array bit for bit, and the record kernel
    (``ops/bvh._bw_rows``, ``csrc/refit.cu``) against ``pack_bw`` bit for
    bit on the refit's own leaf rows; the kernel timed alone (CUDA
    events) beside its bound (the leaf rows read and the records written
    at the HBM rate), ``pack_bw`` timed on the host, the whole refit
    timed;
23. the fused frame as CUDA graph replays (``ops/graphs``) on
    ``mesh100k`` (1920x1080), ``mesh10k`` (1024x1024) and ``cornell_box``
    (512x512) at their preset sizes: ``GRAPH_ROUNDS`` rounds over the
    ``GRAPH_YAWS`` orbit cameras, each camera's frame eager
    (``render._frame_eager``) and through ``render_frame`` in turns
    (their order swapped every round; a fresh graph cache first, so the
    first graphed frame runs eagerly and the second captures): the chain
    frames bit for bit with the eager ones, the tree's within the worst
    gap of two eager frames of each camera (``index_add``'s atomics; at
    least ``GRAPH_ULPS`` ulps of the frame's largest value); one capture
    and a replay for every later graphed frame (``render.graph.captures``
    / ``.replays``); the whole frame one graph, and the capture a
    recorded frame makes cut into a graph per stage and one before,
    between and after them (the chain's stages its segments, the tree's
    its fork launches and compactions); the launches of a replayed frame
    in ``mega.launches``
    (one per segment or level); each side's median frame time (CUDA
    events around the call) and host time after the first round, the
    capture's host time and the key's (``frame_key``, a mean of 2,000)
    (``phase 23`` lines).

Every kernel's launch count is read from its main path's run alone: the
counts are set to 0 just before that run and read just after. Any failure
raises and the exit code is not 0. The last two lines are the
``nvidia-smi`` name/power-limit line and ``{"ok": true, "device":
{...}}``; the line before them is the JSON record of every kernel (the
fused kernel's rows: modes (a), (b), (d) on Baldwin–Weber BVH4, the fork
(c) meshless and on BVH4, and the forward (e) instances; the rows of #1
mode (a), #3, #4 and #5 also carry ``sharded_launches``, phase 17's
launches per call, and those of #1 modes (a), (e) on BVH4 and (c)
meshless and of #4 ``phase18_launches``, phase 18's; those of #1
(a), (b), (d) and #4 ``bench_launches``, phase 19 (b)'s; #4
``entry_launches``, phase 21's; the four probe
rows follow, ``launches`` the probe run's, the FMA chain's the bench's;
then the refit's record kernel, ``launches`` phase 22's fit's).
Without
a CUDA card, or without the package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
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
# phase 18: the presplit budget (the twin's measured setting,
# docs/KERNELS.md "Spatial presplitting") and the mesh-vertex fit's steps
PRESPLIT = 0.3
# the order in which phase 18 times the presplit and the unsplit tree
TURNS = ("presplit", "unsplit", "unsplit", "presplit")
# (FIT_r05_mesh.json ran 500 on the CPU; a step of its plain per-lane walk
# took 2.5 s on an H100, so the smoke runs a 25x shorter fit)
MESH_FIT_STEPS = 20
BIG = 3.0e38
KERNEL_SRC = "unity_raytracer_tpu_torch/csrc/mega_segment.cu"
REPLACES = "unity_raytracer_tpu/ops/pallas/mega.py:459"
TRAVERSE_SRC = "unity_raytracer_tpu_torch/csrc/traverse.cu"
NEAREST_SRC = "unity_raytracer_tpu_torch/csrc/nearest_tri.cu"
REFIT_SRC = "unity_raytracer_tpu_torch/csrc/refit.cu"
# phase 22: the geometry fit's image side, steps, learning rate and seed
REFIT_FIT_SIZE, REFIT_FIT_STEPS, REFIT_FIT_LR, REFIT_FIT_SEED = 64, 3, 0.005, 7
# phase 23: the presets, rounds and orbit yaws (degrees about a point 20
# units ahead of the preset camera) of the eager / graphed frames, and the
# least gap, in ulps of a tree frame's largest value, it allows the tree
GRAPH_SCENES = ("mesh100k", "mesh10k", "cornell_box")
GRAPH_ROUNDS, GRAPH_YAWS, GRAPH_ULPS = 4, (-12, -6, -2, 2, 6, 12), 8
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
# phase 20: rays aimed at triangle corners and edges (ROADMAP Queue C #14),
# as tests/test_torch_walk.py builds them
CORNER_RAYS, CORNER_SEED = 16384, 14
# phase 20: the seed of the scene-box rays (ROADMAP Queue C #15,
# utils/boxes.box_rays), the gate tests' seed
BOX_SEED = 15
# phase 19: the probes (csrc/probes.cu) and the TPU sites they replace
PROBES_SRC = "unity_raytracer_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {"dead_tables": "scripts/tpu_probe2.py:151",
                  "dead_nob": "scripts/tpu_probe2.py:161",
                  "dead_persistent": "scripts/tpu_probe2.py:181",
                  "fma_chain": "scripts/tpu_r2_session.py:80"}
# rows of the FMA chain held against the plain version, and the tolerance
# (the value grows to ~1025 v; the plain version rounds each step once
# from float64, the kernel once from the fused product)
FMA_CHECK_ROWS, FMA_RTOL = 4096, 1e-6
# the bench's flagship and its issued rays (1920 x 1080 x 5 x 4)
BENCH_PRESET, BENCH_RAYS = "mesh100k", 41472000
# the twin's run_once record (bench.py:314-345)
TWIN_RECORD_KEYS = (
    "preset", "width", "height", "depth", "lights", "mesh_tris", "kernel",
    "use_bvh", "bvh_build_s", "compile_s", "frame_s", "grad_s",
    "grad_composed_s", "grad_soft_s", "rays_issued", "rays_live",
    "tree_truncated", "rays_per_s_fwd", "rays_per_s_fwd_bwd",
    "rays_per_s_fwd_bwd_composed", "rays_per_s_fwd_bwd_soft",
    "rays_per_s_live", "fraction_of_hbm_roofline", "hbm_bound_rays_per_s",
    "fraction_of_compute_roofline", "fraction_of_compute_roofline_fwd_bwd",
    "fraction_of_compute_roofline_fwd_bwd_soft", "compute_bound_rays_per_s",
    "compute_model_gflop_frame", "device")


def log(msg):
    print(msg, flush=True)


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


def events_ms(fn, repeats, warmup=1):
    """Mean ms of ``repeats`` calls after ``warmup`` warm-ups, by CUDA
    events. A fused frame takes two: its second captures its graphs."""
    from unity_raytracer_tpu_torch.utils.profiling import events_mean_s
    return events_mean_s(fn, repeats, warmup) * 1e3


def bound(nbytes, ops):
    """(ms, 'bytes' | 'operations'): the larger of bytes / HBM rate and
    FP32 operations / FP32 rate (``profiling.HBM_BPS``, ``FP32_OPS``)."""
    from unity_raytracer_tpu_torch.utils.profiling import FP32_OPS, HBM_BPS
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
    table = m3.walk_table(packed, layout)
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
    table = m3.walk_table(packed, layout)
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


def corner_rays(packed, n, seed):
    """Rays built as tests/test_torch_walk.py's ``_rays`` builds them, on
    the card: from seeded points around the tree's box, half toward random
    points of the box, half toward points of random live triangles near
    their corners and edges (Dirichlet weights 0.05), where their hits
    lie on the faces of the node boxes that bound those triangles."""
    import torch
    rng = np.random.default_rng(seed)
    nodes = packed.nodes.cpu().numpy()
    lo, hi = nodes[0, 0:3], nodes[0, 3:6]
    span = hi - lo
    o = lo - 0.5 * span + rng.random((n, 3)) * 2.0 * span
    tgt = lo + rng.random((n, 3)) * span
    live = packed.leaf_prim.cpu().numpy().reshape(-1) >= 0
    tri = packed.tris.cpu().numpy()[:, :126].reshape(-1, 3, 3)[live]
    pick = rng.integers(0, tri.shape[0], n // 2)
    w = rng.dirichlet([0.05] * 3, n // 2)
    tgt[:n // 2] = (w[:, :, None] * tri[pick]).sum(axis=1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dev = packed.tris.device
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))


def tied_lanes(packed, o, d, isect):
    """Lanes whose nearest leaf-slot hit under the leaf test ``isect``
    ('mt' on ``tris``, 'bw' on ``tris_bw``: the plain versions' brute
    force) is met by two or more slots at exactly its t: the tie lanes of
    ROADMAP Queue C #8, where a walk in another order keeps another
    triangle."""
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import mega
    rec, _ = mega._leaf_slots(packed, isect)
    o3, d3 = o.unbind(-1), d.unbind(-1)
    n = o.shape[0]
    best = torch.full((n,), torch.inf, device=o.device)
    n_eq = torch.zeros(n, dtype=torch.int64, device=o.device)
    for _, ok, t in mega._slot_chunks(o3, d3, rec):
        t = torch.where(ok, t, torch.inf)
        tmin = t.amin(dim=1)
        k = (t == tmin[:, None]).sum(dim=1)
        n_eq = torch.where(tmin < best, k, torch.where(tmin == best,
                                                       n_eq + k, n_eq))
        best = torch.minimum(best, tmin)
    return torch.isfinite(best) & (n_eq >= 2)


def corner_phase(dev, card, failures, scene, cfg, packed, packed8):
    """Phase 20 (ROADMAP Queue C #14): ``CORNER_RAYS`` rays aimed near the
    corners and edges of ``mesh100k``'s triangles (``corner_rays``), on
    which exact node boxes cull hits. Walks #4 (mk4), #5 (mk3) and #2
    (wide4, wide8), nearest (t_max _BIG) and any-hit (t_max just above
    the brute-force nearest t, so that only that hit or a tie occludes),
    against their brute-force plain version (``check_walk``); kernel #1's
    forward mode on Baldwin–Weber BVH4 and Möller–Trumbore binary at
    depth 0 against its plain version (``compare``'s criterion). 0 lanes
    off are allowed beside the tie lanes (``check_walk``'s; for #1 the
    lanes ``tied_lanes`` finds under the route's leaf test), which are
    counted."""
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    t0 = time.perf_counter()
    o, d = corner_rays(packed, CORNER_RAYS, CORNER_SEED)
    n = o.shape[0]
    big = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    near = m3.traverse_plain(packed, o, d, big)
    hit = near[1] >= 0
    ties = {isect: tied_lanes(packed, o, d, isect) for isect in ("mt", "bw")}
    t_any = torch.where(hit, near[0] * (1.0 + 1e-3), big)
    log(f"phase 20: {n} corner- and edge-aimed rays on mesh100k, "
        f"{int(hit.sum())} hit the mesh, at an exact tie "
        f"{int(ties['mt'].sum())} (Möller–Trumbore) and "
        f"{int(ties['bw'].sum())} (Baldwin–Weber)")
    for layout, pk in (("mk4", packed), ("mk3", packed), ("wide4", packed),
                       ("wide8", packed8)):
        for any_hit, tmax in ((False, big), (True, t_any)):
            plain = near if not any_hit else m3.traverse_plain(
                pk, o, d, tmax, True)
            bad, tie, _ = check_walk(layout, pk, (o, d, tmax, any_hit),
                                     plain, torch)
            what = f"{layout} {'any-hit' if any_hit else 'nearest'}"
            log(f"phase 20 walk {what}: {bad} lanes off the brute force, "
                f"{tie} tie lanes")
            if bad:
                failures.append(f"phase 20 walk {what}: {bad} lanes off "
                                f"the brute force")
    aux = mega.build_aux(scene, cfg.background)
    thr = torch.ones_like(o)
    kw = dict(n_lights=scene.lights.positions.shape[0],
              n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
              max_bounces=cfg.max_bounces, light_cull=cfg.light_cull)
    for isect, wide in (("bw", True), ("mt", False)):
        rk = dict(kw, tri_isect=isect, use_wide=wide)
        got = mega.trace_segment(packed, aux, 0, o, d, thr, big, **rk)
        want = mega.trace_segment_plain(packed, aux, 0, o, d, thr, big,
                                        **rk)
        cont = want[4] >= 0
        close = lambda a, b: torch.isclose(a, b, **TOL).all(-1)
        off = ~close(got[0], want[0]) | ((got[4] >= 0) != cont)
        for a, b in zip(got[1:4], want[1:4]):
            off |= cont & ~close(a, b)
        route = mega.segment_route(packed, isect, wide)
        tie = ties[isect]
        n_off, n_tie = int((off & ~tie).sum()), int((off & tie).sum())
        log(f"phase 20 kernel #1 forward {route}: {n_off} lanes off the "
            f"plain version, {n_tie} tie lanes off")
        if n_off:
            compare(got, want, torch)  # logs the first lanes off
            failures.append(f"phase 20 kernel #1 forward {route}: {n_off} "
                            f"lanes off the plain version")
    log(f"phase 20: {time.perf_counter() - t0:.3f} s wall {card}")


def box_phase(dev, card, failures, scene, cfg, packed, packed8):
    """Phase 20 (ROADMAP Queue C #15): ``CORNER_RAYS`` rays aimed at
    ``mesh100k``'s scene box (``utils/boxes.box_rays``). ``nearest_hit`` on the
    composed routes ('auto', 'pallas', 'pallas3', 'wide' on BVH4 and
    BVH8), with the scene's widened gate box, against the gate-free brute
    force: ``nearest_hit`` on a scene whose gate box is infinite, its
    walk replaced by the walks' plain version (``traverse_plain``, every
    leaf slot); kernel #1's forward mode (Baldwin–Weber BVH4,
    Möller–Trumbore binary) against its plain version on the infinite
    box. ``nearest_hit``: t within ``TOL`` on every lane (a culled hit is
    a miss there). A lane whose kind or index differs at that t is a tie
    (the second mesh's pole touches the ground, and rays at shared
    vertices meet several triangles) only if the route's mesh walk
    (``traverse_any`` on the route) finds the reference walk's mesh t
    within ``TOL`` there, both missing or both hitting; else it is off,
    so a mesh hit the walk missed behind a ground triangle at the same t
    cannot pass as a tie. #1: ``compare``'s criterion, ties
    (``tied_lanes``) counted. 0 lanes off allowed. Also counts the lanes
    the exact box culls."""
    import dataclasses

    import torch
    from unity_raytracer_tpu_torch.ops.bvh import traverse_any
    from unity_raytracer_tpu_torch.ops.intersect import nearest_hit
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    from unity_raytracer_tpu_torch.utils.boxes import box_rays
    t0 = time.perf_counter()
    o, d, _ = (torch.from_numpy(a).to(dev)
               for a in box_rays(scene, CORNER_RAYS, BOX_SEED))
    n = o.shape[0]
    inf = torch.full((3,), torch.inf, device=dev)
    free = dataclasses.replace(scene, gate_min=-inf, gate_max=inf)
    exact = dataclasses.replace(scene, gate_min=scene.aabb_min,
                                gate_max=scene.aabb_max)
    walk_raw = m3.walk_raw
    m3.walk_raw = lambda layout, pk, o_, d_, tmax, any_hit=False, **k: \
        m3.traverse_plain(pk, o_, d_, tmax, any_hit)
    try:
        want = nearest_hit(free, o, d, bvh=packed, kernel="pallas")
        want_mesh = traverse_any(packed, o, d, kernel="pallas")[0]
    finally:
        m3.walk_raw = walk_raw
    hits = int((want.kind != 0).sum())
    ties = {isect: tied_lanes(packed, o, d, isect) for isect in ("mt", "bw")}
    ex = nearest_hit(exact, o, d, bvh=packed, kernel="pallas")
    culled = int(((ex.kind == 0) & (want.kind != 0)).sum())
    log(f"phase 20 box: {n} rays aimed at the mesh100k scene box's "
        f"corners, edges, face-setting vertices and face planes; {hits} "
        f"hit by the gate-free brute force, {culled} of them culled by the "
        f"exact box; at an exact tie {int(ties['mt'].sum())} (Möller–"
        f"Trumbore) and {int(ties['bw'].sum())} (Baldwin–Weber)")
    for route, pk in (("auto", packed), ("pallas", packed),
                      ("pallas3", packed), ("wide", packed),
                      ("wide", packed8)):
        got = nearest_hit(scene, o, d, bvh=pk, kernel=route)
        got_mesh = traverse_any(pk, o, d, kernel=route)[0]
        agree = lambda a, b: ((torch.isinf(a) & torch.isinf(b))
                              | torch.isclose(a, b, **TOL))
        off_t = ~agree(got.t, want.t)
        differ = ~off_t & ((got.kind != want.kind)
                           | (got.index != want.index))
        walk_off = differ & ~agree(got_mesh, want_mesh)
        tie = differ & ~walk_off
        off = off_t | walk_off
        n_off = int(off.sum())
        what = route + (f"/arity{pk.wide.shape[1] // 8}"
                        if route == "wide" else "")
        log(f"phase 20 box nearest_hit {what}: {n_off} lanes off the "
            f"gate-free brute force ({int(off_t.sum())} on t, "
            f"{int(walk_off.sum())} on the mesh walk's t where kind or "
            f"index differ), {int(tie.sum())} tie lanes (kind "
            f"{int((tie & (got.kind != want.kind)).sum())}, index only "
            f"{int((tie & (got.kind == want.kind)).sum())}) with the mesh "
            f"walk's t within tolerance")
        if walk_off.any():
            i = torch.nonzero(walk_off)[:4, 0]
            log(f"  first lanes off on the mesh walk: {i.tolist()} kind "
                f"{got.kind[i].tolist()} vs {want.kind[i].tolist()}, mesh "
                f"t {got_mesh[i].tolist()} vs {want_mesh[i].tolist()}")
        if n_off:
            failures.append(f"phase 20 box nearest_hit {what}: {n_off} "
                            f"lanes off the gate-free brute force")
    big = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    thr = torch.ones_like(o)
    aux, aux_free = (mega.build_aux(sc, cfg.background)
                     for sc in (scene, free))
    kw = dict(n_lights=scene.lights.positions.shape[0],
              n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
              max_bounces=cfg.max_bounces, light_cull=cfg.light_cull)
    for isect, wide in (("bw", True), ("mt", False)):
        rk = dict(kw, tri_isect=isect, use_wide=wide)
        got = mega.trace_segment(packed, aux, 0, o, d, thr, big, **rk)
        ref = mega.trace_segment_plain(packed, aux_free, 0, o, d, thr, big,
                                       **rk)
        cont = ref[4] >= 0
        close = lambda a, b: torch.isclose(a, b, **TOL).all(-1)
        off = ~close(got[0], ref[0]) | ((got[4] >= 0) != cont)
        for a, b in zip(got[1:4], ref[1:4]):
            off |= cont & ~close(a, b)
        route = mega.segment_route(packed, isect, wide)
        tie = ties[isect]
        n_off, n_tie = int((off & ~tie).sum()), int((off & tie).sum())
        log(f"phase 20 box kernel #1 forward {route}: {n_off} lanes off "
            f"the gate-free plain version, {n_tie} tie lanes off")
        if n_off:
            compare(got, ref, torch)  # logs the first lanes off
            failures.append(f"phase 20 box kernel #1 forward {route}: "
                            f"{n_off} lanes off the gate-free plain version")
    log(f"phase 20 box: {time.perf_counter() - t0:.3f} s wall {card}")


def entry_phase(dev, card, failures):
    """Phase 21: ``graft_entry.entry()`` (the twin's ``__graft_entry__``
    forward step) on the card: its inputs on the card, ``fn(*args)``
    launching the ordered binary walk (#4, counts set to 0 just before,
    read just after), its radiance against ``entry("cpu")``'s at
    ``TOL`` on every ray, 1 warm-up + 3 steps timed with CUDA events."""
    import torch
    from unity_raytracer_tpu_torch.graft_entry import entry
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    t0 = time.perf_counter()
    fn, args = entry()
    scene, o, d, bvh = args
    on_card = all(t.is_cuda for t in (o, d, scene.meshes.verts,
                                      bvh.nodes_walk))
    for k in m3.launches:
        m3.launches[k] = 0
    got = fn(*args)
    torch.cuda.synchronize()
    walks = dict(m3.launches)
    fn_c, args_c = entry("cpu")
    want = fn_c(*args_c)
    off = int((~torch.isclose(got.cpu(), want, **TOL).all(-1)).sum())
    err = float((got.cpu() - want).abs().max())
    ms = events_ms(lambda: fn(*args), 3)
    log(f"phase 21 entry(): {tuple(got.shape)} radiance, inputs on the "
        f"card {on_card}; walk launches {walks}; {off} of {got.shape[0]} "
        f"rays outside rtol = atol = 5e-4 of entry('cpu'), max abs err "
        f"{err:.3g}; {ms:.3f} ms a step; {time.perf_counter() - t0:.3f} s "
        f"wall {card}")
    if not on_card:
        failures.append("entry(): inputs not on the card")
    if not walks["mk4"]:
        failures.append("entry(): fn launched no traverse_packet4 walk")
    if off or not bool(torch.isfinite(got).all()):
        failures.append(f"entry(): {off} rays off entry('cpu')")
    return walks["mk4"]


def refit_phase(dev, card, failures):
    """Phase 22 (module docstring). Returns the kernels-line row of the
    refit's Baldwin–Weber record kernel."""
    import torch
    from unity_raytracer_tpu_torch.__main__ import run_fit
    from unity_raytracer_tpu_torch.fit import set_params
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import (
        PackedBVH, pack_bw)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    bvhmod.launches["bw_records"] = 0
    res, _, (scene, _, _, bvh, _) = run_fit(
        "mesh10k", REFIT_FIT_SIZE, REFIT_FIT_SIZE, REFIT_FIT_STEPS,
        REFIT_FIT_LR, REFIT_FIT_SEED, dev, replay=False,
        params="mesh_positions")
    torch.cuda.synchronize()
    launched = bvhmod.launches["bw_records"]
    losses = [float(x) for x in res.losses]
    log(f"phase 22 mesh10k {REFIT_FIT_SIZE}x{REFIT_FIT_SIZE} fit "
        f"--params mesh_positions {REFIT_FIT_STEPS} steps: losses {losses}; "
        f"record kernel launches {launched} {card}")
    if launched != REFIT_FIT_STEPS:
        failures.append(f"refit: {launched} record kernel launches in a "
                        f"{REFIT_FIT_STEPS}-step mesh fit")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        failures.append(f"refit: the mesh fit's loss did not fall {losses}")
    moved = set_params(scene, {"mesh_positions":
                               res.params["mesh_positions"].to(dev)})
    tree = bvhmod.with_refit_tables(bvh, moved)
    got, g_scene = bvhmod.refit(tree, moved)
    want, w_scene = bvhmod.refit(bvh.to("cpu"), moved.to("cpu"))
    differ = [k for k in ("nodes", "nodes_walk", "wide", "wide_walk",
                          "tris", "leafbox", "tris_bw")
              if not torch.equal(getattr(got, k).cpu().view(torch.int32),
                                 getattr(want, k).view(torch.int32))]
    differ += [f"bvh.{k}" for k in ("node_min", "node_max", "tri_verts")
               if not torch.equal(getattr(got.bvh, k).detach().cpu(),
                                  getattr(want.bvh, k).detach())]
    differ += [k for k in ("aabb_min", "aabb_max", "gate_min", "gate_max")
               if not torch.equal(getattr(g_scene, k).cpu(),
                                  getattr(w_scene, k))]
    tb = tree.bvh.refit_tables
    n_leaves, rpl, bw_rpl = tb.bw
    tris = got.tris
    recs = bvhmod._bw_rows(tris, tb.bw)
    t1 = time.perf_counter()
    plain = pack_bw(PackedBVH(nodes=None, tris=tris.cpu(), leaf_prim=None,
                              bvh=None, rows_per_leaf=rpl)).tris_bw
    plain_ms = (time.perf_counter() - t1) * 1e3
    same = torch.equal(recs.cpu().view(torch.int32), plain.view(torch.int32))
    err = float((recs.cpu() - plain).abs().max())
    ms = events_ms(lambda: bvhmod._bw_rows(tris, tb.bw), 20)
    refit_ms = events_ms(lambda: bvhmod.refit(tree, moved), 20)
    nbytes = 4 * (tris.numel() + recs.numel())
    b, by = bound(nbytes, 0)
    log(f"phase 22 refit at the fit's vertices, card vs CPU: "
        f"{'every array bit for bit' if not differ else f'DIFFER {differ}'}"
        f"; record kernel ({n_leaves} leaves, {tris.shape[0]} leaf rows, "
        f"{recs.shape[0]} record rows) vs pack_bw: "
        f"{'bit for bit' if same else 'DIFFER'} (max abs diff {err:.3g}); "
        f"kernel {ms:.4f} ms, bound {b:.4f} ms ({nbytes} B at the HBM "
        f"rate), pack_bw {plain_ms:.3f} ms on the host; the whole refit "
        f"{refit_ms:.4f} ms; {time.perf_counter() - t0:.3f} s wall {card}")
    if differ:
        failures.append(f"refit on the card differs from the CPU's: {differ}")
    if not same:
        failures.append("refit record kernel differs from pack_bw")
    return dict(
        name="refit_bw_records", route="cuda", source=REFIT_SRC,
        replaces=None, launches=launched, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
        refit_ms=refit_ms)


def orbit_camera(cam, degrees):
    """``cam`` yawed by ``degrees`` about the point 20 units ahead of it."""
    from unity_raytracer_tpu_torch.models.camera import Camera
    pos = cam.position.cpu().numpy().astype(np.float64)
    fwd = cam.forward.cpu().numpy().astype(np.float64)
    centre = pos + 20.0 * fwd
    a = math.radians(degrees)
    rot = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                    [-math.sin(a), 0, math.cos(a)]])
    return Camera.make(position=centre + rot @ (pos - centre),
                       forward=rot @ fwd, up=(0, 1, 0), dist=float(cam.dist),
                       half_h=float(cam.half_h), half_v=float(cam.half_v),
                       width=cam.width, height=cam.height,
                       device=cam.position.device)


def frame_graph_phase(dev, card, failures):
    """Phase 23 (module docstring). Returns its readings per preset."""
    import torch
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops import render as rd
    from unity_raytracer_tpu_torch.ops.graphs import frame_key
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.utils import profiling as pf

    def frame(fn, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        img = fn(*args)
        b.record()
        b.synchronize()
        return img, a.elapsed_time(b), (time.perf_counter() - h0) * 1e3

    out = {}
    for name in GRAPH_SCENES:
        t0 = time.perf_counter()
        scene, cam, cfg = get_preset(name, device=dev)
        cfg = rd.resolve_mode(scene, cfg.with_(kernel="mega"))
        bvh = bvhmod.prepare_bvh(scene, cfg, dev) if cfg.use_bvh else None
        cams = [orbit_camera(cam, a) for a in GRAPH_YAWS]
        chain = cfg.mode == "scan"
        args = lambda c: (scene, c, cfg, bvh)
        eager_gap = [float((rd._frame_eager(*args(c))
                            - rd._frame_eager(*args(c))).abs().max())
                     for c in cams]
        rd.FRAME_GRAPHS.clear()
        ms = {"eager": [], "graph": []}
        host = {"eager": [], "graph": []}
        differ, worst, over = 0, 0.0, 0
        with pf.collect_counts() as counts:
            for r in range(GRAPH_ROUNDS):
                for i, c in enumerate(cams):
                    img = {}
                    for how in (("eager", "graph") if r % 2 == 0
                                else ("graph", "eager")):
                        fn = rd._frame_eager if how == "eager" \
                            else rd.render_frame
                        img[how], m, h = frame(fn, *args(c))
                        ms[how].append(m)
                        host[how].append(h)
                    gap = float((img["graph"] - img["eager"]).abs().max())
                    differ += not torch.equal(img["graph"], img["eager"])
                    worst = max(worst, gap)
                    ulps = GRAPH_ULPS * float(torch.finfo(torch.float32).eps
                                              * img["eager"].abs().max())
                    over += gap > max(eager_gap[i], ulps)
        tally = lambda k: sum(v for n, v in counts if n == k)
        captures = tally("render.graph.captures")
        replays = tally("render.graph.replays")
        n_graphed = len(ms["graph"])
        pieces = [len(g.graphs[False].pieces)
                  for g in rd.FRAME_GRAPHS.graphs.values()]
        stages = cfg.max_bounces + 1     # a segment's or a fork's graph
        lanes = 1                         # the tree's, in pixels
        for _ in range(0 if chain else cfg.max_bounces):
            lanes *= 2
            if cfg.tree_cap and lanes > cfg.tree_cap:
                lanes, stages = cfg.tree_cap, stages + 1  # a compaction's
        want_pieces = 2 * stages + 1
        for k in mega.launches:
            mega.launches[k] = 0
        rd.render_frame(*args(cams[0]))
        torch.cuda.synchronize()
        launched = sum(mega.launches.values())
        with pf.recording():                # captures the cut frame
            rd.render_frame(*args(cams[0]))
        cut = [len(g.graphs[True].pieces)
               for g in rd.FRAME_GRAPHS.graphs.values()]
        n_key = 2000
        k0 = time.perf_counter()
        for _ in range(n_key):
            frame_key(scene, cams[0], cfg, bvh)
        key_us = (time.perf_counter() - k0) / n_key * 1e6
        later = len(cams)               # the first round warms up
        med = {k: float(np.median(v[later:])) for k, v in ms.items()}
        med_host = {k: float(np.median(v[later:])) for k, v in host.items()}
        row = dict(eager_ms=med["eager"], graph_ms=med["graph"],
                   eager_host_ms=med_host["eager"],
                   graph_host_ms=med_host["graph"],
                   capture_host_ms=host["graph"][1], key_us=key_us,
                   captures=captures, pieces=pieces, cut_pieces=cut,
                   replays=replays, frames=n_graphed,
                   launches_replayed=launched,
                   differ=differ, worst_gap=worst,
                   eager_gap=max(eager_gap))
        out[name] = row
        log(f"phase 23 {name} {cam.width}x{cam.height} ({cfg.mode}): "
            f"eager {med['eager']:.3f} ms (host {med_host['eager']:.3f}), "
            f"graphed {med['graph']:.3f} ms (host "
            f"{med_host['graph']:.3f}), {med['eager'] / med['graph']:.2f}x "
            f"(medians of {n_graphed - later} frames each); capture "
            f"{host['graph'][1]:.1f} ms host; the key {key_us:.1f} us "
            f"host; {captures} capture, "
            f"{replays} replays over {n_graphed} graphed frames; "
            f"{pieces} graphs a key, {cut} recorded; "
            f"{launched} segment launches a replayed frame; "
            f"{differ} frames not bit for bit, worst gap {worst:.3g} "
            f"(eager vs eager {max(eager_gap):.3g}); "
            f"{time.perf_counter() - t0:.1f} s wall {card}")
        if captures != 1 or replays != n_graphed - 1:
            failures.append(f"frame graph {name}: {captures} captures and "
                            f"{replays} replays over {n_graphed} frames")
        if pieces != [1] or cut != [want_pieces]:
            failures.append(f"frame graph {name}: graphs {pieces} a key and "
                            f"{cut} recorded, not [1] and [{want_pieces}]")
        if launched != cfg.max_bounces + 1:
            failures.append(f"frame graph {name}: {launched} segment "
                            f"launches counted for a replayed frame")
        if (differ if chain else over):
            failures.append(f"frame graph {name}: {differ} graphed frames "
                            f"differ from the eager ones (worst {worst:.3g},"
                            f" eager vs eager {max(eager_gap):.3g})")
        rd.FRAME_GRAPHS.clear()
        del scene, bvh, cams
        torch.cuda.empty_cache()
    log("phase 23 " + json.dumps(out))
    return out


def nearest_work(o, d, verts, valid, kept):
    """(bytes, operations, exact pair tests, cull tests) of one
    nearest-triangle launch: rays and triangles read once, (t, index)
    written once, and the exact tests the culled kernel makes (every ray
    of a block tests each triangle its block kept: ``kept``, from the
    counting instance). The cull tests (every block with a ray that can
    hit tests each valid triangle's ball against its cone) are the
    design's own stream, not work the function needs: counted apart."""
    from unity_raytracer_tpu_torch.utils.profiling import OPS_PER_TEST
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
    from unity_raytracer_tpu_torch.utils.profiling import (
        FP32_OPS, OPS_PER_TEST)
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
    the four walks and the nearest-triangle kernel, and phase 9's live
    rays (``trace_radiance_stats``: nearest and shadow lanes summed)."""
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
    return ([rows[k] for k in ("mk4", "wide4", "wide8", "mk3", "nearest")],
            sum(live) + sum(shadow))


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
    from unity_raytracer_tpu_torch.utils.profiling import (
        capture_segments, segment_work)
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
    f_ms = events_ms(lambda: render_frame(scene, cam, cfg_m), 3, 2)
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
    from unity_raytracer_tpu_torch.utils.profiling import (
        capture_segments, segment_work)
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
        f_ms = events_ms(lambda: render_frame(scene, cam, fcfg, pk), 3, 2)
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


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL group of this process on the card, opened through a
    file store (NCCL's bootstrap on the loopback), left on exit."""
    import tempfile

    import torch
    from unity_raytracer_tpu_torch.parallel import bootstrap
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: loopback
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    bootstrap.maybe_initialize(f"file://{store}/store", 1, 0, device="cuda",
                               timeout_s=300)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def parallel_phase(dev, card, failures, scene, cam, cfg, packed):
    """Phase 17: the multi-device layer at world size 1 on the card — a
    one-rank NCCL group opened in this process through a file store — on
    the flagship frame. Returns ``{kernel: {call: launches per call}}``
    for kernels #1, #3, #4 and #5."""
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

    with one_rank_group():
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
    return per_call


def live_slice(ins, n):
    """``n`` lanes of one segment's inputs ``(o, d, thr, tmax)``: evenly
    spaced live lanes, or every live lane topped up with dead ones."""
    import torch
    live_idx = torch.nonzero(ins[3] >= 0).squeeze(1)
    if live_idx.numel() >= n:
        pick = live_idx[torch.linspace(0, live_idx.numel() - 1, n,
                                       device=live_idx.device).long()]
    else:
        dead_idx = torch.nonzero(ins[3] < 0).squeeze(1)
        pick = torch.cat([live_idx, dead_idx[:n - live_idx.numel()]])
    return [x[pick].contiguous() for x in ins]


def presplit_frames(dev, card, failures, scene, cam, cfg, packed, counted):
    """Phase 18 (a): the flagship on an SBVH-presplit tree, the fused
    frame on #1 modes (a) and (e) (BVH4) against the plain version on
    every launch's slice and against the unsplit frame."""
    from unity_raytracer_tpu_torch.utils.profiling import capture_segments
    import torch
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    from unity_raytracer_tpu_torch.ops.render import render, render_frame

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = bvhmod.prepare_bvh(scene, cfg.with_(bvh_presplit=PRESPLIT), dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    log(f"phase 18 (a): mesh100k BVH prepare with bvh_presplit={PRESPLIT}: "
        f"{prep_s:.3f} s; {split.bvh.tri_verts.shape[0]} references of "
        f"{scene.meshes.count} triangles, {split.nodes.shape[0]} binary "
        f"nodes, {split.wide.shape[0]} wide rows, stack depths binary "
        f"{split.stack_binary} / wide {split.stack_wide} (unsplit: "
        f"{packed.nodes.shape[0]} nodes, {packed.wide.shape[0]} wide rows, "
        f"{packed.stack_binary} / {packed.stack_wide}; capacities "
        f"{m3.STACK_BINARY} / {m3._WIDE_STACK}) {card}")
    aux = mega.build_aux(scene, cfg.background)
    n_lights = int(scene.lights.valid.sum())
    issued = cam.width * cam.height * (cfg.max_bounces + 1) * (1 + n_lights)
    for isect, name in (("bw", "mega_segment/forward"),
                        ("mt", "mega_segment/forward/mt/wide4")):
        route = f"{isect}/wide4"
        fcfg = cfg.with_(kernel="mega", tri_isect=isect, bvh_arity=4)
        kw = dict(n_lights=scene.lights.positions.shape[0],
                  n_spheres=scene.spheres.count,
                  n_tris=scene.triangles.count,
                  max_bounces=cfg.max_bounces, light_cull=cfg.light_cull,
                  tri_isect=isect)
        whole = render(scene, cam, fcfg, bvh=packed)
        img = counted(f"{name} presplit frame",
                      lambda: render(scene, cam, fcfg, bvh=split), name)
        segs = capture_segments(lambda: render(scene, cam, fcfg, bvh=split))
        bad = lanes = 0
        err = 0.0
        for depth, ins in segs:
            sl = live_slice(ins, PLAIN_LANES)
            got = mega.trace_segment(split, aux, depth, *sl, **kw)
            want = mega.trace_segment_plain(split, aux, depth, *sl, **kw)
            b, n_, e = compare(got, want, torch)
            bad, lanes, err = bad + b, lanes + n_, max(err, e)
            log(f"presplit {route} segment {depth} slice: "
                f"{int((sl[3] >= 0).sum())} live of {n_}, {b} lanes outside "
                f"rtol=atol=5e-4, max abs err {e:.3g}")
        if bad > MAX_BAD_FRACTION * lanes:
            failures.append(f"presplit {route}: {bad} of {lanes} slice "
                            f"lanes disagree with the plain version")
        px = img.shape[0] * img.shape[1]
        off = int((~torch.isclose(img, whole, **TOL).all(-1)).sum())
        same = int((img == whole).all(-1).sum())
        # the frame, then its launches alone, timed in turns (presplit,
        # unsplit, unsplit, presplit); the walk's work on the first two
        # segments from the counting instance
        trees = {"presplit": (split, segs), "unsplit": (
            packed, capture_segments(
                lambda: render(scene, cam, fcfg, bvh=packed)))}
        frame_ms = {k: [] for k in trees}
        alone = {k: [] for k in trees}
        for what in TURNS:
            pk, pk_segs = trees[what]
            frame_ms[what].append(events_ms(
                lambda: render_frame(scene, cam, fcfg, pk), 5, 2))
            alone[what].append(sum(events_ms(lambda: mega.trace_segment(
                pk, aux, depth, *ins, **kw), 5) for depth, ins in pk_segs))
        for what, (pk, pk_segs) in trees.items():
            for depth, ins in pk_segs[:2]:
                log_segment_counts(f"{what} {route} segment {depth}", pk,
                                   aux, depth, ins, kw)
        ms = lambda v: " / ".join(f"{x:.3f}" for x in v)
        log(f"presplit {route} in turns (presplit, unsplit, unsplit, "
            f"presplit; CUDA events, 1 warm-up + 5 each): frame "
            f"{ms(frame_ms['presplit'])} ms vs unsplit "
            f"{ms(frame_ms['unsplit'])} ms; its 5 launches alone "
            f"{ms(alone['presplit'])} ms vs unsplit {ms(alone['unsplit'])} "
            f"ms {card}")
        ms_split, ms_whole = (sum(frame_ms[k]) / len(frame_ms[k])
                              for k in trees)
        log(f"mesh100k 1920x1080 presplit frame on {route}: {len(segs)} "
            f"launches, {ms_split:.3f} ms = {issued / ms_split * 1e3:.4g} "
            f"issued rays/s; the unsplit frame {ms_whole:.3f} ms = "
            f"{issued / ms_whole * 1e3:.4g} (means of the turns); "
            f"vs the unsplit frame: {off} of {px} pixels outside "
            f"rtol=atol=5e-4, {same} bit for bit, max abs diff "
            f"{float((img - whole).abs().max()):.3g}; slices {bad} of "
            f"{lanes} lanes off the plain version, max abs err {err:.3g} "
            f"{card}")
        if off > MAX_BAD_FRACTION * px or not bool(torch.isfinite(img).all()):
            failures.append(f"presplit {route} frame: {off} pixels off the "
                            f"unsplit frame")


def debug_maps_phase(dev, card, failures, scene, cam, packed, counted):
    """Phase 18 (b): ``debug_maps`` on the flagship (#4 walks) with every
    walk launch held against the plain version, then ``mesh10k`` 64x64
    card vs CPU."""
    import torch
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.debugviz import debug_maps
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3

    torch.cuda.reset_peak_memory_stats(dev)
    maps = counted("debug_maps", lambda: debug_maps(scene, cam, bvh=packed),
                   "traverse_packet4")
    peak = torch.cuda.max_memory_allocated(dev)
    ms = events_ms(lambda: debug_maps(scene, cam, bvh=packed), 3)
    hit = maps["hit_kind"] > 0
    finite = all(bool(torch.isfinite(v).all()) for v in maps.values())
    sh = maps["shadow"]
    frac = float(hit.float().mean())
    log(f"phase 18 (b): debug_maps mesh100k {cam.width}x{cam.height}: "
        f"{ms:.3f} ms (CUDA events, 1 warm-up + 3), peak "
        f"{peak / 2 ** 30:.3f} GiB; hit fraction {frac:.4f}, shadow mean on "
        f"hits {float(sh[hit].mean()):.4f}, all finite {finite} {card}")
    if not finite or float(sh.min()) < 0 or float(sh.max()) > 1 \
            or not 0.05 < frac <= 1.0:
        failures.append(f"debug_maps: finite {finite}, shadow in "
                        f"[{float(sh.min())}, {float(sh.max())}], hit "
                        f"fraction {frac}")
    walks = capture_walks(lambda: debug_maps(scene, cam, bvh=packed))
    for k, (layout, o, d, tmax, any_hit) in enumerate(walks):
        lo = o.shape[0] // 2
        sl = (o[lo:lo + PLAIN_LANES], d[lo:lo + PLAIN_LANES],
              tmax[lo:lo + PLAIN_LANES], any_hit)
        plain = m3.traverse_plain(packed, *sl)
        bad, tie, err = check_walk(layout, packed, sl, plain, torch)
        hits = int((plain[1] >= 0).sum())
        log(f"debug_maps walk {k} ({layout}, {'any-hit' if any_hit else 'nearest'}"
            f", {o.shape[0]} lanes): lanes [{lo}, {lo + sl[0].shape[0]}) "
            f"against the plain version: {bad} off, {tie} tied, {hits} hits, "
            f"max abs err of t {err:.3g}")
        if bad or not hits:
            failures.append(f"debug_maps walk {k}: {bad} lanes off the plain "
                            f"version, {hits} hits")
    if not walks or any(w[0] != "mk4" for w in walks):
        failures.append(f"debug_maps walks {[w[0] for w in walks]}, "
                        f"expected mk4")

    s_cpu, c_cpu, cfg10 = get_preset("mesh10k", width=64, height=64,
                                     device="cpu")
    pk = bvhmod.prepare_bvh(s_cpu, cfg10)
    cpu = debug_maps(s_cpu, c_cpu, bvh=pk)
    card_maps = debug_maps(s_cpu.to(dev), c_cpu.to(dev), bvh=pk.to(dev))
    px = 64 * 64
    near = {k: int((~torch.isclose(card_maps[k].cpu(), cpu[k], rtol=1e-4,
                                   atol=1e-4)).reshape(px, -1).any(-1).sum())
            for k in ("normal", "depth", "shadow")}
    # the category code and the hashed id as the integers they encode
    # (the card divides by 255 and 3 as a product with the reciprocal,
    # one ulp off the CPU's quotient)
    code = {"hit_kind": 3.0, "hit_id": 255.0}
    ids = {k: int((torch.round(card_maps[k].cpu() * f)
                   != torch.round(cpu[k] * f)).reshape(px, -1).any(-1)
                  .sum()) for k, f in code.items()}
    log(f"debug_maps mesh10k 64x64 card vs CPU: pixels outside 1e-4 {near}, "
        f"pixels unequal {ids}")
    if near["normal"] or near["depth"] or any(
            v > MAX_BAD_FRACTION * px for v in ids.values()):
        failures.append(f"debug_maps card vs CPU: {near}, {ids}")


def profiling_phase(dev, card, failures, scene, cam, cfg, packed):
    """Phase 18 (c): ``utils/profiling`` on the fused flagship frame."""
    from unity_raytracer_tpu_torch.utils.profiling import (
        capture_segments, segment_work)
    import tempfile

    import torch
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.render import render, render_frame
    from unity_raytracer_tpu_torch.utils import profiling

    fcfg = cfg.with_(kernel="mega")
    frame = lambda: render_frame(scene, cam, fcfg, packed)
    ev_ms = events_ms(frame, 5, 2)
    best_ms = profiling.timed(frame, repeats=5, warmup=1).per_run_s * 1e3
    rel = abs(best_ms - ev_ms) / ev_ms
    aux = mega.build_aux(scene, cfg.background)
    kw = dict(n_lights=scene.lights.positions.shape[0],
              n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
              max_bounces=cfg.max_bounces, light_cull=cfg.light_cull)
    segs = capture_segments(lambda: render(scene, cam, fcfg, bvh=packed))
    nbytes, _ = segment_work(packed, aux, kw, segs, 52, "bw/wide4")
    n_lights = int(scene.lights.valid.sum())
    issued = cam.width * cam.height * (cfg.max_bounces + 1) * (1 + n_lights)
    log(f"phase 18 (c): profiling.timed on the fused flagship frame "
        f"{best_ms:.3f} ms (best of 5, synchronized host clock) vs CUDA "
        f"events {ev_ms:.3f} ms (mean of 5): {rel:.1%} apart {card}")
    if rel > 0.2:
        failures.append(f"profiling.timed {best_ms:.3f} ms vs events "
                        f"{ev_ms:.3f} ms")
    try:
        roof = profiling.roofline(issued / ev_ms * 1e3, nbytes / issued)
        log(f"profiling.roofline ({torch.cuda.get_device_name(0)}, "
            f"{profiling.device_hbm_gbps()} GB/s; bytes per issued ray from "
            f"the frame's counted bytes): {json.dumps(roof)} {card}")
    except ValueError as e:
        failures.append(f"profiling.roofline: {e}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
        with profiling.trace(logdir):
            frame()
        files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
        sizes = [os.path.getsize(f) for f in files]
    log(f"profiling.trace: {len(files)} file(s), {sum(sizes)} bytes")
    if len(files) != 1 or not sizes[0]:
        failures.append(f"profiling.trace wrote {sizes}")


def oracle_phase(dev, card, failures, counted):
    """Phase 18 (d): the fused cornell tree on the card against the
    port's scalar oracle, at tests/test_render_golden.py's tolerance."""
    from unity_raytracer_tpu_torch import oracle
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops.render import render, resolve_mode

    scene, cam, cfg = get_preset("cornell_box", width=16, height=16,
                                 device=dev)
    cfg = resolve_mode(scene, cfg.with_(kernel="mega", max_bounces=4))
    img = counted("oracle cornell 16x16",
                  lambda: render(scene, cam, cfg),
                  "mega_segment/fork/meshless").cpu().numpy()
    t0 = time.perf_counter()
    ref = oracle.render(oracle.from_scene(scene), cam, cfg.max_bounces,
                        background=cfg.background)
    osec = time.perf_counter() - t0
    err = np.abs(img - ref)
    p999, mean = float(np.quantile(err, 0.999)), float(err.mean())
    limit = 2e-4 + 1e-3 * float(np.abs(ref).mean())
    log(f"phase 18 (d): cornell_box 16x16 depth {cfg.max_bounces} fused "
        f"tree ({cfg.mode}) vs the scalar oracle: p99.9 err {p999:.3g} "
        f"(< 5e-3), mean err {mean:.3g} (< {limit:.3g}), max "
        f"{float(err.max()):.3g}; the oracle took {osec:.3f} s on the host "
        f"{card}")
    if not p999 < 5e-3 or not mean < limit or not ref.max() > 0.05:
        failures.append(f"cornell fused tree vs oracle: p99.9 {p999}, mean "
                        f"{mean}")


def mesh_fit_phase(dev, card, failures, steps):
    """Phase 18 (e): the mesh-vertex fit of ``FIT_r05_mesh.json``
    (``scripts/meshfit_cpu.py``) on the card: a subdivision-2 icosphere
    (320 triangles) over a ground plane, 16 camera-facing faces dented
    (v0 moved 0.6 x the mean edge along the face normal), 96x96, depth 1,
    ``mesh_verts`` through ``bind_verts`` on the composed path's plain walk
    (``kernel='xla'``, the twin's), ``bvh_pad`` = 2 x the dent,
    chunks of 2304 rays with remat. Held only to a falling loss and a
    falling dented-face normal error."""
    import torch
    from unity_raytracer_tpu_torch.fit import FitConfig, fit
    from unity_raytracer_tpu_torch.models import meshgen
    from unity_raytracer_tpu_torch.models.camera import Camera
    from unity_raytracer_tpu_torch.models.scene import (
        SceneBuilder, make_material)
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.render import render, resolve_mode
    from unity_raytracer_tpu_torch.utils.config import RenderConfig

    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=2.0, center=(0, 2, 8))
    b.add_mesh(v, f, make_material(diffuse=(0.7, 0.5, 0.2),
                                   ambient=(0.7, 0.5, 0.2),
                                   specular=(0.4, 0.4, 0.4), phong=30.0))
    g = 30.0
    gmat = make_material(diffuse=(0.5, 0.5, 0.55), ambient=(0.5, 0.5, 0.55),
                         phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 9, 2), 900.0)
    b.set_ambient((8, 8, 8))
    scene = b.build(device=dev)
    cam = Camera.make(position=(0, 2.5, 2), forward=(0, -0.05, 1), dist=1.0,
                      half_h=0.5, half_v=0.5, width=96, height=96,
                      device=dev)
    true_v = scene.meshes.verts.cpu().numpy()
    valid = scene.meshes.valid.cpu().numpy()
    edge = np.linalg.norm(true_v[:, 1] - true_v[:, 0], axis=1)
    amp = 0.6 * float(edge[valid].mean())
    cfg = resolve_mode(scene, RenderConfig(
        max_bounces=1, background=(0.04, 0.05, 0.07), use_bvh=True,
        mode="scan", kernel="xla", block_size=8, ray_chunk=96 * 96 // 4,
        remat=True, bvh_pad=2.0 * amp))
    bvh = bvhmod.prepare_bvh(scene, cfg)
    target = render(scene, cam, cfg, bvh=bvh)
    cent = true_v.mean(axis=1)
    to_cam = cam.position.cpu().numpy() - cent
    to_cam /= np.maximum(np.linalg.norm(to_cam, axis=1, keepdims=True), 1e-9)
    nrm = scene.meshes.normals.cpu().numpy()
    facing = np.argsort(-(nrm * to_cam).sum(axis=1) * valid)[:16]
    dent = np.zeros_like(true_v)
    dent[facing, 0, :] = amp * nrm[facing]
    start = true_v + dent
    fcfg = FitConfig(param_names=("mesh_verts",), learning_rate=0.035 * amp,
                     steps=steps, soft_shadow_temp=1.0, soft_hit_temp=0.05,
                     log_every=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(scene, cam, cfg, target, fcfg,
              init_params={"mesh_verts": torch.as_tensor(start, device=dev)},
              bvh=bvh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def face_normals(vv):
        n = -np.cross(vv[:, 2] - vv[:, 0], vv[:, 1] - vv[:, 0])
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    def normal_err(verts):
        """1 - cos of the angle to the true normal, mean over the dents."""
        return float((1 - (face_normals(verts[facing])
                           * face_normals(true_v[facing])).sum(1)).mean())

    e0 = normal_err(start)
    e1 = normal_err(res.params["mesh_verts"].detach().cpu().numpy())
    l0, l1 = float(res.losses[0]), float(res.losses[-1])
    log(f"phase 18 (e): mesh-vertex fit (FIT_r05_mesh.json's scenario) "
        f"{steps} steps in {wall:.3f} s ({wall / steps * 1e3:.1f} ms per "
        f"step): loss {l0:.6g} -> {l1:.6g} (ratio {l1 / l0:.4f}), dented-"
        f"face normal error {e0:.4f} -> {e1:.4f} (the CPU artifact, 500 "
        f"steps: 0.175 -> 0.073, loss 2.028e-05 -> 6.063e-06) {card}")
    if not (l1 < l0 and e1 < e0):
        failures.append(f"mesh fit: loss {l0} -> {l1}, normal error "
                        f"{e0} -> {e1}")


def rest_phase(dev, card, failures, scene, cam, cfg, packed,
               fit_steps=MESH_FIT_STEPS):
    """Phase 18 (module docstring). Returns ``{kernels-line row: {call:
    launches}}`` for the launches of #1 and #4 it makes."""
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3

    per_call = {}

    def counts():
        c = {"mega_segment/forward": mega.route_launches["forward",
                                                         "bw/wide4"],
             "mega_segment/forward/mt/wide4": mega.route_launches[
                 "forward", "mt/wide4"],
             "mega_segment/fork/meshless": mega.route_launches["fork",
                                                               "meshless"]}
        c.update({WALKS[k][0]: n for k, n in m3.launches.items()})
        return c

    def counted(call, fn, row):
        """One call with the counts set to 0 just before it and read just
        after; it must launch the kernel of ``row``."""
        torch.cuda.synchronize()
        reset_mega_counts()
        for k in m3.launches:
            m3.launches[k] = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: n for k, n in counts().items() if n}
        for k, n in got.items():
            per_call.setdefault(k, {})[call] = n
        log(f"phase 18 {call}: launches {got}")
        if row not in got:
            failures.append(f"phase 18 {call}: no launch of {row}")
        return out

    t0 = time.perf_counter()
    presplit_frames(dev, card, failures, scene, cam, cfg, packed, counted)
    debug_maps_phase(dev, card, failures, scene, cam, packed, counted)
    profiling_phase(dev, card, failures, scene, cam, cfg, packed)
    oracle_phase(dev, card, failures, counted)
    mesh_fit_phase(dev, card, failures, fit_steps)
    log(f"phase 18: {time.perf_counter() - t0:.3f} s wall")
    return per_call


def fma_sass(path):
    """FP32 multiply-add instructions of ``fma_chain_kernel`` in the built
    library's SASS (``cuobjdump -sass``, which ships with the ``nvcc``
    that built it): ``{'FFMA': n, 'FMUL': n, 'FADD': n}``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise FileNotFoundError(f"no cuobjdump beside nvcc ({tool})")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    body = next((part for part in sass.split("Function : ")[1:]
                 if part.split("\n", 1)[0].find("fma_chain_kernel") >= 0),
                "")
    return {op: len(re.findall(rf"\b{op}\b", body))
            for op in ("FFMA", "FMUL", "FADD")}


def probe_phase(dev, card, failures):
    """Phase 19 (a): the probes' main path (``scripts/torch_probes.
    run_probes``, counts set to 0 just before it and read just after),
    then each kernel against its plain version on seeded inputs (the dead
    kernels bit for bit on every lane of every tile, ``fma_chain`` on
    ``FMA_CHECK_ROWS`` rows at rtol ``FMA_RTOL``); the dead kernels' plain
    versions timed as the probes are (``torch_probes.time_launches``: over
    a ring of inputs beyond the L2, queued behind a spin kernel), and
    ``torch.mul`` per tile from the probe run (``torch_mul_tile*``).
    Returns the four kernels-line rows (``launches``: the probe run's;
    ``fma_chain``'s is set by the caller from phase 19 (b))."""
    import torch
    from scripts.torch_probes import dead_ring, run_probes, time_launches
    from unity_raytracer_tpu_torch.ops.kernels import _lib
    from unity_raytracer_tpu_torch.utils import probes

    for k in probes.launches:
        probes.launches[k] = 0
    recs = {r["step"]: r for r in run_probes(
        dev, lambda r: log(f"phase 19 (a) probe {json.dumps(r)}"))}
    torch.cuda.synchronize()
    launched = dict(probes.launches)
    log(f"phase 19 (a) probe launches {launched}")
    for k, n in launched.items():
        if not n:
            failures.append(f"probe run made no {k} launch")

    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal(probes.PROBE_N).astype(
        np.float32)).to(dev)
    nodes, tris = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev) for s in probes.TABLE_SHAPES)
    tables = lambda xp: probes.dead_tables_plain(xp, nodes, tris)
    steps = {"dead_tables": [(f"pallas_repblocks_tile{t}", t,
                              lambda xp, t=t: probes.dead_tables(
                                  xp, nodes, tris, t), tables)
                             for t in probes.TILES],
             "dead_nob": [(f"pallas_noblocks_tile{t}", t,
                           lambda xp, t=t: probes.dead_nob(xp, t),
                           probes.dead_nob_plain)
                          for t in probes.TILES],
             "dead_persistent": [("pallas_repblocks_tile1024_arbitrary",
                                  probes.PERSISTENT_TILE,
                                  lambda xp: probes.dead_persistent(
                                      xp, nodes, tris), tables)]}
    rows = {}
    for name, runs in steps.items():
        off = lanes = 0
        plain_ms = lib_ms = err = 0.0
        tile_lib = {}
        for step, tile, kernel, plain in runs:
            ring = dead_ring(x, tile)
            xp = ring[0][0]
            if name == "dead_nob":
                tile_lib[step] = recs[f"torch_mul_tile{tile}"]["time_s"] * 1e3
                lib_ms += tile_lib[step]
            got, want = kernel(xp), plain(xp)
            n_off = int((got.view(torch.int32) != want.view(torch.int32))
                        .sum())
            off, lanes = off + n_off, lanes + xp.shape[0]
            err = max(err, float((got - want).abs().max()))
            plain_ms += time_launches(plain, ring)[1] * 1e3
            del ring, got, want
        if off:
            failures.append(f"{name}: {off} of {lanes} lanes differ from "
                            f"the plain version")
        sel = [recs[step] for step, *_ in runs]
        ms = sum(r["time_s"] for r in sel) * 1e3
        b = sum(r["bound_s"] for r in sel) * 1e3
        rows[name] = dict(
            name=f"probe_{name}", route="cuda", source=PROBES_SRC,
            replaces=PROBE_REPLACES[name], launches=launched[name],
            max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b, bound_by="bytes",
            library_ms=lib_ms if name == "dead_nob" else None,
            steps={step: dict(tile=tile, grid=recs[step]["grid"],
                              threads=recs[step]["threads"],
                              words_per_thread=recs[step].get(
                                  "words_per_thread"),
                              tiles_per_block=recs[step].get(
                                  "tiles_per_block"),
                              ms=recs[step]["time_s"] * 1e3,
                              host_ms=recs[step]["host_s"] * 1e3,
                              bound_ms=recs[step]["bound_s"] * 1e3,
                              library_ms=tile_lib.get(step))
                   for step, tile, *_ in runs})
        lib = lambda step: (f", torch.mul {tile_lib[step]:.4f} ms"
                            if step in tile_lib else "")
        words = lambda r: (f" ({r['words_per_thread']} float4 words a "
                           f"thread, {r['tiles_per_block'][0]} / "
                           f"{r['tiles_per_block'][1]} tiles a block)"
                           if "words_per_thread" in r else "")
        log(f"phase 19 (a) {name}: {off} of {lanes} lanes off the plain "
            f"version (bit for bit, {len(runs)} tile(s)); "
            + "; ".join(f"{step} {recs[step]['time_s'] * 1e3:.4f} ms "
                        f"device, {recs[step]['host_s'] * 1e3:.4f} ms host "
                        f"per launch{lib(step)}, {recs[step]['grid']} "
                        f"blocks of {recs[step]['threads']} threads"
                        f"{words(recs[step])}, bound "
                        f"{recs[step]['bound_s'] * 1e3:.4f} ms (bytes)"
                        for step, *_ in runs)
            + f"; plain {plain_ms:.4f} ms summed {card}")

    # the FMA chain: kernel vs plain on FMA_CHECK_ROWS rows, SASS, times
    xf = torch.from_numpy(rng.uniform(0.5, 1.5, (
        FMA_CHECK_ROWS, probes.FMA_SHAPE[1])).astype(np.float32)).to(dev)
    got, want = probes.fma_chain(xf), probes.fma_chain_plain(xf)
    n_bad = int((~torch.isclose(got, want, rtol=FMA_RTOL, atol=0)).sum())
    err = float((got - want).abs().max())
    same = float((got == want).double().mean())
    if n_bad:
        failures.append(f"fma_chain: {n_bad} of {got.numel()} values "
                        f"outside rtol {FMA_RTOL}")
    sass = fma_sass(_lib.probes_lib().build["path"])
    if not sass["FFMA"] or sass["FMUL"]:
        failures.append(f"fma_chain_kernel SASS is not a fused chain: "
                        f"{sass}")
    full = torch.ones(probes.FMA_SHAPE, dtype=torch.float32, device=dev)
    plain_ms = events_ms(lambda: probes.fma_chain_plain(full), 1)
    del full
    r = recs["vpu_fma"]
    log(f"phase 19 (a) fma_chain: {n_bad} of {got.numel()} values outside "
        f"rtol {FMA_RTOL} ({same:.6f} bit for bit), max abs err {err:.3g}; "
        f"SASS of fma_chain_kernel {sass}; "
        f"{r['time_s'] * 1e3:.4f} ms per launch ({r['tflops']:.2f} "
        f"TFLOP/s, host {r['host_s'] * 1e3:.4f} ms), bound "
        f"{r['bound_s'] * 1e3:.4f} ms (operations); plain "
        f"{plain_ms:.1f} ms {card}")
    rows["fma_chain"] = dict(
        name="probe_fma_chain", route="cuda", source=PROBES_SRC,
        replaces=PROBE_REPLACES["fma_chain"], launches=0,
        probe_launches=launched["fma_chain"], max_abs_err=err,
        ms=r["time_s"] * 1e3, plain_ms=plain_ms, bound_ms=r["bound_s"] * 1e3,
        bound_by="operations", library_ms=None, tflops=r["tflops"],
        host_ms=r["host_s"] * 1e3, sass=sass)
    return rows


def bench_phase(dev, card, failures, frame, frame_ms, stats_live):
    """Phase 19 (b)-(d): the port's bench at full size. ``frame`` renders
    phase 4's fused flagship frame, whose time ``frame_ms`` phase 4 read;
    it is timed again the same way just before (b), and (b)'s ``frame_s``
    is held to that time: the frame is host-bound (48-73% busy), so a time
    taken minutes earlier can differ by more than the tolerance. Returns
    the launches of (b)'s call (counts set to 0 just before it) per
    kernels-line row."""
    import torch
    from unity_raytracer_tpu_torch import bench
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    from unity_raytracer_tpu_torch.utils import probes

    # ---- (b) run_once on the flagship, with gradients
    ref_ms = events_ms(frame, 3, 2)
    torch.cuda.synchronize()
    reset_mega_counts()
    for counts in (m3.launches, probes.launches):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    r = bench.run_once(BENCH_PRESET, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {
        "mega_segment/forward": mega.route_launches["forward", "bw/wide4"],
        "mega_segment/record": mega.route_launches["record", "bw/wide4"],
        "mega_segment/record_soft": mega.route_launches["record_soft",
                                                        "bw/wide4"],
        "traverse_packet4": m3.launches["mk4"],
        "probe_fma_chain": probes.launches["fma_chain"]}
    log(f"phase 19 (b) bench.run_once({BENCH_PRESET!r}): {json.dumps(r)}; "
        f"{wall:.3f} s wall {card}")
    log(f"phase 19 (b) launches in the call: {launched}")
    for k, n in launched.items():
        if not n:
            failures.append(f"bench.run_once made no {k} launch")
    missing = [k for k in TWIN_RECORD_KEYS if k not in r]
    timed = [k for k in r if k.endswith("_s") or "per_s" in k]
    bad = [k for k in timed if r[k] is None or not math.isfinite(r[k])
           or r[k] <= 0]
    fracs = {k: v for k, v in r.items() if k.startswith("fraction_")}
    over = [k for k, v in fracs.items() if v is None or not v <= 1.05]
    ratio = r["frame_s"] * 1e3 / ref_ms
    log(f"phase 19 (b) checks: missing keys {missing}; times and rates not "
        f"finite or not > 0: {bad}; fractions {fracs} (above 1.05 or null: "
        f"{over}); rays_issued {r['rays_issued']} (want {BENCH_RAYS}); "
        f"rays_live {r['rays_live']} (phase 9: {stats_live}); frame_s "
        f"{r['frame_s'] * 1e3:.3f} ms vs phase 4's frame timed just before "
        f"{ref_ms:.3f} ms (x{ratio:.3f}; phase 4 read {frame_ms:.3f} ms)")
    if missing or bad or over:
        failures.append(f"bench record: missing {missing}, bad {bad}, "
                        f"fractions {over}")
    if r["rays_issued"] != BENCH_RAYS or r["rays_live"] != stats_live:
        failures.append(f"bench rays: issued {r['rays_issued']}, live "
                        f"{r['rays_live']} vs phase 9's {stats_live}")
    if not 1 / 1.5 <= ratio <= 1.5:
        failures.append(f"bench frame_s {r['frame_s']} vs phase 4's "
                        f"frame {ref_ms} ms")

    # ---- (c) the --all presets, no gradients; the tree loses no lane
    for p in bench.ALL_PRESETS:
        rp_ = bench.run_once(p, repeats=2, grad=False, device=dev)
        log(f"phase 19 (c) bench.run_once({p!r}, grad=False): "
            f"{json.dumps(rp_)} {card}")
        if not (math.isfinite(rp_["frame_s"]) and rp_["frame_s"] > 0):
            failures.append(f"bench {p}: frame_s {rp_['frame_s']}")
        if p == "cornell_box" and rp_["tree_truncated"] != 0:
            failures.append(f"bench cornell_box: {rp_['tree_truncated']} "
                            f"truncated lanes")

    # ---- (d) run_sharded as the CLI's `bench --sharded` runs it (a spawned
    # one-rank NCCL group, the row back through a file), then on phase 17's
    # one-rank group joined by this process
    torch.cuda.empty_cache()
    for how, group in (("spawned rank", contextlib.nullcontext()),
                       ("joined group", one_rank_group())):
        t0 = time.perf_counter()
        with group:
            out = bench.run_sharded(BENCH_PRESET, counts=(1,), device=dev)
        log(f"phase 19 (d) bench.run_sharded({BENCH_PRESET!r}, counts=(1,)) "
            f"on a {how}: {json.dumps(out)}; "
            f"{time.perf_counter() - t0:.3f} s wall {card}")
        rows = out["table"]
        if [x["devices"] for x in rows] != [1] \
                or rows[0]["efficiency"] != 1.0:
            failures.append(f"run_sharded on a {how}: rows {rows}")
    return launched


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
    from unity_raytracer_tpu_torch.utils.profiling import (
        OPS_PER_TEST, nvidia_smi)

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
    for entry, v in sorted(entries(libs["probes"].build["log"]).items()):
        what = re.search(r"([a-z_]+_kernel)E", entry)
        log(f"  ptxas: probes {what.group(1) if what else entry}: "
            f"{v.get('registers')} registers, {v.get('stack')} bytes stack, "
            f"{v.get('spill')} bytes spill")
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
        sl = live_slice(ins, SLICE)
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
    frame_ms = events_ms(lambda: render_frame(scene, cam, cfg_m, packed),
                         3, 2)
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
    walk_rows, stats_live = composed_phases(
        dev, card, failures, scene, cam, cfg, packed, packed8, fused_img,
        fused_live, issued, names)
    # ---- the tree and mode (e): phases 13-16 ---------------------------------
    new_rows = tree_phases(dev, card, failures)
    new_rows += mode_e_phases(dev, card, failures, scene, cam, cfg, packed,
                              packed8, slice_segs, fused_img, frame_ms)
    # ---- the multi-device layer at world size 1: phase 17 --------------------
    sharded = parallel_phase(dev, card, failures, scene, cam, cfg, packed)
    # ---- the port's last modules: phase 18 ------------------------------------
    rest = rest_phase(dev, card, failures, scene, cam, cfg, packed)
    # ---- the probes and the bench: phase 19 ---------------------------------
    t19 = time.perf_counter()
    probe_rows = probe_phase(dev, card, failures)
    bench_launches = bench_phase(
        dev, card, failures, lambda: render_frame(scene, cam, cfg_m, packed),
        frame_ms, stats_live)
    probe_rows["fma_chain"]["launches"] = bench_launches.pop(
        "probe_fma_chain")
    log(f"phase 19: {time.perf_counter() - t19:.3f} s wall")
    # ---- corner-, edge- and box-aimed rays (Queue C #14, #15): phase 20 -----
    corner_phase(dev, card, failures, scene, cfg, packed, packed8)
    box_phase(dev, card, failures, scene, cfg, packed, packed8)
    # ---- the single-device entry (Queue A #16): phase 21 --------------------
    entry_launches = entry_phase(dev, card, failures)
    # ---- the BVH refit of a mesh-geometry fit: phase 22 --------------------
    refit_row = refit_phase(dev, card, failures)
    # ---- the fused frame as one CUDA graph replay: phase 23 ---------------
    frame_graph_phase(dev, card, failures)
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
    rows = (kernels + walk_rows + new_rows + list(probe_rows.values())
            + [refit_row])
    for row in rows:  # launches per call of phases 17, 18 and 19 (b)
        if row["name"] in sharded:
            row["sharded_launches"] = sharded[row["name"]]
        if row["name"] in rest:
            row["phase18_launches"] = rest[row["name"]]
        if row["name"] in bench_launches:
            row["bench_launches"] = bench_launches[row["name"]]
        if row["name"] == WALKS["mk4"][0]:
            row["entry_launches"] = entry_launches
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
