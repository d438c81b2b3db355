#!/usr/bin/env python3
"""Smoke run of the PyTorch port (unity_raytracer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, it

1. prints the card (``nvidia-smi`` name and power limit), the PyTorch and
   CUDA versions and the ``nvcc`` path;
2. builds the port's native libraries from the checkout's sources (the
   BVH builder and the fused segment kernel) and times the build;
3. holds the fused segment kernel against its plain PyTorch version on
   the same inputs: every segment of the ``mesh10k`` chain at 256x256,
   then a 16,384-ray slice of every segment of the flagship frame; it
   fails if more than 0.01% of lanes fall outside rtol = atol = 5e-4;
4. renders the flagship frame (``mesh100k``, 1920x1080, 4 bounces) the
   way ``python -m unity_raytracer_tpu_torch render`` does, checks that
   the frame went through 5 kernel launches with no stack overflow and
   is finite and not flat, then times 1 warm-up + 3 frames with CUDA
   events, times each of the 5 launches alone, and profiles one frame;
5. renders a small ``mesh10k`` frame on the card and with the plain
   version on the CPU and compares the two images.

Any failure raises and the exit code is not 0. The last two lines are
the ``nvidia-smi`` name/power-limit line and
``{"ok": true, "device": {...}}``; the line before them is the JSON
record of the kernel. Without a CUDA card, or without the package beside
this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

TOL = dict(rtol=5e-4, atol=5e-4)
MAX_BAD_FRACTION = 1e-4   # lanes outside TOL: FMA contraction / visit order
SLICE = 16384
KERNEL_SRC = "unity_raytracer_tpu_torch/csrc/mega_segment.cu"
REPLACES = "unity_raytracer_tpu/ops/pallas/mega.py:459"


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels import _lib, mega
    from unity_raytracer_tpu_torch.ops.render import (
        check_supported, render, render_frame, resolve_mode)

    dev = torch.device("cuda:0")
    smi = nvidia_smi("name,power.limit")
    card = f"[{smi}]"
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_bvh = _lib.bvh_lib()
    lib_mega = _lib.mega_lib()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s total (bvh {lib_bvh.build['seconds']:.3f} "
        f"s, mega {lib_mega.build['seconds']:.3f} s) {card}")
    for line in lib_mega.build["log"].splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas: {line.strip()}")

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

    def events_ms(fn, repeats):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(repeats):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / repeats

    max_err, bad_total, lanes_total = 0.0, 0, 0
    failures = []  # checks that failed; raised after every phase has run

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
    for depth, ins in enumerate(chain_inputs(scene, cam, cfg, packed, aux)):
        live_idx = torch.nonzero(ins[3] >= 0).squeeze(1)
        if live_idx.numel() >= SLICE:
            pick = live_idx[torch.linspace(0, live_idx.numel() - 1, SLICE,
                                           device=dev).long()]
        else:  # every live lane, topped up with dead ones
            dead_idx = torch.nonzero(ins[3] < 0).squeeze(1)
            pick = torch.cat([live_idx, dead_idx[:SLICE - live_idx.numel()]])
        sl = [x[pick].contiguous() for x in ins]
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
    log(f"kernel vs plain: {bad_total} of {lanes_total} lanes outside "
        f"tolerance, max abs err {max_err:.6g}")

    # ---- the main path: the flagship frame as the CLI renders it ------------
    mega.launches = 0
    img = render(scene, cam, cfg, bvh=packed)
    torch.cuda.synchronize()
    launches = mega.launches
    n_segments = cfg.max_bounces + 1
    if launches != n_segments:
        raise AssertionError(f"frame made {launches} kernel launches, "
                             f"expected {n_segments}")
    if tuple(img.shape) != (cam.height, cam.width, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("image has non-finite values")
    std = float(img.std())
    if std <= 0.01:
        raise AssertionError(f"image std {std} <= 0.01: nothing rendered")
    log(f"mesh100k {cam.width}x{cam.height} depth {cfg.max_bounces}: "
        f"{launches} launches, stack overflow 0, image std {std:.4f}, "
        f"mean {float(img.mean()):.4f}")

    frame_ms = events_ms(lambda: render_frame(scene, cam, cfg, packed), 3)
    # the five launches of one frame alone
    o, d = generate_rays_blocks(cam, cfg.block_size)
    seg_ms = []
    n = o.shape[0]
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    tmax = torch.full((n,), 3.0e38, dtype=torch.float32, device=dev)
    for depth in range(n_segments):
        ms = events_ms(lambda: mega.trace_segment(
            packed, aux, depth, o, d, thr, tmax, **kw), 3)
        seg_ms.append(ms)
        _, o, d, thr, tmax = mega.trace_segment(packed, aux, depth, o, d,
                                                thr, tmax, **kw)
    n_lights = int(scene.lights.valid.sum())
    issued = cam.width * cam.height * n_segments * (1 + n_lights)
    log(f"mesh100k frame: {frame_ms:.3f} ms, {issued / frame_ms * 1e3:.4g} "
        f"issued rays/s ({issued} = pixels x {n_segments} segments x "
        f"(1 + {n_lights} lights)) {card}")
    log(f"fused kernel per frame: {sum(seg_ms):.3f} ms (segments "
        f"{', '.join(f'{m:.3f}' for m in seg_ms)} ms) {card}")
    # where one frame's device time goes (torch.profiler's CUDA trace)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_frame(scene, cam, cfg, packed)
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    ops = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in ops)
    if busy_us > 0:
        log(f"profile of one frame: device busy {busy_us / 1e3:.3f} ms "
            f"= {busy_us / 1e3 / frame_ms:.1%} of the timed frame "
            f"{frame_ms:.3f} ms {card}")
        for e in ops[:8]:
            log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:70]}")
    else:
        log("profile of one frame: no device time recorded (not measured)")
    log(f"clocks/power after timing: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # ---- small frame: card vs the plain version on the CPU ------------------
    s_cpu, c_cpu, cfg_s = get_preset("mesh10k", width=64, height=64)
    img_cpu = render(s_cpu, c_cpu, cfg_s).numpy()
    img_card = render(s_cpu.to(dev), c_cpu.to(dev), cfg_s).cpu().numpy()
    bad_px = int((~np.isclose(img_card, img_cpu, **TOL).all(-1)).sum())
    log(f"mesh10k 64x64 card vs CPU plain: {bad_px} of {64 * 64} pixels "
        f"outside rtol=atol=5e-4, max abs err "
        f"{float(np.abs(img_card - img_cpu).max()):.3g}")
    if bad_px > max(1, MAX_BAD_FRACTION * 64 * 64):
        failures.append("card image disagrees with the CPU image")
    if failures:
        raise AssertionError("; ".join(failures))

    print(json.dumps({"kernels": [{
        "name": "mega_segment", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
