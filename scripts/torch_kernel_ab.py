#!/usr/bin/env python3
"""Time the port's redesigned kernels against other revisions, in turns, on one card.

    python3 scripts/torch_kernel_ab.py LABEL=ROOT [LABEL=ROOT ...] \\
        [--order 0,1,1,0] [--only nearest] [--device-time] \\
        [--out build/ab.json] [--frames DIR]

Each ROOT is a directory holding a revision's ``unity_raytracer_tpu_torch/``
and ``native/`` (``.`` for this checkout; an earlier commit unpacked with
``git archive REV unity_raytracer_tpu_torch native | tar -x -C DIR``). The
roots run one at a time, each in its own process (``--worker``), in the
order ``--order`` gives (indices into the roots; default: every root, then
the same in reverse, so old, new, new, old for two), so the card's clocks
and neighbours weigh on each alike. A worker builds its root's libraries
into the root's ``build/`` and, on the card, times with CUDA events each
launch alone (1 warm-up + 5):

* the fused segment kernel on the five segments of the ``mesh100k``
  1920x1080 fused frame (4 bounces; segment inputs from the forward
  chain) on Baldwin–Weber BVH4 in modes forward, record and record_soft,
  and forward on Möller–Trumbore BVH4, BVH8 and the binary layout; the
  whole fused frame (``render_frame``, 1 warm-up + 3);
* the fork mode on the five levels of the ``cornell_box`` 512x512 tree
  (meshless);
* the four launches of each BVH walk (mk4, mk3, wide4, wide8) in the
  composed ``mesh100k`` frame;
* the brute-force nearest triangle on ``mesh10k`` (10,240 triangles):
  every launch of the BVH-less 24x24, 64x64 and 128x128 frames, and the
  proxy launches (i)-(iv) that no path makes
  (``scripts/torch_nearest_census.py``, which builds them).

The fused frame is timed as a launch is (1 warm-up + 5, its image
hashed).

``--only`` times some of these families alone (``fused``, ``fork``,
``walks``, ``nearest``; default all). ``--device-time`` also reads each
launch's device busy time (its kernels and memsets in a torch.profiler
trace of 5 calls), which leaves out the host's part of a launch.

Each walk launch and each Baldwin–Weber BVH4 forward segment also runs
once on its counting instance; the summary prints its slab tests (node,
child and group boxes) and leaf-slot tests per label. With ``--frames``
each run writes its fused frame (``render_frame``) to ``DIR`` as .npy,
and the summary counts the pixels of each label's frame that differ from
the first label's (any bit, and outside rtol = atol = 5e-4).

Each launch's outputs are hashed (sha256 of their bytes), so the summary
says whether every root computes the same bits. It prints one line per
measurement (the mean ms of each label over its runs, each label's
ratio to the first label's, equal hashes or not) with the card's name
and power limit, and writes every run's numbers to ``--out``. Needs a
CUDA card; no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPEATS = 5


FAMILIES = ("fused", "fork", "walks", "nearest")


def device_ms(fn) -> float:
    """Mean device busy ms of ``fn`` over REPEATS calls: the kernels and
    memsets in torch.profiler's CUDA trace, host time left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in prof.key_averages()
               if not e.key.startswith("aten::"))
    return busy / 1e3 / REPEATS


def worker(root: str, only=FAMILIES, device_time=False,
           frame_path=None) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import _lib

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    _lib.build_all()
    out = {"root": root, "build_s": time.perf_counter() - t0, "ms": {},
           "device_ms": {}, "hash": {}, "counts": {},
           "frame_path": frame_path}

    def timed(name, fn):
        res = fn()
        h = hashlib.sha256()
        for t in flat(res):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        out["hash"][name] = h.hexdigest()[:16]
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPEATS):
            fn()
        b.record()
        torch.cuda.synchronize()
        out["ms"][name] = a.elapsed_time(b) / REPEATS
        if device_time:
            out["device_ms"][name] = device_ms(fn)

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x for t in flat(y)]

    if "fused" in only or "walks" in only:
        mesh100k(dev, only, timed, out)
    if "fork" in only:
        fork_levels(dev, timed)
    if "nearest" in only:
        nearest(dev, timed)
    return out


def mesh100k(dev, only, timed, out):
    """The fused kernel's segments and frame, and the walks, on the
    mesh100k 1920x1080 frame."""
    import torch
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    from unity_raytracer_tpu_torch.ops.render import resolve_mode
    counters = getattr(m3, "new_counters",
                       lambda d: torch.zeros(1, dtype=torch.int32, device=d))
    scene, cam, cfg = get_preset("mesh100k", device=dev)
    cfg = resolve_mode(scene, cfg)
    aux = mega.build_aux(scene, cfg.background)
    kw = dict(n_lights=scene.lights.positions.shape[0],
              n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
              max_bounces=cfg.max_bounces, light_cull=cfg.light_cull)
    packs = {"bw/wide4": (bvhmod.prepare_bvh(scene, cfg, dev), "bw", 4)}
    packs["mt/wide4"] = (packs["bw/wide4"][0], "mt", 4)
    packs["mt/wide8"] = (bvhmod.prepare_bvh(
        scene, cfg.with_(bvh_arity=8), dev), "mt", 8)
    packs["mt/binary"] = (bvhmod.prepare_bvh(
        scene, cfg.with_(bvh_arity=0), dev), "mt", 0)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    n = o.shape[0]
    ins = (o, d, torch.ones((n, 3), device=dev),
           torch.full((n,), 3.0e38, device=dev))
    segs = []
    pk4 = packs["bw/wide4"][0]
    for depth in range(cfg.max_bounces + 1):
        segs.append((depth, ins))
        ins = mega.trace_segment(pk4, aux, depth, *ins, **kw)[1:5]
    ctl = counters(dev)
    if "fused" in only:
        fused(scene, cam, cfg, aux, kw, packs, segs, m3, ctl, timed, out)
    if "walks" in only:
        walks(scene, cam, cfg, pk4, packs["mt/wide8"][0], m3, ctl, timed,
              out)


def fused(scene, cam, cfg, aux, kw, packs, segs, m3, ctl, timed, out):
    """The fused kernel on each segment and the fused frame."""
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.render import render_frame
    pk4 = packs["bw/wide4"][0]
    modes = {"forward": {}, "record": dict(record=True),
             "record_soft": dict(record_soft=True)}
    for route, (pk, isect, arity) in packs.items():
        for mode, mkw in modes.items():
            if route != "bw/wide4" and mode != "forward":
                continue
            for depth, x in segs:
                timed(f"fused {route} {mode} segment {depth}",
                      lambda: mega.trace_segment(
                          pk, aux, depth, *x, tri_isect=isect,
                          use_wide=arity != 0, overflow=ctl, **mkw, **kw))
    m3.check_overflow(ctl)
    for depth, x in segs:
        c = torch.zeros(len(mega.COUNTS), dtype=torch.int64,
                        device=aux.device)
        mega.trace_segment(pk4, aux, depth, *x, counts=c, **kw)
        out["counts"][f"fused bw/wide4 forward segment {depth}"] = dict(
            zip(mega.COUNTS, c.tolist()))
    cfg_m = cfg.with_(kernel="mega")
    frame = lambda: render_frame(scene, cam, cfg_m, pk4)
    if out["frame_path"]:
        import numpy as np
        np.save(out["frame_path"], frame().cpu().numpy())
    timed("fused frame bw/wide4 (render_frame)", frame)


def fork_levels(dev, timed):
    """The fork mode on the cornell_box 512x512 tree's levels."""
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.render import (resolve_mode,
                                                      trace_radiance)
    cs, cc, ccfg = get_preset("cornell_box", device=dev)
    ccfg = resolve_mode(cs, ccfg)
    caux = mega.build_aux(cs, ccfg.background)
    ckw = dict(n_lights=cs.lights.positions.shape[0],
               n_spheres=cs.spheres.count, n_tris=cs.triangles.count,
               max_bounces=ccfg.max_bounces, fork=True, has_mesh=False,
               tri_isect="mt")
    levels, seg = [], mega.trace_segment

    def spy(packed, aux_, depth, *x, **k):
        levels.append((depth, x[:4]))
        return seg(packed, aux_, depth, *x, **k)

    mega.trace_segment = spy
    try:
        co, cd = generate_rays_blocks(cc, ccfg.block_size)
        trace_radiance(cs, co, cd, ccfg.with_(kernel="mega"))
    finally:
        mega.trace_segment = seg
    for depth, x in levels:
        timed(f"fork meshless cornell level {depth}",
              lambda: mega.trace_segment(None, caux, depth, *x, **ckw))


def walks(scene, cam, cfg, pk4, pk8, m3, ctl, timed, out):
    """The four launches of each walk in the composed mesh100k frame,
    each also counted once."""
    import torch
    from unity_raytracer_tpu_torch.ops.render import render_frame
    walk_raw = m3.walk_raw
    for layout, kernel, pk in (("mk4", "pallas", pk4), ("mk3", "pallas3", pk4),
                               ("wide4", "wide", pk4),
                               ("wide8", "wide", pk8)):
        seen = []

        def spy_walk(lay, packed, o_, d_, tmax, any_hit=False, **k):
            seen.append((o_, d_, tmax, any_hit))
            return walk_raw(lay, packed, o_, d_, tmax, any_hit, **k)

        m3.walk_raw = spy_walk
        try:
            render_frame(scene, cam, cfg.with_(kernel=kernel), pk)
        finally:
            m3.walk_raw = walk_raw
        rows = (pk.nodes if layout in ("mk3", "mk4") else pk.wide).shape[0]
        for k, x in enumerate(seen):
            timed(f"walk {layout} frame launch {k}",
                  lambda: walk_raw(layout, pk, *x, overflow=ctl))
            c = torch.zeros(len(m3.COUNTS), dtype=torch.int64,
                            device=pk.tris.device)
            walk_raw(layout, pk, *x, counts=c, seen=tuple(
                torch.zeros(r, dtype=torch.uint8, device=pk.tris.device)
                for r in (rows, pk.tris.shape[0] * m3.PALLAS_LEAF)))
            out["counts"][f"walk {layout} frame launch {k}"] = dict(
                zip(m3.COUNTS, c.tolist()))
    m3.check_overflow(ctl)


def nearest(dev, timed):
    """The nearest-triangle launches on mesh10k
    (``torch_nearest_census.nearest_launches``)."""
    from torch_nearest_census import nearest_launches
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk
    runs, verts, valid = nearest_launches(dev)
    for name, (lo, ld) in runs.items():
        timed(f"nearest_triangle {name}",
              lambda: imk.nearest_triangle_pallas(lo, ld, verts, valid))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--order", default=None)
    ap.add_argument("--out", default="build/ab.json")
    ap.add_argument("--worker", default=None)
    ap.add_argument("--only", default=",".join(FAMILIES))
    ap.add_argument("--device-time", action="store_true")
    ap.add_argument("--frames", default=None)
    ap.add_argument("--frame-path", default=None)
    args = ap.parse_args(argv)
    only = tuple(args.only.split(","))
    if args.worker is not None:
        print("AB " + json.dumps(worker(args.worker, only, args.device_time,
                                        args.frame_path)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    labels = [r.split("=", 1) for r in args.roots]
    order = ([int(k) for k in args.order.split(",")] if args.order else
             list(range(len(labels))) + list(range(len(labels)))[::-1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for k in order:
        label, root = labels[k]
        t0 = time.perf_counter()
        frame = [] if not args.frames else [
            "--frame-path", os.path.join(os.path.abspath(args.frames),
                                         f"frame_{label}_{len(runs)}.npy")]
        if frame:
            os.makedirs(args.frames, exist_ok=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", root, "--only", args.only]
                              + ["--device-time"] * args.device_time + frame,
                              capture_output=True, text=True, timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode or not line:
            print(f"{label} ({root}) failed:\n{proc.stdout[-4000:]}"
                  f"{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        res = json.loads(line[0][3:])
        res["label"] = label
        runs.append(res)
        print(f"run {len(runs)}: {label} in {time.perf_counter() - t0:.1f} s "
              f"(build {res['build_s']:.1f} s)", flush=True)
    names = list(runs[0]["ms"])
    first = labels[0][0]
    summary = {}
    print(f"mean ms per label over its runs [{card}]; x = ratio to {first}; "
          f"'same' = output bits equal to {first}'s")
    for name in names:
        row = {}
        for label, _ in labels:
            ms = [r["ms"][name] for r in runs if r["label"] == label]
            row[label] = sum(ms) / len(ms)
        ref = next(r["hash"].get(name) for r in runs if r["label"] == first)
        same = {label: all(r["hash"].get(name) == ref for r in runs
                           if r["label"] == label) for label, _ in labels}
        dev = {label: sum(r["device_ms"].get(name, float("nan"))
                          for r in runs
                          if r["label"] == label)
               / sum(r["label"] == label for r in runs)
               for label, _ in labels} if args.device_time else {}
        summary[name] = dict(ms=row, same=same, device_ms=dev)
        print(f"  {name}: " + ", ".join(
            f"{label} {row[label]:.4f} ms (x{row[label] / row[first]:.3f}"
            + (f"; device {dev[label]:.4f} ms" if dev else "")
            + f"{'' if same[label] else ', BITS DIFFER'})"
            for label, _ in labels))
    for name in runs[0]["counts"]:
        row = {label: next(r["counts"][name] for r in runs
                           if r["label"] == label) for label, _ in labels}
        ref = row[first]
        print(f"  counts {name}: " + ", ".join(
            f"{label} slab {c['slab']} (x{c['slab'] / max(ref['slab'], 1):.4f})"
            + "".join(f", {k} {c[k]}" for k in ("mt", "bw_slot", "groups",
                                                "nearest_groups",
                                                "shadow_groups") if k in c)
            for label, c in row.items()))
    frames = [(r["label"], r["frame_path"]) for r in runs
              if r.get("frame_path")]
    if frames:
        import numpy as np
        ref = np.load(next(p for lab, p in frames if lab == first))
        for label, path in frames:
            img = np.load(path)
            px = (img != ref).any(-1)
            far = ~np.isclose(img, ref, rtol=5e-4, atol=5e-4).all(-1)
            summary.setdefault("frames", {})[path] = dict(
                label=label, pixels_differ=int(px.sum()),
                pixels_outside_tol=int(far.sum()))
            print(f"  fused frame {os.path.basename(path)}: {int(px.sum())} "
                  f"of {px.size} pixels differ from {first}'s first frame, "
                  f"{int(far.sum())} outside rtol = atol = 5e-4, max abs "
                  f"diff {float(np.abs(img - ref).max()):.4g}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, order=[labels[k][0] for k in order],
                       runs=runs, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
