#!/usr/bin/env python3
"""The nearest-triangle kernel's launches on mesh10k; what its cull keeps; SASS.

    python3 scripts/torch_nearest_census.py [--sass LABEL=ROOT ...] \\
        [--memory 128,192,256] [--out build/nearest_census.json]

On a CUDA card. ``nearest_launches`` builds the rays of the
``nearest_triangle`` launches on the ``mesh10k`` scene (10,240
triangles); ``chip_smoke.py`` (phase 11) and ``torch_kernel_ab.py`` take
theirs from it. Two kinds:

* launches of a path: every ``nearest_triangle_pallas`` call of a
  BVH-less ``mesh10k`` frame (``use_bvh=False``, ``kernel='pallas'``) at
  ``FRAMES`` (24x24, 64x64, 128x128), in the order the frame makes
  them. Its shadow rays take the plain ``[N, T]`` brute force of
  ``ops/shade.shadow_min_t``: on an 80 GB H100 a 128x128 frame peaks at
  30.5 GiB, a 192x192 one at 68.6 GiB, and 256x256 runs out of memory;
* proxies, which no path makes today (kept to compare with earlier
  measurements): (i) the whole 1024x1024 primary batch in
  ``generate_rays_blocks`` order (256 consecutive rays: one 32x8 pixel
  tile), (ii) every 16th of its rays, (iii) the live rays of segment 1
  of the 1024x1024 frame with a BVH (the mirror bounces, in lane order),
  (iv) the primary batch in a seeded random permutation.

For each launch the script prints the rays, the blocks, the triangles
kept per block of ``intersect_mk.BLOCK`` rays (mean, max, share of
blocks that keep none), the exact pair tests per ray that the kernel
makes after the cull and the rays that take no part (non-finite or
d = 0), from the plain model of the cull
(``intersect_mk.nearest_triangle_survivors_plain``, run on the card).
``--sass`` builds each ROOT's ``libnearest_tri`` (``ROOT`` holds a
revision's ``unity_raytracer_tpu_torch/``), writes ``cuobjdump -sass``
beside ``--out`` and prints each loop of the kernels (a backward branch):
its instructions, how many are FP32 arithmetic, compares, shared and
global loads. ``--memory`` renders a BVH-less ``mesh10k`` frame of each
size and prints its peak device memory, or that it ran out. Writes every
number to ``--out``. No JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

# BVH-less mesh10k frames whose launches are measured (square, pixels)
FRAMES = (24, 64, 128)


def nearest_launches(dev, frames=FRAMES, proxies=True):
    """``({name: (o, d)}, verts, valid)``: the rays of each launch (module
    docstring) on ``dev``, and the ``mesh10k`` soup. Imports the port's
    package as found on ``sys.path``, so that ``torch_kernel_ab.py`` gets
    each revision's own."""
    import numpy as np
    import torch
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import render as rmod
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk

    scene, cam, cfg = get_preset("mesh10k", device=dev)
    out = {}
    fn, got = imk.nearest_triangle_pallas, []

    def spy_k(o_, d_, *a, **k):
        got.append((o_.detach().clone(), d_.detach().clone()))
        return fn(o_, d_, *a, **k)

    for size in frames:
        s_, c_, f_ = get_preset("mesh10k", width=size, height=size,
                                device=dev)
        got.clear()
        imk.nearest_triangle_pallas = spy_k
        try:
            rmod.render(s_, c_, f_.with_(use_bvh=False, kernel="pallas"))
        finally:
            imk.nearest_triangle_pallas = fn
        for k, x in enumerate(got):
            out[f"{size}x{size} frame, launch {k}"] = x
    if not proxies:
        return out, scene.meshes.verts, scene.meshes.valid
    o, d = generate_rays_blocks(cam, cfg.block_size)
    out["(i) proxy: 1024x1024 primary"] = (o, d)
    out["(ii) proxy: every 16th primary ray"] = (o[::16].contiguous(),
                                                 d[::16].contiguous())
    seen, seg = [], rmod._segment

    def spy(scene_, cfg_, bvh, depth, o_, d_, thr, active, *a):
        seen.append((o_, d_, active))
        return seg(scene_, cfg_, bvh, depth, o_, d_, thr, active, *a)

    rmod._segment = spy
    try:
        rmod.render(scene, cam, cfg.with_(kernel="pallas"))
    finally:
        rmod._segment = seg
    o1, d1, act = seen[1]
    out["(iii) proxy: segment-1 bounces"] = (o1[act].contiguous(),
                                             d1[act].contiguous())
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        o.shape[0])).to(dev)
    out["(iv) proxy: shuffled primary"] = (o[perm].contiguous(),
                                           d[perm].contiguous())
    return out, scene.meshes.verts, scene.meshes.valid


def frame_memory(dev, size):
    """Peak device memory in GiB of one BVH-less ``mesh10k`` frame of
    ``size`` x ``size`` on ``dev``, or None where it runs out."""
    import torch
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops.render import render
    torch.cuda.init()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    scene, cam, cfg = get_preset("mesh10k", width=size, height=size,
                                 device=dev)
    try:
        render(scene, cam, cfg.with_(use_bvh=False, kernel="pallas"))
        torch.cuda.synchronize(dev)
    except torch.cuda.OutOfMemoryError:
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def counts(keep, part, n):
    import torch
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk
    kept = keep.sum(1).double()
    lanes = torch.full_like(kept, imk.BLOCK)
    lanes[-1] = n - imk.BLOCK * (kept.shape[0] - 1)
    return dict(blocks=int(kept.shape[0]), mean=float(kept.mean()),
                max=int(kept.max()), zero_share=float((kept == 0).double()
                                                      .mean()),
                pairs_per_ray=float((kept * lanes).sum() / n),
                no_part=int(part))


def sass(label, root, out_dir):
    """Build ROOT's nearest-triangle library, dump its SASS, return the
    loops of each kernel function."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from unity_raytracer_tpu_torch.ops.kernels import _lib; "
            "print(_lib.nearest_tri_lib()._name)")
    lib = subprocess.run([sys.executable, "-c", code, os.path.abspath(root)],
                         capture_output=True, text=True, check=True,
                         cwd=root).stdout.strip().splitlines()[-1]
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    with open(os.path.join(out_dir, f"sass_{label}.txt"), "w") as f:
        f.write(text)
    loops = []
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        ins = [(int(a, 16), op.strip()) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", fn)]
        at = {a: k for k, (a, _) in enumerate(ins)}
        for k, (a, op) in enumerate(ins):
            tgt = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if not tgt or int(tgt.group(1), 16) not in at \
                    or int(tgt.group(1), 16) >= a:
                continue
            body = [o_.split()[1] if o_.startswith("@") else o_.split()[0]
                    for _, o_ in ins[at[int(tgt.group(1), 16)]:k + 1]]
            kind = lambda pat: sum(bool(re.match(pat, b_)) for b_ in body)
            loops.append(dict(
                function=name, start=hex(ins[at[int(tgt.group(1), 16)]][0]),
                end=hex(a), instructions=len(body),
                fp32=kind(r"(FADD|FMUL|FFMA|FMNMX|MUFU|FCHK)"),
                compares=kind(r"(FSETP|ISETP|FSEL|SEL|PLOP3)"),
                lds=kind(r"LDS"), ldg=kind(r"LDG")))
    return loops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", nargs="*", default=[])
    ap.add_argument("--memory", default="")
    ap.add_argument("--out", default="build/nearest_census.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_nearest_census: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as imk
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    res = {"card": card, "launches": {}, "sass": {}, "memory_gib": {}}
    for size in [int(x) for x in args.memory.split(",") if x]:
        gib = frame_memory(dev, size)
        res["memory_gib"][size] = gib
        print(f"BVH-less mesh10k {size}x{size} frame: "
              + ("out of memory" if gib is None else
                 f"peak {gib:.3f} GiB") + f" [{card}]", flush=True)
    runs, verts, valid = nearest_launches(dev)
    for name, (o, d) in runs.items():
        b = imk.block_bundles(o, d)
        part = int((~b["part"]).sum()) - (b["part"].numel() - o.shape[0])
        cone = counts(imk.nearest_triangle_survivors_plain(o, d, verts,
                                                           valid),
                      part, o.shape[0])
        res["launches"][name] = dict(rays=o.shape[0], cone=cone)
        print(f"{name}: {o.shape[0]} rays, {cone['blocks']} blocks; kept "
              f"per block mean {cone['mean']:.2f}, max {cone['max']}, none "
              f"in {cone['zero_share']:.4f} of blocks, "
              f"{cone['pairs_per_ray']:.2f} exact tests per ray (of "
              f"{verts.shape[0]}), {part} rays take no part [{card}]",
              flush=True)
    for spec in args.sass:
        label, root = spec.split("=", 1)
        loops = sass(label, root, out_dir)
        res["sass"][label] = loops
        for lp in loops:
            print(f"sass {label}: {lp['function'][:60]} loop "
                  f"{lp['start']}-{lp['end']}: {lp['instructions']} "
                  f"instructions, {lp['fp32']} FP32, {lp['compares']} "
                  f"compares/selects, {lp['lds']} LDS, {lp['ldg']} LDG",
                  flush=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
