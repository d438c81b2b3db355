#!/usr/bin/env python3
"""Dispatched tensor operations per call of the port's gated paths, on the CPU.

    python3 scripts/torch_dispatch_counts.py [ROOT]

ROOT (default: this checkout) holds a revision's
``unity_raytracer_tpu_torch/`` and ``native/`` (an earlier commit
unpacked with ``git archive REV unity_raytracer_tpu_torch native``). On
``mesh10k`` at 16x16, depth 2, it counts the aten operations each call
dispatches that are not views (a ``TorchDispatchMode``): ``build_aux``,
``nearest_hit`` and ``shadow_min_t`` on the packed walk ('pallas') and
the plain walk ('xla'), the composed frame on each, the fused frame's
plain version, ``parallel/shard._fold_rest`` and the soft replay with
its bias diagnostics at 1, 2 and 3 live segments and without them.
Off the CPU each counted operation is at most one kernel launch, and
views launch none, so two revisions' counts compare their launches
without a card (the plain versions of the walks add their own
operations alike). Prints one JSON line. No JAX.
"""

from __future__ import annotations

import json
import pathlib
import sys


def main() -> None:
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                        pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops import intersect as isect
    from unity_raytracer_tpu_torch.ops import replay as rp
    from unity_raytracer_tpu_torch.ops import shade
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.render import trace_radiance
    from unity_raytracer_tpu_torch.parallel import shard

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func.__name__ != "detach.default":
                self.n += 1
            return func(*args, **(kwargs or {}))

    def count(fn):
        with Count() as c:
            fn()
        return c.n

    torch.set_num_threads(4)
    scene, cam, cfg = get_preset("mesh10k", width=16, height=16,
                                 device="cpu")
    cfg = cfg.with_(max_bounces=2)
    packed = bvhmod.prepare_bvh(scene, cfg, "cpu")
    o, d = generate_rays_blocks(cam, cfg.block_size)
    out = {"build_aux": count(lambda: mega.build_aux(scene, cfg.background))}
    for k in ("pallas", "xla"):
        out[f"nearest_hit[{k}]"] = count(
            lambda: isect.nearest_hit(scene, o, d, bvh=packed, kernel=k))
        out[f"shadow_min_t[{k}]"] = count(
            lambda: shade.shadow_min_t(scene, o, d, bvh=packed, kernel=k))
        out[f"composed frame[{k}]"] = count(lambda: trace_radiance(
            scene, o, d, cfg.with_(kernel=k), bvh=packed))
    out["fused frame (plain)"] = count(lambda: trace_radiance(
        scene, o, d, cfg.with_(kernel="mega"), bvh=packed))
    t_m, i_m = isect._best(isect.ray_triangles(o, d, scene.meshes.verts,
                                               scene.meshes.valid))
    rest = shard._rest_scene(scene)
    out["_fold_rest"] = count(lambda: shard._fold_rest(rest, o, d, t_m, i_m))
    _, recs = rp.trace_records(scene, o, d, cfg, packed, soft=True)
    for n in (1, 2, 3):
        out[f"soft replay, diagnostics, {n} segments"] = count(
            lambda: rp.replay_radiance_soft(scene, o, d, recs, cfg,
                                            live_segments=n, with_diag=True))
    out["soft replay"] = count(
        lambda: rp.replay_radiance_soft(scene, o, d, recs, cfg))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
