"""Debug render modes: normal / depth / hit-id / shadow-mask maps.

Twin: ``unity_raytracer_tpu/ops/debugviz.py`` (``debug_maps``,
``:21-74``). The reference's gizmo toggles (RayTracingSetup.cs:25-36 —
DrawPixelRays, DrawIntersections, DrawSurfaceNormals, ...) become cheap
images of the primary hit: its normal, distance, category and primitive,
and how many lights see it. The hits go through ``nearest_hit`` (with a
BVH, kernel 'auto': the ordered binary walk ``traverse_packet4`` on the
card, the plain walk on the CPU) and the shadows through
``shade.shadow_min_t`` on the same walk.
"""

from __future__ import annotations

from typing import Dict

import torch

from unity_raytracer_tpu_torch.models.camera import Camera, generate_rays
from unity_raytracer_tpu_torch.models.scene import Scene
from unity_raytracer_tpu_torch.ops import shade as sh
from unity_raytracer_tpu_torch.ops.intersect import nearest_hit

# Knuth's multiplicative hash constant (the twin multiplies in uint32)
_HASH = 2654435761


def debug_maps(scene: Scene, cam: Camera, bvh=None
               ) -> Dict[str, torch.Tensor]:
    """Primary-hit diagnostics, each ``[H,W,...]`` on a 0-1-ish scale:

    * ``normal``   — the shading normal as 0.5 * (n + 1), 0 on a miss;
    * ``depth``    — the hit distance over the frame's largest, 1 on a miss;
    * ``hit_kind`` — the category code / 3 (0 miss, mesh 1/3, sphere 2/3,
      loose triangle 1);
    * ``hit_id``   — the primitive index hashed to a colour, 0 on a miss;
    * ``shadow``   — the fraction of the valid lights that see the hit.
    """
    h, w = cam.height, cam.width
    o, d = generate_rays(cam)
    hit = nearest_hit(scene, o, d, bvh=bvh)
    hm = hit.is_hit
    t_safe = torch.where(hm, hit.t, 0.0)
    p = o + d * t_safe[:, None]
    n, _ = sh.surface_attributes(scene, p, hit)

    normal = torch.where(hm[:, None], 0.5 * (n + 1.0), 0.0)

    tmax = torch.clamp_min(torch.where(hm, hit.t, 0.0).max(), 1e-6)
    depth = torch.where(hm, hit.t / tmax, 1.0)

    kind = hit.kind.to(torch.float32) / 3.0

    # (index * _HASH) mod 2^24 in int64 equals the twin's uint32 product
    # (which wraps mod 2^32) mod 2^24: 2^24 divides 2^32
    hashed = (hit.index.long() * _HASH) & 0xFFFFFF
    rgb = torch.stack([(hashed >> 16) & 0xFF, (hashed >> 8) & 0xFF,
                       hashed & 0xFF], dim=-1).to(torch.float32) / 255.0
    hit_id = torch.where(hm[:, None], rgb, 0.0)

    # shadow mask: the visible share of the valid lights at the hit
    n_lights = scene.lights.positions.shape[0]
    lvec = scene.lights.positions[None, :, :] - p[:, None, :]
    ldist_sq = (lvec * lvec).sum(-1)
    ldir = lvec / torch.sqrt(ldist_sq)[..., None]
    so = p + n * sh.SHADOW_EPS
    n_rays = p.shape[0]
    st = sh.shadow_min_t(
        scene, so[:, None, :].expand(n_rays, n_lights, 3).reshape(-1, 3),
        ldir.reshape(-1, 3), bvh=bvh,
        t_max=torch.sqrt(ldist_sq).reshape(-1)).reshape(n_rays, n_lights)
    visible = ((st * st) >= ldist_sq).to(torch.float32)
    lv = scene.lights.valid.to(torch.float32)[None, :]
    frac = (visible * lv).sum(1) / torch.clamp_min(lv.sum(), 1.0)
    shadow = torch.where(hm, frac, 0.0)

    return {
        "normal": normal.reshape(h, w, 3),
        "depth": depth.reshape(h, w),
        "hit_kind": kind.reshape(h, w),
        "hit_id": hit_id.reshape(h, w, 3),
        "shadow": shadow.reshape(h, w),
    }
