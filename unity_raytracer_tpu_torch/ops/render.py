"""Forward render: primary rays -> mirror bounce chain -> image.

Twin: ``unity_raytracer_tpu/ops/render.py`` — ``resolve_mode``,
``_trace_chain_mega`` (``:133-184``), ``render_frame`` and ``render``
(``:614-660``). Only the path the flagship frame runs is ported:
``mode='scan'`` (the reference's mirror-only chain) on a BVH, hard
visibility (both soft temperatures 0), every segment one launch of the
fused segment kernel (``ops/kernels/mega.py``). Radiance accumulates on
the reference's 0-255 scale and is divided by 255 at the end
(Data/Shading/Rgb.cs:13).

The twin skips a segment with no live lane (one ``lax.cond``); here that
test would cost a host sync per segment, so all ``max_bounces + 1``
segments launch and dead rays exit at their first instruction. The result
is the same: a dead lane contributes zero and passes through.

``kernel='auto'`` means the fused kernel here (the port has no other).
Everything else raises ``NotImplementedError`` naming the ROADMAP Queue A
item that ports it.
"""

from __future__ import annotations

import torch

from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.scene import Scene
from unity_raytracer_tpu_torch.ops import bvh as bvhmod
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.utils.config import RenderConfig
from unity_raytracer_tpu_torch.utils.swizzle import unswizzle_image


def resolve_mode(scene: Scene, cfg: RenderConfig) -> RenderConfig:
    """Resolve mode='auto' on a concrete scene: 'tree' when any material
    is dielectric, else 'scan'."""
    if cfg.mode != "auto":
        return cfg
    return cfg.with_(mode="tree" if scene.has_dielectrics else "scan")


def check_supported(cfg: RenderConfig, bvh=None) -> None:
    """Raise ``NotImplementedError`` for a config outside the ported
    slice, naming the ROADMAP Queue A item that ports it."""
    todo = None
    if cfg.mode == "tree":
        todo = "the dielectric tree (mode='tree', fused fork kernel) is #8"
    elif cfg.mode != "scan":
        todo = f"mode={cfg.mode!r} is unresolved; call resolve_mode first"
    elif cfg.diff.soft_hit_temp or cfg.diff.soft_shadow_temp:
        todo = "soft visibility (the composed differentiable path) is #10"
    elif cfg.ray_chunk:
        todo = "chunked frames (ray_chunk) are #14"
    elif not cfg.use_bvh and bvh is None:
        todo = ("rendering without a BVH (brute force, the composed "
                "path) is #10")
    elif cfg.kernel == "xla":
        todo = "the composed path (kernel='xla') is #10"
    elif cfg.kernel not in ("auto", "mega"):
        todo = (f"the standalone traversal kernels (kernel={cfg.kernel!r}) "
                "are #12")
    elif cfg.tri_isect != "bw" or cfg.bvh_arity < 2:
        todo = ("the Möller–Trumbore leaf test and the binary BVH layout "
                "(fused kernel mode e) are #12")
    if todo:
        raise NotImplementedError(
            f"not ported to unity_raytracer_tpu_torch yet: {todo} in "
            f"ROADMAP.md Queue A")


def _trace_chain_mega(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                      cfg: RenderConfig, bvh) -> torch.Tensor:
    """Mirror bounce chain, one fused segment launch per depth. Returns
    radiance [N,3] on the 0-255 scale. Raises if a launch dropped stack
    entries (one host sync, after the last segment)."""
    aux = mega.build_aux(scene, cfg.background)
    kw = dict(n_lights=scene.lights.positions.shape[0],
              n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
              max_bounces=cfg.max_bounces, light_cull=cfg.light_cull)
    n = o.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    thr = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    tmax = torch.full((n,), 3.0e38, dtype=torch.float32, device=o.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
    for depth in range(cfg.max_bounces + 1):
        delta, o, d, thr, tmax = mega.trace_segment(
            bvh, aux, depth, o, d, thr, tmax, overflow=overflow, **kw)
        acc = acc + delta
    if o.device.type == "cuda":
        mega.check_overflow(overflow)
    return acc


def trace_radiance(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                   cfg: RenderConfig, bvh=None) -> torch.Tensor:
    """Radiance [N,3] (0-255 scale) for arbitrary ray batches."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg, bvh)
    if bvh is None:
        raise ValueError("trace_radiance needs the PackedBVH from "
                         "ops/bvh.prepare_bvh")
    return _trace_chain_mega(scene, o, d, cfg, bvh)


def render_frame(scene: Scene, cam: Camera, cfg: RenderConfig,
                 bvh) -> torch.Tensor:
    """Block-order raygen -> trace -> unswizzle -> [H,W,3] image on the
    display (0-1) scale, on the camera's device."""
    o, d = generate_rays_blocks(cam, cfg.block_size)
    rad = trace_radiance(scene, o, d, cfg, bvh=bvh)
    return unswizzle_image(rad, cam.width, cam.height,
                           cfg.block_size) / 255.0


def render(scene: Scene, cam: Camera, cfg: RenderConfig,
           bvh=None) -> torch.Tensor:
    """Render the full image [H,W,3] on the display (0-1) scale: resolve
    'auto' mode, build the BVH on the scene's device if ``cfg.use_bvh``
    and none was passed, then ``render_frame``."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg, bvh)
    if bvh is None:
        bvh = bvhmod.prepare_bvh(scene, cfg, scene.aabb_min.device)
    return render_frame(scene, cam, cfg, bvh)
