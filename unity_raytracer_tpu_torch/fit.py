"""Differentiable inverse rendering on the record-replay path.

Twin: ``unity_raytracer_tpu/fit.py`` — ``PARAM_PATHS``, ``get_params``,
``set_params`` and ``_replace_path`` (``:34-76``), ``FitConfig`` and
``FitResult`` (``:79-111``) and ``fit`` (``:214-365``) on its
``use_replay=True`` path. Recover scene parameters (sphere positions,
materials, light intensities) from a target image by pixel-gradient
descent: each step records the bounce chain with the fused kernel at the
current parameters and back-propagates the pixel MSE through the soft
shading replay (``ops/replay.soft_replay_value_and_grad``).

The parameters are leaf tensors with ``requires_grad``, installed into a
template scene with ``dataclasses.replace``; the optimizer is
``torch.optim.Adam`` (optax's adam defaults are its defaults).

Not ported here, raising ``NotImplementedError`` naming ROADMAP Queue A
#10: the composed differentiable path — ``make_loss_fn``,
``make_chunked_value_and_grad`` and ``fit`` with ``use_replay=False``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.convert import (
    adam_state_from_arrays, params_from_arrays)
from unity_raytracer_tpu_torch.models.scene import Scene
from unity_raytracer_tpu_torch.ops import replay as rp
from unity_raytracer_tpu_torch.ops.render import resolve_mode
from unity_raytracer_tpu_torch.utils import checkpoint as ckpt
from unity_raytracer_tpu_torch.utils.config import DiffConfig, RenderConfig
from unity_raytracer_tpu_torch.utils.swizzle import swizzle_image

# Parameter classes that can be optimized; each names a leaf of the scene.
PARAM_PATHS = {
    "sphere_centers": ("spheres", "centers"),
    "sphere_radius_sq": ("spheres", "radius_sq"),
    "sphere_diffuse": ("spheres", "materials", "diffuse"),
    "sphere_ambient": ("spheres", "materials", "ambient"),
    "sphere_specular": ("spheres", "materials", "specular"),
    "sphere_mirror": ("spheres", "materials", "mirror"),
    "tri_verts": ("triangles", "verts"),
    "tri_diffuse": ("triangles", "materials", "diffuse"),
    "light_positions": ("lights", "positions"),
    "light_intensities": ("lights", "intensities"),
    # mesh-vertex deformation needs the composed path (bind_verts):
    # ROADMAP Queue A #10
    "mesh_verts": ("meshes", "verts"),
}

_COMPOSED = ("the composed differentiable path ({}) is not ported to "
             "unity_raytracer_tpu_torch yet: #10 in ROADMAP.md Queue A; "
             "use FitConfig(use_replay=True)")


def get_params(scene: Scene, names: Tuple[str, ...]
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for name in names:
        node = scene
        for attr in PARAM_PATHS[name]:
            node = getattr(node, attr)
        out[name] = node
    return out


def set_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    for name, value in params.items():
        scene = _replace_path(scene, PARAM_PATHS[name], value)
    return scene


def _replace_path(node, path, value):
    if len(path) == 1:
        return dataclasses.replace(node, **{path[0]: value})
    child = getattr(node, path[0])
    return dataclasses.replace(
        node, **{path[0]: _replace_path(child, path[1:], value)})


@dataclass(frozen=True)
class FitConfig:
    param_names: Tuple[str, ...] = ("sphere_centers", "sphere_diffuse")
    learning_rate: float = 0.05
    steps: int = 200
    soft_shadow_temp: float = 1.0
    soft_hit_temp: float = 0.05
    log_every: int = 20
    checkpoint_every: int = 0          # 0 = disabled
    checkpoint_path: Optional[str] = None
    use_replay: bool = False           # the soft record-replay step
    #   (ops/replay.soft_replay_value_and_grad): fused-kernel records
    #   with min-mode shadow walks + the differentiable soft replay. The
    #   only path ported; False raises (ROADMAP Queue A #10).
    prefix_guard_every: int = 25       # every K steps, re-measure the
    #   live bounce depth on the current params; if the mirror chain
    #   deepened past the replay's live-segment prefix (which would
    #   silently drop radiance and gradients), widen the prefix. 0
    #   disables the guard.


class FitResult(NamedTuple):
    scene: Scene
    params: Dict[str, torch.Tensor]
    losses: np.ndarray
    step: int
    # the final live-segment prefix of the replay; above the first
    # measurement iff the prefix guard widened it mid-fit
    live_prefix: Optional[int] = None


def make_loss_fn(*args, **kwargs) -> Callable:
    raise NotImplementedError(_COMPOSED.format("make_loss_fn"))


def make_chunked_value_and_grad(*args, **kwargs) -> Callable:
    raise NotImplementedError(_COMPOSED.format(
        "make_chunked_value_and_grad"))


def fit(template: Scene, cam: Camera, rcfg: RenderConfig,
        target: torch.Tensor, cfg: FitConfig,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        resume_from: Optional[str] = None,
        grad_transform: Optional[Callable] = None,
        bvh=None) -> FitResult:
    """Adam descent on the pixel MSE against ``target`` ([H,W,3], display
    scale), on the record-replay path.

    ``bvh``: the PackedBVH from ``ops/bvh.prepare_bvh`` (mesh geometry is
    never optimized, so one BVH serves every step). ``grad_transform
    (grads, params) -> grads`` hooks in a gradient all-reduce for
    multi-device runs. ``resume_from``: a checkpoint written by this
    function (``cfg.checkpoint_every``); the fit continues from its step,
    parameters and Adam state.
    """
    if not cfg.use_replay:
        raise NotImplementedError(_COMPOSED.format("fit with "
                                                   "use_replay=False"))
    rcfg = resolve_mode(template, rcfg).with_(
        diff=DiffConfig(soft_shadow_temp=cfg.soft_shadow_temp,
                        soft_hit_temp=cfg.soft_hit_temp,
                        straight_through=True))
    if rcfg.mode != "scan" or bvh is None \
            or getattr(bvh, "leafmeta", None) is None:
        raise ValueError("FitConfig.use_replay needs mode='scan' and the "
                         "fused kernel's PackedBVH (ops/bvh.prepare_bvh)")
    dev = template.aabb_min.device
    src = init_params or get_params(template, cfg.param_names)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in src.items()}
    rcfg_m = rcfg.with_(kernel="mega")
    o, d = generate_rays_blocks(cam, rcfg.block_size)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    tgt_rad = swizzle_image(target, rcfg.block_size) * 255.0
    lane_w = swizzle_image(torch.ones((cam.height, cam.width, 1),
                                      dtype=torch.float32, device=dev),
                           rcfg.block_size)[:, 0]

    def measure_prefix(p):
        _, recs = rp.trace_records(set_params(template, p), o, d, rcfg_m,
                                   bvh, soft=True)
        return rp.live_depth(recs)

    # the live-segment prefix is measured on the scene being optimized
    # (template + init params), +1 for a chain that extends by one; the
    # guard below catches deeper extensions mid-fit
    live_prefix = min(rcfg_m.max_bounces + 1, measure_prefix(params) + 1)
    # the replay runs in chunks at frame scale (its [N,L] temporaries
    # would otherwise hold the whole frame's graph)
    chunk = rcfg.ray_chunk or ((1 << 18) if o.shape[0] > (1 << 18)
                               else None)
    scale = 1.0 / (255.0 * 255.0)  # radiance-scale MSE -> image MSE

    def value_and_grad(p):
        loss, grads = rp.soft_replay_value_and_grad(
            template, p, o, d, tgt_rad, rcfg_m, bvh, weights=lane_w,
            live_segments=live_prefix, chunk=chunk)
        return loss * scale, {k: g * scale for k, g in grads.items()}

    # one-time check: warn when the fit starts inside the soft replay's
    # biased mesh-shadow regime
    diag = rp.soft_replay_bias_counts(set_params(template, params), o, d,
                                      rcfg_m, bvh,
                                      live_segments=live_prefix)
    if diag["mesh_occ_frozen"] or diag["proxy_mesh_risk"]:
        print(f"[fit] WARNING: soft-replay mesh-shadow bias regime active "
              f"— {diag['mesh_occ_frozen']} lanes with frozen "
              f"mesh-occluder shadow terms, {diag['proxy_mesh_risk']} "
              f"proxy lanes with unqueried mesh-shadow risk; gradients "
              f"for those lanes drop mesh silhouette terms")

    start_step = 0
    if resume_from:
        start_step, p_np, adam = ckpt.load_checkpoint(resume_from)
        params = params_from_arrays(p_np, dev)
    optimizer = torch.optim.Adam(list(params.values()),
                                 lr=cfg.learning_rate)
    if resume_from and adam is not None:
        adam_state_from_arrays(*adam, optimizer, params)

    losses = []
    step = start_step - 1
    for step in range(start_step, cfg.steps):
        loss, grads = value_and_grad(params)
        if grad_transform is not None:
            grads = grad_transform(grads, params)
        for k, p in params.items():
            p.grad = grads[k]
        optimizer.step()
        losses.append(float(loss))
        if cfg.log_every and (step % cfg.log_every == 0
                              or step == cfg.steps - 1):
            print(f"[fit] step {step:5d} loss {losses[-1]:.6e}")
        if (cfg.prefix_guard_every
                and (step + 1) % cfg.prefix_guard_every == 0
                and live_prefix < rcfg.max_bounces + 1):
            depth_now = measure_prefix(params)
            if depth_now + 1 > live_prefix:
                live_prefix = min(rcfg.max_bounces + 1, depth_now + 1)
                print(f"[fit] live-prefix guard: bounce depth grew to "
                      f"{depth_now}; replay prefix now {live_prefix}")
        if (cfg.checkpoint_every and cfg.checkpoint_path
                and (step + 1) % cfg.checkpoint_every == 0):
            ckpt.save_checkpoint(cfg.checkpoint_path, step + 1, params,
                                 optimizer)

    final = {k: v.detach() for k, v in params.items()}
    return FitResult(scene=set_params(template, final), params=final,
                     losses=np.asarray(losses), step=step + 1,
                     live_prefix=live_prefix)
