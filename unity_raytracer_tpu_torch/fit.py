"""Differentiable inverse rendering: the composed path and the record-replay path.

Twin: ``unity_raytracer_tpu/fit.py`` — ``PARAM_PATHS``, ``get_params``,
``set_params`` and ``_replace_path`` (``:34-76``), ``FitConfig`` and
``FitResult`` (``:79-111``), ``make_loss_fn`` (``:114-131``), ``_bind``
(``:134-141``), ``make_chunked_value_and_grad`` (``:144-211``) and
``fit`` (``:214-365``). Recover scene parameters (sphere positions,
materials, light intensities, mesh vertices) from a target image by
pixel-gradient descent, on one of three steps:

* the composed path, whole image (the default): autograd through
  ``ops/render.render`` — the composed bounce chain around the traversal
  kernels, with soft visibility for silhouette gradients;
* the composed path, chunked (``rcfg.ray_chunk`` set): one ``backward()``
  per chunk of rays into accumulated gradients, then the weighted mean
  (``make_chunked_value_and_grad``); with ``rcfg.remat`` each bounce
  segment is recomputed in the backward;
* the record-replay path (``FitConfig.use_replay``): each step records
  the bounce chain with the fused kernel at the current parameters and
  back-propagates through the soft shading replay
  (``ops/replay.soft_replay_value_and_grad``).

The parameters are leaf tensors with ``requires_grad``, installed into a
template scene with ``dataclasses.replace``; the optimizer is
``torch.optim.Adam`` (optax's adam defaults are its defaults). Mesh
vertices reach the BVH's epilogue through ``ops/bvh.bind_verts``.
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
from unity_raytracer_tpu_torch.ops.bvh import bind_verts
from unity_raytracer_tpu_torch.ops.render import (
    render, resolve_mode, trace_radiance)
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
    # mesh-vertex deformation: the losses below re-bind the BVH's
    # epilogue triangles to the current verts each step (bind_verts);
    # composed path, BVH built with cfg.bvh_pad >= the displacement
    "mesh_verts": ("meshes", "verts"),
}


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
    #   with min-mode shadow walks + the differentiable soft replay;
    #   False runs the composed path
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


def make_loss_fn(template: Scene, cam: Camera, rcfg: RenderConfig,
                 target: torch.Tensor, bvh=None) -> Callable:
    """Pixel-MSE loss of ``render`` against ``target`` ([H,W,3], display
    scale). ``rcfg`` should carry a soft ``DiffConfig`` so silhouette
    gradients exist; with ``straight_through`` the forward stays hard.
    ``bvh``: a prebuilt BVH (``ops/bvh.prepare_bvh``), re-bound to each
    step's mesh verts; mesh geometry otherwise never moves, so one BVH
    serves every step."""
    rcfg = resolve_mode(template, rcfg)

    def loss_fn(params: Dict[str, torch.Tensor]) -> torch.Tensor:
        scene = set_params(template, params)
        img = render(scene, cam, rcfg, bvh=_bind(bvh, scene))
        return ((img - target) ** 2).mean()

    return loss_fn


def _bind(bvh, scene):
    """Re-bind the BVH's epilogue triangles to the scene's current mesh
    verts (``ops/bvh.bind_verts``, the mesh-vertex gradient)."""
    if bvh is None:
        return None
    return bind_verts(bvh, scene)


def make_chunked_value_and_grad(template: Scene, rcfg: RenderConfig,
                                o: torch.Tensor, d: torch.Tensor,
                                target: torch.Tensor, bvh=None,
                                chunk: Optional[int] = None,
                                weights: Optional[torch.Tensor] = None,
                                denom: Optional[float] = None
                                ) -> Callable:
    """Chunked gradient accumulation on the composed path: for each chunk
    of rays, ``backward()`` of its summed squared error into the same
    ``.grad``; the loss and gradients are divided once at the end by 3x
    the weight sum, so they equal the unchunked weighted-mean MSE's. Only
    one chunk's graph is alive at a time; ``rcfg.remat`` also recomputes
    each bounce segment in the backward.

    ``target``: radiance on the 0-255 scale, [N,3] aligned with
    ``(o, d)``. ``weights`` (optional [N]): per-lane loss weights, e.g. 0
    on the pad margin of block-ordered raygen. ``denom`` replaces the
    divisor: a rank's share of a loss over more rays than its own
    (``parallel/shard.make_sharded_train_step``). Returns ``f(params) ->
    (loss, grads)``."""
    rcfg = resolve_mode(template, rcfg)
    n = o.shape[0]
    c = min(chunk or rcfg.ray_chunk or n, n)
    w = (torch.ones((n,), dtype=torch.float32, device=o.device)
         if weights is None else weights.to(torch.float32))
    if denom is None:
        denom = w.sum() * 3.0
    pad = (-n) % c
    if pad:
        z = torch.zeros((pad, 3), dtype=torch.float32, device=o.device)
        z[:, 2] = 1.0
        o, d = torch.cat([o, z]), torch.cat([d, z])
        target = torch.cat([target, torch.zeros_like(z)])
        w = torch.cat([w, w.new_zeros(pad)])
    oc, dc = o.reshape(-1, c, 3), d.reshape(-1, c, 3)
    tc, wc = target.reshape(-1, c, 3), w.reshape(-1, c)

    def value_and_grad_fn(params):
        leaves = rp._leaves(params)
        scene = set_params(template, leaves)
        loss = torch.zeros((), dtype=torch.float32, device=o.device)
        for i in range(oc.shape[0]):
            rad = trace_radiance(scene, oc[i], dc[i], rcfg,
                                 bvh=_bind(bvh, scene))
            l_i = (((rad - tc[i]) ** 2) * wc[i][:, None]).sum()
            l_i.backward()
            loss = loss + l_i.detach()
        return loss / denom, rp._grads(leaves, denom)

    return value_and_grad_fn


def fit(template: Scene, cam: Camera, rcfg: RenderConfig,
        target: torch.Tensor, cfg: FitConfig,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        resume_from: Optional[str] = None,
        grad_transform: Optional[Callable] = None,
        bvh=None) -> FitResult:
    """Adam descent on the pixel MSE against ``target`` ([H,W,3], display
    scale): on the composed path (whole image, or chunked when
    ``rcfg.ray_chunk`` is set), or on the record-replay path with
    ``cfg.use_replay``.

    ``bvh``: the BVH from ``ops/bvh.prepare_bvh`` for ``use_bvh`` scenes
    (the replay needs the fused kernel's ``PackedBVH``). ``grad_transform
    (grads, params) -> grads`` hooks in a gradient all-reduce for
    multi-device runs. ``resume_from``: a checkpoint written by this
    function (``cfg.checkpoint_every``); the fit continues from its step,
    parameters and Adam state.
    """
    rcfg = resolve_mode(template, rcfg).with_(
        diff=DiffConfig(soft_shadow_temp=cfg.soft_shadow_temp,
                        soft_hit_temp=cfg.soft_hit_temp,
                        straight_through=True))
    dev = template.aabb_min.device
    src = init_params or get_params(template, cfg.param_names)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in src.items()}
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    scale = 1.0 / (255.0 * 255.0)  # radiance-scale MSE -> image MSE
    live_prefix = measure_prefix = None
    if cfg.use_replay:
        if rcfg.mode != "scan" or bvh is None \
                or getattr(bvh, "leafmeta", None) is None:
            raise ValueError("FitConfig.use_replay needs mode='scan' and "
                             "the fused kernel's PackedBVH "
                             "(ops/bvh.prepare_bvh)")
        rcfg_m = rcfg.with_(kernel="mega")
        o, d = generate_rays_blocks(cam, rcfg.block_size)
        tgt_rad = swizzle_image(target, rcfg.block_size) * 255.0
        lane_w = _lane_weights(cam, rcfg, dev)

        def measure_prefix(p):
            _, recs = rp.trace_records(set_params(template, p), o, d,
                                       rcfg_m, bvh, soft=True)
            return rp.live_depth(recs)

        # the live-segment prefix is measured on the scene being optimized
        # (template + init params), +1 for a chain that extends by one;
        # the guard below catches deeper extensions mid-fit
        live_prefix = min(rcfg_m.max_bounces + 1, measure_prefix(params) + 1)
        # the replay runs in chunks at frame scale (its [N,L] temporaries
        # would otherwise hold the whole frame's graph)
        chunk = rcfg.ray_chunk or ((1 << 18) if o.shape[0] > (1 << 18)
                                   else None)

        def value_and_grad(p):
            loss, grads = rp.soft_replay_value_and_grad(
                template, p, o, d, tgt_rad, rcfg_m, bvh, weights=lane_w,
                live_segments=live_prefix, chunk=chunk)
            return loss * scale, {k: g * scale for k, g in grads.items()}

        # one-time check: warn when the fit starts inside the soft
        # replay's biased mesh-shadow regime
        diag = rp.soft_replay_bias_counts(set_params(template, params), o,
                                          d, rcfg_m, bvh,
                                          live_segments=live_prefix)
        if diag["mesh_occ_frozen"] or diag["proxy_mesh_risk"]:
            print(f"[fit] WARNING: soft-replay mesh-shadow bias regime "
                  f"active — {diag['mesh_occ_frozen']} lanes with frozen "
                  f"mesh-occluder shadow terms, {diag['proxy_mesh_risk']} "
                  f"proxy lanes with unqueried mesh-shadow risk; gradients "
                  f"for those lanes drop mesh silhouette terms (use the "
                  f"composed path for exactness)")
    elif rcfg.ray_chunk:
        o, d = generate_rays_blocks(cam, rcfg.block_size)
        tgt_rad = swizzle_image(target, rcfg.block_size) * 255.0
        raw_vg = make_chunked_value_and_grad(
            template, rcfg, o, d, tgt_rad, bvh=bvh,
            weights=_lane_weights(cam, rcfg, dev))

        def value_and_grad(p):
            loss, grads = raw_vg(p)
            return loss * scale, {k: g * scale for k, g in grads.items()}
    else:
        loss_fn = make_loss_fn(template, cam, rcfg, target, bvh=bvh)

        def value_and_grad(p):
            leaves = rp._leaves(p)
            loss = loss_fn(leaves)
            loss.backward()
            return loss.detach(), rp._grads(leaves)

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
        if (measure_prefix is not None and cfg.prefix_guard_every
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


def _lane_weights(cam: Camera, rcfg: RenderConfig, dev) -> torch.Tensor:
    """1 on the block-ordered lanes of image pixels, 0 on the pad margin."""
    return swizzle_image(torch.ones((cam.height, cam.width, 1),
                                    dtype=torch.float32, device=dev),
                         rcfg.block_size)[:, 0]
