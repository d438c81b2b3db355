"""Wavefront renderer: primary rays -> mirror bounce chain -> image.

Twin: ``unity_raytracer_tpu/ops/render.py`` — ``_local_radiance``
(``:42-130``), ``_trace_chain_mega`` (``:133-184``), ``_trace_chain``
(``:187-268``), ``resolve_mode``, ``trace_radiance``'s scan dispatch
(``:578-592``), ``trace_radiance_stats`` (``:595-600``), ``render_frame``
and ``render`` (``:614-660``). Radiance accumulates on the reference's
0-255 scale and is divided by 255 at the end (Data/Shading/Rgb.cs:13).

Two routes run ``mode='scan'``, the reference's mirror-only chain:

* **fused** — ``kernel='mega'``, hard visibility and a ``PackedBVH`` with
  ``leafmeta``: each segment is one launch of the fused segment kernel
  (``ops/kernels/mega.py``). All ``max_bounces + 1`` segments launch;
  dead rays exit at their first instruction, so no host sync is needed.
* **composed** — everything else: ``nearest_hit`` (BVH walk, brute force,
  or the brute-force nearest-triangle kernel), ``direct_lighting`` with
  light-major shadow queries, and the mirror continuation, in
  differentiable torch around the traversal kernels. Retired lanes get
  ``t_max = -1``, so the kernels cull them. A segment with no live lane
  is skipped, as the twin's ``lax.cond`` skips it: that test is one host
  sync per segment, and once a segment is dead the rest are too.
  ``cfg.remat`` runs each segment under ``torch.utils.checkpoint`` (the
  backward recomputes it; the kernels are deterministic, so the recompute
  equals the forward).

``kernel='auto'`` is composed, as in the twin; its walk is the ordered
binary kernel on the card and the plain per-lane walk elsewhere
(``ops/bvh.traverse_any``). Not ported, raising ``NotImplementedError``
naming the ROADMAP Queue A item: the dielectric tree (``mode='tree'``,
#8), the fused kernel's Möller–Trumbore leaf test and binary layout (its
mode (e), #12) and chunked frames (``ray_chunk`` in ``render``, #14).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.scene import Scene
from unity_raytracer_tpu_torch.ops import bvh as bvhmod
from unity_raytracer_tpu_torch.ops import shade as sh
from unity_raytracer_tpu_torch.ops.intersect import (
    KIND_SPHERE, Hit, dot3, nearest_hit)
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import check_overflow
from unity_raytracer_tpu_torch.utils.config import RenderConfig
from unity_raytracer_tpu_torch.utils.swizzle import unswizzle_image

SHADOW_EPS = sh.SHADOW_EPS
KERNELS = ("auto", "xla", "pallas", "pallas3", "wide", "mega")


def resolve_mode(scene: Scene, cfg: RenderConfig) -> RenderConfig:
    """Resolve mode='auto' on a concrete scene: 'tree' when any material
    is dielectric, else 'scan'."""
    if cfg.mode != "auto":
        return cfg
    return cfg.with_(mode="tree" if scene.has_dielectrics else "scan")


def uses_fused(cfg: RenderConfig, bvh) -> bool:
    """Whether the scan chain runs on the fused segment kernel (the twin's
    test at ``:214-218``): ``kernel='mega'``, a packed BVH with
    ``leafmeta`` and hard visibility."""
    return (cfg.kernel == "mega" and bvh is not None
            and getattr(bvh, "leafmeta", None) is not None
            and cfg.diff.soft_hit_temp == 0.0
            and cfg.diff.soft_shadow_temp == 0.0)


def check_supported(cfg: RenderConfig, bvh=None) -> None:
    """Raise ``NotImplementedError`` for a config outside the ported
    routes, naming the ROADMAP Queue A item that ports it, and
    ``ValueError`` for an unknown kernel."""
    if cfg.kernel not in KERNELS:
        raise ValueError(f"unknown kernel {cfg.kernel!r}; have {KERNELS}")
    todo = None
    if cfg.mode == "tree":
        todo = "the dielectric tree (mode='tree', fused fork kernel) is #8"
    elif cfg.mode != "scan":
        todo = f"mode={cfg.mode!r} is unresolved; call resolve_mode first"
    elif uses_fused(cfg, bvh) and (cfg.tri_isect != "bw"
                                   or cfg.bvh_arity < 2):
        todo = ("the fused kernel's Möller–Trumbore leaf test and binary "
                "BVH layout (its mode e) are #12")
    if todo:
        raise NotImplementedError(
            f"not ported to unity_raytracer_tpu_torch yet: {todo} in "
            f"ROADMAP.md Queue A")


def _local_radiance(scene: Scene, o, d, cfg: RenderConfig, hit: Hit,
                    bvh=None, active: torch.Tensor | None = None,
                    with_stats: bool = False,
                    overflow: torch.Tensor | None = None):
    """One segment's surface point, attributes and local shading.

    Returns ``(contrib [N,3] (local radiance or background), p, n, mats,
    hit_mask)``, paired with the live shadow-query count under
    ``with_stats``. With ``cfg.diff.soft_hit_temp > 0`` a missing ray
    adopts a proxy hit on its best near-miss sphere (first maximum of the
    silhouette margin), shaded at the closest-approach point, and the
    segment blends toward it with ``sigmoid(margin / temp)``; with
    ``straight_through`` the forward value stays hard. Masked lanes carry
    finite values. ``overflow`` goes to the shadow walks."""
    hit_mask = hit.is_hit
    soft_temp = cfg.diff.soft_hit_temp
    if soft_temp > 0.0:
        sp = scene.spheres
        S = sp.count
        margs = []
        m_best = torch.full(hit_mask.shape, -torch.inf, device=o.device)
        j_best = torch.zeros(hit_mask.shape, dtype=torch.int32,
                             device=o.device)
        t_close_best = torch.full(hit_mask.shape, 1e-3, device=o.device)
        for si in range(S):
            oc = o - sp.centers[si][None, :]
            uoc = dot3(d, oc)
            oc2 = dot3(oc, oc)
            r2s = sp.radius_sq[si]
            disc = uoc * uoc - (oc2 - r2s)
            marg = disc / torch.maximum(r2s, r2s.new_full((), 1e-12))
            okm = ((-uoc) > 0.0) & sp.valid[si]
            marg = torch.where(okm, marg, -torch.inf)
            margs.append(marg)
            better = marg > m_best   # the first maximum wins ties
            m_best = torch.where(better, marg, m_best)
            j_best = torch.where(better, si, j_best)
            t_close_best = torch.where(
                better, torch.maximum(-uoc, uoc.new_full((), 1e-3)),
                t_close_best)
        use_proxy = ~hit_mask & torch.isfinite(m_best)
        hit = dataclasses.replace(hit,
            t=torch.where(use_proxy, t_close_best, hit.t),
            kind=torch.where(use_proxy, KIND_SPHERE, hit.kind).to(
                torch.int32),
            index=torch.where(use_proxy, j_best, hit.index))
        shade_mask = hit_mask | use_proxy
        # the winner's margin: sphere hits and proxies relax their own
        # silhouette; other hits stay hard (+inf)
        win_sphere = hit_mask & (hit.kind == KIND_SPHERE)
        sel_idx = torch.where(win_sphere, hit.index.clamp(0, max(S - 1, 0)),
                              j_best)
        own = margs[0] if S else torch.full(hit_mask.shape, -torch.inf,
                                            device=o.device)
        for si in range(1, S):
            own = torch.where(sel_idx == si, margs[si], own)
        margin_sel = torch.where(win_sphere | use_proxy, own, torch.inf)
        x = margin_sel / soft_temp
        w_soft = torch.sigmoid(torch.minimum(
            torch.maximum(x, x.new_full((), -30.0)), x.new_full((), 30.0)))
        if cfg.diff.straight_through:  # forward hard, backward soft
            w = w_soft + (hit_mask.to(torch.float32) - w_soft).detach()
        else:
            w = w_soft
    else:
        shade_mask = hit_mask
        w = hit_mask.to(torch.float32)

    t_safe = torch.where(shade_mask, hit.t, 1.0)
    p = o + d * t_safe[:, None]
    n, mats = sh.surface_attributes(scene, p, hit)
    v = -d  # unit direction back toward the segment origin (:325)
    shadow_mask = shade_mask if active is None else (shade_mask & active)
    local, n_shadow = sh.direct_lighting(
        scene, p, n, v, mats, soft_shadow_temp=cfg.diff.soft_shadow_temp,
        straight_through=cfg.diff.straight_through, bvh=bvh,
        kernel=cfg.kernel, mask=shadow_mask, light_cull=cfg.light_cull,
        with_stats=True, overflow=overflow)
    bg = torch.tensor(cfg.background, dtype=torch.float32,
                      device=o.device) * 255.0
    local_safe = torch.where(shade_mask[:, None], local, bg[None, :])
    contrib = bg[None, :] + w[:, None] * (local_safe - bg[None, :])
    out = (contrib, p, n, mats, hit_mask)
    return (out, n_shadow) if with_stats else out


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


def _segment(scene: Scene, cfg: RenderConfig, bvh, depth: int, o, d, thr,
             active, acc, overflow):
    """One composed bounce segment (the twin's ``live_seg``): returns the
    next ``(o, d, thr, active, acc)`` and the live shadow-query count.
    Its walks add dropped stack pushes to ``overflow``."""
    tmax = torch.where(active, 3.0e38, -1.0)
    hit = nearest_hit(scene, o, d, bvh=bvh, kernel=cfg.kernel, t_max=tmax,
                      overflow=overflow)
    (contrib, p, n, mats, hit_mask), n_shadow = _local_radiance(
        scene, o, d, cfg, hit, bvh=bvh, active=active, with_stats=True,
        overflow=overflow)
    acc = acc + thr * contrib * active[:, None]
    cont = (active & hit_mask & mats.is_mirror
            & (depth < cfg.max_bounces))
    thr = torch.where(cont[:, None], thr * mats.mirror, thr)
    o = p + n * SHADOW_EPS    # Reflect origin offset (:368-373)
    d = torch.where(cont[:, None], sh.reflect_dir(d, n), d)
    return o, d, thr, cont, acc, n_shadow


def _trace_chain(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                 cfg: RenderConfig, bvh=None, with_stats: bool = False):
    """Mirror-only linear bounce chain — the exact reference semantics.

    Segment s contributes ``prod(mirror_0..s-1) * local_s``; the chain
    stops at the first non-mirror hit or miss, and segment ``max_bounces``
    shades but spawns nothing (RayTracingSetup.cs:358). Runs on the fused
    kernel when ``uses_fused`` (and not ``with_stats``), else composed.
    ``with_stats`` also returns ``(live [B], shadow_live [B])`` int32
    lane counts per segment. The walks of the whole chain share one
    stack-overflow counter, checked once at the end (a raise if any push
    was dropped)."""
    if not with_stats and uses_fused(cfg, bvh):
        return _trace_chain_mega(scene, o, d, cfg, bvh)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    acc = torch.zeros((n, 3), **f32)
    thr = torch.ones((n, 3), **f32)
    active = torch.ones((n,), dtype=torch.bool, device=o.device)
    live, shadow = [], []
    zero = torch.zeros((), dtype=torch.int32, device=o.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
    for depth in range(cfg.max_bounces + 1):
        n_live = active.sum(dtype=torch.int32)
        if not bool(n_live > 0):  # the twin's dead_seg; one host sync
            live.append(zero)
            shadow.append(zero)
            continue
        args = (scene, cfg, bvh, depth, o, d, thr, active, acc, overflow)
        if cfg.remat:
            o, d, thr, active, acc, n_shadow = checkpoint(
                _segment, *args, use_reentrant=False)
        else:
            o, d, thr, active, acc, n_shadow = _segment(*args)
        live.append(n_live)
        shadow.append(n_shadow)
    if o.device.type == "cuda":
        check_overflow(overflow, "traversal")
    if with_stats:
        return acc, (torch.stack(live), torch.stack(shadow))
    return acc


def trace_radiance(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                   cfg: RenderConfig, bvh=None) -> torch.Tensor:
    """Radiance [N,3] (0-255 scale) for arbitrary ray batches; ``bvh=None``
    intersects by brute force."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg, bvh)
    return _trace_chain(scene, o, d, cfg, bvh=bvh)


def trace_radiance_stats(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                         cfg: RenderConfig, bvh=None):
    """The composed chain with per-segment ``(live nearest lanes, live
    shadow lanes)`` counts: ``(radiance, (live [B], shadow [B]))`` —
    bench.py's live-ray accounting."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg, bvh)
    return _trace_chain(scene, o, d, cfg, bvh=bvh, with_stats=True)


def render_frame(scene: Scene, cam: Camera, cfg: RenderConfig,
                 bvh=None) -> torch.Tensor:
    """Block-order raygen -> trace -> unswizzle -> [H,W,3] image on the
    display (0-1) scale, on the camera's device."""
    o, d = generate_rays_blocks(cam, cfg.block_size)
    rad = trace_radiance(scene, o, d, cfg, bvh=bvh)
    return unswizzle_image(rad, cam.width, cam.height,
                           cfg.block_size) / 255.0


def render(scene: Scene, cam: Camera, cfg: RenderConfig,
           bvh=None) -> torch.Tensor:
    """Render the full image [H,W,3] on the display (0-1) scale: resolve
    'auto' mode, build the BVH ``cfg.kernel`` walks on the scene's device
    if ``cfg.use_bvh`` and none was passed, then ``render_frame``."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg, bvh)
    if cfg.ray_chunk:
        raise NotImplementedError(
            "not ported to unity_raytracer_tpu_torch yet: chunked frames "
            "(ray_chunk) are #14 in ROADMAP.md Queue A")
    if cfg.use_bvh and bvh is None:
        bvh = bvhmod.prepare_bvh(scene, cfg, scene.aabb_min.device)
    return render_frame(scene, cam, cfg, bvh)
