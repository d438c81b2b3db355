"""Record-replay backward: fused-kernel records + a differentiable shading replay.

Twin: ``unity_raytracer_tpu/ops/replay.py`` (the whole module, ``:72-805``).
The work splits the way the math splits:

* **Traversal is index logic** — which primitive wins, which lights are
  occluded. It carries no parameter gradient in the hard-visibility
  regime. ``trace_records`` runs the fused segment kernel
  (``ops/kernels/mega.py``) once per bounce with ``record=True`` (or
  ``record_soft=True``) and keeps its per-segment hit records. They are
  facts without a gradient: the kernel's outputs come back with
  ``requires_grad=False``, so no ``autograd.Function`` is needed.
* **Shading is the differentiable part** — the winner's analytic t, the
  surface normal, Blinn-Phong terms, light falloff. ``replay_radiance``
  (hard) and ``replay_radiance_soft`` (soft visibility) redo the bounce
  chain's shading in plain torch under autograd, with the discrete
  decisions frozen to the records.

Gradient semantics are the twin's: sphere and loose-triangle winners are
re-derived analytically from the scene parameters; mesh winners use the
recorded t and normal through a frozen plane (``.detach()`` terms), which
is exact for every class of ``fit.PARAM_PATHS`` (none moves mesh
vertices); visibility is frozen. The soft replay recomputes sphere
silhouettes and sphere/loose-triangle soft shadows and freezes the mesh
facts (see ``replay_radiance_soft``).

Where the twin calls ``jnp.maximum``/``jnp.clip`` this module calls
``torch.maximum``/``torch.minimum``, which split the gradient at exact
ties as JAX does (``torch.clamp`` would not). Masked square roots keep the
twin's double ``where`` so masked lanes get a zero gradient, not NaN.

Reference semantics mirrored: shading terms RayTracingSetup.cs:324-455,
Intensity/d^2 falloff :350, mirror continuation :358-373, 0-255 Rgb scale
(Data/Shading/Rgb.cs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from unity_raytracer_tpu_torch.models.scene import Materials, Scene
from unity_raytracer_tpu_torch.ops import intersect as isect
from unity_raytracer_tpu_torch.ops.intersect import dot3
from unity_raytracer_tpu_torch.ops.bvh import _mt_one
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.ops.render import (
    check_supported, resolve_mode)
from unity_raytracer_tpu_torch.ops.shade import (
    SHADOW_EPS, _rows, _soft_or_hard_vis, reflect_dir)
from unity_raytracer_tpu_torch.utils.config import RenderConfig

# records tuple, each stacked over segments (leading dim B):
#   hard: (t [B,N], n [B,N,3], matid [B,N], occbits [B,N])
#   soft (trace_records(soft=True)): + (st [B,N,L] min occluder t)
Records = Tuple[torch.Tensor, ...]

_BIG = 3.0e38
# The bias diagnostic ``mesh_occ_frozen`` counts a lane only where the
# recorded mesh occluder, moved FROZEN_MARGIN (relative) farther, still
# lies below the recomputed sphere / loose-triangle occluder and still
# occludes. Where the nearest occluder is a sphere or a loose triangle,
# the record and the recomputation are one distance computed twice, and
# without the margin their rounding would decide the count. The shading
# min is not affected.
FROZEN_MARGIN = 1e-4


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: the gradient splits at an exact tie. The
    constant is filled on x's device (``torch.tensor`` would copy it from
    the host and synchronise the stream)."""
    return torch.maximum(x, x.new_full((), c))


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``rsqrt`` as the fused kernel rounds it: ``1 / sqrt``, each
    correctly rounded (``torch.rsqrt`` is approximate on the card)."""
    return 1.0 / torch.sqrt(x)


def _sel3(m, a, b):
    return torch.where(m[:, None], a, b)


def _take(mats: Materials, idx: torch.Tensor) -> Materials:
    """Per-lane material rows."""
    return Materials(**{f.name: _rows(getattr(mats, f.name), idx)
                        for f in dataclasses.fields(mats)})


def combined_materials(scene: Scene) -> Materials:
    """One material table in the fused kernel's combined id order:
    sphere ++ loose-triangle ++ per-mesh rows (mega.build_aux)."""
    parts = (scene.spheres.materials, scene.triangles.materials,
             scene.meshes.mesh_materials)
    return Materials(**{f.name: torch.cat([getattr(m, f.name)
                                           for m in parts], 0)
                        for f in dataclasses.fields(Materials)})


def trace_records(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                  cfg: RenderConfig, bvh,
                  soft: bool = False) -> Tuple[torch.Tensor, Records]:
    """Fused-kernel bounce chain with hit recording, on the config's leaf
    test (``cfg.tri_isect``) and layout (``cfg.bvh_arity``).

    Returns ``(acc [N,3], records)`` with each record stacked over the
    ``max_bounces + 1`` segments (leading dim B). Every segment launches,
    with no host sync between them (a dead lane writes the record
    defaults, as the twin's skipped segment does); the kernel writes its
    records straight into the ``[B, N, ...]`` buffers. One sync at the end
    checks the stack-overflow counter. No gradient: the records are facts.

    ``soft=True``: shadow walks run in min mode and the records gain
    ``st [B, N, L]``, the per-light nearest occluder distance.
    """
    # the records pass runs the fused kernel whatever cfg.kernel says; the
    # soft temperatures and chunking belong to the replay
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg)
    n, dev = o.shape[0], o.device
    L = scene.lights.positions.shape[0]
    B = cfg.max_bounces + 1
    # the config's leaf test and layout (twin :105-110)
    kw = dict(n_lights=L, n_spheres=scene.spheres.count,
              n_tris=scene.triangles.count, max_bounces=cfg.max_bounces,
              light_cull=cfg.light_cull, tri_isect=cfg.tri_isect,
              use_wide=cfg.bvh_arity != 0)
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.no_grad():
        aux = mega.build_aux(scene, cfg.background)
        recs = (torch.empty((B, n), **f32), torch.empty((B, n, 3), **f32),
                torch.empty((B, n), **f32), torch.empty((B, n), **f32))
        if soft:
            recs += (torch.empty((B, n, L), **f32),)
        acc = torch.zeros((n, 3), **f32)
        thr = torch.ones((n, 3), **f32)
        tmax = torch.full((n,), 3.0e38, **f32)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        o, d = o.detach(), d.detach()
        for depth in range(B):
            delta, o, d, thr, tmax, _ = mega.trace_segment(
                bvh, aux, depth, o, d, thr, tmax, record=True,
                record_soft=soft, overflow=overflow,
                out=tuple(r[depth] for r in recs), **kw)
            acc = acc + delta
        if dev.type == "cuda":
            mega.check_overflow(overflow)
    return acc, recs


def _sphere_t(o, d, center, r2, selected):
    """Reference smallest-positive-root sphere t (RMath.cs:81-108) for the
    per-lane SELECTED sphere; differentiable w.r.t. center/r2. Masked
    lanes stay finite with a zero gradient (double where)."""
    oc = o - center
    uoc = dot3(d, oc)
    oc2 = dot3(oc, oc)
    disc = uoc * uoc - (oc2 - r2)
    pos = selected & (disc > 0.0)
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    big = -uoc + sq
    small = -uoc - sq
    return torch.where(small < 0.0, big, small)


def _winner_geometry(scene: Scene, o, d, t_rec, n_rec, comb_f, hit):
    """Differentiable ``(t_safe, p, n, comb)`` for recorded winners.

    Spheres / loose triangles are re-derived analytically from the scene
    parameters (full gradients); mesh winners go through the frozen plane
    (value t_rec, chain gradient through o/d kept). Non-hit lanes carry
    safe finite values."""
    S = scene.spheres.count
    T = scene.triangles.count
    K = scene.meshes.mesh_aabb_min.shape[0]
    comb = comb_f.to(torch.int64).clamp(0, S + T + K - 1)
    is_sp = hit & (comb_f >= 0.0) & (comb_f < S)
    is_lo = hit & (comb_f >= S) & (comb_f < S + T)

    if S:
        sidx = comb.clamp(0, S - 1)
        c_sel = _rows(scene.spheres.centers, sidx)
        r2_sel = _rows(scene.spheres.radius_sq, sidx)
        t_sph = _sphere_t(o, d, c_sel, r2_sel, is_sp)
    if T:
        tidx = (comb - S).clamp(0, T - 1)
        tv = _rows(scene.triangles.verts, tidx)                 # [N,3,3]
        t_tri = _mt_one(o, d, tv[:, 0], tv[:, 1], tv[:, 2])
        t_tri = torch.where(is_lo & torch.isfinite(t_tri), t_tri, 1.0)
        n_tri = _rows(scene.triangles.normals, tidx)

    # mesh winners: plane-intersection t against the FROZEN winner plane
    # (constant point p0 + recorded normal); value t_rec, d t/d(o,d) kept
    # for mirror-chain gradients. The twin writes t_plane + stop_gradient(
    # t_rec - t_plane), whose value is t_rec up to one rounding; this
    # form's value is t_rec exactly, with the same gradient.
    p0 = o.detach() + d.detach() * t_rec[:, None]
    denom = dot3(n_rec, d)
    denom = torch.where(denom.abs() < 1e-12, 1.0, denom)
    t_plane = dot3(n_rec, p0 - o) / denom
    t_mesh = t_rec + (t_plane - t_plane.detach())
    t = torch.where(hit & (comb_f >= S + T), t_mesh, t_rec)
    n = n_rec
    if S:
        t = torch.where(is_sp, t_sph, t)
    if T:
        t = torch.where(is_lo, t_tri, t)
    t_safe = torch.where(hit, t, 1.0)
    p = o + d * t_safe[:, None]
    if S:
        n_sph = (p - c_sel) * _rsqrt(_max(r2_sel, 1e-60))[:, None]
        n = _sel3(is_sp, n_sph, n)
    if T:
        n = _sel3(is_lo, n_tri, n)
    return t_safe, p, n, comb


def replay_lighting(scene: Scene, p, n, v, mats: Materials,
                    occbits: torch.Tensor, mask: torch.Tensor,
                    light_cull: float = 0.0):
    """Direct lighting with visibility frozen to the recorded per-light
    occlusion bits — the terms of the twin's shade.direct_lighting, no
    queries."""
    occ_int = occbits.to(torch.int32)
    color = mats.ambient * scene.lights.ambient[None, :]
    L = scene.lights.positions.shape[0]
    if L == 0:
        return color

    lvec = scene.lights.positions[None, :, :] - p[:, None, :]   # [N,L,3]
    ldist_sq = dot3(lvec, lvec)
    ldir = lvec * _rsqrt(_max(ldist_sq, 1e-60))[..., None]
    ln = dot3(ldir, n[:, None, :])                              # [N,L]

    occ = torch.stack([(occ_int >> l) & 1 for l in range(L)], 1) > 0
    need = (ln >= 0.0) & scene.lights.valid[None, :] & mask[:, None]
    if light_cull > 0.0:
        # the recording kernel's attenuation gate: culled lanes' bits
        # were never computed, so their terms stay off
        kdks = mats.diffuse.amax(-1) + mats.specular.amax(-1)
        imax = scene.lights.intensities.amax(-1)
        need = need & (kdks[:, None] * imax[None, :]
                       >= light_cull * ldist_sq).detach()
    vis = (need & ~occ).to(torch.float32)

    irr = scene.lights.intensities[None, :, :] \
        / _max(ldist_sq, 1e-60)[..., None]                      # [N,L,3]
    diffuse = mats.diffuse[:, None, :] * _max(ln, 0.0)[..., None] * irr

    hv = ldir + v[:, None, :]
    # n . (hv / |hv|), associated as the kernel does: sum (n_i hv_i) / |hv|
    hinv = _rsqrt(_max(dot3(hv, hv), 1e-60))[..., None]
    nh = _max(dot3(n[:, None, :] * hv, hinv.expand_as(hv)), 0.0)
    # the nh > 0 gate mirrors the kernel: at nh == 0 with phong == 0,
    # exp(phong * log(max(nh, 1e-30))) would be 1, false specular light
    spec_term = torch.where(
        nh > 0.0,
        torch.exp(mats.phong[:, None] * torch.log(_max(nh, 1e-30))), 0.0)
    spec = mats.specular[:, None, :] * spec_term[..., None] * irr
    return color + ((diffuse + spec) * vis[..., None]).sum(1)


def _n_segments(B: int, live_segments: Optional[int]) -> int:
    return B if live_segments is None else min(B, max(1, live_segments))


def replay_radiance(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                    records: Records, cfg: RenderConfig,
                    live_segments: int | None = None) -> torch.Tensor:
    """Differentiable radiance [N,3] (0-255 scale) from frozen records.

    Unrolled over the segments; each is shading only. ``live_segments``:
    process only the first k segments — exact if no record beyond the
    prefix is live (caller-measured, ``live_depth``); None processes
    all."""
    rt_all, rn_all, rmat_all, rocc_all = records[:4]
    B = rt_all.shape[0]
    mats_table = combined_materials(scene)
    bg = torch.tensor(cfg.background, dtype=torch.float32,
                      device=o.device) * 255.0
    n_rays = o.shape[0]
    acc = torch.zeros((n_rays, 3), dtype=torch.float32, device=o.device)
    thr = torch.ones((n_rays, 3), dtype=torch.float32, device=o.device)
    live = torch.ones((n_rays,), dtype=torch.bool, device=o.device)

    n_seg = _n_segments(B, live_segments)
    for s in range(n_seg):
        t_rec, n_rec = rt_all[s].detach(), rn_all[s].detach()
        comb_f, occ = rmat_all[s].detach(), rocc_all[s].detach()
        hit = live & (t_rec >= 0.0)
        _, p, n, comb = _winner_geometry(scene, o, d, t_rec, n_rec, comb_f,
                                         hit)
        mats = _take(mats_table, comb)
        local = replay_lighting(scene, p, n, -d, mats, occ, hit,
                                light_cull=cfg.light_cull)
        contrib = _sel3(hit, local, bg.expand(n_rays, 3))
        acc = acc + thr * contrib * live[:, None]
        if s == B - 1:
            break
        cont = hit & mats.is_mirror & (s < cfg.max_bounces)
        thr = _sel3(cont, thr * mats.mirror, thr)
        o = p + n * SHADOW_EPS
        d = _sel3(cont, reflect_dir(d, n), d)
        live = cont
    return acc


def _soup_box(scene: Scene):
    """The mesh-soup box of the proxy-risk diagnostic (a conservative
    entry test for proxy lanes whose shadow rays the hard forward never
    queried): the valid mesh vertices' box, widened on each face by the
    scene gate's pad there (``aabb_min - gate_min``, ``gate_max -
    aabb_max``), so that it under-counts no lane whose shadow ray meets
    the mesh on its face. While the mesh lies in the scene box that pad is
    at least ``pad_box``'s own for the soup box (2^-16 of the largest
    |coordinate|), and it takes two operations a face where ``pad_box``
    takes twelve. Built once per diagnostic replay: the mesh vertices may
    be fit parameters, so it is not kept with the scene."""
    mv = scene.meshes.verts                                     # [M,3,3]
    mvalid = scene.meshes.valid[:, None, None]
    lo = torch.where(mvalid, mv, torch.inf).amin(dim=(0, 1))
    hi = torch.where(mvalid, mv, -torch.inf).amax(dim=(0, 1))
    return (lo - (scene.aabb_min - scene.gate_min),
            hi + (scene.gate_max - scene.aabb_max))


def _soft_lighting(scene: Scene, p, n, v, mats: Materials,
                   st_rec: torch.Tensor, cfg: RenderConfig,
                   diag_proxy: torch.Tensor | None = None,
                   diag_box=None):
    """Soft-shadow direct lighting from the recorded mesh min-t plus
    recomputed sphere / loose-triangle occluder minima, with no traversal.
    ``st_rec [N,L]`` is the min-mode record (_BIG when unoccluded);
    sphere/loose occluders are re-derived so their silhouette gradients
    flow; the mesh branch is a frozen constant. Every temporary is [N] or
    [N,3] (unrolled over lights, spheres, loose triangles).

    ``diag_proxy`` ([N] bool, the segment's proxy-adopted lanes) switches
    on the bias diagnostics, with ``diag_box`` the ``_soup_box``: the
    return is then ``(color, frozen_any, frozen_band_any,
    proxy_risk_any)`` as in the twin (``:354-365``)."""
    temp = cfg.diff.soft_shadow_temp
    stt = cfg.diff.straight_through
    color = mats.ambient * scene.lights.ambient[None, :]
    L = scene.lights.positions.shape[0]
    if L == 0:
        return color
    so = p + n * SHADOW_EPS
    S = scene.spheres.count
    T = scene.triangles.count
    if cfg.light_cull > 0.0:
        kdks = mats.diffuse.amax(-1) + mats.specular.amax(-1)

    diag = diag_proxy is not None
    if diag:
        n_lanes = p.shape[0]
        frozen_any = torch.zeros((n_lanes,), dtype=torch.bool,
                                 device=p.device)
        frozen_band_any = torch.zeros_like(frozen_any)
        proxy_risk_any = torch.zeros_like(frozen_any)
        mesh_lo, mesh_hi = diag_box

    acc = color
    for l in range(L):
        lp = scene.lights.positions[l]
        lint = scene.lights.intensities[l]                      # [3]
        lvec = lp[None, :] - p                                  # [N,3]
        ld2 = dot3(lvec, lvec)
        linv = _rsqrt(_max(ld2, 1e-60))
        ldir = lvec * linv[:, None]
        ln = dot3(ldir, n)

        st = torch.full_like(ld2, _BIG)
        for s in range(S):
            oc = so - scene.spheres.centers[s][None, :]
            uoc = dot3(ldir, oc)
            oc2 = dot3(oc, oc)
            disc = uoc * uoc - (oc2 - scene.spheres.radius_sq[s])
            pos = disc > 0.0
            # double where: masked lanes get a zero subgradient
            sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)),
                             0.0)
            bigroot = -uoc + sq
            small = -uoc - sq
            t_s = torch.where(small < 0.0, bigroot, small)
            ok = (disc >= 0.0) & (bigroot >= 0.0) & scene.spheres.valid[s]
            st = torch.minimum(st, torch.where(ok, t_s, _BIG))
        for ti in range(T):
            tv = scene.triangles.verts[ti]
            tt = _mt_one(so, ldir, tv[0][None], tv[1][None], tv[2][None])
            tt = torch.where(torch.isfinite(tt) & scene.triangles.valid[ti],
                             tt, _BIG)
            st = torch.minimum(st, tt)
        # scene-AABB gate (the twin's shadow_min_t inherits IntersectRay's
        # early-out), on the widened gate box as shadow_min_t tests it
        in_box = isect.ray_aabb(so, ldir, scene.gate_min[None, :],
                                scene.gate_max[None, :])
        st = torch.where(in_box, st, _BIG)
        stl = st_rec[:, l]
        if diag:
            # biased regime: the mesh record wins the occluder min and
            # occludes — its d(st) chain terms are frozen below
            lit = scene.lights.valid[l] & (ln >= 0.0)
            stl2 = stl * stl
            mesh_wins = (stl < st) & (stl2 < ld2) & lit
            band = (stl2 - ld2).abs() < 30.0 * max(temp, 1e-6)
            far = stl * (1.0 + FROZEN_MARGIN)
            frozen_any = frozen_any | (
                (far < st) & (far * far < ld2) & lit)
            frozen_band_any = frozen_band_any | (mesh_wins & band)
            proxy_risk_any = proxy_risk_any | (
                diag_proxy & lit
                & isect.ray_aabb(so, ldir, mesh_lo[None, :],
                                 mesh_hi[None, :]))
        # min with the frozen mesh record; <= keeps the differentiable
        # branch at exact ties
        st = torch.where(st <= stl, st, stl.detach())
        occ = (st * st) < ld2
        vis = _soft_or_hard_vis(~occ, st * st - ld2, temp, stt)

        irr_s = 1.0 / _max(ld2, 1e-60)                           # [N]
        dterm = _max(ln, 0.0) * irr_s * vis
        hv = ldir + v
        hinv = _rsqrt(_max(dot3(hv, hv), 1e-60))[:, None]
        nh = _max(dot3(n * hv, hinv.expand_as(hv)), 0.0)
        # nh > 0 gate as in the kernel; the double where keeps
        # d(nh**phong)/d(nh) = inf at nh == 0 off the masked lanes
        pos_nh = nh > 0.0
        sterm = (torch.where(pos_nh,
                             torch.where(pos_nh, nh, 1.0) ** mats.phong, 0.0)
                 * (ln >= 0.0).to(torch.float32) * irr_s * vis)
        keepf = scene.lights.valid[l].to(torch.float32)
        if cfg.light_cull > 0.0:
            keepf = keepf * (kdks * lint.max() >= cfg.light_cull * ld2
                             ).detach().to(torch.float32)
        acc = acc + (mats.diffuse * (dterm * keepf)[:, None]
                     + mats.specular * (sterm * keepf)[:, None]
                     ) * lint[None, :]
    if diag:
        return acc, frozen_any, frozen_band_any, proxy_risk_any
    return acc


def replay_radiance_soft(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                         records: Records, cfg: RenderConfig,
                         live_segments: int | None = None,
                         with_diag: bool = False):
    """Differentiable soft-visibility radiance from soft records — the
    silhouette-fitting path.

    Under ``straight_through`` the forward value equals the hard image
    (soft terms enter gradients only). Sphere silhouettes (the soft-hit
    proxy/winner margins) and sphere / loose-triangle soft shadows are
    recomputed exactly; mesh winner geometry and mesh-occluder st are
    frozen records; proxy (miss-side silhouette) lanes assume no mesh
    occlusion of their shadow rays (the hard forward never queried them).

    ``with_diag=True`` also returns the lane counts of those biased
    regimes: ``{"mesh_occ_frozen", "mesh_occ_in_band",
    "proxy_mesh_risk"}`` (Python ints)."""
    rt_all, rn_all, rmat_all, _, rst_all = records
    B = rt_all.shape[0]
    S = scene.spheres.count
    mats_table = combined_materials(scene)
    dev = o.device
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=dev) \
        * 255.0
    n_rays = o.shape[0]
    acc = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    thr = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    live = torch.ones((n_rays,), dtype=torch.bool, device=dev)
    ht = cfg.diff.soft_hit_temp
    stt = cfg.diff.straight_through
    diag_acc = [0, 0, 0]
    soup = _soup_box(scene) if with_diag else None

    for s in range(_n_segments(B, live_segments)):
        t_rec, n_rec = rt_all[s].detach(), rn_all[s].detach()
        comb_f, st_rec = rmat_all[s].detach(), rst_all[s].detach()
        hit = live & (t_rec >= 0.0)
        _, p, n, comb = _winner_geometry(scene, o, d, t_rec, n_rec, comb_f,
                                         hit)
        shade_mask = hit
        w = hit.to(torch.float32)
        comb2 = comb
        use_proxy = torch.zeros((n_rays,), dtype=torch.bool, device=dev)
        if ht > 0.0 and S:
            # sphere silhouette relaxation (the twin's render.
            # _local_radiance proxy adoption and margin blend) as a
            # running argmax over the unrolled sphere table
            margs = []
            m_best = torch.full((n_rays,), -torch.inf, device=dev)
            j_best = torch.zeros((n_rays,), dtype=torch.int64, device=dev)
            t_prox = torch.full((n_rays,), 1e-3, device=dev)
            for si in range(S):
                oc = o - scene.spheres.centers[si][None, :]
                uoc = dot3(d, oc)
                oc2 = dot3(oc, oc)
                r2s = scene.spheres.radius_sq[si]
                disc = uoc * uoc - (oc2 - r2s)
                marg = disc / _max(r2s, 1e-12)
                ok = ((-uoc) > 0.0) & scene.spheres.valid[si]
                marg = torch.where(ok, marg, -torch.inf)
                margs.append(marg)
                better = marg > m_best   # the first max wins ties (argmax)
                m_best = torch.where(better, marg, m_best)
                j_best = torch.where(better, si, j_best)
                t_prox = torch.where(better, _max(-uoc, 1e-3), t_prox)
            use_proxy = live & ~hit & torch.isfinite(m_best)
            c_prox = _rows(scene.spheres.centers, j_best)
            p = _sel3(use_proxy, o + d * t_prox[:, None], p)
            n_prox = p - c_prox
            n_prox = n_prox * _rsqrt(_max(dot3(n_prox, n_prox),
                                          1e-60))[:, None]
            n = _sel3(use_proxy, n_prox, n)
            comb2 = torch.where(use_proxy, j_best, comb)
            shade_mask = hit | use_proxy
            win_sphere = hit & (comb_f >= 0.0) & (comb_f < S)
            sel_idx = torch.where(win_sphere, comb.clamp(0, S - 1), j_best)
            own = margs[0]
            for si in range(1, S):
                own = torch.where(sel_idx == si, margs[si], own)
            margin_sel = torch.where(win_sphere | use_proxy, own, torch.inf)
            x = margin_sel / ht
            w_soft = torch.sigmoid(torch.minimum(_max(x, -30.0),
                                                 x.new_full((), 30.0)))
            w = (w_soft + (hit.to(torch.float32) - w_soft).detach()
                 if stt else w_soft)

        mats = _take(mats_table, comb2)
        if with_diag:
            local, frozen, frozen_band, proxy_risk = _soft_lighting(
                scene, p, n, -d, mats, st_rec, cfg, diag_proxy=use_proxy,
                diag_box=soup)
            diag_acc[0] += int((frozen & shade_mask).sum())
            diag_acc[1] += int((frozen_band & shade_mask).sum())
            diag_acc[2] += int(proxy_risk.sum())
        else:
            local = _soft_lighting(scene, p, n, -d, mats, st_rec, cfg)
        local_safe = _sel3(shade_mask, local, bg.expand(n_rays, 3))
        contrib = bg[None, :] + w[:, None] * (local_safe - bg[None, :])
        acc = acc + thr * contrib * live[:, None]
        if s == B - 1:
            break
        cont = hit & mats.is_mirror & (s < cfg.max_bounces)
        thr = _sel3(cont, thr * mats.mirror, thr)
        o = p + n * SHADOW_EPS
        d = _sel3(cont, reflect_dir(d, n), d)
        live = cont
    if with_diag:
        return acc, {"mesh_occ_frozen": diag_acc[0],
                     "mesh_occ_in_band": diag_acc[1],
                     "proxy_mesh_risk": diag_acc[2]}
    return acc


def _chunk_records(o, d, target, weights, recs, chunk):
    """Reshape per-lane tensors to [nc, chunk, ...] (records keep their
    leading segment dim inside each chunk: [nc, B, chunk, ...]), padding
    with dead lanes and zero weights. Returns ``(oc, dc, tc, wc, rc,
    n_eff)``."""
    n = o.shape[0]
    pad = (-n) % chunk
    dev = o.device
    w = (weights.to(torch.float32) if weights is not None
         else torch.ones((n,), dtype=torch.float32, device=dev))
    if pad:
        z = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
        z[:, 2] = 1.0
        o = torch.cat([o, z], 0)
        d = torch.cat([d, z], 0)
        if target is not None:
            target = torch.cat([target, torch.zeros_like(z)], 0)
        w = torch.cat([w, torch.zeros((pad,), dtype=torch.float32,
                                      device=dev)])
        fills = (-1.0, 0.0, -1.0, 0.0, _BIG)
        recs = tuple(
            torch.cat([r, torch.full((r.shape[0], pad) + r.shape[2:], fill,
                                     dtype=r.dtype, device=dev)], 1)
            for r, fill in zip(recs, fills))
    nc = o.shape[0] // chunk
    cl = lambda x: x.reshape(nc, chunk, *x.shape[1:])
    cr = lambda r: r.reshape(r.shape[0], nc, chunk,
                             *r.shape[2:]).movedim(1, 0)
    return (cl(o), cl(d), cl(target) if target is not None else None, cl(w),
            tuple(cr(r) for r in recs), w.sum())


def trace_radiance_replay_soft(scene: Scene, o: torch.Tensor,
                               d: torch.Tensor, cfg: RenderConfig, bvh,
                               live_segments: int | None = None,
                               chunk: int | None = None) -> torch.Tensor:
    """Soft records + the soft replay. The forward equals the hard image
    (straight-through); gradients carry the soft silhouette/shadow terms.
    ``chunk`` replays the records in chunks of that many lanes."""
    _, recs = trace_records(scene, o, d, cfg, bvh, soft=True)
    if not chunk or chunk >= o.shape[0]:
        return replay_radiance_soft(scene, o, d, recs, cfg,
                                    live_segments=live_segments)
    n = o.shape[0]
    oc, dc, _, _, rc, _ = _chunk_records(o, d, None, None, recs, chunk)
    rad = [replay_radiance_soft(scene, oc[i], dc[i],
                                tuple(r[i] for r in rc), cfg,
                                live_segments=live_segments)
           for i in range(oc.shape[0])]
    return torch.cat(rad, 0)[:n]


def soft_replay_bias_counts(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                            cfg: RenderConfig, bvh,
                            live_segments: int | None = None
                            ) -> Dict[str, int]:
    """One soft-records pass + the diagnostic replay -> the biased-regime
    lane counts of ``replay_radiance_soft(with_diag=True)``. Run once at
    fit start (``fit`` warns when they are not zero)."""
    _, recs = trace_records(scene, o, d, cfg, bvh, soft=True)
    with torch.no_grad():
        _, diag = replay_radiance_soft(scene, o, d, recs, cfg,
                                       live_segments=live_segments,
                                       with_diag=True)
    return diag


def _mse(rad, target, weights):
    if weights is None:
        return ((rad - target) ** 2).mean()
    return (((rad - target) ** 2) * weights[:, None]).sum() \
        / (weights.sum() * 3.0)


def _leaves(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fresh leaf tensors holding the parameter values (the caller's
    tensors and their .grad stay untouched)."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def _grads(leaves: Dict[str, torch.Tensor], scale=None):
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad)
            / (1.0 if scale is None else scale) for k, v in leaves.items()}


def soft_replay_value_and_grad(template: Scene, params, o, d, target,
                               cfg: RenderConfig, bvh, weights=None,
                               live_segments: int | None = None,
                               chunk: int | None = None):
    """The soft fwd+bwd step: min-mode records with the CURRENT params,
    then the pixel-MSE value and gradient through the soft replay.
    ``params``: {name: tensor} (``fit.PARAM_PATHS`` names); returns
    ``(loss, grads)`` like the twin. ``weights`` (optional [N]): per-lane
    loss weights (e.g. zero on the block-raygen pad margin); the loss is
    then the weighted mean. ``chunk``: the replay runs in chunks of that
    many lanes, each chunk's summed squared error back-propagated on its
    own into the same ``.grad`` and divided once by ``n_eff * 3`` at the
    end — the twin's scan-of-vjp sum, with one chunk's graph alive at a
    time."""
    from unity_raytracer_tpu_torch.fit import set_params

    _, recs = trace_records(set_params(template, params), o, d, cfg, bvh,
                            soft=True)
    leaves = _leaves(params)
    scene = set_params(template, leaves)
    if not chunk or chunk >= o.shape[0]:
        rad = replay_radiance_soft(scene, o, d, recs, cfg,
                                   live_segments=live_segments)
        loss = _mse(rad, target, weights)
        loss.backward()
        return loss.detach(), _grads(leaves)

    oc, dc, tc, wc, rc, n_eff = _chunk_records(o, d, target, weights, recs,
                                               chunk)
    loss = torch.zeros((), dtype=torch.float32, device=o.device)
    for i in range(oc.shape[0]):
        rad = replay_radiance_soft(scene, oc[i], dc[i],
                                   tuple(r[i] for r in rc), cfg,
                                   live_segments=live_segments)
        l_i = (((rad - tc[i]) ** 2) * wc[i][:, None]).sum()
        l_i.backward()
        loss = loss + l_i.detach()
    denom = n_eff * 3.0
    return loss / denom, _grads(leaves, denom)


def trace_radiance_replay(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                          cfg: RenderConfig, bvh) -> torch.Tensor:
    """Forward records + the differentiable replay: the radiance equals
    the fused kernel's to rounding, and gradients flow to every
    ``fit.PARAM_PATHS`` class."""
    _, recs = trace_records(scene, o, d, cfg, bvh)
    return replay_radiance(scene, o, d, recs, cfg)


def live_depth(records) -> int:
    """Number of bounce segments with at least one hit record — the exact
    prefix for ``live_segments``. One host sync; stable across a fit
    (the mirror topology does not change), so measure once and reuse."""
    return int((records[0] >= 0.0).any(dim=1).sum())


def replay_value_and_grad(template: Scene, params, o, d, target,
                          cfg: RenderConfig, bvh, weights=None,
                          live_segments: int | None = None):
    """One fused fwd+bwd step: records with the CURRENT params, then the
    pixel-MSE value and gradient through the replay. ``target`` is
    radiance on the 0-255 scale, [N,3] like the ray batch. This is the
    unit the twin's ``bench.py`` times as fwd+bwd."""
    from unity_raytracer_tpu_torch.fit import set_params

    _, recs = trace_records(set_params(template, params), o, d, cfg, bvh)
    leaves = _leaves(params)
    rad = replay_radiance(set_params(template, leaves), o, d, recs, cfg,
                          live_segments=live_segments)
    loss = _mse(rad, target, weights)
    loss.backward()
    return loss.detach(), _grads(leaves)
