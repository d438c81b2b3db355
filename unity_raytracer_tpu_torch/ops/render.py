"""Wavefront renderer: primary rays -> mirror bounce chain or dielectric tree -> image.

Twin: ``unity_raytracer_tpu/ops/render.py`` — ``_local_radiance``
(``:42-130``), ``_trace_chain_mega`` (``:133-184``), ``_trace_chain``
(``:187-268``), ``_trace_tree`` (``:271-412``), ``_trace_tree_mega``
(``:435-546``), ``resolve_mode``, ``trace_radiance`` (``:578-592``),
``trace_radiance_stats`` (``:595-600``), ``trace_radiance_tree_stats``
(``:603-611``), ``render_frame`` and ``render`` (``:614-660``). Radiance
accumulates on the reference's 0-255 scale and is divided by 255 at the
end (Data/Shading/Rgb.cs:13).

``mode='scan'`` is the reference's mirror-only chain, ``mode='tree'`` the
level-synchronous Whitted tree with dielectric reflect/refract forks
(``resolve_mode`` picks it for a scene with a dielectric). Each runs on
one of two routes:

* **fused** — ``kernel='mega'`` and hard visibility (``uses_fused``):
  each segment, or each tree level, is one launch of the fused segment
  kernel (``ops/kernels/mega.py``) on the config's leaf test and layout;
  the chain needs a ``PackedBVH`` with ``leafmeta``, the tree runs a
  scene without mesh triangles without one (the meshless instance). All
  segments launch; dead rays exit at their first instruction, so no host
  sync is needed between them.
* **composed** — everything else: ``nearest_hit`` (BVH walk, brute force,
  or the brute-force nearest-triangle kernel), ``direct_lighting`` with
  light-major shadow queries, and the mirror continuation or the tree's
  fork, in differentiable torch around the traversal kernels. Retired
  lanes get ``t_max = -1``, so the kernels cull them. A chain segment with
  no live lane is skipped, as the twin's ``lax.cond`` skips it: that test
  is one host sync per segment, and once a segment is dead the rest are
  too. A caller that passes its own stack-overflow counter (``overflow``;
  ``fit.GraphedComposedStep``, which captures the chain in a CUDA graph)
  gets every segment run instead, with no live test and no overflow read:
  a dead segment's lanes all carry ``t_max = -1`` and it adds exactly 0
  to the radiance, so the chain makes no host sync and the caller reads
  the counter. ``cfg.remat`` runs each chain segment under
  ``torch.utils.checkpoint`` (the backward recomputes it; the kernels are
  deterministic, so the recompute equals the forward). The background row
  is built once a chain or tree, not once a segment.

Both tree routes compact the lanes between levels the same way (the
composed tree's rule: weakest throughput first, stable, one gather) and
count the live lanes ``tree_cap`` drops (``trace_radiance_tree_stats``);
the twin's fused tree drops whole overflow tiles without a count (ROADMAP
Queue C #1) and silently ignores a mesh it was given no BVH for (Queue C
#2), where the port raises ``ValueError``.

``kernel='auto'`` is composed, as in the twin; its walk is the ordered
binary kernel on the card and the plain per-lane walk elsewhere
(``ops/bvh.traverse_any``).

``render`` chunks a frame over rays when ``cfg.ray_chunk`` is below the
pixel count (the twin's ``_frame_chunked``, ``:645-688``): the
block-ordered rays go through ``trace_radiance`` one chunk at a time, the
last chunk padded with the twin's filler rays. A chain lane depends on no
other lane, so a chunked chain equals the unchunked one bit for bit; a
tree applies ``tree_cap`` per chunk, as the twin's does.

Spans (``utils/profiling.span``, kept only while a recording runs):
``render`` > ``render.raygen``, ``chain`` or ``tree``, ``render.unswizzle``;
``chain`` > ``chain.aux``, ``chain.segment`` (attribute ``depth``; around
the segment's launch, or the composed segment), ``chain.sync`` (the live
test of a composed segment, the overflow check; neither runs, nor the
span, where the caller passes its counter); ``tree`` > ``tree.aux``,
``tree.level`` (attribute ``level``) > ``tree.fork`` (attribute
``level``; around the fork launch), ``tree.fold``, ``tree.compact``
(attribute ``level`` on the fused tree), then ``tree.sync``. Counters:
``tree.lanes`` (lanes of a fork launch), ``tree.live`` (the live lanes
handed to each fork launch: every primary lane at level 0, then
``_compact``'s live lanes (the next launch's live lanes up to the cap)
or, where the level was not compacted, the children with ``tmax >= 0``),
``tree.dropped`` (``_compact``'s live lanes past the cap: 0 unless the cap
cut the tree), and on the composed chain ``chain.live`` and
``chain.shadow`` (live nearest and shadow lanes of a segment). All are
device tensors or ints the code makes anyway, but the live children of an
uncompacted fused level (one sum over its lanes), which only a recorded
frame (or capture) computes.

On the card ``render_frame`` runs the fused route's frames through
``ops/graphs``: a key's first frame eagerly, its second captured as
CUDA graphs (span ``render.capture``, holding the spans above), every
later one a replay of them (``render.graph``; while a recording runs,
the replay of the capture cut at each stage, which holds a
``chain.segment`` span around each segment's graph, or a ``tree.fork``
span around each fork launch's graph and a ``tree.compact`` span around
each compaction's; then ``render.sync``: the overflow read; the eager
frame reads it there too).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.scene import Scene
from unity_raytracer_tpu_torch.ops import bvh as bvhmod
from unity_raytracer_tpu_torch.ops import graphs
from unity_raytracer_tpu_torch.ops import shade as sh
from unity_raytracer_tpu_torch.ops.intersect import (
    KIND_SPHERE, Hit, dot3, nearest_hit)
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import check_overflow
from unity_raytracer_tpu_torch.utils.config import RenderConfig
from unity_raytracer_tpu_torch.utils.profiling import count, is_recording, span
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
    """Whether the segments run on the fused kernel (the twin's tests at
    ``:214-218`` and ``:587-592``): ``kernel='mega'`` with hard
    visibility, and for the scan chain a packed BVH with ``leafmeta`` (the
    tree takes a scene without mesh triangles without one). Any leaf test
    and layout: ``ops/kernels/mega.segment_route`` picks the instance."""
    if cfg.kernel != "mega" or cfg.diff.soft_hit_temp != 0.0 \
            or cfg.diff.soft_shadow_temp != 0.0:
        return False
    return cfg.mode == "tree" or (
        bvh is not None and getattr(bvh, "leafmeta", None) is not None)


def check_supported(cfg: RenderConfig) -> None:
    """Raise ``ValueError`` for an unknown kernel or an unresolved mode
    (every leaf test, layout and mode is ported)."""
    if cfg.kernel not in KERNELS:
        raise ValueError(f"unknown kernel {cfg.kernel!r}; have {KERNELS}")
    if cfg.mode not in ("scan", "tree"):
        raise ValueError(f"mode={cfg.mode!r} is unresolved; call "
                         f"resolve_mode first")


def _local_radiance(scene: Scene, o, d, cfg: RenderConfig, hit: Hit,
                    bg: torch.Tensor, bvh=None,
                    active: torch.Tensor | None = None,
                    with_stats: bool = False,
                    overflow: torch.Tensor | None = None):
    """One segment's surface point, attributes and local shading.

    Returns ``(contrib [N,3] (local radiance or background ``bg``, the
    caller's ``mega.background_row``), p, n, mats, hit_mask)``, paired with
    the live shadow-query count under ``with_stats``. With
    ``cfg.diff.soft_hit_temp > 0`` a missing ray adopts a proxy hit on its
    best near-miss sphere (first maximum of the silhouette margin), shaded
    at the closest-approach point, and the segment blends toward it with
    ``sigmoid(margin / temp)``; with ``straight_through`` the forward
    value stays hard. Masked lanes carry finite values. ``overflow`` goes
    to the shadow walks."""
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
    local_safe = torch.where(shade_mask[:, None], local, bg[None, :])
    contrib = bg[None, :] + w[:, None] * (local_safe - bg[None, :])
    out = (contrib, p, n, mats, hit_mask)
    return (out, n_shadow) if with_stats else out


def _segment_kw(scene: Scene, cfg: RenderConfig, has_mesh: bool = True):
    """The fused segment's scene counts, cap, leaf test and layout (the
    twin's chain passes ``use_wide=cfg.bvh_arity != 0``, ``:153``)."""
    return dict(n_lights=scene.lights.positions.shape[0],
                n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
                max_bounces=cfg.max_bounces, light_cull=cfg.light_cull,
                tri_isect=cfg.tri_isect if has_mesh else "mt",
                use_wide=cfg.bvh_arity != 0, has_mesh=has_mesh)


def _trace_chain_mega(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                      cfg: RenderConfig, bvh, overflow=None,
                      bg=None, stage=span) -> torch.Tensor:
    """Mirror bounce chain, one fused segment launch per depth. Returns
    radiance [N,3] on the 0-255 scale. Raises if a launch dropped stack
    entries (one host sync, after the last segment). ``overflow``: an
    int32 [1] device counter of dropped pushes that the caller checks
    instead (no sync here); ``bg``: ``mega.build_aux``'s; ``stage``: the
    context each segment launch runs in, ``span`` or a capture's
    (``ops/graphs``)."""
    with span("chain"):
        with span("chain.aux"):
            aux = mega.build_aux(scene, cfg.background, bg)
        n = o.shape[0]
        acc = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
        thr = torch.ones((n, 3), dtype=torch.float32, device=o.device)
        tmax = torch.full((n,), 3.0e38, dtype=torch.float32, device=o.device)
        check = overflow is None and o.device.type == "cuda"
        if overflow is None:
            overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
        for depth in range(cfg.max_bounces + 1):
            with stage("chain.segment", depth=depth):
                delta, o, d, thr, tmax = mega.trace_segment(
                    bvh, aux, depth, o, d, thr, tmax, overflow=overflow,
                    **_segment_kw(scene, cfg))
            acc = acc + delta
        if check:
            with span("chain.sync"):
                mega.check_overflow(overflow)
    return acc


def _segment(scene: Scene, cfg: RenderConfig, bvh, depth: int, o, d, thr,
             active, acc, overflow, bg):
    """One composed bounce segment (the twin's ``live_seg``): returns the
    next ``(o, d, thr, active, acc)`` and the live shadow-query count.
    Its walks add dropped stack pushes to ``overflow``."""
    tmax = torch.where(active, 3.0e38, -1.0)
    hit = nearest_hit(scene, o, d, bvh=bvh, kernel=cfg.kernel, t_max=tmax,
                      overflow=overflow)
    (contrib, p, n, mats, hit_mask), n_shadow = _local_radiance(
        scene, o, d, cfg, hit, bg, bvh=bvh, active=active, with_stats=True,
        overflow=overflow)
    acc = acc + thr * contrib * active[:, None]
    cont = (active & hit_mask & mats.is_mirror
            & (depth < cfg.max_bounces))
    thr = torch.where(cont[:, None], thr * mats.mirror, thr)
    o = p + n * SHADOW_EPS    # Reflect origin offset (:368-373)
    d = torch.where(cont[:, None], sh.reflect_dir(d, n), d)
    return o, d, thr, cont, acc, n_shadow


def _trace_chain(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                 cfg: RenderConfig, bvh=None, with_stats: bool = False,
                 overflow: torch.Tensor | None = None,
                 bg: torch.Tensor | None = None):
    """Mirror-only linear bounce chain — the exact reference semantics.

    Segment s contributes ``prod(mirror_0..s-1) * local_s``; the chain
    stops at the first non-mirror hit or miss, and segment ``max_bounces``
    shades but spawns nothing (RayTracingSetup.cs:358). Runs on the fused
    kernel when ``uses_fused`` (and not ``with_stats``), else composed.
    ``with_stats`` also returns ``(live [B], shadow_live [B])`` int32
    lane counts per segment. The walks of the whole chain share one
    stack-overflow counter, checked once at the end (a raise if any push
    was dropped). ``overflow``: the caller's int32 [1] counter instead,
    which the caller reads; the composed chain then runs every segment
    (no live test, no host sync: a dead segment adds exactly 0) and
    checkpoints without stashing the RNG state (a segment draws no random
    numbers), so a CUDA graph can hold it (``fit.GraphedComposedStep``,
    which also passes ``bg``, ``mega.background_row`` built outside the
    graph; else it is built here, a copy from the host)."""
    if not with_stats and uses_fused(cfg, bvh):
        return _trace_chain_mega(scene, o, d, cfg, bvh, overflow=overflow,
                                 bg=bg)
    with span("chain"):
        n = o.shape[0]
        f32 = dict(dtype=torch.float32, device=o.device)
        acc = torch.zeros((n, 3), **f32)
        thr = torch.ones((n, 3), **f32)
        active = torch.ones((n,), dtype=torch.bool, device=o.device)
        if bg is None:
            bg = mega.background_row(cfg.background, o.device)
        live, shadow = [], []
        zero = torch.zeros((), dtype=torch.int32, device=o.device)
        every = overflow is not None   # the caller's counter: no sync here
        if overflow is None:
            overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
        for depth in range(cfg.max_bounces + 1):
            n_live = active.sum(dtype=torch.int32)
            if not every:
                with span("chain.sync"):
                    dead = not bool(n_live > 0)  # the twin's dead_seg; a sync
                if dead:
                    live.append(zero)
                    shadow.append(zero)
                    continue
            args = (scene, cfg, bvh, depth, o, d, thr, active, acc, overflow,
                    bg)
            with span("chain.segment", depth=depth):
                if cfg.remat:
                    o, d, thr, active, acc, n_shadow = checkpoint(
                        _segment, *args, use_reentrant=False,
                        preserve_rng_state=not every)
                else:
                    o, d, thr, active, acc, n_shadow = _segment(*args)
                count("chain.live", n_live)
                count("chain.shadow", n_shadow)
            live.append(n_live)
            shadow.append(n_shadow)
        if not every and o.device.type == "cuda":
            with span("chain.sync"):
                check_overflow(overflow, "traversal")
    if with_stats:
        return acc, (torch.stack(live), torch.stack(shadow))
    return acc


def _compact(cap: int, live, o, d, weight, parent, extra=None):
    """Dead-fork compaction (the twin's ``:362-405``): when the lanes
    outnumber ``cap``, drop the zero-weight ones, order the rest by a
    stable descending sort of their throughput ``sum |w|`` and keep the
    first ``cap``, gathering the packed lane state with one
    ``index_select``. Returns ``(live, o, d, weight, parent, extra,
    dropped)``: ``dropped`` counts the live lanes cut (a device tensor, no
    host sync); ``extra`` ([N] float, e.g. the fused tree's tmax) rides
    along."""
    live = live & (weight != 0.0).any(dim=-1)
    w = weight.detach().abs()
    score = torch.where(live, w[:, 0] + w[:, 1] + w[:, 2], -1.0)
    n_live = live.sum()
    count("tree.live", n_live)
    dropped = torch.clamp_min(n_live - cap, 0)
    count("tree.dropped", dropped)
    order = torch.argsort(-score, stable=True)[:cap]
    cols = [o, d, weight, parent.view(torch.float32)[:, None],
            live.to(torch.float32)[:, None]]
    if extra is not None:
        cols.append(extra[:, None])
    sel = torch.cat(cols, dim=1).index_select(0, order)
    part = lambda a, b: sel[:, a:b].contiguous()  # the kernels read rows
    return (sel[:, 10] > 0.5, part(0, 3), part(3, 6), part(6, 9),
            sel[:, 9].detach().contiguous().view(torch.int32),
            None if extra is None else sel[:, 11].contiguous(), dropped)


def _trace_tree(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                cfg: RenderConfig, bvh=None, with_stats: bool = False,
                overflow: torch.Tensor | None = None,
                bg: torch.Tensor | None = None):
    """Whitted tree with mirror and dielectric branches as a
    level-synchronous wavefront (the twin's ``_trace_tree``).

    Each level is one batched composed stage over the lane array:
    ``nearest_hit`` and ``_local_radiance`` on the live lanes, each lane's
    weighted radiance folded into its primary ray with ``index_add``, then
    every hit forks into a reflect child (weight ``is_mirror * mirror +
    is_dielectric * F * transparency``, Schlick F) and a refract child
    (``is_dielectric * (1 - F) * transparency``, none on total internal
    reflection), concatenated. Past ``cfg.tree_cap * N`` lanes the array
    is compacted (``_compact``); a mirror-only scene keeps one lane per
    ray. Differentiable. Returns radiance [N,3] (0-255 scale), and with
    ``with_stats`` the count of live lanes the cap dropped (a device
    tensor: no host sync per level). The walks share one stack-overflow
    counter, checked once at the end, unless the caller gives its own
    ``overflow`` counter to read; ``bg``: as in ``_trace_chain``."""
    n = o.shape[0]
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    branching = scene.has_dielectrics
    acc = torch.zeros((n, 3), **f32)
    parent = torch.arange(n, dtype=torch.int32, device=dev)
    weight = torch.ones((n, 3), **f32)
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    n_truncated = torch.zeros((), dtype=torch.int64, device=dev)
    check = overflow is None and dev.type == "cuda"
    if overflow is None:
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    cap = (cfg.tree_cap or 0) * n
    up = torch.tensor([0.0, 0.0, 1.0], **f32)
    if bg is None:
        bg = mega.background_row(cfg.background, dev)
    for level in range(cfg.max_bounces + 1):
        tmax = torch.where(live, 3.0e38, -1.0)
        hit = nearest_hit(scene, o, d, bvh=bvh, kernel=cfg.kernel,
                          t_max=tmax, overflow=overflow)
        contrib, p, nrm, mats, hit_mask = _local_radiance(
            scene, o, d, cfg, hit, bg, bvh=bvh, active=live,
            overflow=overflow)
        acc = acc.index_add(0, parent, weight * contrib * live[:, None])
        if level == cfg.max_bounces:
            break
        hm = hit_mask[:, None]
        d_dot_n = dot3(d, nrm)[:, None]
        entering = d_dot_n < 0.0
        n_eff = torch.where(entering, nrm, -nrm)
        is_die = mats.is_dielectric[:, None]
        is_mir = mats.is_mirror[:, None]
        n_refl = torch.where(is_die, n_eff, nrm)
        ro = p + n_refl * SHADOW_EPS   # Reflect origin offset (:368-373)
        rd_safe = torch.where(hm, sh.reflect_dir(d, n_refl), up)
        n1 = torch.where(entering[:, 0], 1.0, mats.ior)
        n2 = torch.where(entering[:, 0], mats.ior, 1.0)
        cos_i = d_dot_n[:, 0].abs()
        refr_d, tir = sh.refract_dir(d, n_eff, n1 / n2)
        fres = torch.where(tir, 1.0,
                           sh.schlick_fresnel(cos_i, n1, n2))[:, None]
        w_refl = (is_mir * mats.mirror
                  + is_die * fres * mats.transparency) * hm
        refl_live = live & hit_mask & (mats.is_mirror | mats.is_dielectric)
        if not branching:
            o, d = ro, rd_safe
            weight = weight * w_refl
            live = refl_live
            continue
        to = p - n_eff * SHADOW_EPS
        refr_ok = hm & is_die & ~tir[:, None]
        w_refr = (is_die * (1.0 - fres) * mats.transparency
                  * refr_ok.to(torch.float32))
        refr_live = live & hit_mask & mats.is_dielectric & ~tir
        o = torch.cat([ro, to], dim=0)
        d = torch.cat([rd_safe, torch.where(refr_ok, refr_d, up)], dim=0)
        weight = torch.cat([weight * w_refl, weight * w_refr], dim=0)
        parent = torch.cat([parent, parent], dim=0)
        live = torch.cat([refl_live, refr_live], dim=0)
        if cap and o.shape[0] > cap:
            live, o, d, weight, parent, _, dropped = _compact(
                cap, live, o, d, weight, parent)
            n_truncated = n_truncated + dropped
    if check:
        check_overflow(overflow, "traversal")
    return (acc, n_truncated) if with_stats else acc


def _trace_tree_mega(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                     cfg: RenderConfig, bvh=None, with_stats: bool = False,
                     overflow=None, bg=None, stage=span):
    """The tree on the fused kernel: one fork launch per level
    (``mega.trace_segment(fork=True)``: nearest hit, shadows, shading and
    both children), ``index_add`` of each lane's delta into its primary
    ray, and between levels the composed tree's compaction
    (``_compact``), so with nothing truncated both routes shade the same
    lanes. ``bvh``: the packed BVH of the scene's mesh; without one the
    scene must have no mesh triangles (the meshless instance walks
    nothing), else ``ValueError``. Forward only. Returns radiance [N,3],
    and with ``with_stats`` the live lanes the cap dropped. One host sync
    at the end checks the stack-overflow counter, unless the caller gives
    its own ``overflow`` counter to check; ``bg``: ``mega.build_aux``'s;
    ``stage``: the context each level's fork launch and compaction run in,
    ``span`` or a capture's (``ops/graphs``)."""
    has_mesh = bvh is not None and getattr(bvh, "leafmeta", None) is not None
    # a CUDA graph capture cannot read the device: the eager frame that
    # precedes every capture of a key (ops/graphs) made this check
    capturing = o.is_cuda and torch.cuda.is_current_stream_capturing()
    if not has_mesh and not capturing and bool(scene.meshes.valid.any()):
        raise ValueError(
            "the fused tree (kernel='mega') walks mesh triangles through a "
            "packed BVH with leafmeta, and this scene has mesh triangles "
            "but none was given: pass one from ops/bvh.prepare_bvh (or set "
            "cfg.use_bvh)")
    with span("tree"):
        n = o.shape[0]
        dev = o.device
        f32 = dict(dtype=torch.float32, device=dev)
        with span("tree.aux"):
            aux = mega.build_aux(scene, cfg.background, bg)
        kw = _segment_kw(scene, cfg, has_mesh)
        packed = bvh if has_mesh else None
        acc = torch.zeros((n, 3), **f32)
        parent = torch.arange(n, dtype=torch.int32, device=dev)
        weight = torch.ones((n, 3), **f32)
        tmax = torch.full((n,), 3.0e38, **f32)
        n_truncated = torch.zeros((), dtype=torch.int64, device=dev)
        check = overflow is None and dev.type == "cuda"
        if overflow is None:
            overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        cap = (cfg.tree_cap or 0) * n
        count("tree.live", n)   # every primary lane enters level 0 live
        for level in range(cfg.max_bounces + 1):
            with span("tree.level", level=level):
                with stage("tree.fork", level=level):
                    count("tree.lanes", o.shape[0])
                    (delta, ro, rd, w_re, tm_re, to, td, w_tr,
                     tm_tr) = mega.trace_segment(
                        packed, aux, level, o, d, weight, tmax, fork=True,
                        overflow=overflow, **kw)
                with span("tree.fold"):
                    acc = acc.index_add(0, parent, delta)
                if level == cfg.max_bounces:
                    break
                o = torch.cat([ro, to], dim=0)
                d = torch.cat([rd, td], dim=0)
                weight = torch.cat([w_re, w_tr], dim=0)
                tmax = torch.cat([tm_re, tm_tr], dim=0)
                parent = torch.cat([parent, parent], dim=0)
                if cap and o.shape[0] > cap:
                    with stage("tree.compact", level=level):
                        live, o, d, weight, parent, tmax, dropped = _compact(
                            cap, tmax >= 0.0, o, d, weight, parent, tmax)
                    # outside the stage: a capture's piece between two
                    # stages is never empty
                    tmax = torch.where(live, tmax, -1.0)
                    n_truncated = n_truncated + dropped
                elif is_recording():   # a sum no unrecorded frame needs
                    count("tree.live", (tmax >= 0.0).sum())
        if check:
            with span("tree.sync"):
                check_overflow(overflow)
    return (acc, n_truncated) if with_stats else acc


def _trace_tree_any(scene, o, d, cfg, bvh, with_stats=False, overflow=None,
                    bg=None):
    """The tree on its route: fused when ``uses_fused``, else composed."""
    if uses_fused(cfg, bvh):
        return _trace_tree_mega(scene, o, d, cfg, bvh, with_stats, overflow,
                                bg)
    return _trace_tree(scene, o, d, cfg, bvh, with_stats, overflow, bg)


def trace_radiance(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                   cfg: RenderConfig, bvh=None,
                   overflow: torch.Tensor | None = None,
                   bg: torch.Tensor | None = None) -> torch.Tensor:
    """Radiance [N,3] (0-255 scale) for arbitrary ray batches; ``bvh=None``
    intersects by brute force. ``overflow``: the caller's stack-overflow
    counter, which it reads itself, and ``bg``: the background row built
    once by the caller (``_trace_chain``: the composed chain then runs
    every segment, with no host sync and no copy from the host)."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg)
    if cfg.mode == "tree":
        return _trace_tree_any(scene, o, d, cfg, bvh, overflow=overflow,
                               bg=bg)
    return _trace_chain(scene, o, d, cfg, bvh=bvh, overflow=overflow, bg=bg)


def trace_radiance_stats(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                         cfg: RenderConfig, bvh=None):
    """The composed chain with per-segment ``(live nearest lanes, live
    shadow lanes)`` counts: ``(radiance, (live [B], shadow [B]))`` —
    bench.py's live-ray accounting."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg)
    return _trace_chain(scene, o, d, cfg, bvh=bvh, with_stats=True)


def trace_radiance_tree_stats(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                              cfg: RenderConfig, bvh=None):
    """The tree on its route (fused or composed) -> ``(radiance [N,3],
    n_truncated [])``: the live weighted lanes ``tree_cap`` dropped, an
    accuracy loss when > 0. A device tensor, read without a host callback.
    Unlike the twin's (composed only), the fused route counts too."""
    cfg = resolve_mode(scene, cfg).with_(mode="tree")
    check_supported(cfg)
    return _trace_tree_any(scene, o, d, cfg, bvh, with_stats=True)


def _frame(cam: Camera, cfg: RenderConfig, trace, chunk: int = 0
           ) -> torch.Tensor:
    """Block-order raygen, ``trace(o, d)`` -> radiance [N,3], then
    un-swizzle and /255 -> [H,W,3]. With ``chunk``, ``trace`` takes chunks
    of ``chunk`` rays, the last padded with the twin's filler rays (origin
    and direction +z); a tree's ``tree_cap`` then applies per chunk, as in
    the twin."""
    with span("render.raygen"):
        o, d = generate_rays_blocks(cam, cfg.block_size)
        total = o.shape[0]
        pad = (-total) % chunk if chunk else 0
        if pad:
            filler = torch.zeros((pad, 3), dtype=o.dtype, device=o.device)
            filler[:, 2] = 1.0
            o, d = torch.cat([o, filler]), torch.cat([d, filler])
    if chunk:
        rad = torch.cat([trace(o[i:i + chunk], d[i:i + chunk])
                         for i in range(0, total + pad, chunk)])[:total]
    else:
        rad = trace(o, d)
    with span("render.unswizzle"):
        return unswizzle_image(rad, cam.width, cam.height,
                               cfg.block_size) / 255.0


def _frame_eager(scene: Scene, cam: Camera, cfg: RenderConfig, bvh=None,
                 chunk: int = 0) -> torch.Tensor:
    """``render_frame`` off the fused route, or on the CPU; with
    ``chunk``, ``render``'s chunked frame."""
    return _frame(cam, cfg, lambda o, d: trace_radiance(scene, o, d, cfg,
                                                        bvh=bvh), chunk)


def _frame_fused(scene: Scene, cam: Camera, cfg: RenderConfig, bvh, bg,
                 stage=span):
    """The fused frame on the card, as ``ops/graphs`` runs it eagerly and
    captures it: the eager frame's functions, its stack-overflow counter
    made (zeroed) here and returned unread, ``bg`` for the aux block,
    ``stage`` around each chain segment, or each tree level's fork launch
    and compaction -> ``(image, overflow)``."""
    overflow = torch.zeros(1, dtype=torch.int32, device=cam.position.device)
    if cfg.mode == "tree":
        trace = lambda o, d: _trace_tree_mega(
            scene, o, d, cfg, bvh, overflow=overflow, bg=bg, stage=stage)
    else:
        trace = lambda o, d: _trace_chain_mega(
            scene, o, d, cfg, bvh, overflow=overflow, bg=bg, stage=stage)
    return _frame(cam, cfg, trace), overflow


# the fused frames' CUDA graphs of this process; FRAME_GRAPHS.clear() frees
# them
FRAME_GRAPHS = graphs.FrameGraphs(_frame_fused)


def render_frame(scene: Scene, cam: Camera, cfg: RenderConfig,
                 bvh=None) -> torch.Tensor:
    """Block-order raygen -> trace -> unswizzle -> [H,W,3] image on the
    display (0-1) scale, on the camera's device. On the card the fused
    route's frames go through ``FRAME_GRAPHS`` (``ops/graphs``): from a
    key's second frame on, each frame is a CUDA graph replay."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg)
    if cam.position.device.type == "cuda" and uses_fused(cfg, bvh):
        return FRAME_GRAPHS(scene, cam, cfg, bvh)
    return _frame_eager(scene, cam, cfg, bvh)


def render(scene: Scene, cam: Camera, cfg: RenderConfig,
           bvh=None) -> torch.Tensor:
    """Render the full image [H,W,3] on the display (0-1) scale: resolve
    'auto' mode, build the BVH ``cfg.kernel`` walks on the scene's device
    if ``cfg.use_bvh`` and none was passed, then ``render_frame``, or the
    chunked frame when ``cfg.ray_chunk`` is below the pixel count."""
    with span("render"):
        cfg = resolve_mode(scene, cfg)
        check_supported(cfg)
        if cfg.use_bvh and bvh is None:
            bvh = bvhmod.prepare_bvh(scene, cfg, scene.aabb_min.device)
        if cfg.ray_chunk and cfg.ray_chunk < cam.width * cam.height:
            return _frame_eager(scene, cam, cfg, bvh, cfg.ray_chunk)
        return render_frame(scene, cam, cfg, bvh)
