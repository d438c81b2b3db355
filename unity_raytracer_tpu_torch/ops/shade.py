"""Batched Blinn-Phong shading and surface attributes (plain, differentiable torch).

Twin: ``unity_raytracer_tpu/ops/shade.py`` — ``SHADOW_EPS`` (``:22``),
``surface_attributes`` (``:51-112``), ``shadow_min_t`` (``:115-143``),
``_soft_or_hard_vis`` (``:146-156``), ``direct_lighting``
(``:159-255``), ``reflect_dir``, ``refract_dir`` and ``schlick_fresnel``
(``:258-284``). ``take_rows`` (``:32-48``) is a TPU gather workaround and
is not ported: the port indexes (``index_select``, whose backward is one
``index_add_``). Control flow of the reference's recursive shader
(RayTracingSetup.cs:304-455) is masks; radiance is on its 0-255 scale.

Gradient rules are the twin's: ``torch.maximum`` where it writes
``jnp.maximum`` (ties split the gradient alike), a double ``where`` under
masked square roots and powers, ``.detach()`` for ``stop_gradient``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unity_raytracer_tpu_torch.models.scene import Materials, Scene
from unity_raytracer_tpu_torch.ops import intersect as isect
from unity_raytracer_tpu_torch.ops.intersect import (
    Hit, KIND_MESH, KIND_SPHERE, dot3)

SHADOW_EPS = 1e-4  # ShadowRayEpsilon, RayTracingSetup.cs:42


def _sel3(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask[:, None], a, b)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a small table and one index per lane. Its
    gradient is a scatter-add either way; ``index_select``'s backward is
    ``index_add_`` (atomics on the card), where the backward of ``table
    [idx]`` sorts the indices and sums each table row's millions of
    duplicates in one warp — 1.6 s for the flagship replay on an H100,
    against milliseconds (PERF.md)."""
    return torch.index_select(table, 0, idx.long())


def surface_attributes(scene: Scene, p: torch.Tensor,
                       hit: Hit) -> Tuple[torch.Tensor, Materials]:
    """Per-ray surface normal and material, selected by category: sphere
    normals from the hit point (GetSphereNormal, RayTracingSetup.cs:
    402-407), loose-triangle normals from their table, mesh normals from
    the traversal epilogue (``hit.mesh_n``) or the mesh table; materials
    from one combined sphere ++ loose-triangle ++ mesh table."""
    idx = hit.index.clamp_min(0)
    is_s = hit.kind == KIND_SPHERE
    is_m = hit.kind == KIND_MESH
    s_cnt = scene.spheres.count
    t_cnt = scene.triangles.count
    k_cnt = scene.meshes.mesh_aabb_min.shape[0]

    sc = _rows(scene.spheres.centers, idx.clamp(0, s_cnt - 1))
    sn = p - sc
    n2 = dot3(sn, sn)[:, None]
    # the twin clamps with max(x, 1e-60), which is max(x, 0) in float32
    sn = sn * (1.0 / torch.sqrt(torch.maximum(n2, n2.new_zeros(()))))
    tn = _rows(scene.triangles.normals, idx.clamp(0, t_cnt - 1))
    if hit.mesh_n is not None:
        mn = hit.mesh_n
    else:
        mn = _rows(scene.meshes.normals, idx.clamp(0, scene.meshes.count - 1))
    n = _sel3(is_s, sn, _sel3(is_m, mn, tn))

    comb = torch.where(
        is_s, idx.clamp(0, s_cnt - 1),
        torch.where(is_m,
                    s_cnt + t_cnt + hit.mesh_index.clamp(0, k_cnt - 1),
                    s_cnt + idx.clamp(0, t_cnt - 1)))
    parts = (scene.spheres.materials, scene.triangles.materials,
             scene.meshes.mesh_materials)
    mats = Materials(**{
        f: _rows(torch.cat([getattr(m, f) for m in parts], 0), comb)
        for f in ("diffuse", "ambient", "mirror", "specular", "phong",
                  "is_mirror", "transparency", "ior", "is_dielectric")})
    return n, mats


def shadow_min_t(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                 bvh=None, t_max: torch.Tensor | None = None,
                 kernel: str = "auto", any_hit: bool = False,
                 overflow: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest occluder distance per ray, +inf on a miss (the occlusion
    predicate ``t^2 < light distance^2`` needs only the distance). With a
    BVH, ``t_max`` (the light distance) seeds the walk's cull and a
    negative one culls the lane; ``any_hit`` stops a lane at its first
    occluder (hard shadows only: its t is an occluder, not the nearest);
    ``overflow`` as in ``ops/bvh.traverse_any``. Without a BVH, the mesh
    is tested by the plain ``[N, M]`` brute force, as in the twin. The
    scene-box gate tests ``Scene.gate_min`` / ``gate_max``."""
    if bvh is None:
        t_m = isect.ray_triangles(o, d, scene.meshes.verts,
                                  scene.meshes.valid).amin(dim=1)
    else:
        from unity_raytracer_tpu_torch.ops.bvh import traverse_any
        t_m, _, _ = traverse_any(bvh, o, d, t_max=t_max, kernel=kernel,
                                 any_hit=any_hit, overflow=overflow)
    t_s = isect.ray_spheres(o, d, scene.spheres.centers,
                            scene.spheres.radius_sq, scene.spheres.valid)
    t_t = isect.ray_triangles(o, d, scene.triangles.verts,
                              scene.triangles.valid)
    t = torch.minimum(torch.minimum(t_m, t_s.amin(dim=1)), t_t.amin(dim=1))
    in_box = isect.ray_aabb(o, d, scene.gate_min[None, :],
                            scene.gate_max[None, :])
    return torch.where(in_box, t, torch.inf)


def _soft_or_hard_vis(hard: torch.Tensor, margin: torch.Tensor, temp: float,
                      straight_through: bool) -> torch.Tensor:
    """Visibility in [0,1]. temp == 0: hard. Otherwise sigmoid(margin /
    temp); with ``straight_through`` the forward value is the hard one and
    only the gradient is soft (soft + detach(hard - soft))."""
    if temp <= 0.0:
        return hard.to(torch.float32)
    soft = torch.sigmoid(margin / temp)
    if straight_through:
        return soft + (hard.to(torch.float32) - soft).detach()
    return soft


def direct_lighting(scene: Scene, p: torch.Tensor, n: torch.Tensor,
                    v: torch.Tensor, mats: Materials,
                    soft_shadow_temp: float = 0.0,
                    straight_through: bool = True, bvh=None,
                    kernel: str = "auto", mask: torch.Tensor | None = None,
                    light_cull: float = 0.0, with_stats: bool = False,
                    overflow: torch.Tensor | None = None):
    """Ambient + per-light shadowed diffuse + Blinn-Phong specular, [N,3]
    (the light loop of RayTracingSetup.cs:324-356): a shadow ray from
    ``p + n * 1e-4`` toward each light, the light skipped when an
    occluder is closer (:337-345); irradiance ``I / d^2`` (:350);
    ``kd max(0, l.n) E`` and ``ks max(0, n.h)^phong E`` with the halfway
    vector of ``l`` and ``v``, zero when the light is behind the surface.

    ``mask`` marks the lanes whose result is used; shadow queries run only
    for masked-in lanes facing the light (and, with ``light_cull``, above
    the cull bound, whose light then contributes nothing, as in the fused
    kernel). The queries go out light-major (``[L*N]``, one light after
    the other), with ``t_max = -1`` on lanes that need none.
    ``with_stats`` also returns the number of live shadow queries;
    ``overflow`` goes to the shadow walks (``shadow_min_t``)."""
    L = scene.lights.positions.shape[0]
    N = p.shape[0]
    lights = scene.lights
    color = mats.ambient * lights.ambient[None, :]           # (:438-441)

    lvec = lights.positions[None, :, :] - p[:, None, :]      # [N,L,3]
    ldist_sq = dot3(lvec, lvec)                              # [N,L]
    ldist = torch.sqrt(ldist_sq)
    ldir = lvec / ldist[..., None]
    ln = dot3(ldir, n[:, None, :])                           # [N,L]

    need = (ln >= 0.0) & lights.valid[None, :]
    if mask is not None:
        need = need & mask[:, None]
    cull_keep = None
    if light_cull > 0.0:
        kdks = mats.diffuse.amax(dim=-1) + mats.specular.amax(dim=-1)
        imax = lights.intensities.amax(dim=-1)
        cull_keep = kdks[:, None] * imax[None, :] >= light_cull * ldist_sq
        need = need & cull_keep

    so = p + n * SHADOW_EPS
    so_lm = so[None, :, :].expand(L, N, 3).reshape(-1, 3)
    sd_lm = ldir.transpose(0, 1).reshape(-1, 3)
    tmax_lm = torch.where(need, ldist, -1.0).T.reshape(-1)
    st = shadow_min_t(scene, so_lm, sd_lm, bvh=bvh, t_max=tmax_lm,
                      kernel=kernel, any_hit=soft_shadow_temp <= 0.0,
                      overflow=overflow).reshape(L, N).T

    occluded = (st * st) < ldist_sq
    vis = _soft_or_hard_vis(~occluded, (st * st) - ldist_sq,
                            soft_shadow_temp, straight_through)

    zero = p.new_zeros(())
    irr = lights.intensities[None, :, :] / ldist_sq[..., None]  # [N,L,3]
    diffuse = mats.diffuse[:, None, :] * torch.maximum(zero, ln)[..., None] \
        * irr

    hv = ldir + v[:, None, :]
    hv = hv / torch.maximum(torch.linalg.vector_norm(hv, dim=-1,
                                                     keepdim=True),
                            p.new_full((), 1e-30))
    nh = torch.maximum(zero, dot3(n[:, None, :], hv))        # [N,L]
    spec_mask = (ln >= 0.0).to(torch.float32)
    # nh > 0 gate (fused kernel / replay parity): 0 ** 0 == 1 would leak
    # specular for phong 0; the double where keeps the power rule's
    # gradient at nh == 0 out
    pos_nh = nh > 0.0
    spec_term = torch.where(
        pos_nh, torch.where(pos_nh, nh, 1.0) ** mats.phong[:, None], 0.0)
    spec = (mats.specular[:, None, :] * spec_term[..., None] * irr
            * spec_mask[..., None])

    lvalid = lights.valid[None, :, None].to(torch.float32)
    if cull_keep is not None:
        # a culled light contributes nothing (not its unshadowed light)
        lvalid = lvalid * cull_keep[..., None].to(torch.float32)
    color = color + ((diffuse + spec) * vis[..., None] * lvalid).sum(dim=1)
    if with_stats:  # live shadow-query lanes (bench.py's accounting)
        return color, need.sum(dtype=torch.int32)
    return color


def reflect_dir(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror direction ``d - 2 n (d.n)`` (Reflect, RayTracingSetup.cs:
    368-373, with v = -d). Unit length when d and n are."""
    return d - 2.0 * n * dot3(d, n)[..., None]


def refract_dir(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snell refraction (an extension; the reference has none). ``n``
    opposes ``d``. Returns (direction, total-internal-reflection mask);
    the direction is junk on TIR lanes, which callers mask.

    The root is ``sqrt(k)`` for ``k > 0`` and 0 otherwise, with a zero
    gradient at ``k <= 0``. The twin takes ``sqrt(where(k < 0, 1, k))``,
    whose gradient at ``k == 0`` is infinite: a grazing lane, such as every
    soft-hit proxy (its normal is perpendicular to the ray), then turns
    the whole gradient into NaN (ROADMAP Queue C #11). Both give the same
    direction wherever it is used (``k >= 0``)."""
    cos_i = -dot3(d, n)[:, None]
    eta = eta[:, None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = (k < 0.0)[:, 0]
    # double where: sqrt'(0) = inf must not reach any lane
    pos = k > 0.0
    root = torch.where(pos, torch.sqrt(torch.where(pos, k, 1.0)), 0.0)
    out = eta * d + (eta * cos_i - root) * n
    return out, tir


def schlick_fresnel(cos_i: torch.Tensor, n1: torch.Tensor,
                    n2: torch.Tensor) -> torch.Tensor:
    """Schlick's reflectance ``r0 + (1 - r0) (1 - cos_i)^5``, ``r0 =
    ((n1 - n2) / (n1 + n2))^2``. The powers are written as the products
    XLA lowers the twin's ``** 2`` and ``** 5`` to (``x * x`` and ``x *
    ((x * x) * (x * x))``); torch's ``**`` would call ``pow``, which
    rounds differently."""
    q = (n1 - n2) / (n1 + n2)
    r0 = q * q
    c = 1.0 - cos_i
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))
