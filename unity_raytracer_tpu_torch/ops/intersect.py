"""Batched ray/primitive tests and the nearest hit (plain, differentiable torch).

Twin: ``unity_raytracer_tpu/ops/intersect.py`` — ``Hit`` and the ``KIND_*``
codes (``:31-58``), ``ray_aabb`` (``:61-82``), ``ray_spheres`` and
``_safe_sqrt`` (``:85-115``), ``ray_triangles`` (``:144-168``),
``sphere_margins`` (``:171-194``), ``_best`` (``:197-206``) and
``nearest_hit`` (``:209-296``), plus ``dot3``, the 3-vector dot product
summed left to right as the CUDA kernels sum it, and ``ray_spheres_mm``
(``:118-141``), the matrix form of ``ray_spheres`` (no path calls it).

Every function is an ``[N rays] x [N prims]`` broadcast with masks for the
rejects, so branch conditions carry gradients through ``t``. A miss is
``t = +inf``. Hit identity follows the reference's category order (mesh
triangles, then spheres, then loose triangles, strict ``>`` updates,
Data/Objects/Scene.cs:64-115).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

EPS = 1e-5          # triangle epsilon, RMath.cs:9
INF = float("inf")

KIND_NONE = 0
KIND_MESH = 1
KIND_SPHERE = 2
KIND_TRI = 3


@dataclass(frozen=True)
class Hit:
    """Per-ray nearest-hit record (SoA over rays), the reference's
    ``IntersectionResult`` as parallel tensors."""

    t: torch.Tensor           # [N] distance; +inf on miss
    kind: torch.Tensor        # [N] int32 category code
    index: torch.Tensor       # [N] int32 primitive index within category
    mesh_index: torch.Tensor  # [N] int32 mesh id for mesh hits, else -1
    # shading normal of mesh hits from the BVH traversal epilogue; None on
    # the brute-force path (surface_attributes gathers the normal table)
    mesh_n: Optional[torch.Tensor] = None

    @property
    def is_hit(self) -> torch.Tensor:
        return self.kind != KIND_NONE


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b).sum(-1)`` over a last dimension of 3, summed left to
    right as the CUDA kernels sum it (``.sum`` may associate otherwise
    on the card). The replay recomputes hit points the kernel computed;
    a phong-200 highlight turns a one-ulp difference there into a
    1e-4-relative difference of radiance."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def ray_aabb(o: torch.Tensor, d: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """Slab test with ``tmin`` seeded 0 (an origin inside the box hits),
    as RMath.RayAABBIntersection (RMath.cs:12-26). ``o, d [...,3]`` and
    ``lo, hi [...,3]`` broadcast; returns a bool mask. A zero direction
    component divides to +-inf, as in the twin."""
    inv = 1.0 / d
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    # sequential per-axis fold, the scalar loop's clamping order
    tmin = torch.zeros((), dtype=o.dtype, device=o.device)
    tmax = torch.full((), torch.inf, dtype=o.dtype, device=o.device)
    for i in range(3):
        a, b = t1[..., i], t2[..., i]
        tmin = torch.minimum(torch.maximum(a, tmin), torch.maximum(b, tmin))
        tmax = torch.maximum(torch.minimum(a, tmax), torch.minimum(b, tmax))
    return tmin <= tmax


def _safe_sqrt(disc: torch.Tensor) -> torch.Tensor:
    """sqrt(disc) with exact forward values and a zero gradient where
    disc <= 0 (tangent rays, where sqrt' is unbounded): double ``where``."""
    pos = disc > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)


def ray_spheres(o: torch.Tensor, d: torch.Tensor, centers: torch.Tensor,
                radius_sq: torch.Tensor,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """All-pairs ray/sphere distances ``t [N,S]`` (+inf = miss): half-b
    quadratic on the squared radius, smallest non-negative root
    (RMath.cs:81-108); an origin inside the sphere takes the far root."""
    oc = o[:, None, :] - centers[None, :, :]            # [N,S,3]
    uoc = dot3(d[:, None, :], oc)                       # [N,S]
    oc_sq = dot3(oc, oc)
    disc = uoc * uoc - (oc_sq - radius_sq[None, :])
    sq = _safe_sqrt(disc)
    big = -uoc + sq
    small = -uoc - sq
    t = torch.where(small < 0, big, small)
    miss = (disc < 0) | (big < 0)
    if valid is not None:
        miss = miss | ~valid[None, :]
    return torch.where(miss, INF, t)


def ray_spheres_mm(o: torch.Tensor, d: torch.Tensor, centers: torch.Tensor,
                   radius_sq: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """``ray_spheres`` with its two inner products as matrix products,
    for large N x S: ``d.oc = d.o - d @ C^T`` and ``|oc|^2 = |o|^2 - 2 o @
    C^T + |C|^2``. The same results up to floating-point association."""
    dC = d @ centers.T                                   # [N,S]
    oC = o @ centers.T                                   # [N,S]
    do = (d * o).sum(-1, keepdim=True)                   # [N,1]
    oo = (o * o).sum(-1, keepdim=True)                   # [N,1]
    cc = (centers * centers).sum(-1)[None, :]            # [1,S]
    uoc = do - dC
    oc_sq = oo - 2.0 * oC + cc
    disc = uoc * uoc - (oc_sq - radius_sq[None, :])
    sq = _safe_sqrt(disc)
    big = -uoc + sq
    small = -uoc - sq
    t = torch.where(small < 0, big, small)
    miss = (disc < 0) | (big < 0)
    if valid is not None:
        miss = miss | ~valid[None, :]
    return torch.where(miss, INF, t)


def ray_triangles(o: torch.Tensor, d: torch.Tensor, verts: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """All-pairs Möller–Trumbore ``t [N,T]`` (+inf = miss), with the
    rejects of RMath.RayTriangleIntersection (RMath.cs:29-73): |det| <
    1e-5, u outside [0,1], v < 0, u+v > 1, t <= 1e-5. All-zero padding
    triangles fall to the parallel reject."""
    v0 = verts[:, 0, :]                                  # [T,3]
    e1 = verts[:, 1, :] - v0
    e2 = verts[:, 2, :] - v0
    h = torch.linalg.cross(d[:, None, :], e2[None, :, :], dim=-1)  # [N,T,3]
    a = dot3(e1[None, :, :], h)                          # [N,T]
    parallel = a.abs() < EPS
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = o[:, None, :] - v0[None, :, :]                   # [N,T,3]
    u = f * dot3(s, h)
    q = torch.linalg.cross(s, e1[None, :, :], dim=-1)    # [N,T,3]
    v = f * dot3(d[:, None, :], q)
    t = f * dot3(e2[None, :, :], q)
    miss = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (t <= EPS))
    if valid is not None:
        miss = miss | ~valid[None, :]
    return torch.where(miss, INF, t)


def sphere_margins(scene, o: torch.Tensor, d: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-silhouette support: per-(ray, sphere) hit margin
    ``disc / r^2`` (> 0 inside the silhouette, 0 at its edge, -inf for
    spheres behind the origin or invalid) and closest-approach distance
    ``max(-d.oc, 1e-3)``; both ``[N,S]``."""
    centers = scene.spheres.centers
    r2 = scene.spheres.radius_sq
    oc = o[:, None, :] - centers[None, :, :]
    uoc = dot3(d[:, None, :], oc)
    oc_sq = dot3(oc, oc)
    disc = uoc * uoc - (oc_sq - r2[None, :])
    margin = disc / torch.maximum(r2[None, :], r2.new_full((), 1e-12))
    ok = ((-uoc) > 0.0) & scene.spheres.valid[None, :]
    margin = torch.where(ok, margin, -INF)
    t_close = torch.maximum(-uoc, uoc.new_full((), 1e-3))
    return margin, t_close


def _best(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray (min t, argmin), the first minimum on ties — the
    reference's strict-``>`` update keeps the earliest of equals
    (Scene.cs:72-81)."""
    tmin, idx = t.min(dim=1)
    return tmin, idx.to(torch.int32)


def nearest_mesh_triangle(o: torch.Tensor, d: torch.Tensor,
                          verts: torch.Tensor, valid: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest triangle of a soup by the brute-force nearest-triangle
    kernel (``ops/kernels/intersect_mk``, its plain version on the CPU):
    ``(t [N], index [N] >= 0)``, +inf where nothing is hit. The kernel's
    ``t`` is re-derived differentiably from the winning triangle, falling
    back to the kernel's value where the re-derivation misses on
    rounding."""
    from unity_raytracer_tpu_torch.ops.bvh import _mt_one
    from unity_raytracer_tpu_torch.ops.kernels.intersect_mk import (
        nearest_triangle_pallas)
    t_k, idx = nearest_triangle_pallas(o, d, verts, valid)
    idx = idx.clamp_min(0)
    tri = verts[idx.long()]
    t_diff = _mt_one(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
    t = torch.where(torch.isfinite(t_k),
                    torch.where(torch.isfinite(t_diff), t_diff, t_k), INF)
    return t, idx


def nearest_hit(scene, o: torch.Tensor, d: torch.Tensor, bvh=None,
                kernel: str = "auto",
                t_max: torch.Tensor | None = None,
                overflow: torch.Tensor | None = None) -> Hit:
    """Nearest hit over the three categories, by brute force or through
    the BVH (``ops/bvh.traverse_any``), combined mesh -> sphere -> loose
    triangle with strict ``>`` (Scene.cs:43-122) and masked by the scene
    AABB (Scene.cs:54), tested as ``Scene.gate_min`` / ``gate_max`` (the
    exact box widened by ``pad_box``, so that a hit on its face is kept).

    Without a BVH, a mesh of >= 2048 triangles with ``kernel`` 'pallas*'
    or 'mega' goes through the brute-force nearest-triangle kernel
    (``nearest_mesh_triangle``). ``t_max`` (detached) culls a
    lane of the BVH walk when negative; ``overflow`` goes to the walk
    (``ops/bvh.traverse_any``)."""
    mesh_n = None
    if bvh is None:
        if ((kernel.startswith("pallas") or kernel == "mega")
                and scene.meshes.verts.shape[0] >= 2048):
            t_mesh, i_mesh = nearest_mesh_triangle(o, d, scene.meshes.verts,
                                                   scene.meshes.valid)
        else:
            t_mesh, i_mesh = _best(ray_triangles(o, d, scene.meshes.verts,
                                                 scene.meshes.valid))
    else:
        from unity_raytracer_tpu_torch.ops.bvh import traverse_any
        t_mesh, i_mesh, nml = traverse_any(
            bvh, o, d, kernel=kernel,
            t_max=None if t_max is None else t_max.detach(),
            overflow=overflow)
        i_mesh = i_mesh.clamp_min(0)  # downstream masks on kind
        canonical = bvh.bvh.canonical if hasattr(bvh, "bvh") \
            else bvh.canonical
        if canonical:
            mesh_n = nml
    t_sph, i_sph = _best(ray_spheres(o, d, scene.spheres.centers,
                                     scene.spheres.radius_sq,
                                     scene.spheres.valid))
    t_tri, i_tri = _best(ray_triangles(o, d, scene.triangles.verts,
                                       scene.triangles.valid))

    i32 = dict(dtype=torch.int32, device=o.device)
    t = t_mesh
    fin = torch.isfinite(t_mesh)
    kind = torch.where(fin, KIND_MESH, KIND_NONE).to(torch.int32)
    index = torch.where(fin, i_mesh.to(torch.int32),
                        torch.full((), -1, **i32))
    for kind_c, t_c, i_c in ((KIND_SPHERE, t_sph, i_sph),
                             (KIND_TRI, t_tri, i_tri)):
        upd = t > t_c                        # strict > (Scene.cs:94,107)
        t = torch.where(upd, t_c, t)
        kind = torch.where(upd, torch.full((), kind_c, **i32), kind)
        index = torch.where(upd, i_c, index)

    in_box = ray_aabb(o, d, scene.gate_min[None, :], scene.gate_max[None, :])
    t = torch.where(in_box, t, INF)
    kind = torch.where(in_box, kind, torch.full((), KIND_NONE, **i32))
    index = torch.where(in_box, index, torch.full((), -1, **i32))

    # clipped to the mesh table: a sphere or loose winner's index may
    # exceed M (masked below, but it must still be a valid gather)
    mesh_index = torch.where(
        kind == KIND_MESH,
        scene.meshes.mesh_id[index.clamp(0, scene.meshes.count - 1).long()],
        torch.full((), -1, **i32))
    return Hit(t=t, kind=kind, index=index,
               mesh_index=mesh_index.to(torch.int32), mesh_n=mesh_n)
