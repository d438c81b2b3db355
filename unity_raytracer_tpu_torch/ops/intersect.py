"""Batched ray/primitive tests (plain, differentiable torch).

Twin: ``unity_raytracer_tpu/ops/intersect.py`` — a partial port of what the
record-replay training path needs: ``ray_aabb`` (``:61-82``), plus
``dot3``, the 3-vector dot product summed left to right. Still to port
under ROADMAP Queue A #10: ``ray_spheres``, ``ray_triangles``,
``nearest_hit`` and the ``Hit`` record (the composed path).
"""

from __future__ import annotations

import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b).sum(-1)`` over a last dimension of 3, summed left to
    right as the fused kernel sums it (``.sum`` may associate otherwise
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
