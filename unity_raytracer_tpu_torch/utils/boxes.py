"""The widening rule of every box a walk or a scene gate tests.

Port only (the JAX package tests its exact boxes). A triangle's hit is
computed off the triangle by a few ulps of the coordinates (more for a
grazing ray) and of t, so a box that holds a triangle exactly can cull
that triangle's hit on its face. ``pad_box`` widens such a box outward by
``GROUP_MARGIN`` of its largest |coordinate| and then one ulp; the walks'
node, wide and group boxes, the fused kernel's scene box and the composed
path's scene gate (``Scene.gate_min`` / ``gate_max``) are all so widened.
No dependency beyond numpy and torch, so that the data layer
(``models/scene``) and the kernel layer share it.
"""

from __future__ import annotations

import numpy as np
import torch

# the kernels also test a group up to the walk's bound x (1 + GROUP_MARGIN)
# (csrc/bvh_walk.cuh kGroupMargin), so that culling errs only towards
# testing a box
GROUP_MARGIN = 2.0 ** -16


def pad_box(lo, hi):
    """The box ``lo, hi [..., 3]`` (float32 numpy arrays, or tensors on
    any device) widened outward by GROUP_MARGIN times its largest
    |coordinate| and then by one ulp (``nextafter``), so that it holds
    every hit its triangles report, which lie a few ulps off the exact
    box. An infinite coordinate (an empty box) keeps its pad at 0."""
    as_np = isinstance(lo, np.ndarray)
    lo, hi = torch.as_tensor(lo), torch.as_tensor(hi)
    pad = torch.nan_to_num(GROUP_MARGIN * torch.maximum(
        lo.abs(), hi.abs()).amax(dim=-1, keepdim=True), posinf=0.0)
    inf = torch.full_like(lo, torch.inf)
    out = torch.nextafter(lo - pad, -inf), torch.nextafter(hi + pad, inf)
    return tuple(t.numpy() for t in out) if as_np else out


def box_rays(scene, n, seed):
    """``(o, d, target)`` float32 numpy, ``n`` rays from ``seed`` aimed at
    the boundary of ``scene``'s exact box (tensors on any device), where
    an unwidened scene gate culls hits: a quarter aimed from points around
    the box (1.5 box diagonals from its centre) at the vertices (mesh,
    loose triangles) that set a face of the box, a quarter at its corners,
    a quarter at seeded points of its edges, and a quarter in a face plane
    (the origin's and the direction's coordinate on that axis exactly the
    face's and 0) at a face-setting vertex of that face. Shared by the
    gate tests (tests/test_torch_gates.py) and the card's smoke run."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.aabb_min.cpu().numpy(), scene.aabb_max.cpu().numpy()
    pts = np.concatenate([
        scene.meshes.verts.cpu().numpy()[scene.meshes.valid.cpu().numpy()],
        scene.triangles.verts.cpu().numpy()[
            scene.triangles.valid.cpu().numpy()]]).reshape(-1, 3)
    pts = np.unique(pts, axis=0)
    ext = pts[((pts == lo) | (pts == hi)).any(axis=1)]
    corners = np.array([[(lo, hi)[(k >> a) & 1][a] for a in range(3)]
                        for k in range(8)], np.float32)
    centre = (lo.astype(np.float64) + hi) / 2
    reach = 1.5 * np.linalg.norm(hi.astype(np.float64) - lo)
    q = n // 4
    tgt = np.empty((n, 3), np.float32)
    tgt[:q] = ext[rng.integers(0, len(ext), q)]
    tgt[q:2 * q] = corners[rng.integers(0, 8, q)]
    edge = corners[rng.integers(0, 8, q)]
    axis = rng.integers(0, 3, q)
    s = rng.random(q)
    edge[np.arange(q), axis] = (lo[axis] + s * (hi[axis].astype(np.float64)
                                                - lo[axis]))
    tgt[2 * q:3 * q] = edge
    u = rng.standard_normal((n, 3))
    o = centre + reach * u / np.linalg.norm(u, axis=1, keepdims=True)
    # the face-plane quarter
    m = n - 3 * q
    v = ext[rng.integers(0, len(ext), m)]
    on = (v == lo) | (v == hi)
    ax = np.array([rng.choice(np.nonzero(r)[0]) for r in on])
    w = rng.standard_normal((m, 3))
    w[np.arange(m), ax] = 0.0
    o[3 * q:] = v + reach * w / np.linalg.norm(w, axis=1, keepdims=True)
    o = o.astype(np.float32)
    o[3 * q:][np.arange(m), ax] = v[np.arange(m), ax]
    tgt[3 * q:] = v
    d = tgt.astype(np.float64) - o
    d[3 * q:][np.arange(m), ax] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, tgt
