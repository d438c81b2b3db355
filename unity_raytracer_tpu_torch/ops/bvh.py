"""BVH: the SAH builds, SBVH presplitting, canonical winding, ``prepare_bvh`` and the walks.

Twin: ``unity_raytracer_tpu/ops/bvh.py`` — ``MeshBVH``,
``_clip_tri_halfspaces`` (``:174-214``), ``presplit_refs`` (``:217-272``),
``build`` on both backends (``:274-491``: the native builder, the numpy
reference builder with its binned SAH and midpoint fallback, presplit
references, the single empty leaf of a meshless scene), ``_slab_enter``
and ``_safe_inv`` (``:498-519``), ``_mt_one``
(``:522-538``), ``shading_normal`` (``:541-549``), ``traverse``
(``:552-629``, the plain per-lane threaded walk: the twin's
``kernel='xla'`` route), ``canonical_winding`` (``:632-644``),
``bind_verts`` (``:647-677``), ``prepare_bvh`` (``:680-731``, the packed
branch for the kernels and the plain ``MeshBVH`` for ``kernel='xla'``)
and ``traverse_any`` (``:734-778``). The C++ builder is compiled from
``native/bvh_builder.cc`` into ``build/`` (``ops/kernels/_lib.py``); the
tracked ``native/libbvh.so`` is never loaded. Equal inputs give arrays
equal to the JAX package's (``tests/test_torch_bvh.py``).

A ``MeshBVH`` holds numpy arrays while the host builds and packs it;
``MeshBVH.to(device)`` (and ``PackedBVH.to``, which moves its ``bvh``)
turns them into tensors on the device, where the walks and the traversal
epilogue read ``tri_verts``, ``prim_index`` and ``flip``.

One departure from the twin (ROADMAP Queue C #3): ``presplit_refs``
rounds each clipped float64 reference box outward to float32, where the
twin rounds to nearest and a box can lose a sliver of its triangle. The
numpy builder takes its decisions (centroids, SAH costs) from the
nearest-rounded boxes, as the twin does, and bounds its nodes with the
outward ones: the tree is the twin's, and a node box differs from the
twin's only where an outward-rounded reference box sets it
(``tests/test_torch_presplit.py``).

Another (ROADMAP Queue C #14): a ray aimed at a triangle's corner or edge
hits it at a point a few ulps off the node boxes that bound the triangle
exactly, and the twin's walks can cull that hit. ``MeshBVH.node_min`` /
``node_max`` stay the twin's arrays; every walk tests them widened by
``utils/boxes.pad_box``: ``traverse`` here, and the kernels through the
packed walk rows (``PackedBVH.nodes_walk`` / ``wide_walk``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from unity_raytracer_tpu_torch.ops.intersect import EPS, dot3
from unity_raytracer_tpu_torch.ops.kernels import _lib
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import (
    PALLAS_LEAF, PackedBVH, node_walk_rows, pack_bw, pack_rows,
    wide_walk_rows)
from unity_raytracer_tpu_torch.ops.kernels.traverse_wide import widen
from unity_raytracer_tpu_torch.utils.boxes import pad_box

LEAF_SIZE = 4
SAH_BINS = 16


@dataclass(frozen=True)
class MeshBVH:
    """Flat threaded BVH over the scene's concatenated mesh triangles:
    numpy arrays on the host, tensors after ``to(device)``. ``tri_verts``
    are the triangles in leaf order; ``prim_index`` maps leaf-order rows
    back to ``MeshSet`` rows."""

    node_min: np.ndarray    # [Nn,3] f32
    node_max: np.ndarray    # [Nn,3] f32
    first: np.ndarray       # [Nn] i32 leaf: first prim; interior: -1
    count: np.ndarray       # [Nn] i32 leaf: prim count; interior: 0
    miss_next: np.ndarray   # [Nn] i32 skip pointer, -1 terminates
    tri_verts: np.ndarray   # [M,3,3] f32 leaf-ordered triangles
    prim_index: np.ndarray  # [M] i32 leaf order -> original MeshSet row
    leaf_size: int = LEAF_SIZE
    # winding canonicalized so the shading normal is the -cross bake
    # convention of the stored normals (see canonical_winding)
    canonical: bool = False
    flip: Optional[np.ndarray] = None  # [M_total] bool rows swapped v1<->v2

    @property
    def n_nodes(self) -> int:
        return self.first.shape[0]

    def to(self, device) -> "MeshBVH":
        """The same tree with every array a tensor on ``device``."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (np.ndarray, torch.Tensor)):
                v = torch.as_tensor(v, device=device)
            kw[f.name] = v
        return MeshBVH(**kw)


def _clip_tri_halfspaces(tri: np.ndarray, axis: np.ndarray,
                         split: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]:
    """Vectorized Sutherland–Hodgman clip of triangles ``[K,3,3]`` against
    the plane ``x[axis] = split`` (``axis``, ``split``: ``[K]``) -> the
    boxes of the two clipped polygons (lo_left, hi_left, lo_right,
    hi_right). A side with no vertex gets an inverted (empty) box."""
    k = tri.shape[0]
    coord = np.take_along_axis(
        tri, axis[:, None, None].repeat(3, 1), axis=2)[..., 0]  # [K,3]
    lo_l = np.full((k, 3), np.inf)
    hi_l = np.full((k, 3), -np.inf)
    lo_r = np.full((k, 3), np.inf)
    hi_r = np.full((k, 3), -np.inf)

    def acc(pmask, pts, lo, hi):
        np.minimum(lo, np.where(pmask[:, None], pts, np.inf), out=lo)
        np.maximum(hi, np.where(pmask[:, None], pts, -np.inf), out=hi)

    for i in range(3):
        j = (i + 1) % 3
        vi, vj = tri[:, i], tri[:, j]
        ci, cj = coord[:, i], coord[:, j]
        acc(ci <= split, vi, lo_l, hi_l)
        acc(ci >= split, vi, lo_r, hi_r)
        crosses = (ci - split) * (cj - split) < 0
        denom = np.where(np.abs(cj - ci) < 1e-30, 1e-30, cj - ci)
        t = np.clip((split - ci) / denom, 0.0, 1.0)
        pt = vi + t[:, None] * (vj - vi)
        # the crossing lies on the plane: force its split coordinate so
        # rounding cannot leak a box across the plane
        np.put_along_axis(pt, axis[:, None], split[:, None], axis=1)
        acc(crosses, pt, lo_l, hi_l)
        acc(crosses, pt, lo_r, hi_r)
    return lo_l, hi_l, lo_r, hi_r


def _presplit_refs64(tris: np.ndarray, budget_frac: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The twin's ``presplit_refs`` loop, returning its float64 reference
    boxes before any rounding: (ref_tri [R] int64, lo [R,3], hi [R,3])."""
    m = tris.shape[0]
    budget = int(m * budget_frac)
    ref_tri = np.arange(m, dtype=np.int64)
    ref_lo = tris.min(axis=1).astype(np.float64)
    ref_hi = tris.max(axis=1).astype(np.float64)
    while budget > 0:
        ext = ref_hi - ref_lo
        d = np.maximum(ext, 0)
        area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
        k = min(budget, max(256, budget // 4), len(area))
        top = np.argpartition(area, -k)[-k:]
        # refs already degenerate along their longest axis are not split
        top = top[ext[top].max(axis=1) > 1e-12]
        if top.size == 0:
            break
        axis = np.argmax(ext[top], axis=1)
        split = 0.5 * (np.take_along_axis(ref_lo[top], axis[:, None], 1)
                       + np.take_along_axis(ref_hi[top], axis[:, None],
                                            1))[:, 0]
        t = tris[ref_tri[top]].astype(np.float64)
        lo_l, hi_l, lo_r, hi_r = _clip_tri_halfspaces(t, axis, split)
        # each half within its parent ref box (an earlier split may have
        # made that tighter than the whole triangle)
        lo_l = np.maximum(lo_l, ref_lo[top])
        hi_l = np.minimum(hi_l, ref_hi[top])
        lo_r = np.maximum(lo_r, ref_lo[top])
        hi_r = np.minimum(hi_r, ref_hi[top])
        ok = (hi_l >= lo_l).all(1) & (hi_r >= lo_r).all(1)
        top, lo_l, hi_l, lo_r, hi_r = (top[ok], lo_l[ok], hi_l[ok],
                                       lo_r[ok], hi_r[ok])
        if top.size == 0:
            break
        ref_lo[top] = lo_l
        ref_hi[top] = hi_l
        ref_tri = np.concatenate([ref_tri, ref_tri[top]])
        ref_lo = np.concatenate([ref_lo, lo_r])
        ref_hi = np.concatenate([ref_hi, hi_r])
        budget -= top.size
    return ref_tri, ref_lo, ref_hi


def round_out(lo: np.ndarray, hi: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 boxes -> the least float32 boxes that contain them: a
    coordinate whose nearest float32 lies inside the box moves one ulp
    outward (``np.nextafter``)."""
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def presplit_refs(tris: np.ndarray, budget_frac: float
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SBVH-style spatial presplitting (Ernst–Greiner early split
    clipping): build references ``(ref_tri [R] i32, ref_lo [R,3] f32,
    ref_hi [R,3] f32)`` in which large triangles appear several times,
    each with the box of one clipped piece, so that the SAH build places
    each piece in its own subtree. ``R <= len(tris) * (1 + budget_frac)``.
    The largest-area refs split first, each at the midpoint of its box's
    longest axis, the triangle clipped to both halves and each half's box
    kept within its parent's. The float32 boxes contain the float64
    clipped boxes (``round_out``; the twin rounds to nearest)."""
    ref_tri, lo, hi = _presplit_refs64(tris, budget_frac)
    lo32, hi32 = round_out(lo, hi)
    return ref_tri.astype(np.int32), lo32, hi32


def _build_native(tris: np.ndarray, leaf_size: int, use_sah: bool,
                  sah_bins: int, lib) -> Tuple[np.ndarray, ...]:
    """The C++ builder's arrays: (node_min, node_max, first, count,
    miss_next, leaf order)."""
    m = tris.shape[0]
    tris_f = np.ascontiguousarray(tris.reshape(m, 9), np.float32)
    max_nodes = 2 * m - 1
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty((max_nodes,), np.int32)
    count = np.empty((max_nodes,), np.int32)
    miss = np.empty((max_nodes,), np.int32)
    order = np.empty((m,), np.int32)
    n = lib.urt_build_bvh_ex(
        tris_f.ctypes.data, m, leaf_size, int(use_sah), int(sah_bins),
        node_min.ctypes.data, node_max.ctypes.data, first.ctypes.data,
        count.ctypes.data, miss.ctypes.data, order.ctypes.data)
    if n <= 0:
        raise RuntimeError(f"native BVH build failed (returned {n})")
    return node_min[:n], node_max[:n], first[:n], count[:n], miss[:n], order


def _build_numpy(lo: np.ndarray, hi: np.ndarray, cent: np.ndarray,
                 blo: np.ndarray, bhi: np.ndarray, leaf_size: int,
                 use_sah: bool, sah_bins: int) -> Tuple[np.ndarray, ...]:
    """The twin's numpy reference build over references with boxes
    ``lo, hi`` and centroids ``cent`` (``[m,3]`` each), which take every
    decision: top-down binned SAH with a midpoint fallback, nodes in DFS
    order (the hit successor of an interior node is ``i + 1``) threaded by
    miss links. Node boxes bound ``blo, bhi``. Returns (node_min,
    node_max, first, count, miss_next, leaf order)."""
    m = lo.shape[0]
    order = np.arange(m, dtype=np.int32)
    n_min, n_max, n_first, n_count = [], [], [], []

    def area(lo_, hi_):
        d = np.maximum(hi_ - lo_, 0)
        return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                    + d[..., 2] * d[..., 0])

    def sah_split(start, end, axis, c, idx):
        """Binned SAH along ``axis``: the global mid, or None to fall
        back."""
        n = end - start
        cmin, cmax = c[:, axis].min(), c[:, axis].max()
        if cmax - cmin < 1e-12:
            return None
        bins = np.clip(((c[:, axis] - cmin) / (cmax - cmin)
                        * sah_bins).astype(np.int32), 0, sah_bins - 1)
        counts = np.zeros(sah_bins, np.int64)
        b_lo = np.full((sah_bins, 3), np.inf)
        b_hi = np.full((sah_bins, 3), -np.inf)
        for b in range(sah_bins):
            sel = bins == b
            counts[b] = sel.sum()
            if counts[b]:
                b_lo[b] = lo[idx[sel]].min(axis=0)
                b_hi[b] = hi[idx[sel]].max(axis=0)
        best_cost, best_b = np.inf, -1
        for b in range(1, sah_bins):
            cl, cr = counts[:b].sum(), counts[b:].sum()
            if cl == 0 or cr == 0:
                continue
            llo = b_lo[:b][counts[:b] > 0].min(axis=0)
            lhi = b_hi[:b][counts[:b] > 0].max(axis=0)
            rlo = b_lo[b:][counts[b:] > 0].min(axis=0)
            rhi = b_hi[b:][counts[b:] > 0].max(axis=0)
            cost = area(llo, lhi) * cl + area(rlo, rhi) * cr
            if cost < best_cost:
                best_cost, best_b = cost, b
        if best_b < 0:
            return None
        mask = bins < best_b
        k = int(mask.sum())
        if k == 0 or k == n:
            return None
        order[start:end] = np.concatenate([idx[mask], idx[~mask]])
        return start + k

    def build_range(start, end):
        """DFS build of ``order[start:end]``."""
        idx = order[start:end]
        n_min.append(blo[idx].min(axis=0))
        n_max.append(bhi[idx].max(axis=0))
        n = end - start
        if n <= leaf_size:
            n_first.append(start)
            n_count.append(n)
            return
        n_first.append(-1)
        n_count.append(0)
        c = cent[idx]
        clo, chi = c.min(axis=0), c.max(axis=0)
        axis = int(np.argmax(chi - clo))
        if chi[axis] - clo[axis] < 1e-12:
            mid = start + n // 2  # all centroids coincide: median index
        else:
            mid = sah_split(start, end, axis, c, idx) if use_sah else None
            if mid is None:
                # midpoint fallback (the reference's intent, BVH.cs:60)
                mask = c[:, axis] < 0.5 * (clo[axis] + chi[axis])
                k = int(mask.sum())
                if 0 < k < n:
                    order[start:end] = np.concatenate([idx[mask],
                                                       idx[~mask]])
                    mid = start + k
                else:
                    mid = start + n // 2
        build_range(start, mid)
        build_range(mid, end)

    build_range(0, m)
    count = np.asarray(n_count, np.int32)
    nn = count.shape[0]
    # miss links: a node's subtree is a contiguous DFS range, left child
    # i + 1, right child after the left subtree; left's miss is the
    # right child, right's miss the parent's
    subtree = np.ones(nn, np.int64)
    for i in range(nn - 1, -1, -1):
        if count[i] == 0:
            left = i + 1
            subtree[i] = 1 + subtree[left] + subtree[left + subtree[left]]
    miss = np.full(nn, -1, np.int32)
    stack = [(0, -1)]
    while stack:
        i, miss_of_i = stack.pop()
        miss[i] = miss_of_i
        if count[i] == 0:
            left = i + 1
            right = left + int(subtree[left])
            stack.append((left, right))
            stack.append((right, miss_of_i))
    return (np.asarray(n_min, np.float32), np.asarray(n_max, np.float32),
            np.asarray(n_first, np.int32), count, miss, order)


def build(verts: np.ndarray, valid: np.ndarray | None = None,
          leaf_size: int = LEAF_SIZE, use_sah: bool = True,
          backend: str = "auto", sah_bins: int = SAH_BINS,
          aabb_pad: float = 0.0, presplit: float = 0.0) -> MeshBVH:
    """Binned-SAH build over triangles ``[M,3,3]``; invalid rows are
    excluded. ``backend``: 'native' (the C++ builder; raises where it
    cannot be built), 'numpy' (the reference builder) or 'auto' (native
    where it builds, else numpy). Both emit the same threaded layout and
    equal hits; with ``presplit`` > 0 the build runs on the SBVH
    references of ``presplit_refs`` (a budget of ``presplit`` x M extra
    references) and always on numpy, as in the twin. ``aabb_pad``
    inflates every node box (a tree conservative for vertex moves up to
    the pad)."""
    verts = np.asarray(verts, np.float32)
    if valid is None:
        valid = np.ones((verts.shape[0],), bool)
    orig_idx = np.nonzero(np.asarray(valid))[0].astype(np.int32)
    tris = verts[orig_idx]
    m = tris.shape[0]
    if m == 0:  # a single empty leaf, as the twin builds it
        return MeshBVH(
            node_min=np.full((1, 3), np.inf, np.float32),
            node_max=np.full((1, 3), -np.inf, np.float32),
            first=np.zeros((1,), np.int32), count=np.zeros((1,), np.int32),
            miss_next=np.full((1,), -1, np.int32),
            tri_verts=np.zeros((1, 3, 3), np.float32),
            prim_index=np.zeros((1,), np.int32), leaf_size=leaf_size)
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown BVH backend {backend!r}")

    lib = None
    if backend in ("auto", "native") and not presplit:
        try:
            lib = _lib.bvh_lib()
        except (RuntimeError, OSError):
            if backend == "native":
                raise
    if lib is not None:
        ref_tri = np.arange(m, dtype=np.int32)
        node_min, node_max, first, count, miss, order = _build_native(
            tris, leaf_size, use_sah, sah_bins, lib)
    else:
        if presplit:
            ref_tri, lo64, hi64 = _presplit_refs64(tris, presplit)
            # decisions on the twin's nearest-rounded boxes (binning keys
            # off the clipped piece's centre), bounds on outward ones
            lo, hi = lo64.astype(np.float32), hi64.astype(np.float32)
            cent = 0.5 * (lo + hi)
            blo, bhi = round_out(lo64, hi64)
        else:
            ref_tri = np.arange(m, dtype=np.int32)
            lo = blo = tris.min(axis=1)
            hi = bhi = tris.max(axis=1)
            cent = tris.mean(axis=1)
        node_min, node_max, first, count, miss, order = _build_numpy(
            lo, hi, cent, blo, bhi, leaf_size, use_sah, sah_bins)
    if aabb_pad:
        node_min = node_min - aabb_pad
        node_max = node_max + aabb_pad
    rows = ref_tri[order]
    return MeshBVH(node_min=node_min, node_max=node_max, first=first,
                   count=count, miss_next=miss, tri_verts=tris[rows],
                   prim_index=orig_idx[rows], leaf_size=leaf_size)


def _slab_enter(o, d_inv, lo, hi, tmax):
    """Slab test over [0, tmax] -> (hit, t_enter); ``d_inv`` finite (see
    ``_safe_inv``)."""
    t1 = (lo - o) * d_inv
    t2 = (hi - o) * d_inv
    tn = torch.minimum(t1, t2)
    tf = torch.maximum(t1, t2)
    t_enter = torch.clamp_min(tn.amax(dim=-1), 0.0)
    t_exit = torch.minimum(tf.amin(dim=-1), tmax)
    return t_enter <= t_exit, t_enter


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with components below 1e-30 clamped to +-1e-30, so slab
    products stay NaN-free (0 * 1e30 = 0, never 0 * inf)."""
    tiny = 1e-30
    fix = torch.where(d < 0, -tiny, tiny).to(d.dtype)
    return 1.0 / torch.where(d.abs() < tiny, fix, d)


def _mt_one(o, d, v0, v1, v2):
    """Möller–Trumbore for one triangle per ray (``[N,3]`` each), +inf on
    a miss; differentiable in every input where it hits. Same rejects and
    epsilon as ``ops/intersect.ray_triangles``."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = torch.linalg.cross(d, e2, dim=-1)
    a = dot3(e1, h)
    parallel = a.abs() < EPS
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = o - v0
    u = f * dot3(s, h)
    q = torch.linalg.cross(s, e1, dim=-1)
    v = f * dot3(d, q)
    t = f * dot3(e2, q)
    miss = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (t <= EPS))
    return torch.where(miss, torch.inf, t)


def shading_normal(tri: torch.Tensor) -> torch.Tensor:
    """The reference's mesh-bake shading normal from gathered triangles
    ``[N,3,3]``: ``-normalize(cross(v2-v0, v1-v0))`` (SceneMesh.cs:43;
    winding canonicalized by ``prepare_bvh``). Junk on miss lanes."""
    e1 = tri[:, 2] - tri[:, 0]
    e2 = tri[:, 1] - tri[:, 0]
    nml = -torch.linalg.cross(e1, e2, dim=-1)
    # the twin clamps with max(x, 1e-60), which is max(x, 0) in float32
    n2 = dot3(nml, nml)[:, None]
    return nml * (1.0 / torch.sqrt(torch.maximum(n2, n2.new_zeros(()))))


def traverse(bvh: MeshBVH, o: torch.Tensor, d: torch.Tensor,
             t_max: torch.Tensor | None = None, any_hit: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest mesh-triangle hit by the plain per-lane threaded walk.

    Returns ``(t [N], original prim index [N], shading normal [N,3])``,
    +inf / -1 / junk on a miss. Every lane steps through its own node
    sequence (descend to ``cursor + 1`` on a box hit, else the miss link)
    with ``bvh.leaf_size`` triangle tests per leaf; the loop ends when no
    lane is left (one host sync per step). ``t_max`` seeds the cull
    distance, and a negative one culls the lane; ``any_hit`` stops a lane
    at its first occluder closer than ``t_max``. The walk is index logic
    on detached rays; ``t`` is re-derived differentiably from the winner
    (``tri_verts``, which ``bind_verts`` may make a function of the
    scene)."""
    n = o.shape[0]
    od, dd = o.detach(), d.detach()
    d_inv = _safe_inv(dd)
    tv = bvh.tri_verts.detach()
    # the node boxes widened as the kernels' walk rows are (pad_box)
    box_lo, box_hi = pad_box(torch.as_tensor(bvh.node_min),
                             torch.as_tensor(bvh.node_max))
    best_t = (torch.full((n,), torch.inf, dtype=torch.float32,
                         device=o.device) if t_max is None
              else t_max.detach().to(torch.float32).clone())
    cursor = torch.where(best_t < 0.0, -1, 0).to(torch.int64)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    m = tv.shape[0]
    while True:
        lanes = torch.nonzero(cursor >= 0).squeeze(1)
        if lanes.numel() == 0:
            break
        node = cursor[lanes]
        ol, dl, bt = od[lanes], dd[lanes], best_t[lanes]
        bi = best_i[lanes]
        box_hit, _ = _slab_enter(ol, d_inv[lanes], box_lo[node],
                                 box_hi[node], bt)
        count = bvh.count[node].long()
        first = bvh.first[node].long()
        is_leaf = count > 0
        # the leaf's slots at once; the first of equal t wins, as the
        # twin's unrolled strict < over the slots keeps it
        at = torch.nonzero(box_hit & is_leaf).squeeze(1)
        if at.numel():
            ks = torch.arange(bvh.leaf_size, device=o.device)
            pi = (first[at, None] + ks).clamp(0, m - 1)       # [nl, K]
            tri = tv[pi]
            t = _mt_one(ol[at, None], dl[at, None], tri[..., 0, :],
                        tri[..., 1, :], tri[..., 2, :])
            cand = (ks < count[at, None]) & (t < bt[at, None])
            if any_hit:
                k0 = cand.to(torch.uint8).argmax(dim=1)
                new_t = torch.full_like(t[:, 0], -1.0)
            else:
                new_t, k0 = torch.where(cand, t, torch.inf).min(dim=1)
            upd = cand.any(dim=1)
            bt[at] = torch.where(upd, new_t, bt[at])
            bi[at] = torch.where(upd, pi.gather(1, k0[:, None])[:, 0],
                                 bi[at])
        # (the meshless tree's one empty node has no child to descend to)
        nxt = torch.where(box_hit & ~is_leaf & (node + 1 < bvh.n_nodes),
                          node + 1, bvh.miss_next[node].long())
        if any_hit:  # occluded lanes retire at once
            nxt = torch.where(bt < 0.0, -1, nxt)
        cursor[lanes] = nxt
        best_t[lanes] = bt
        best_i[lanes] = bi
    hit = best_i >= 0
    safe = best_i.clamp_min(0)
    orig = torch.where(hit, bvh.prim_index[safe].long(), -1)
    tri = bvh.tri_verts[safe]
    t_diff = _mt_one(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
    t_out = torch.where(hit, torch.where(torch.isfinite(t_diff), t_diff,
                                         best_t), torch.inf)
    return t_out, orig.to(torch.int32), shading_normal(tri)


def canonical_winding(verts: np.ndarray, normals: np.ndarray,
                      return_flip: bool = False):
    """Swap v1/v2 of triangles whose derived normal
    ``-cross(v2-v0, v1-v0)`` opposes the stored shading normal (the swap
    never changes the intersection set). ``return_flip`` also returns the
    per-row swap mask."""
    v = np.array(verts, np.float32, copy=True)
    nc = -np.cross(v[:, 2] - v[:, 0], v[:, 1] - v[:, 0])
    flip = np.sum(nc * np.asarray(normals, np.float32), axis=-1) < 0.0
    v[flip] = v[flip][:, [0, 2, 1]]
    return (v, flip) if return_flip else v


def bind_verts(bvh, scene):
    """Re-derive the traversal epilogue's triangle table from the scene's
    current mesh verts, differentiably — the ``mesh_verts`` gradient hook
    (``fit.PARAM_PATHS``). The walk keeps its baked boxes and rows; the
    epilogue's ``t`` and shading normal then read this table, so the
    radiance's gradient reaches the mesh verts as on the brute-force
    path. Contract (the twin's): the walk picks winners on the baked
    rows, so build the BVH with ``cfg.bvh_pad`` >= the largest vertex
    displacement, and keep the verts near their build positions."""
    if scene.meshes.count == 0:
        return bvh
    packed = isinstance(bvh, PackedBVH)
    inner = bvh.bvh if packed else bvh
    v = scene.meshes.verts
    if inner.flip is not None:
        flip = torch.as_tensor(inner.flip, device=v.device)
        v = torch.where(flip[:, None, None], v[:, (0, 2, 1), :], v)
    idx = torch.as_tensor(inner.prim_index, device=v.device).long()
    new_inner = dataclasses.replace(inner, tri_verts=v[idx.clamp_min(0)])
    return bvh.replace(bvh=new_inner) if packed else new_inner


def _meshless_packed(arity: int) -> PackedBVH:
    """A one-row ``PackedBVH`` for a scene without mesh triangles (the
    twin's ``render._dummy_packed``): the binary root is a leaf holding
    one all-zero triangle, which no ray hits, and every wide slot is
    absent, so every walk ends at the root."""
    arity = max(arity, 2)
    nodes = np.zeros((1, 16), np.float32)
    nodes[0, 7] = 1.0                      # a leaf of one (zero) triangle
    nodes[0, 8], nodes[0, 9] = -1.0, -1.0  # no miss link, no right child
    wide = np.zeros((1, 8 * arity), np.float32)
    wide[:, 7::8] = -1.0
    return PackedBVH(
        nodes=torch.from_numpy(nodes), tris=torch.zeros((1, 128)),
        leaf_prim=torch.full((1, PALLAS_LEAF), -1, dtype=torch.int32),
        bvh=build(np.zeros((0, 3, 3), np.float32)),
        leafmeta=torch.zeros((1, 16)), wide=torch.from_numpy(wide),
        tris_bw=torch.zeros((1, 128)), bw_rows_per_leaf=1,
        leafbox=torch.zeros((1, 16)),
        nodes_walk=torch.from_numpy(node_walk_rows(nodes)),
        wide_walk=torch.from_numpy(wide_walk_rows(wide)),
        stack_binary=0, stack_wide=0)


def prepare_bvh(scene, cfg, device=None):
    """Build the BVH ``cfg.kernel`` walks, on the host, and move it to
    ``device`` (default: the scene's device).

    Every kernel but 'xla' gets a ``PackedBVH``: native SAH build with
    ``cfg.bvh_leaf``-triangle leaves and ``cfg.bvh_bins`` bins,
    ``pack_rows`` (with the port's group boxes ``leafbox`` and the binary
    walk's worst push depth ``stack_binary``), ``widen`` to
    ``cfg.bvh_arity`` (with ``stack_wide``), ``pack_bw`` and the
    per-leaf-slot combined material ids (``leafmeta``, table order
    spheres ++ loose triangles ++ meshes, as ``ops/kernels/mega.build_aux``
    lays it out). ``kernel='xla'`` gets a plain ``MeshBVH`` with
    ``LEAF_SIZE`` leaves. Unlike the twin, 'auto' gets the packed rows on
    every device (the twin builds a plain tree on its CPU backend): they
    serve every route, and off the card 'auto' walks their ``bvh`` with
    the plain per-lane walk. Winding is canonicalized against the stored
    normals so the epilogue re-derives them. ``cfg.bvh_presplit`` > 0
    builds on SBVH references (``presplit_refs``, the numpy builder):
    leaves then hold duplicated triangles and ``prim_index`` repeats."""
    device = scene.aabb_min.device if device is None else device
    verts, flip = canonical_winding(scene.meshes.verts.cpu().numpy(),
                                    scene.meshes.normals.cpu().numpy(),
                                    return_flip=True)
    valid = scene.meshes.valid.cpu().numpy()
    bins = getattr(cfg, "bvh_bins", SAH_BINS) or SAH_BINS
    pad = getattr(cfg, "bvh_pad", 0.0) or 0.0
    presplit = getattr(cfg, "bvh_presplit", 0.0) or 0.0
    if getattr(cfg, "kernel", "auto") == "xla":
        b = build(verts, valid, sah_bins=bins, aabb_pad=pad,
                  presplit=presplit)
        return dataclasses.replace(b, canonical=True, flip=flip).to(device)
    if not valid.any():
        return _meshless_packed(getattr(cfg, "bvh_arity", 4)).to(device)
    leaf = getattr(cfg, "bvh_leaf", PALLAS_LEAF) or PALLAS_LEAF
    b = build(verts, valid, leaf_size=leaf, sah_bins=bins, aabb_pad=pad,
              presplit=presplit)
    b = dataclasses.replace(b, canonical=True, flip=flip)
    packed = pack_bw(widen(pack_rows(b, leaf_slots=leaf),
                           arity=getattr(cfg, "bvh_arity", 4)))
    lp = packed.leaf_prim.numpy()
    mid = scene.meshes.mesh_id.cpu().numpy()
    matid = (scene.spheres.count + scene.triangles.count
             + mid[b.prim_index[np.clip(lp, 0, None)]])
    mwidth = max(16, -(-lp.shape[1] // 8) * 8)
    leafmeta = np.zeros((lp.shape[0], mwidth), np.float32)
    leafmeta[:, : lp.shape[1]] = matid.astype(np.float32)
    return packed.replace(leafmeta=torch.from_numpy(leafmeta)).to(device)


def traverse_any(bvh, o: torch.Tensor, d: torch.Tensor,
                 t_max: torch.Tensor | None = None, kernel: str = "auto",
                 any_hit: bool = False,
                 overflow: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatching traversal -> ``(t, prim index, shading normal)``.

    ``kernel``: 'xla' (the plain per-lane walk ``traverse``), 'pallas'
    (ordered binary walk, ``ops/kernels/traverse_mk4``), 'pallas3'
    (threaded binary walk, ``traverse_mk3``), 'wide' (BVH4/8 walk,
    ``traverse_wide``), 'mega' (= 'pallas'), 'auto' ('pallas' on the
    card, 'xla' elsewhere). The kernels need a ``PackedBVH``; a bare
    ``MeshBVH`` always takes the plain walk. On a CUDA tensor a kernel
    route launches its CUDA kernel; on a CPU tensor it runs the kernel's
    plain version. ``any_hit``: lanes finish at the first occluder
    closer than ``t_max``; a negative ``t_max`` culls a lane.
    ``overflow``: the kernels' shared stack-overflow counter
    (``traverse_mk3.walk_raw``), which the caller checks; without one
    each launch checks its own."""
    from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import (
        traverse_packet3)
    from unity_raytracer_tpu_torch.ops.kernels.traverse_mk4 import (
        traverse_packet4)
    from unity_raytracer_tpu_torch.ops.kernels.traverse_wide import (
        traverse_wide)
    if kernel == "auto":
        kernel = "pallas" if o.device.type == "cuda" else "xla"
    if kernel == "mega":
        kernel = "pallas"
    if not isinstance(bvh, PackedBVH):
        return traverse(bvh, o, d, t_max=t_max, any_hit=any_hit)
    if kernel == "xla":
        return traverse(bvh.bvh, o, d, t_max=t_max, any_hit=any_hit)
    if kernel == "pallas3":
        return traverse_packet3(bvh, o, d, t_max=t_max, any_hit=any_hit,
                                overflow=overflow)
    if kernel == "wide" and bvh.wide is not None:
        return traverse_wide(bvh, o, d, t_max=t_max, any_hit=any_hit,
                             overflow=overflow)
    if kernel not in ("pallas", "wide"):
        raise ValueError(f"unknown traversal kernel {kernel!r}")
    return traverse_packet4(bvh, o, d, t_max=t_max, any_hit=any_hit,
                            overflow=overflow)
