"""Packed-row BVH layout and its host packers.

Twin: ``unity_raytracer_tpu/ops/pallas/traverse_mk3.py:34-193`` — the
constants, ``PackedBVH``, ``pack_rows`` and ``pack_bw``. The numpy code is
copied because the JAX module imports Pallas at the top. The packed
arrays are the exact arrays the JAX package builds
(``tests/test_torch_bvh.py``), so the fused segment kernel reads the same
layout on either device:

* ``nodes [Nn, 16] f32`` — box min/max in lanes 0-5, then leaf row /
  count / miss link / right child as exact small-integer floats;
* ``tris [n_leaves*rpl, 128] f32`` — up to 14 triangles (9 floats each)
  per row, ``rpl`` consecutive rows per leaf;
* ``tris_bw [n_leaves*bw_rpl, 128] f32`` — Baldwin–Weber records, 10 per
  row x 12 floats (unit normal, plane offset, two barycentric rows).

The host stage works on CPU tensors (zero-copy numpy views);
``PackedBVH.to(device)`` moves the finished arrays.

The traversal kernel of the JAX module (``traverse_packet3``) is not part
of this slice (ROADMAP Queue A #12).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

EPS = 1e-5
_BIG = 3.0e38

PALLAS_LEAF = 14  # 14 tris x 9 floats = 126 lanes <= 128
BW_PER_ROW = 10   # 10 tris x 12 floats = 120 lanes <= 128


@dataclass(frozen=True)
class PackedBVH:
    nodes: torch.Tensor       # [Nn, 16] f32
    tris: torch.Tensor        # [n_leaves*rpl, 128] f32
    leaf_prim: torch.Tensor   # [n_leaves*rpl, 14] i32 row slot -> tri row
    bvh: object               # ops.bvh.MeshBVH (host numpy)
    # [n_leaves*rpl, >=16] f32 combined-material-table id per row slot
    leafmeta: Optional[torch.Tensor] = None
    # [Nw, 8*arity] f32 wide interior rows (traverse_wide.widen)
    wide: Optional[torch.Tensor] = None
    rows_per_leaf: int = 1
    # [n_leaves*bw_rpl, 128] f32 Baldwin–Weber leaf records (pack_bw)
    tris_bw: Optional[torch.Tensor] = None
    bw_rows_per_leaf: int = 0

    def replace(self, **kw) -> "PackedBVH":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PackedBVH":
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                kw[k] = v.to(device)
        return PackedBVH(**kw)


def pack_rows(bvh, leaf_slots: int = PALLAS_LEAF) -> PackedBVH:
    """Host-side repack of a ``MeshBVH`` into node rows and leaf rows.
    Requires every leaf count <= ``leaf_slots``; leaves wider than
    PALLAS_LEAF span consecutive 128-lane rows, and ``nodes`` leaf ids
    point at the first row."""
    first = np.asarray(bvh.first)
    count = np.asarray(bvh.count)
    miss = np.asarray(bvh.miss_next)
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    tv = np.asarray(bvh.tri_verts).reshape(-1, 9)
    nn = first.shape[0]
    if count.max(initial=0) > leaf_slots:
        raise ValueError(
            f"leaf size {count.max()} > {leaf_slots}; build the BVH with "
            f"leaf_size={leaf_slots}")

    is_leaf = count > 0
    leaf_ids = np.cumsum(is_leaf) - 1          # node -> leaf id
    n_leaves = int(is_leaf.sum())
    rpl = -(-leaf_slots // PALLAS_LEAF)        # rows per leaf

    rows = max(n_leaves, 1) * rpl
    tris = np.zeros((rows, 128), np.float32)
    leaf_prim = np.full((rows, PALLAS_LEAF), -1, np.int32)
    leaf_nodes = np.nonzero(is_leaf)[0]
    for r, node in enumerate(leaf_nodes):
        f0, c = first[node], count[node]
        for k in range(c):
            rr, kk = divmod(k, PALLAS_LEAF)
            tris[r * rpl + rr, 9 * kk: 9 * kk + 9] = tv[f0 + k]
            leaf_prim[r * rpl + rr, kk] = f0 + k

    # meta stored as exact small-integer float values
    nodes = np.zeros((nn, 16), np.float32)
    nodes[:, 0:3] = nmin
    nodes[:, 3:6] = nmax
    nodes[:, 6] = np.where(is_leaf, leaf_ids * rpl, -1).astype(np.float32)
    nodes[:, 7] = count.astype(np.float32)
    nodes[:, 8] = miss.astype(np.float32)
    # lane 9: right child of interior nodes (DFS pre-order: left = i+1,
    # and left's miss link is the right sibling)
    right = np.full(nn, -1, np.int64)
    interior = ~is_leaf
    if nn > 1:
        right[interior] = miss[np.nonzero(interior)[0] + 1]
    nodes[:, 9] = right.astype(np.float32)

    return PackedBVH(nodes=torch.from_numpy(nodes),
                     tris=torch.from_numpy(tris),
                     leaf_prim=torch.from_numpy(leaf_prim), bvh=bvh,
                     rows_per_leaf=rpl)


def pack_bw(packed: PackedBVH) -> PackedBVH:
    """Host-side Baldwin–Weber repack of the leaf rows.

    Per triangle, the 12-float record ``(n̂, d̂, a, a0, b, b0)``: the unit
    plane normal (under the canonical winding it is the reference's baked
    shading normal, SceneMesh.cs:43), ``d̂ = n̂·v0``, and the affine
    barycentric rows ``u(p) = a·p + a0``, ``v(p) = b·p + b0``. Degenerate
    and pad slots get all-zero records, which reject at the |n̂·d| gate.
    """
    tris = np.asarray(packed.tris)
    rpl = packed.rows_per_leaf
    n_rows = tris.shape[0]
    n_leaves = n_rows // rpl
    slots = rpl * PALLAS_LEAF
    v9 = np.zeros((n_leaves, slots, 9), np.float32)
    for rr in range(rpl):
        for k in range(PALLAS_LEAF):
            v9[:, rr * PALLAS_LEAF + k] = \
                tris[rr::rpl][:n_leaves, 9 * k: 9 * k + 9]
    v = v9.reshape(-1, 3, 3).astype(np.float64)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n0 = np.cross(e1, e2)
    n2 = (n0 * n0).sum(-1)
    ok = n2 > 1e-30
    n2s = np.where(ok, n2, 1.0)
    nh = n0 / np.sqrt(n2s)[:, None]
    dh = (nh * v[:, 0]).sum(-1)
    a = np.cross(e2, n0) / n2s[:, None]
    b = np.cross(n0, e1) / n2s[:, None]
    a0 = -(a * v[:, 0]).sum(-1)
    b0 = -(b * v[:, 0]).sum(-1)
    rec = np.concatenate(
        [nh, dh[:, None], a, a0[:, None], b, b0[:, None]],
        axis=-1).astype(np.float32)
    rec[~ok] = 0.0
    rec = rec.reshape(n_leaves, slots, 12)

    bw_rpl = -(-slots // BW_PER_ROW)
    out = np.zeros((max(n_leaves, 1) * bw_rpl, 128), np.float32)
    for j in range(slots):
        rr, kk = divmod(j, BW_PER_ROW)
        out[rr::bw_rpl][:n_leaves, 12 * kk: 12 * kk + 12] = rec[:, j]
    return packed.replace(tris_bw=torch.from_numpy(out),
                          bw_rows_per_leaf=bw_rpl)
