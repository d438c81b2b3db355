"""Packed-row BVH layout, its host packers, and the threaded-order walk.

Twin: ``unity_raytracer_tpu/ops/pallas/traverse_mk3.py`` — the constants,
``PackedBVH``, ``pack_rows`` and ``pack_bw`` (``:34-193``) and the
``traverse_packet3`` wrapper (``:310-389``), whose Pallas kernel
(``_kernel``, ``:196-307``, ``pallas_call`` at ``:354``) is replaced by
the ``MK3`` instances of ``csrc/traverse.cu``. The numpy code is copied
because the JAX module imports Pallas at the top. The packed arrays are
the exact arrays the JAX package builds (``tests/test_torch_bvh.py``), so
the CUDA kernels read the same layout on either device:

* ``nodes [Nn, 16] f32`` — box min/max in lanes 0-5, then leaf row /
  count / miss link / right child as exact small-integer floats;
* ``tris [n_leaves*rpl, 128] f32`` — up to 14 triangles (9 floats each)
  per row, ``rpl`` consecutive rows per leaf;
* ``tris_bw [n_leaves*bw_rpl, 128] f32`` — Baldwin–Weber records, 10 per
  row x 12 floats (unit normal, plane offset, two barycentric rows).

More pieces belong to the port alone (the JAX package has no
counterpart): ``leafbox [n_leaves*rpl, 16] f32``, per ``tris`` row the
boxes of its two 7-slot groups (``group_boxes``), which the kernels' leaf
tests slab-test before testing a group's slots; ``nodes_walk`` and
``wide_walk``, the copies of ``nodes`` and ``wide`` whose boxes are
widened outward (``node_walk_rows``, ``wide_walk_rows``), which the
kernels walk instead of the exact boxes, so that a hit a ray finds at a
triangle's corner or edge is not culled by rounding (``pad_box``: one
rule for every box a walk tests); and the worst push depth of each walk's
stack (``binary_stack_depth``, ``wide_stack_depth``), which the wrappers
hold to the kernels' stack capacities before a launch (``check_stack``
raises for a deeper tree). ``nodes`` and ``wide`` stay the twin's arrays.

The host stage works on CPU tensors (zero-copy numpy views);
``PackedBVH.to(device)`` moves the finished arrays.

What the three traversal wrappers share lives here too (the twin's
``traverse_mk4`` and ``traverse_wide`` import it from this module as
well): ``walk_raw`` launches the CUDA kernel of a layout on CUDA tensors
and runs ``traverse_plain`` on CPU tensors, nothing else; ``epilogue``
turns the raw ``(t, slot, leaf row)`` into ``(t, MeshSet row, shading
normal)``. The plain version finds hits by brute force over every leaf
slot of ``tris`` (ignoring the nodes), so a wrong walk or packer shows;
it shares no walk code with the kernels. No gradient reaches the kernels:
they read detached rays, and ``t`` is re-derived differentiably from the
winning triangle (``ops/bvh._mt_one``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from unity_raytracer_tpu_torch.ops.kernels import _lib
from unity_raytracer_tpu_torch.utils.boxes import pad_box

EPS = 1e-5
_BIG = 3.0e38

PALLAS_LEAF = 14  # 14 tris x 9 floats = 126 lanes <= 128
BW_PER_ROW = 10   # 10 tris x 12 floats = 120 lanes <= 128
GROUP = 7         # leaf slots per group box (csrc/bvh_walk.cuh kGroup)
# stack entries per lane of the kernels' wide walks (traverse_wide.STACK
# is this value) and of the ordered binary walk (the twin's
# traverse_mk4.STACK): csrc/bvh_walk.cuh kStackWide, kStackBinary
_WIDE_STACK = 256
STACK_BINARY = 96


@dataclass(frozen=True)
class PackedBVH:
    nodes: torch.Tensor       # [Nn, 16] f32
    tris: torch.Tensor        # [n_leaves*rpl, 128] f32
    leaf_prim: torch.Tensor   # [n_leaves*rpl, 14] i32 row slot -> tri row
    bvh: object               # ops.bvh.MeshBVH (tri_verts, prim_index)
    # [n_leaves*rpl, >=16] f32 combined-material-table id per row slot
    leafmeta: Optional[torch.Tensor] = None
    # [Nw, 8*arity] f32 wide interior rows (traverse_wide.widen)
    wide: Optional[torch.Tensor] = None
    rows_per_leaf: int = 1
    # [n_leaves*bw_rpl, 128] f32 Baldwin–Weber leaf records (pack_bw)
    tris_bw: Optional[torch.Tensor] = None
    bw_rows_per_leaf: int = 0
    # [n_leaves*rpl, 16] f32 group boxes of the tris rows (group_boxes)
    leafbox: Optional[torch.Tensor] = None
    # the rows the kernels walk: ``nodes`` and ``wide`` with every box
    # widened (node_walk_rows, wide_walk_rows)
    nodes_walk: Optional[torch.Tensor] = None
    wide_walk: Optional[torch.Tensor] = None
    # worst push depth of the ordered binary walk (binary_stack_depth) and
    # of the wide walk of ``wide`` (wide_stack_depth); -1: not computed
    stack_binary: int = -1
    stack_wide: int = -1

    def replace(self, **kw) -> "PackedBVH":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PackedBVH":
        """Every tensor, and the ``bvh``'s arrays, on ``device``."""
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                kw[k] = v.to(device)
            elif k == "bvh" and hasattr(v, "to"):
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
                     rows_per_leaf=rpl,
                     leafbox=torch.from_numpy(group_boxes(tris, leaf_prim)),
                     nodes_walk=torch.from_numpy(node_walk_rows(nodes)),
                     stack_binary=binary_stack_depth(nodes))


def node_walk_rows(nodes) -> np.ndarray:
    """A copy of the binary node rows [Nn,16] with each box (lanes 0-5)
    widened by ``pad_box``: the rows the kernels walk."""
    out = np.array(nodes, np.float32, copy=True)
    out[:, 0:3], out[:, 3:6] = pad_box(out[:, 0:3], out[:, 3:6])
    return out


def wide_walk_rows(wide) -> np.ndarray:
    """A copy of the wide rows [Nw, 8*arity] with each present child's box
    (lanes 8c..8c+5, count >= 0) widened by ``pad_box``; absent slots stay
    as they are."""
    out = np.array(wide, np.float32, copy=True)
    v = out.reshape(out.shape[0], -1, 8)
    present = v[..., 7:8] >= 0
    lo, hi = pad_box(v[..., 0:3], v[..., 3:6])
    v[..., 0:3] = np.where(present, lo, v[..., 0:3])
    v[..., 3:6] = np.where(present, hi, v[..., 3:6])
    return out


def group_boxes(tris, leaf_prim) -> np.ndarray:
    """Per ``tris`` row [R,128] the boxes of its PALLAS_LEAF // GROUP
    (two) groups of GROUP slots -> [R,16] f32: group g at lanes 8g..8g+5
    (min xyz, max xyz), the rest 0. A box is the exact min and max of the
    float32 vertices of the group's live slots (``leaf_prim >= 0``), as the
    builder bounds a node, widened by ``pad_box``, so that it holds every
    hit its triangles report; dead slots do not widen it,
    and a group with no live slot gets zeros (no leaf test reaches it: the
    slots fill from 0)."""
    tris = np.asarray(tris, np.float32)
    rows, groups = tris.shape[0], PALLAS_LEAF // GROUP
    v = tris[:, :9 * PALLAS_LEAF].reshape(rows, groups, GROUP, 3, 3)
    live = (np.asarray(leaf_prim) >= 0).reshape(rows, groups, GROUP)
    keep = live[..., None, None]
    inf = np.float32(np.inf)
    used = live.any(axis=2)[..., None]
    lo = np.where(used, np.where(keep, v, inf).min(axis=(2, 3)), 0.0)
    hi = np.where(used, np.where(keep, v, -inf).max(axis=(2, 3)), 0.0)
    lo, hi = pad_box(lo.astype(np.float32), hi.astype(np.float32))
    out = np.zeros((rows, 2, 8), np.float32)
    out[:, :groups, 0:3] = np.where(used, lo, 0.0)
    out[:, :groups, 3:6] = np.where(used, hi, 0.0)
    return out.reshape(rows, 16)


def binary_stack_depth(nodes) -> int:
    """The most entries the ordered binary walk (traverse_mk4's order)
    can hold on its stack for the node rows [Nn,16]: it pushes one far
    child per interior node on its path, so the deepest interior node's
    depth + 1 (0 when the root is a leaf). Children follow their parent
    in the rows (left = i + 1, right = lane 9)."""
    nodes = np.asarray(nodes)
    count = nodes[:, 7]
    right = nodes[:, 9].astype(np.int64)
    depth = np.zeros(nodes.shape[0], np.int64)
    worst = 0
    for i in range(nodes.shape[0]):
        if count[i] <= 0:
            worst = max(worst, int(depth[i]) + 1)
            depth[i + 1] = depth[right[i]] = depth[i] + 1
    return worst


def wide_stack_depth(wide) -> int:
    """The most entries the wide walk can hold on its stack for the wide
    rows [Nw, 8*arity]: expanding row r pushes its present children on
    top of, at most, every present child but one of each row above it,
    so max over rows of (present children of r + sum over its ancestors of
    their present children - 1)."""
    w = np.asarray(wide)
    cnt = w[:, 7::8]
    meta = w[:, 6::8].astype(np.int64)
    present = (cnt >= 0).sum(axis=1)
    worst, todo = 0, [(0, 0)] if w.shape[0] else []
    while todo:
        row, below = todo.pop()
        worst = max(worst, below + int(present[row]))
        for c in np.nonzero(cnt[row] == 0)[0]:
            todo.append((int(meta[row, c]), below + int(present[row]) - 1))
    return worst


def check_stack(depth: int, capacity: int, what: str = "walk") -> None:
    """Raise ``ValueError`` when a tree whose worst push depth is
    ``depth`` needs more stack entries than a kernel's ``capacity`` (or
    carries no depth, -1): the wrappers call it before any launch, so no
    walk can drop a push."""
    if depth < 0:
        raise ValueError(f"{what}: the PackedBVH carries no stack depth; "
                         f"build it with pack_rows / widen / prepare_bvh")
    if depth > capacity:
        raise ValueError(f"{what}: the tree needs a stack of {depth} "
                         f"entries, more than the kernel's capacity "
                         f"{capacity}; rebuild it with larger leaves")


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


# ---------------------------------------------------------------------------
# the walks: raw kernel outputs, plain version, epilogue
# ---------------------------------------------------------------------------

# kernel launches per layout since the counts were last reset (set them to
# 0 to start a count); only walk_raw's CUDA branch adds to them
LAYOUTS = ("mk3", "mk4", "wide4", "wide8")
launches = dict.fromkeys(LAYOUTS, 0)
# the counting instance's tallies, in the order of its ``counts`` tensor:
# slab tests, Möller–Trumbore tests, warp issues of a leaf-slot test (MT
# tests / issues = mean active lanes per test), the deepest stack (a
# maximum), live lanes, leaf-group box tests, and the slot tests that the
# cooperative passes of mk3 and wide run (0 in mk4). slab, groups and mt
# are the sequential leaf test's, the work the walk needs; in mk3 and
# wide an issue is a cooperative pass (pass_slots / issues = lanes busy
# per pass, mt / issues = lanes doing needed work per pass)
COUNTS = ("slab", "mt", "issues", "depth", "live", "groups", "pass_slots")
# plain version: ray x leaf-slot pairs per brute-force chunk
_CHUNK_ELEMS = 1 << 22


def _slots(packed: PackedBVH):
    """Every non-empty leaf slot of ``tris`` as (triangle [K,9], global
    slot index row * 14 + slot [K]), in (row, slot) order."""
    v = packed.tris[:, :9 * PALLAS_LEAF].reshape(-1, 9)
    keep = torch.nonzero((v != 0.0).any(dim=1)).squeeze(1)
    return v[keep], keep


def traverse_plain(packed: PackedBVH, o: torch.Tensor, d: torch.Tensor,
                   tmax: torch.Tensor, any_hit: bool = False):
    """Plain version of the walks' raw outputs ``(t [N], slot [N], leaf
    row [N])`` by brute force over every leaf slot, in chunks: nearest
    mode keeps the smallest ``t < tmax`` (of equal t the first slot in
    (row, slot) order), any-hit mode reports -1 and the first slot with
    ``t < tmax``; ``t`` stays ``tmax`` and slot = row = -1 where nothing
    is closer, and a lane with ``tmax < 0`` is culled."""
    from unity_raytracer_tpu_torch.ops.kernels.mega import _mt
    n = o.shape[0]
    best_t = tmax.clone()
    best_g = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    lanes = torch.nonzero(tmax >= 0.0).squeeze(1)
    tri, gidx = _slots(packed)
    if lanes.numel() and tri.shape[0]:
        o3 = tuple(c[lanes][:, None] for c in o.unbind(-1))
        d3 = tuple(c[lanes][:, None] for c in d.unbind(-1))
        bt, bg = best_t[lanes], best_g[lanes]
        chunk = max(1, _CHUNK_ELEMS // lanes.numel())
        for s0 in range(0, tri.shape[0], chunk):
            ok, t = _mt(o3, d3, tri[s0:s0 + chunk].T[:, None, :])
            if any_hit:
                occ = ok & (t < bt[:, None])
                first = occ.to(torch.int8).argmax(dim=1)
                upd = occ.any(dim=1) & (bg < 0)
                bg = torch.where(upd, first + s0, bg)
            else:
                tmin, j = torch.where(ok, t, torch.inf).min(dim=1)
                upd = tmin < bt
                bt = torch.where(upd, tmin, bt)
                bg = torch.where(upd, j + s0, bg)
        if any_hit:
            bt = torch.where(bg >= 0, -1.0, bt)
        best_t[lanes], best_g[lanes] = bt, bg
    hit = best_g >= 0
    g = gidx[best_g.clamp_min(0)] if gidx.numel() else best_g
    slot = torch.where(hit, g % PALLAS_LEAF, -1).to(torch.int32)
    leaf = torch.where(hit, g // PALLAS_LEAF, -1).to(torch.int32)
    return best_t, slot, leaf


def walk_table(packed: PackedBVH, layout: str) -> torch.Tensor:
    """The rows a kernel of ``layout`` walks: ``nodes_walk`` for the
    binary layouts ('mk3', 'mk4', the fused kernel's 'binary'), else
    ``wide_walk``."""
    table = packed.nodes_walk if layout in ("mk3", "mk4", "binary") \
        else packed.wide_walk
    if table is None:
        raise ValueError(f"PackedBVH has no walk rows for {layout!r} — "
                         f"build it with pack_rows / widen / prepare_bvh")
    return table


def check_overflow(overflow: torch.Tensor,
                   what: str = "fused segment") -> None:
    """Raise if a kernel counted stack pushes it had to drop."""
    dropped = int(overflow.item())
    if dropped:
        raise RuntimeError(f"{what} kernel dropped {dropped} stack pushes "
                           f"(stack overflow); the result is not exact")


def walk_raw(layout: str, packed: PackedBVH, o: torch.Tensor,
             d: torch.Tensor, tmax: torch.Tensor, any_hit: bool = False,
             counts: torch.Tensor | None = None,
             overflow: torch.Tensor | None = None,
             seen: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Raw walk outputs ``(t, slot, leaf row)`` of ``layout`` ('mk3',
    'mk4', 'wide4', 'wide8') for rays ``o, d [N,3]`` and ``tmax [N]``:
    the CUDA kernel for CUDA tensors, ``traverse_plain`` for CPU tensors.
    ``overflow``: an int32 [1] device counter of dropped stack pushes
    shared by several launches, which the caller checks
    (``check_overflow``) once they are done; without one the wrapper
    makes its own and checks it after this launch (one host sync).
    ``check_stack`` raises first for a tree deeper than the walk's stack
    (``packed.stack_binary`` against STACK_BINARY for mk4,
    ``packed.stack_wide`` against ``traverse_wide.STACK`` for wide).
    ``counts`` (CUDA only, for measurement): an int64 ``[len(COUNTS)]``
    device tensor; the launch then runs the kernel's counting instance,
    which adds its tallies (``COUNTS``), and sets to 1 the bytes of
    ``seen = (rows, slots)`` (uint8, one per row of the layout's table and
    one per leaf slot of ``tris``: ``tris`` rows x 14) that it reads."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")
    table = walk_table(packed, layout)
    if layout.startswith("wide") and table.shape[1] != 8 * int(layout[4:]):
        raise ValueError(f"layout {layout} needs a wide BVH of arity "
                         f"{layout[4:]}, got {table.shape[1] // 8}")
    if o.device.type == "cpu":
        if counts is not None or seen is not None:
            raise ValueError("walk_raw: counts needs the CUDA kernel")
        return traverse_plain(packed, o, d, tmax, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"walk_raw: unsupported device {o.device}")
    n = o.shape[0]
    box = packed.leafbox
    if box is None:
        raise ValueError("walk_raw: PackedBVH.leafbox missing — build the "
                         "BVH with pack_rows / prepare_bvh")
    for name, t in dict(o=o, d=d, tmax=tmax, table=table, tris=packed.tris,
                        leafbox=box).items():
        if t.device != o.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"walk_raw: {name} must be a contiguous, "
                             f"16-byte aligned float32 tensor on {o.device}")
    if o.shape != (n, 3) or d.shape != (n, 3) or tmax.shape != (n,) \
            or packed.tris.shape[1] != 128 \
            or box.shape != (packed.tris.shape[0], 16):
        raise ValueError("walk_raw: bad ray or table shapes")
    if (counts is None) != (seen is None):
        raise ValueError("walk_raw: counts and seen go together")
    if layout == "mk4":
        check_stack(packed.stack_binary, STACK_BINARY, "walk_raw mk4")
    elif layout.startswith("wide"):
        check_stack(packed.stack_wide, _WIDE_STACK, f"walk_raw {layout}")
    if counts is not None and (
            counts.shape != (len(COUNTS),) or counts.dtype != torch.int64
            or counts.device != o.device
            or [s.shape for s in seen] != [(table.shape[0],), (
                packed.tris.shape[0] * PALLAS_LEAF,)]
            or any(s.dtype != torch.uint8 or s.device != o.device
                   or not s.is_contiguous() for s in seen)):
        raise ValueError(f"walk_raw: counts must be an int64 "
                         f"[{len(COUNTS)}] tensor and "
                         f"seen two contiguous uint8 tensors (table rows, "
                         f"tris rows x {PALLAS_LEAF}) on {o.device}")
    t_out = torch.empty_like(tmax)
    slot = torch.empty((n,), dtype=torch.int32, device=o.device)
    leaf = torch.empty((n,), dtype=torch.int32, device=o.device)
    own_counter = overflow is None
    if own_counter:
        overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
    if n:
        err = _lib.traverse_lib().urt_traverse(
            o.data_ptr(), d.data_ptr(), tmax.data_ptr(), n,
            LAYOUTS.index(layout), int(any_hit), table.data_ptr(),
            packed.tris.data_ptr(), box.data_ptr(), packed.rows_per_leaf,
            t_out.data_ptr(), slot.data_ptr(), leaf.data_ptr(),
            overflow.data_ptr(),
            None if counts is None else counts.data_ptr(),
            None if seen is None else seen[0].data_ptr(),
            None if seen is None else seen[1].data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
        if err:
            raise RuntimeError(f"urt_traverse launch failed: CUDA error "
                               f"{err}")
        launches[layout] += 1
    if own_counter:
        check_overflow(overflow, f"traversal {layout}")
    return t_out, slot, leaf


def epilogue(packed: PackedBVH, o: torch.Tensor, d: torch.Tensor,
             t_raw: torch.Tensor, slot: torch.Tensor, leaf: torch.Tensor):
    """The twin's shared epilogue: leaf slot -> leaf-order row
    (``leaf_prim``) -> MeshSet row (``prim_index``); ``t`` re-derived
    differentiably by ``_mt_one`` on ``bvh.tri_verts``, falling back to
    the kernel's value where the re-derivation misses on rounding; the
    shading normal of the winner. +inf / -1 / junk on a miss."""
    from unity_raytracer_tpu_torch.ops.bvh import _mt_one, shading_normal
    bvh = packed.bvh
    hit = slot >= 0
    row = torch.where(hit, packed.leaf_prim[leaf.clamp_min(0).long(),
                                            slot.clamp_min(0).long()], -1)
    safe = row.clamp_min(0).long()
    orig = torch.where(hit, bvh.prim_index[safe], -1)
    tri = bvh.tri_verts[safe]
    t_diff = _mt_one(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
    t_final = torch.where(hit, torch.where(torch.isfinite(t_diff), t_diff,
                                           t_raw), torch.inf)
    return t_final, orig.to(torch.int32), shading_normal(tri)


def walk(layout: str, packed: PackedBVH, o: torch.Tensor, d: torch.Tensor,
         t_max: torch.Tensor | None = None, any_hit: bool = False,
         overflow: torch.Tensor | None = None):
    """One traversal wrapper: ``t_max`` (default: none) turned into the
    kernel's seed and lane cull, the walk on detached rays, then the
    epilogue on the rays as given. Unlike the TPU wrappers it pads
    nothing: the CUDA kernels run one thread per ray. ``overflow``: as in
    ``walk_raw``."""
    # the kernels read rays 16 bytes at a time: a view of rows that
    # starts mid-way (a chunk of a ray batch) is copied
    aligned = lambda t: t if t.data_ptr() % 16 == 0 else t.clone()
    od = aligned(o.detach().to(torch.float32).contiguous())
    dd = aligned(d.detach().to(torch.float32).contiguous())
    if t_max is None:
        tmax = torch.full((o.shape[0],), _BIG, dtype=torch.float32,
                          device=o.device)
    else:
        tmax = torch.clamp_max(t_max.detach().to(torch.float32),
                               _BIG).contiguous()
    raw = walk_raw(layout, packed, od, dd, tmax, any_hit,
                   overflow=overflow)
    return epilogue(packed, o, d, *raw)


def traverse_packet3(packed: PackedBVH, o: torch.Tensor, d: torch.Tensor,
                     t_max: torch.Tensor | None = None,
                     any_hit: bool = False,
                     overflow: torch.Tensor | None = None):
    """Nearest (or any) mesh hit by the threaded-order binary walk
    (``csrc/traverse.cu``, layout MK3) -> ``(t [N], MeshSet row [N],
    shading normal [N,3])``, +inf / -1 / junk on a miss. ``t_max < 0``
    culls a lane. With ``any_hit`` the first occluder closer than
    ``t_max`` finishes the lane: ``t`` is that occluder's distance, for
    the occlusion predicate only. ``overflow``: as in ``walk_raw``."""
    return walk("mk3", packed, o, d, t_max, any_hit, overflow)
