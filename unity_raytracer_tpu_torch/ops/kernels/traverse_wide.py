"""Wide (BVH4/8) node rows: the host collapse ``widen``, the stack bound, the walk.

Twin: ``unity_raytracer_tpu/ops/pallas/traverse_wide.py`` — ``STACK`` and
``widen`` (``:54,245-331``; numpy code copied, since the JAX module
imports Pallas at the top) and the ``traverse_wide`` wrapper
(``:437-510``), whose Pallas kernel (``_kernel``, ``:334-434``,
``pallas_call`` at ``:473``) is replaced by the ``WIDE4`` / ``WIDE8``
instances of ``csrc/traverse.cu``; the wrapper's ``unroll`` is a Mosaic
knob and is not ported. Layout — ``wide [Nw, 8*arity] f32``, one row per
wide node; child slot c occupies lanes [8c, 8c+8):

  +0..2 box min   +3..5 box max
  +6    meta: interior -> wide row of the child; leaf -> tris row
  +7    count: 0 interior, >0 leaf triangle count, -1 absent slot

The fused segment kernel (``csrc/mega_segment.cu``) and the wide walk
(``csrc/traverse.cu``) walk these rows with a private ``STACK``-entry
stack per ray; ``widen`` refuses, on the host, a tree deep enough to
overflow it, and stores the tree's worst push depth
(``PackedBVH.stack_wide``, ``traverse_mk3.wide_stack_depth``), which the
wrappers hold to ``STACK`` before a launch; the kernels count any
overflow that would still happen so the wrappers raise.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import (
    _WIDE_STACK, PackedBVH, walk, wide_stack_depth, wide_walk_rows)

# up to (arity-1) residual pushes per tree level plus arity at the
# deepest expansion; the wide-tree depth stays far below this
STACK = _WIDE_STACK

DEFAULT_ARITY = 4


def widen(packed: PackedBVH, arity: int = DEFAULT_ARITY) -> PackedBVH:
    """Collapse the packed binary tree into an arity-wide tree (numpy).
    Returns ``packed`` with the ``wide`` field, the copy the kernels walk
    (``wide_walk``, its boxes widened) and its worst push depth
    (``stack_wide``) filled.

    Collapse rule: start from a binary interior node's two children and
    repeatedly replace the largest-surface-area interior child with its
    own two children until ``arity`` slots are filled or all children are
    leaves.
    """
    if arity < 2:
        return packed

    nodes = np.asarray(packed.nodes)
    nmin = nodes[:, 0:3]
    nmax = nodes[:, 3:6]
    leaf_id = nodes[:, 6].astype(np.int64)
    count = nodes[:, 7].astype(np.int64)
    right = nodes[:, 9].astype(np.int64)
    is_leaf = count > 0

    def area(k):
        d = np.maximum(nmax[k] - nmin[k], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def collapse_children(b):
        kids = [b + 1, int(right[b])]
        while len(kids) < arity:
            best, best_a = -1, -1.0
            for i, k in enumerate(kids):
                if not is_leaf[k] and area(k) > best_a:
                    best, best_a = i, area(k)
            if best < 0:
                break
            k = kids.pop(best)
            kids += [k + 1, int(right[k])]
        return kids

    rows: list[list[int]] = []
    widx: dict[int, int] = {}
    depth = [0]  # max wide-tree depth, for the stack-capacity check
    if is_leaf[0]:
        rows.append([0])  # degenerate: root is a single leaf
    else:
        sys.setrecursionlimit(max(sys.getrecursionlimit(), 200_000))

        def assign(b, lvl=1):
            widx[b] = len(rows)
            rows.append([])
            kids = collapse_children(b)
            rows[widx[b]] = kids
            depth[0] = max(depth[0], lvl)
            for k in kids:
                if not is_leaf[k]:
                    assign(k, lvl + 1)

        assign(0)

    # the walk pushes at most (arity-1) residual entries per level plus
    # arity at the deepest expansion: a tree that could overflow the
    # kernel's stack fails here, on the host
    need = (arity - 1) * depth[0] + arity
    if need > STACK:
        raise ValueError(
            f"wide-tree depth {depth[0]} needs stack {need} > {STACK}; "
            "tree is pathologically deep — rebuild with a larger leaf "
            "size or raise STACK")

    out = np.zeros((len(rows), 8 * arity), np.float32)
    out[:, 7::8] = -1.0  # absent slots
    for r, kids in enumerate(rows):
        for c, k in enumerate(kids):
            b0 = 8 * c
            out[r, b0:b0 + 3] = nmin[k]
            out[r, b0 + 3:b0 + 6] = nmax[k]
            if is_leaf[k]:
                out[r, b0 + 6] = float(leaf_id[k])
                out[r, b0 + 7] = float(count[k])
            else:
                out[r, b0 + 6] = float(widx[k])
                out[r, b0 + 7] = 0.0
    return packed.replace(wide=torch.from_numpy(out),
                          wide_walk=torch.from_numpy(wide_walk_rows(out)),
                          stack_wide=wide_stack_depth(out))


def traverse_wide(packed: PackedBVH, o: torch.Tensor, d: torch.Tensor,
                  t_max: torch.Tensor | None = None, any_hit: bool = False,
                  overflow: torch.Tensor | None = None):
    """Wide-row twin of ``traverse_packet3`` (needs ``packed.wide``, arity
    4 or 8): children slab-tested per wide row, the walk descending into
    the nearest hit and pushing the others far to near. Same outputs,
    ``t_max`` cull, ``any_hit`` mode and ``overflow``."""
    if packed.wide is None:
        raise ValueError("PackedBVH.wide missing — call widen() first")
    arity = packed.wide.shape[1] // 8
    if arity not in (4, 8):
        raise NotImplementedError(
            f"the CUDA wide walk has instances for arity 4 and 8, not "
            f"{arity}")
    return walk(f"wide{arity}", packed, o, d, t_max, any_hit, overflow)
