"""Cross-device reductions and exchanges for distributed intersection.

Twin: ``unity_raytracer_tpu/parallel/collectives.py`` (``min_hit_combine``,
``pack_hit``, ``unpack_hit``). The one nontrivial collective a
distributed ray tracer needs is the **lexicographic nearest-hit
combine**: every rank holds a partial ``(t, payload)`` per ray; the
winner is the minimum t, with the reference's tie order (first category
and index win — Scene.cs strict ``>`` updates) kept by breaking ties on
the payload key.

``ring_shift`` and ``all_gather_rows`` are the two exchanges of
``shard.py`` that the twin writes inline as ``lax.ppermute`` and a tiled
``lax.all_gather``. Every rank of a group must call each collective, in
the same order.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

KEY_NONE = 2 ** 31 - 1  # the key of a rank that holds no winner


def min_hit_combine(t: torch.Tensor, key: torch.Tensor,
                    group) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce argmin over ``group``: ``t [N]`` float32 partial
    distances (+inf = miss), ``key [N]`` int32 packed hit ids. Returns the
    (t, key) of the global winner on every rank; ties in t resolve to the
    smallest key, which encodes the reference's evaluation order when
    keys pack kind-major (``pack_hit``)."""
    t_min = t.clone()
    dist.all_reduce(t_min, op=dist.ReduceOp.MIN, group=group)
    # ranks not holding the winner contribute KEY_NONE
    candidate = torch.where(t == t_min, key.to(torch.int32),
                            torch.full_like(key, KEY_NONE, dtype=torch.int32))
    dist.all_reduce(candidate, op=dist.ReduceOp.MIN, group=group)
    return t_min, candidate


def pack_hit(kind: torch.Tensor, index: torch.Tensor,
             index_bits: int = 27) -> torch.Tensor:
    """Pack (kind, index) into one sortable int32: kind-major, index-minor
    — the mesh -> sphere -> loose order of the kind codes 1, 2, 3 (a miss,
    0, never packs)."""
    return (kind.to(torch.int32) << index_bits) | index.to(torch.int32)


def unpack_hit(key: torch.Tensor, index_bits: int = 27
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    mask = (1 << index_bits) - 1
    return (key >> index_bits).to(torch.int32), (key & mask).to(torch.int32)


def ring_shift(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """``lax.ppermute`` with perm ``i -> i+1`` over ``group``: each rank
    sends its tensors to the next rank of the group and receives the
    previous rank's, in one ``batch_isend_irecv``. At a group size of 1
    the tensors come back as they are (no send to self)."""
    size = dist.get_world_size(group)
    if size == 1:
        return list(tensors)
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    nxt, prev = ranks[(me + 1) % size], ranks[(me - 1) % size]
    out = [torch.empty_like(x) for x in tensors]
    ops = []
    for x, y in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, x.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, y, prev, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-gather over ``group``: every rank's ``x [n, ...]``
    concatenated in rank order along dim 0 (``lax.all_gather(...,
    tiled=True)``). The list form, which gloo and NCCL both take."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)
