"""Ordered binary walk: near child first, the far child on a per-ray stack.

Twin: ``unity_raytracer_tpu/ops/pallas/traverse_mk4.py`` — the
``traverse_packet4`` wrapper (``:191-261``). Its Pallas kernel
(``_kernel``, ``:39-188``, ``pallas_call`` at ``:225``) is replaced by the
``MK4`` instances of ``csrc/traverse.cu``: per ray, the child with the
smaller entry distance is visited first and the other is pushed with its
entry distance on a private stack of the twin's 96 entries (``:36``), and
dropped on pop once it exceeds the ray's best t; a push past the stack
raises in the wrapper. This is the traversal ``kernel='pallas'`` (and
``'auto'`` on the card) runs. The wrapper, the plain version and the
epilogue are shared with the threaded walk (``traverse_mk3.walk``).
"""

from __future__ import annotations

import torch

from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import (
    PackedBVH, walk)


def traverse_packet4(packed: PackedBVH, o: torch.Tensor, d: torch.Tensor,
                     t_max: torch.Tensor | None = None,
                     any_hit: bool = False,
                     overflow: torch.Tensor | None = None):
    """Ordered-walk twin of ``traverse_mk3.traverse_packet3``: same
    outputs, ``t_max`` cull, ``any_hit`` mode and ``overflow``."""
    return walk("mk4", packed, o, d, t_max, any_hit, overflow)
