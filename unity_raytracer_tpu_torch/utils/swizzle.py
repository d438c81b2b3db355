"""Pixel-block lane order: padded dims and the un-swizzle back to an image.

Twin: ``unity_raytracer_tpu/utils/swizzle.py:1-61`` (``padded_dims``,
``unswizzle_image``). Primary rays are generated in bs x bs screen-block
lane order (``models/camera.generate_rays_blocks``) on a grid padded to
whole blocks; ``unswizzle_image`` restores row-major order with one
reshape + permute and crops the pad margin — a relayout, exact.
"""

from __future__ import annotations

from typing import Tuple

import torch


def padded_dims(width: int, height: int, bs: int) -> Tuple[int, int]:
    """(Wp, Hp): image dims rounded up to whole bs x bs blocks."""
    if bs <= 1:
        return width, height
    return -(-width // bs) * bs, -(-height // bs) * bs


def unswizzle_image(rad: torch.Tensor, width: int, height: int,
                    bs: int) -> torch.Tensor:
    """Block-ordered radiance [Wp*Hp, C] -> row-major image [H, W, C].

    Lanes are (block row, block col, in-block row, in-block col); one
    5-d reshape + permute restores (row, col)."""
    c = rad.shape[-1]
    if bs <= 1:
        return rad.reshape(height, width, c)
    wp, hp = padded_dims(width, height, bs)
    img = rad.reshape(hp // bs, wp // bs, bs, bs, c).permute(0, 2, 1, 3, 4)
    return img.reshape(hp, wp, c)[:height, :width]
