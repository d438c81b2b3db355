"""Pixel-block lane order: padded dims and the un-swizzle back to an image.

Twin: ``unity_raytracer_tpu/utils/swizzle.py:1-79`` (``padded_dims``,
``unswizzle_image``, ``swizzle_image``). Primary rays are generated in bs x
bs screen-block lane order (``models/camera.generate_rays_blocks``) on a
grid padded to whole blocks; ``unswizzle_image`` restores row-major order
with one reshape + permute and crops the pad margin, and
``swizzle_image`` goes the other way for a target image — relayouts,
exact.
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


def swizzle_image(img: torch.Tensor, bs: int) -> torch.Tensor:
    """Row-major image [H, W, C] -> block-ordered lanes [Wp*Hp, C], the
    inverse of ``unswizzle_image`` with the pad margin zero-filled: puts a
    target image into ``generate_rays_blocks``'s lane order for ray-space
    losses."""
    h, w, c = img.shape
    if bs <= 1:
        return img.reshape(-1, c)
    wp, hp = padded_dims(w, h, bs)
    img = torch.nn.functional.pad(img, (0, 0, 0, wp - w, 0, hp - h))
    img = img.reshape(hp // bs, bs, wp // bs, bs, c).permute(0, 2, 1, 3, 4)
    return img.reshape(-1, c)
