"""Pixel-block lane order: padded dims and the un-swizzle back to an image.

Twin: ``unity_raytracer_tpu/utils/swizzle.py`` (``padded_dims``,
``unswizzle_image``, ``swizzle_image``, ``block_perm``). Primary rays are generated in bs x
bs screen-block lane order (``models/camera.generate_rays_blocks``) on a
grid padded to whole blocks; ``unswizzle_image`` restores row-major order
with one reshape + permute and crops the pad margin, and
``swizzle_image`` goes the other way for a target image — relayouts,
exact. ``block_perm`` gives the same order as an index permutation of an
unpadded row-major image.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
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


@functools.lru_cache(maxsize=32)
def block_perm(width: int, height: int, bs: int = 32
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv) int32 over the W*H pixels of a row-major image:
    ``perm`` lists them in bs x bs block order (block row, block column,
    then row-major within the block; edge blocks are cut, not padded) and
    ``inv`` undoes it. The identity for ``bs <= 1``."""
    if bs <= 1:
        eye = np.arange(width * height, dtype=np.int32)
        return eye, eye
    ys, xs = np.mgrid[0:height, 0:width]
    # a unique sort key: (block row, block col, in-block row-major offset)
    key = (((ys // bs) * ((width + bs - 1) // bs) + (xs // bs))
           * (bs * bs) + (ys % bs) * bs + (xs % bs))
    perm = np.argsort(key.ravel(), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, inv
