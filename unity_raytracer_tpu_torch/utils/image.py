"""Image output: PNG/NPY writers + golden-image helpers — a copy of
``unity_raytracer_tpu/utils/image.py`` (numpy only).

The reference has no image output at all — its display device is one Unity
gizmo cube per pixel (Demo-RayTracing/RayTracingSetup.cs:86-112). Here
rendered images are first-class artifacts: raw radiance as .npy (exact, for
goldens) and tonemapped 8-bit PNG for humans.

PNG encoding is hand-rolled over zlib (stdlib-only, no pillow dependency).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def tonemap(img: np.ndarray) -> np.ndarray:
    """Display transform: clamp to [0,1] and quantize to uint8.

    The reference relies on Unity's Color display clamp (values outside
    [0,1] saturate); same here. No gamma — the reference applies none.
    """
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_png(path, img: np.ndarray) -> None:
    """Write [H,W,3] (float 0-1 or uint8) as an RGB PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(png)


def write_npy(path, img: np.ndarray) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.save(p, np.asarray(img, np.float32))


def load_npy(path) -> np.ndarray:
    return np.load(path)
