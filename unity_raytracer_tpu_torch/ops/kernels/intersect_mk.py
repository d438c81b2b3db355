"""Brute-force nearest triangle: the plain version and the kernel wrapper.

Twin: ``unity_raytracer_tpu/ops/pallas/intersect_mk.py`` — the
``nearest_triangle_pallas`` wrapper (``:108-183``), whose Pallas kernel
(``_nearest_tri_kernel``, ``:44-105``, ``pallas_call`` at ``:145``) is
replaced by ``csrc/nearest_tri.cu``. For every ray the smallest
Möller–Trumbore ``t`` over all triangles of a ``[T,3,3]`` soup with a
valid mask, and its index: the first minimum in ascending triangle order
wins; +inf and -1 where nothing is hit. ``ops/intersect.nearest_hit``
routes a BVH-less mesh of >= 2048 triangles here when ``kernel`` is
'pallas*' or 'mega', so the ``[N, T]`` matrix of the plain brute force
is never stored.

``nearest_triangle_pallas`` launches the CUDA kernel for CUDA tensors and
runs ``nearest_triangle_plain`` for CPU tensors, nothing else. The plain
version folds over blocks of triangles (memory bounded by
``_CHUNK_ELEMS`` ray x triangle pairs) with the kernel's formula. No
gradient reaches either: they read detached inputs, and the caller
re-derives ``t`` from the winning triangle.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unity_raytracer_tpu_torch.ops.kernels import _lib
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import EPS

# kernel launches since the count was last reset (set it to 0 to start a
# count); only nearest_triangle_pallas's CUDA branch adds to it
launches = {"nearest_triangle": 0}
# plain version: ray x triangle pairs per block of the fold
_CHUNK_ELEMS = 1 << 22


def _soup(verts: torch.Tensor, valid: torch.Tensor | None):
    """Detached ``[T,9]`` float32 rows and ``[T]`` float32 flags."""
    tris = verts.detach().to(torch.float32).reshape(-1, 9).contiguous()
    if valid is None:
        live = torch.ones(tris.shape[0], dtype=torch.float32,
                          device=tris.device)
    else:
        live = valid.detach().to(torch.float32).contiguous()
    return tris, live


def nearest_triangle_plain(o: torch.Tensor, d: torch.Tensor,
                           verts: torch.Tensor,
                           valid: torch.Tensor | None = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(t [N], index [N] int32)``."""
    tris, live = _soup(verts, valid)
    o3 = tuple(c[:, None] for c in o.detach().to(torch.float32).unbind(-1))
    dx, dy, dz = (c[:, None] for c in d.detach().to(torch.float32).unbind(-1))
    ox, oy, oz = o3
    n = o.shape[0]
    best_t = torch.full((n,), torch.inf, dtype=torch.float32,
                        device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    block = max(1, _CHUNK_ELEMS // max(n, 1))
    for b0 in range(0, tris.shape[0], block):
        v = tris[b0:b0 + block].T[:, None, :]   # 9 x [1, B]
        ok = live[b0:b0 + block][None, :] >= 0.5
        e1x, e1y, e1z = v[3] - v[0], v[4] - v[1], v[5] - v[2]
        e2x, e2y, e2z = v[6] - v[0], v[7] - v[1], v[8] - v[2]
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        parallel = a.abs() < EPS
        f = 1.0 / torch.where(parallel, 1.0, a)
        sx, sy, sz = ox - v[0], oy - v[1], oz - v[2]
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        w = f * (dx * qx + dy * qy + dz * qz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        miss = (parallel | (u < 0.0) | (u > 1.0) | (w < 0.0)
                | (u + w > 1.0) | (t <= EPS) | ~ok)
        tmin, j = torch.where(miss, torch.inf, t).min(dim=1)
        upd = tmin < best_t
        best_t = torch.where(upd, tmin, best_t)
        best_i = torch.where(upd, j + b0, best_i)
    return best_t, best_i.to(torch.int32)


def nearest_triangle_pallas(o: torch.Tensor, d: torch.Tensor,
                            verts: torch.Tensor,
                            valid: torch.Tensor | None = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-triangle query ``(t [N], index [N] int32)``, +inf / -1 on a
    miss: ``csrc/nearest_tri.cu`` for CUDA tensors, the plain version for
    CPU tensors."""
    if o.device.type == "cpu":
        return nearest_triangle_plain(o, d, verts, valid)
    if o.device.type != "cuda":
        raise ValueError(f"nearest_triangle_pallas: unsupported device "
                         f"{o.device}")
    od = o.detach().to(torch.float32).contiguous()
    dd = d.detach().to(torch.float32).contiguous()
    tris, live = _soup(verts, valid)
    n = od.shape[0]
    for name, t in dict(o=od, d=dd, tris=tris, valid=live).items():
        if t.device != od.device:
            raise ValueError(f"nearest_triangle_pallas: {name} is not on "
                             f"{od.device}")
    if dd.shape != (n, 3) or live.shape != (tris.shape[0],):
        raise ValueError("nearest_triangle_pallas: bad ray or soup shapes")
    t_out = torch.empty((n,), dtype=torch.float32, device=od.device)
    i_out = torch.empty((n,), dtype=torch.int32, device=od.device)
    if n:
        err = _lib.nearest_tri_lib().urt_nearest_tri(
            od.data_ptr(), dd.data_ptr(), tris.data_ptr(), live.data_ptr(),
            n, tris.shape[0], t_out.data_ptr(), i_out.data_ptr(),
            torch.cuda.current_stream(od.device).cuda_stream)
        if err:
            raise RuntimeError(f"urt_nearest_tri launch failed: CUDA error "
                               f"{err}")
        launches["nearest_triangle"] += 1
    return t_out, i_out
