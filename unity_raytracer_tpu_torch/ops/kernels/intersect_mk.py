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

The kernel culls: each block of ``BLOCK`` consecutive rays tests only
the triangles that some ray of the block could hit, in ascending order.
``nearest_triangle_survivors_plain`` is the plain model of that cull
(the same float operations in the same order as ``csrc/nearest_tri.cu``,
so its survivor lists are the kernel's), for the tests and for measuring:
nothing on the render path calls it. ``nearest_triangle_culled_plain``
folds each block over its survivors only; on every input it must equal
``nearest_triangle_plain`` bit for bit, which is what makes the cull
conservative.
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
# rays per bundle of the cull (csrc/nearest_tri.cu kBlock)
BLOCK = 256
# a launch of fewer blocks is split up to this many (kTargetBlocks)
TARGET_BLOCKS = 2048
# the cull's constants (csrc/nearest_tri.cu, where they are derived):
# slack for rounding, 32 units in the last place of 1; the margin's two
# coefficients, 2 x (1.25 u) and 2 x u with u = 2^-24; the floor of |a|
# below which Möller–Trumbore calls a ray parallel
_SLACK = 2.0 ** -19
_C1, _C2 = 2.5 * 2.0 ** -24, 2.0 * 2.0 ** -24
_A_FLOOR = EPS
# blocks of the plain cull per step (memory: blocks x T x ~30 floats)
_CULL_BLOCKS = 32


def _soup(verts: torch.Tensor, valid: torch.Tensor | None):
    """Detached ``[T,9]`` float32 rows and ``[T]`` float32 flags."""
    tris = verts.detach().to(torch.float32).reshape(-1, 9).contiguous()
    if valid is None:
        live = torch.ones(tris.shape[0], dtype=torch.float32,
                          device=tris.device)
    else:
        live = valid.detach().to(torch.float32).contiguous()
    return tris, live


def _pairs(o3, d3, v):
    """The kernel's exact test of rays (``o3``, ``d3``: x, y, z columns
    ``[N, 1]``) against triangle rows ``v`` (9 x ``[1, B]``):
    ``(miss, t)`` ``[N, B]``, validity not applied."""
    (ox, oy, oz), (dx, dy, dz) = o3, d3
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
    miss = (parallel | (u < 0.0) | (u > 1.0) | (w < 0.0) | (u + w > 1.0)
            | (t <= EPS))
    return miss, t


def _columns(x):
    return tuple(c[:, None] for c in x.detach().to(torch.float32).unbind(-1))


def _fold(o, d, tris, live, keep=None, block=BLOCK):
    """The kernel's formula folded over ascending triangle blocks:
    ``(t [N], index [N] int32)``. ``keep`` ([ceil(N / block), T] bool)
    restricts ray ``i`` to the triangles its block kept."""
    o3, d3 = _columns(o), _columns(d)
    n = o.shape[0]
    best_t = torch.full((n,), torch.inf, dtype=torch.float32,
                        device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    lane_block = torch.arange(n, device=o.device) // block
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    for b0 in range(0, tris.shape[0], step):
        miss, t = _pairs(o3, d3, tris[b0:b0 + step].T[:, None, :])
        miss = miss | ~(live[b0:b0 + step][None, :] >= 0.5)
        if keep is not None:
            miss = miss | ~keep[lane_block, b0:b0 + step]
        tmin, j = torch.where(miss, torch.inf, t).min(dim=1)
        upd = tmin < best_t
        best_t = torch.where(upd, tmin, best_t)
        best_i = torch.where(upd, j + b0, best_i)
    return best_t, best_i.to(torch.int32)


def nearest_triangle_accepts_plain(o: torch.Tensor, d: torch.Tensor,
                                   verts: torch.Tensor,
                                   valid: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """``[N, T]`` bool: the pairs the exact test accepts (a valid
    triangle, a hit at t > 1e-5), whether or not they are the nearest;
    the set a conservative cull must keep. For tests; ``N x T`` memory."""
    tris, live = _soup(verts, valid)
    miss, _ = _pairs(_columns(o), _columns(d), tris.T[:, None, :])
    return ~miss & (live[None, :] >= 0.5)


def nearest_triangle_plain(o: torch.Tensor, d: torch.Tensor,
                           verts: torch.Tensor,
                           valid: torch.Tensor | None = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(t [N], index [N] int32)``."""
    tris, live = _soup(verts, valid)
    return _fold(o, d, tris, live)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _big(a, b):
    """``b > a ? b : a``, as the kernel takes it (a NaN ``b`` loses)."""
    return torch.where(b > a, b, a)


def cull_records(tris: torch.Tensor, live: torch.Tensor) -> dict:
    """Per triangle what the cull reads (csrc/nearest_tri.cu
    ``prep_kernel``): the centre of its vertices and a radius that holds
    them, its normal ``e1 x e2``, ``P = |e1| |e2|``, ``Q = |e1| + |e2|``
    and its valid flag."""
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=tris.device)
    v = tris.T
    e1 = (v[3] - v[0], v[4] - v[1], v[5] - v[2])
    e2 = (v[6] - v[0], v[7] - v[1], v[8] - v[2])
    l1 = torch.sqrt(_dot(*e1, *e1))
    l2 = torch.sqrt(_dot(*e2, *e2))
    cen = [(v[j] + v[3 + j] + v[6 + j]) * f(1.0 / 3.0) for j in range(3)]
    r2 = None
    for k in range(3):
        dv = [v[3 * k + j] - cen[j] for j in range(3)]
        q = _dot(*dv, *dv)
        r2 = q if r2 is None else _big(r2, q)
    return dict(cen=torch.stack(cen, 1),
                radius=torch.sqrt(r2) * f(1.0 + _SLACK),
                normal=torch.stack(_cross(*e1, *e2), 1), p=l1 * l2,
                q=l1 + l2, live=live >= 0.5)


def block_bundles(o: torch.Tensor, d: torch.Tensor, block: int = BLOCK
                  ) -> dict:
    """Per block of ``block`` consecutive rays, the bundle the kernel's
    cull tests against (the reductions that open csrc/nearest_tri.cu's
    ``nearest_tri_kernel``): which rays
    take part (finite, a non-zero direction), the box of their origins,
    the apex ball around it, the cone of their directions (axis, the
    bounds of the cosine and sine of any ray's angle to it) and the least
    and largest |d|."""
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=o.device)
    n = o.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    o = torch.nn.functional.pad(o.detach().to(torch.float32), (0, 0, 0, pad))
    d = torch.nn.functional.pad(d.detach().to(torch.float32), (0, 0, 0, pad))
    lane = torch.arange(nb * block, device=o.device) < n
    part = (lane & torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
            & (d != 0).any(-1))
    dx, dy, dz = d.unbind(-1)
    ln = torch.sqrt(_dot(dx, dy, dz, dx, dy, dz))
    wild = part & ~((ln > 0) & (ln < torch.inf))
    good = part & ~wild
    dn = d / ln[:, None]
    inf = torch.inf
    blk = lambda x: x.reshape(nb, block, *x.shape[1:])
    lo = lambda x, m: blk(torch.where(m[:, None] if x.dim() > 1 else m, x,
                                      inf)).amin(1)
    hi = lambda x, m: blk(torch.where(m[:, None] if x.dim() > 1 else m, x,
                                      -inf)).amax(1)
    any_part, any_wild = blk(part).any(1), blk(wild).any(1)
    olo, ohi, dlo, dhi = lo(o, part), hi(o, part), lo(dn, good), hi(dn, good)
    dmin, dmax = lo(ln, good), hi(ln, good)
    m = (dlo + dhi) * f(0.5)
    ml = torch.sqrt(_dot(*m.unbind(-1), *m.unbind(-1)))
    c = m / ml[:, None]
    cl = c.repeat_interleave(block, 0)
    cosv = _dot(*dn.unbind(-1), *cl.unbind(-1))
    sv = _cross(*dn.unbind(-1), *cl.unbind(-1))
    sinv = torch.sqrt(_dot(*sv, *sv))
    cos_lo = lo(cosv, good) - f(_SLACK)
    sin_hi = hi(sinv, good) + f(_SLACK)
    ac = (olo + ohi) * f(0.5)
    h = (ohi - olo) * f(0.5)
    r_o = (torch.sqrt(_dot(*h.unbind(-1), *h.unbind(-1))) * f(1.0 + _SLACK)
           + (ac[:, 0].abs() + ac[:, 1].abs() + ac[:, 2].abs())
           * f(2.0 ** -22))
    cone = (any_part & ~any_wild & (ml > 0) & (cos_lo > 0)
            & torch.isfinite(r_o) & torch.isfinite(ac).all(-1)
            & torch.isfinite(c).all(-1))
    return dict(any_part=any_part, cone=cone, apex=ac, r_o=r_o, axis=c,
                cos_lo=cos_lo, sin_hi=sin_hi, dmin=dmin, dmax=dmax,
                part=blk(part))


def nearest_triangle_survivors_plain(o: torch.Tensor, d: torch.Tensor,
                                     verts: torch.Tensor,
                                     valid: torch.Tensor | None = None,
                                     block: int = BLOCK,
                                     margin_scale: float = 1.0
                                     ) -> torch.Tensor:
    """Plain model of the kernel's cull: ``[ceil(N / block), T]`` bool,
    True where the block keeps the triangle for its exact fold.

    A block with no ray taking part keeps nothing; one whose cone is
    unusable (a ray at 90 degrees or more from the axis, or a direction
    whose length over- or underflows) keeps every valid triangle; else a
    valid triangle is kept unless its ball, grown by the margin, lies
    outside the cone grown by the apex ball. ``margin_scale`` scales the
    margin (1 in the kernel; 0 drops it, and with it the keeping of
    triangles whose margin has no bound, to show what it is for)."""
    tris, live = _soup(verts, valid)
    rec = cull_records(tris, live)
    b = block_bundles(o, d, block)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=o.device)
    nb = b["cone"].shape[0]
    keep = torch.zeros((nb, tris.shape[0]), dtype=torch.bool,
                       device=o.device)
    cen, r, nrm = rec["cen"], rec["radius"][None], rec["normal"]
    p, q = rec["p"][None], rec["q"][None]
    for b0 in range(0, nb, _CULL_BLOCKS):
        sl = slice(b0, b0 + _CULL_BLOCKS)
        col = lambda x: x[sl, None]
        ac, c = b["apex"][sl], b["axis"][sl]
        cos_lo, sin_hi = col(b["cos_lo"]), col(b["sin_hi"])
        r_o, dmin, dmax = col(b["r_o"]), col(b["dmin"]), col(b["dmax"])
        v = [cen[None, :, j] - ac[:, None, j] for j in range(3)]
        cc = [c[:, None, j] for j in range(3)]
        a_ = _dot(*v, *cc)
        pv = _cross(*v, *cc)
        pp = torch.sqrt(_dot(*pv, *pv))
        vl = torch.sqrt(_dot(*v, *v))
        big_f = pp * cos_lo - torch.where(a_ > 0, a_, f(0.0)) * sin_hi
        s = vl + r_o + r
        cn = _dot(*cc, *(nrm[None, :, j] for j in range(3)))
        g = dmin * (cn.abs() * cos_lo - p * (sin_hi + f(_SLACK)))
        a = _big(f(_A_FLOOR), g) - f(_SLACK) * dmax * p
        # the margin m, kept where its bound fails (A <= 0)
        m = f(_C1) * dmax * p * (f(15.0) * s + f(7.0) * q) / a \
            + f(_C2) * (s + q)
        unbounded = ~(a > 0)
        if margin_scale != 1.0:
            m = m * f(margin_scale)
            unbounded = unbounded & (margin_scale != 0.0)
        thr = r + m + r_o + f(_SLACK) * vl
        inside = unbounded | ~(big_f > thr)
        cone = col(b["cone"])
        keep[sl] = rec["live"][None] & col(b["any_part"]) & (~cone | inside)
    return keep


def nearest_triangle_culled_plain(o: torch.Tensor, d: torch.Tensor,
                                  verts: torch.Tensor,
                                  valid: torch.Tensor | None = None,
                                  block: int = BLOCK,
                                  margin_scale: float = 1.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's answer by the plain route: each ray folded over its
    block's survivors (``nearest_triangle_survivors_plain``) only."""
    tris, live = _soup(verts, valid)
    keep = nearest_triangle_survivors_plain(o, d, verts, valid, block,
                                            margin_scale)
    return _fold(o, d, tris, live, keep, block)


def _launch(o, d, verts, valid, survivors: bool):
    """``urt_nearest_tri`` on the card: ``(t, index, survivors or None)``;
    ``survivors`` runs the counting instance."""
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
    scratch = torch.empty((24 * tris.shape[0],), dtype=torch.float32,
                          device=od.device)
    # the split shares meet in n 64-bit keys (urt_nearest_tri's launch)
    blocks, chunks = -(-n // BLOCK), -(-tris.shape[0] // BLOCK)
    split = chunks >= 2 and blocks and -(-TARGET_BLOCKS // blocks) > 1
    keys = (torch.empty((n,), dtype=torch.int64, device=od.device)
            if split else None)
    surv = (torch.zeros((-(-n // BLOCK),), dtype=torch.int32,
                        device=od.device) if survivors else None)
    if n:
        err = _lib.nearest_tri_lib().urt_nearest_tri(
            od.data_ptr(), dd.data_ptr(), tris.data_ptr(), live.data_ptr(),
            n, tris.shape[0], scratch.data_ptr(),
            None if keys is None else keys.data_ptr(),
            t_out.data_ptr(), i_out.data_ptr(),
            None if surv is None else surv.data_ptr(),
            torch.cuda.current_stream(od.device).cuda_stream)
        if err:
            raise RuntimeError(f"urt_nearest_tri launch failed: CUDA error "
                               f"{err}")
    return t_out, i_out, surv


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
    t_out, i_out, _ = _launch(o, d, verts, valid, False)
    if o.shape[0]:
        launches["nearest_triangle"] += 1
    return t_out, i_out


def nearest_triangle_survivors(o: torch.Tensor, d: torch.Tensor,
                               verts: torch.Tensor,
                               valid: torch.Tensor | None = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """For measuring, on CUDA tensors only: the kernel's counting instance,
    ``(t, index, kept)`` with ``kept`` [ceil(N / BLOCK)] int32 the number
    of triangles each block kept (the row sums of
    ``nearest_triangle_survivors_plain``). Not counted in ``launches``."""
    if o.device.type != "cuda":
        raise ValueError("nearest_triangle_survivors needs the CUDA kernel")
    return _launch(o, d, verts, valid, True)
