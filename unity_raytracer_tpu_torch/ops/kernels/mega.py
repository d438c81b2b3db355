"""Fused bounce segment: the aux block, the plain version and the kernel wrapper.

Twin: ``unity_raytracer_tpu/ops/pallas/mega.py`` — ``build_aux``
(``:1251-1289``, same ``[rows,128]`` layout) and ``trace_segment``
(``:1292-1459``, whose Pallas kernel ``_kernel`` at ``:459`` is replaced by
``csrc/mega_segment.cu``) in all its modes: the hard forward the render
runs (a), ``record`` (b), the dielectric ``fork`` of the tree (c) and
``record_soft`` (d), each on the leaf test and BVH layout the config names
(e): Baldwin–Weber records (``tri_isect='bw'``, wide layouts only) or
Möller–Trumbore on the vertex rows (``'mt'``), on the wide BVH4/8 rows or
the binary node rows (``bvh_arity=0``), one shadow query per light,
``light_cull`` honoured. One segment over N rays computes

* the nearest hit: mesh triangles (strict ``<``), then spheres and loose
  triangles (strict ``best_t > t``, the reference combine order,
  Data/Objects/Scene.cs:64-115), masked by the scene AABB;
* the winner's material from ``aux`` (mesh ids from ``leafmeta``) and its
  shading normal (the stored Baldwin–Weber plane normal, or the bake
  convention ``-cross(v2-v0, v1-v0)/|.|`` of the twin's ``tri_normal``);
* per light the ``light_cull`` gate and a shadow query against spheres,
  loose triangles and the mesh: any-hit, or in ``record_soft`` mode the
  nearest occluder (the twin's min mode, ``:1064-1248``);
* Blinn-Phong radiance on the 0-255 scale and the mirror continuation, or
  in ``fork`` mode the reflect and refract children of ``_trace_tree``
  (Schlick Fresnel, total internal reflection, ``:976-1045``).

It returns ``(delta [N,3], o' [N,3], d' [N,3], thr' [N,3], tmax' [N])``.
A lane with ``tmax < 0`` is dead on input and gets pass-through values.
With ``record`` (or ``record_soft``, which implies it) the return gains a
hit-record tuple ``(t [N], n [N,3], matid [N], occbits [N])`` for the
differentiable replay (``ops/replay.py``): ``t`` and ``matid`` are -1
where the lane does not hit, ``n`` is the winner's shading normal,
``occbits`` is the sum of 2^l over occluded lights as float32 (a culled or
unneeded light is not occluded). ``record_soft`` adds ``st [N, L]``, the
nearest occluder distance per light, ``_BIG`` where unoccluded. Dead lanes
record ``t = -1, n = 0, matid = -1, occbits = 0, st = _BIG``.

With ``fork`` (forward only) the return is ``(delta, ro, rd, w_refl,
tmax_refl, to, td, w_refr, tmax_refr)``: the reflect child (mirrors and
dielectrics) and the refract child (dielectrics without total internal
reflection), each with its throughput-weighted weight; ``tmax`` is
``_BIG`` for a live child and -1 for a dead one. A dead input lane gives
two dead children of weight 0 with its own origin and direction.
``has_mesh=False`` (a scene without mesh triangles, such as
``cornell_box``) skips every BVH walk: ``packed`` may then be ``None``.

``trace_segment`` launches the CUDA kernel for CUDA tensors and runs
``trace_segment_plain`` for CPU tensors, nothing else. The plain version
finds mesh hits and occluders by brute force over every non-pad leaf slot
of ``tris_bw`` ('bw') or ``tris`` ('mt'), ignoring the BVH nodes, so the
layout does not change it and it checks the kernel's walks and the host
packers independently; everything else follows the kernel's formulas.

aux rows (``build_aux``):
  row 0:            gate_min(0:3) gate_max(3:6) (the Scene's widened box)
                    ambient(6:9) bg(9:12)
  rows lights:      pos(0:3) intensity(3:6) valid(6)
  rows spheres:     center(0:3) r2(3) valid(4) matid(5)
  rows loose tris:  v0 v1 v2 (0:9) normal(9:12) valid(12) matid(13)
  rows materials:   diffuse(0:3) ambient(3:6) mirror(6:9) specular(9:12)
                    phong(12) is_mirror(13) transparency(14:17) ior(17)
                    is_dielectric(18)
"""

from __future__ import annotations

import torch

from unity_raytracer_tpu_torch.ops.kernels import _lib
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import (
    _BIG, _WIDE_STACK, BW_PER_ROW, EPS, PALLAS_LEAF, STACK_BINARY, PackedBVH,
    check_overflow, check_stack, walk_table)
from unity_raytracer_tpu_torch.ops.shade import SHADOW_EPS

_TINY = 1e-30
# the twin clamps squared lengths with max(x, 1e-60); 1e-60 rounds to 0
# in float32, so the clamp is max(x, 0)
_MIN_SQ = 0.0
# plain version: ray x leaf-slot pairs per brute-force chunk
_CHUNK_ELEMS = 1 << 22

MODES = ("forward", "record", "record_soft", "fork")
# the kernel's instances: a leaf test on a layout, or no walk at all
ROUTES = ("bw/wide4", "bw/wide8", "mt/wide4", "mt/wide8", "mt/binary",
          "meshless")
# the route's layout code in csrc/mega_segment.cu and its library
_LAYOUT = {"wide4": 4, "wide8": 8, "binary": 1, "meshless": 0}
_LIBRARY = {"wide4": "wide4", "wide8": "wide8", "binary": "binary",
            "meshless": "binary"}
# kernel launches since the counts were last reset (set them to 0 to start
# a count), per mode and per (mode, route); only trace_segment's CUDA
# branch adds to them
launches = dict.fromkeys(MODES, 0)
route_launches = {(m, r): 0 for m in MODES for r in ROUTES}
# per-light occlusion bits are a float32 sum of 2^l: exact up to 2^24
MAX_RECORD_LIGHTS = 24
# the counting instance's tallies, in the order of its ``counts`` tensor:
# the totals the bound reads (slab tests, Baldwin–Weber leaf-slot tests,
# sphere tests, Möller–Trumbore tests), then per phase (the nearest walk,
# the shadow walks) slab tests, leaf-slot tests, warp issues of a
# leaf-slot test (slot tests / issues = mean active lanes per test) and
# the deepest stack (a maximum), then live lanes, shadow queries, and per
# phase the leaf-group box tests
COUNTS = ("slab", "bw_slot", "sphere", "mt",
          "nearest_slab", "shadow_slab", "nearest_slots", "shadow_slots",
          "nearest_issues", "shadow_issues", "nearest_depth", "shadow_depth",
          "live", "queries", "nearest_groups", "shadow_groups")


def build_aux(scene, background) -> torch.Tensor:
    """Pack scene constants into the [rows,128] f32 aux block (module
    docstring), on the scene's device, with device ops only (no copy to
    the host, so no sync inside a frame). Unlike the twin's, its scene box
    is the scene's gate box (``Scene.gate_min`` / ``gate_max``: the exact
    box widened once by ``utils/boxes.pad_box``, as the walk rows' boxes
    are), the box every composed gate tests too: the fused kernel's scene
    gate then keeps a hit at the box's face."""
    lt, sp, tr = scene.lights, scene.spheres, scene.triangles
    dev = scene.aabb_min.device
    f = lambda x: x.to(torch.float32).reshape(x.shape[0], -1)
    idx = lambda start, n: torch.arange(
        start, start + n, device=dev, dtype=torch.float32)[:, None]
    bg = torch.tensor(background, dtype=torch.float32, device=dev) * 255.0
    mats = [torch.cat([f(m.diffuse), f(m.ambient), f(m.mirror),
                       f(m.specular), f(m.phong), f(m.is_mirror),
                       f(m.transparency), f(m.ior), f(m.is_dielectric)], 1)
            for m in (sp.materials, tr.materials,
                      scene.meshes.mesh_materials)]
    blocks = [
        torch.cat([scene.gate_min, scene.gate_max, lt.ambient, bg])[None],
        torch.cat([f(lt.positions), f(lt.intensities), f(lt.valid)], 1),
        torch.cat([f(sp.centers), f(sp.radius_sq), f(sp.valid),
                   idx(0, sp.count)], 1),
        torch.cat([f(tr.verts), f(tr.normals), f(tr.valid),
                   idx(sp.count, tr.count)], 1),
        *mats]
    return torch.cat([torch.nn.functional.pad(x, (0, 128 - x.shape[1]))
                      for x in blocks], 0)


def segment_route(packed: PackedBVH | None, tri_isect: str = "bw",
                  use_wide: bool | None = None,
                  has_mesh: bool = True) -> str:
    """The kernel instance a segment runs on (one of ``ROUTES``), by the
    twin's rule (``:1374-1386``): the wide rows whenever ``packed.wide``
    exists and ``use_wide`` is not False, else the binary nodes;
    Baldwin–Weber needs the wide rows and ``tris_bw``. Raises
    ``ValueError`` for a combination the twin refuses."""
    if tri_isect not in ("bw", "mt"):
        raise ValueError(f"tri_isect must be 'bw' or 'mt', got {tri_isect!r}")
    if not has_mesh:
        return "meshless"
    if packed is None or packed.leafmeta is None:
        raise ValueError("the fused segment needs PackedBVH.leafmeta — "
                         "build the BVH with prepare_bvh")
    wide = packed.wide is not None and use_wide is not False
    if tri_isect == "bw":
        if packed.tris_bw is None:
            raise ValueError("tri_isect='bw' needs PackedBVH.tris_bw — "
                             "build the BVH with prepare_bvh (pack_bw)")
        if not wide:
            raise ValueError("tri_isect='bw' is implemented for the wide "
                             "walks only (bvh_arity >= 2)")
    if not wide:
        return "mt/binary"
    return f"{tri_isect}/wide{packed.wide.shape[1] // 8}"


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _sqrt(x):
    """float32 sqrt, correctly rounded on every device (PyTorch's CPU
    float32 sqrt is not always; one rounding from float64 is)."""
    return torch.sqrt(x.double()).float()


def _rsqrt(x):
    """1 / sqrt(x), as the kernel computes it."""
    return 1.0 / _sqrt(x)


def _fix(v):
    """Near-zero direction components to +/-1e-30 (finite slab products)."""
    return torch.where(v.abs() < _TINY,
                       torch.where(v < 0, -_TINY, _TINY).to(v.dtype), v)


def _slab(o3, inv3, box, best):
    ox, oy, oz = o3
    ix, iy, iz = inv3
    t1 = (box[0] - ox) * ix
    t2 = (box[3] - ox) * ix
    tn = torch.minimum(t1, t2)
    tf = torch.maximum(t1, t2)
    t1 = (box[1] - oy) * iy
    t2 = (box[4] - oy) * iy
    tn = torch.maximum(tn, torch.minimum(t1, t2))
    tf = torch.minimum(tf, torch.maximum(t1, t2))
    t1 = (box[2] - oz) * iz
    t2 = (box[5] - oz) * iz
    tn = torch.maximum(tn, torch.minimum(t1, t2))
    tf = torch.minimum(tf, torch.maximum(t1, t2))
    tn = torch.clamp_min(tn, 0.0)
    return (tn <= tf) & (tn <= best)


def _sphere(o3, d3, r):
    """Ray vs the sphere in aux row ``r`` -> (ok, t)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    ocx, ocy, ocz = ox - r[0], oy - r[1], oz - r[2]
    uoc = dx * ocx + dy * ocy + dz * ocz
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    disc = uoc * uoc - (oc2 - r[3])
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    big = -uoc + sq
    small = -uoc - sq
    t = torch.where(small < 0.0, big, small)
    return (disc >= 0.0) & (big >= 0.0) & (r[4] > 0.0), t


def _mt(o3, d3, v):
    """Möller–Trumbore vs one triangle (9 values v0 v1 v2) -> (ok, t)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    e1x, e1y, e1z = v[3] - v[0], v[4] - v[1], v[5] - v[2]
    e2x, e2y, e2z = v[6] - v[0], v[7] - v[1], v[8] - v[2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    par = det.abs() < EPS
    f = 1.0 / torch.where(par, 1.0, det)
    sx, sy, sz = ox - v[0], oy - v[1], oz - v[2]
    u = f * (sx * px + sy * py + sz * pz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    w = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (~par & (u >= 0.0) & (u <= 1.0) & (w >= 0.0) & (u + w <= 1.0)
          & (t > EPS))
    return ok, t


def _tri_normal(v):
    """The bake-convention shading normal of triangles [K,9] (the twin's
    ``tri_normal``, ``:594-604``): ``-c / |c|`` with ``c = cross(v2 - v0,
    v1 - v0)``."""
    e1x, e1y, e1z = v[:, 6] - v[:, 0], v[:, 7] - v[:, 1], v[:, 8] - v[:, 2]
    e2x, e2y, e2z = v[:, 3] - v[:, 0], v[:, 4] - v[:, 1], v[:, 5] - v[:, 2]
    cx = e1y * e2z - e1z * e2y
    cy = e1z * e2x - e1x * e2z
    cz = e1x * e2y - e1y * e2x
    inv = -_rsqrt(torch.clamp_min(cx * cx + cy * cy + cz * cz, _MIN_SQ))
    return torch.stack([cx * inv, cy * inv, cz * inv], dim=-1)


def _leaf_slots(packed: PackedBVH | None, tri_isect: str):
    """Every non-pad leaf slot as (record, material id [K]) — the mesh
    triangles the plain version tests by brute force. Records are the
    Baldwin–Weber rows [K,12] of ``tris_bw`` ('bw') or the vertices [K,9]
    of ``tris`` ('mt'); pad slots are all zero."""
    if packed is None:
        return torch.zeros((0, 9)), torch.zeros((0,))
    rpl = packed.rows_per_leaf
    if tri_isect == "mt":
        rec = packed.tris[:, :9 * PALLAS_LEAF].reshape(-1, 9)
        mid = packed.leafmeta[:, :PALLAS_LEAF].reshape(-1)
        keep = (rec != 0.0).any(dim=1)
        return rec[keep], mid[keep]
    bw_rpl = packed.bw_rows_per_leaf
    n_leaves = packed.tris_bw.shape[0] // bw_rpl
    slots = rpl * PALLAS_LEAF
    rec = packed.tris_bw.reshape(n_leaves, bw_rpl, 128)[
        :, :, :12 * BW_PER_ROW].reshape(n_leaves, -1, 12)[:, :slots]
    mid = packed.leafmeta[:n_leaves * rpl].reshape(n_leaves, rpl, -1)[
        :, :, :PALLAS_LEAF].reshape(n_leaves, slots)
    rec = rec.reshape(-1, 12)
    keep = (rec[:, :3] != 0.0).any(dim=1)  # pad records are all zero
    return rec[keep], mid.reshape(-1)[keep]


def _slot_chunks(o3, d3, rec):
    """Yield (start, ok [n,C], t [n,C]) of the leaf test of rays against
    the records ``rec`` in slot order (Baldwin–Weber for [K,12] records,
    Möller–Trumbore for [K,9] vertices), chunked to bound memory."""
    ox, oy, oz = (c[:, None] for c in o3)
    dx, dy, dz = (c[:, None] for c in d3)
    chunk = max(1, _CHUNK_ELEMS // max(ox.shape[0], 1))
    for s0 in range(0, rec.shape[0], chunk):
        cols = rec[s0:s0 + chunk].T[:, None, :]
        if rec.shape[1] == 9:
            ok, t = _mt((ox, oy, oz), (dx, dy, dz), cols)
            yield s0, ok, t
            continue
        nx, ny, nz, dh, ax, ay, az, a0, bx, by, bz, b0 = cols
        nd = nx * dx + ny * dy + nz * dz
        par = nd.abs() < _TINY
        t = (dh - (nx * ox + ny * oy + nz * oz)) / torch.where(par, 1.0, nd)
        hx = ox + dx * t
        hy = oy + dy * t
        hz = oz + dz * t
        u = ax * hx + ay * hy + az * hz + a0
        v = bx * hx + by * hy + bz * hz + b0
        ok = ~par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
        yield s0, ok, t


def _nearest_mesh_plain(o3, d3, rec, mid, live):
    """Nearest mesh hit by brute force: (best_t, n [3], matid). The first
    slot at the minimum wins, like a strict ``<`` in visit order."""
    n = live.shape[0]
    dev = live.device
    best_t = torch.where(live, _BIG, -1.0).to(torch.float32)
    bn = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    bmat = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    idx = torch.nonzero(live).squeeze(1)
    if idx.numel() == 0 or rec.shape[0] == 0:
        return best_t, bn, bmat
    o3 = tuple(c[idx] for c in o3)
    d3 = tuple(c[idx] for c in d3)
    bt = best_t[idx]
    bi = torch.full_like(idx, -1)
    for s0, ok, t in _slot_chunks(o3, d3, rec):
        tmin, j = torch.where(ok, t, torch.inf).min(dim=1)
        upd = tmin < bt
        bt = torch.where(upd, tmin, bt)
        bi = torch.where(upd, j + s0, bi)
    hit = bi >= 0
    sel = bi[hit]
    best_t[idx] = bt
    # the stored Baldwin–Weber plane normal is the shading normal
    bn[idx[hit]] = rec[sel, 0:3] if rec.shape[1] == 12 else \
        _tri_normal(rec[sel])
    bmat[idx[hit]] = mid[sel]
    return best_t, bn, bmat


def _occluded_plain(s3, l3, tmax, aux, rec, n_lights, n_spheres, n_tris):
    """Any occluder with t < tmax between s and the light (the twin's
    ``_occluded``): scene-box gate, spheres, loose triangles, mesh."""
    inv3 = tuple(1.0 / _fix(c) for c in l3)
    in_box = _slab(s3, inv3, aux[0, :6], _BIG)
    best0 = torch.where(in_box, tmax, -1.0)
    occ = torch.zeros_like(in_box)
    for s in range(n_spheres):
        ok, t = _sphere(s3, l3, aux[1 + n_lights + s])
        occ = occ | (ok & (t < best0))
    for k in range(n_tris):
        r = aux[1 + n_lights + n_spheres + k]
        ok, t = _mt(s3, l3, r[:9])
        occ = occ | (ok & (r[12] > 0.0) & (t < best0))
    idx = torch.nonzero((best0 > 0.0) & ~occ).squeeze(1)
    if idx.numel() and rec.shape[0]:
        s3i = tuple(c[idx] for c in s3)
        l3i = tuple(c[idx] for c in l3)
        tm = best0[idx][:, None]
        hit = torch.zeros_like(idx, dtype=torch.bool)
        for _, ok, t in _slot_chunks(s3i, l3i, rec):
            hit = hit | (ok & (t < tm)).any(dim=1)
        occ[idx] = hit
    return occ & (best0 > 0.0)


def _occluded_min_plain(s3, l3, tmax, aux, rec, n_lights, n_spheres, n_tris):
    """The twin's min-mode shadow query (``:1145-1157``, ``:1209-1211``):
    the nearest occluder below ``best0`` (the light distance, or -1 when
    the lane needs no query or starts outside the scene box) over
    spheres, loose triangles and every mesh leaf slot -> (occluded, st),
    with st = _BIG where not occluded."""
    inv3 = tuple(1.0 / _fix(c) for c in l3)
    in_box = _slab(s3, inv3, aux[0, :6], _BIG)
    best0 = torch.where(in_box, tmax, -1.0)
    best = best0
    for s in range(n_spheres):
        ok, t = _sphere(s3, l3, aux[1 + n_lights + s])
        best = torch.where(ok & (t < best), t, best)
    for k in range(n_tris):
        r = aux[1 + n_lights + n_spheres + k]
        ok, t = _mt(s3, l3, r[:9])
        best = torch.where(ok & (r[12] > 0.0) & (t < best), t, best)
    idx = torch.nonzero(best > 0.0).squeeze(1)
    if idx.numel() and rec.shape[0]:
        s3i = tuple(c[idx] for c in s3)
        l3i = tuple(c[idx] for c in l3)
        bi = best[idx]
        for _, ok, t in _slot_chunks(s3i, l3i, rec):
            tmin = torch.where(ok, t, torch.inf).min(dim=1).values
            bi = torch.where(tmin < bi, tmin, bi)
        best = best.clone()
        best[idx] = bi
    occ = (best < best0) & (best0 > 0.0)
    return occ, torch.where(occ, best, _BIG).to(torch.float32)


def _fork_children(live, hit, depth, max_bounces, o, d, thr, p, bn, m):
    """The reflect and refract children of one fork segment (the twin's
    ``:976-1045``, formula by formula; integer powers written out as the
    products XLA lowers them to): ``(ro, rd, w_refl, tmax_refl, to, td,
    w_refr, tmax_refr)``, dead input lanes passing through with weight 0
    and ``tmax`` -1."""
    dx, dy, dz = d.unbind(-1)
    bnx, bny, bnz = bn.unbind(-1)
    km = m[:, 6:9]
    tp = m[:, 14:17]
    ior, is_die_f, is_mir_f = m[:, 17], m[:, 18], m[:, 13]
    ddn = dx * bnx + dy * bny + dz * bnz
    entering = ddn < 0.0
    ne = bn * torch.where(entering, 1.0, -1.0)[:, None]
    is_die = is_die_f > 0.0
    is_mir = is_mir_f > 0.0
    nr = torch.where(is_die[:, None], ne, bn)
    rddn = dx * nr[:, 0] + dy * nr[:, 1] + dz * nr[:, 2]
    rd = d - 2.0 * nr * rddn[:, None]
    cos_i = ddn.abs()
    n1 = torch.where(entering, 1.0, ior)
    n2v = torch.clamp_min(torch.where(entering, ior, 1.0), 1e-6)
    eta = n1 / n2v
    kq = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = kq < 0.0
    sq = _sqrt(torch.where(tir, 1.0, kq))
    tfac = eta * cos_i - sq
    td = eta[:, None] * d + tfac[:, None] * ne
    q = (n1 - n2v) / (n1 + n2v)
    r0 = q * q
    c = 1.0 - cos_i
    c2 = c * c
    fres = torch.where(tir, 1.0, r0 + (1.0 - r0) * (c * (c2 * c2)))
    hm = hit.to(torch.float32)[:, None]
    w_re = (is_mir_f[:, None] * km
            + is_die_f[:, None] * fres[:, None] * tp) * hm
    refr_ok = hit & is_die & ~tir
    w_tr = (is_die_f[:, None] * (1.0 - fres)[:, None] * tp
            * refr_ok.to(torch.float32)[:, None])
    can = live & (depth < max_bounces)
    refl_live = can & hit & (is_mir | is_die)
    refr_live = can & refr_ok
    z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=o.device)
    lv = live[:, None]
    tm = lambda x: torch.where(x, _BIG, -1.0).to(torch.float32)
    return (torch.where(lv, p + nr * SHADOW_EPS, o),
            torch.where(lv, torch.where(hit[:, None], rd, z), d),
            torch.where(lv, thr * w_re, 0.0), tm(refl_live),
            torch.where(lv, p - ne * SHADOW_EPS, o),
            torch.where(lv, torch.where(refr_ok[:, None], td, z), d),
            torch.where(lv, thr * w_tr, 0.0), tm(refr_live))


def trace_segment_plain(packed: PackedBVH | None, aux: torch.Tensor,
                        depth: int, o: torch.Tensor, d: torch.Tensor,
                        thr: torch.Tensor, tmax: torch.Tensor, *,
                        n_lights: int, n_spheres: int, n_tris: int,
                        max_bounces: int, light_cull: float = 0.0,
                        record: bool = False, record_soft: bool = False,
                        fork: bool = False, has_mesh: bool = True,
                        tri_isect: str = "bw", use_wide: bool | None = None,
                        overflow=None):
    """Plain PyTorch version of one fused segment (same signature and
    outputs as ``trace_segment``; ``overflow`` is unused: no stack). The
    layout changes nothing here: it walks no tree."""
    del overflow
    record = record or record_soft
    if fork and record:
        raise ValueError("fork mode is forward-only (no hit records)")
    segment_route(packed, tri_isect, use_wide, has_mesh)
    L, S, T = n_lights, n_spheres, n_tris
    n_mats = aux.shape[0] - (1 + L + S + T)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    o3, d3 = (ox, oy, oz), (dx, dy, dz)
    live = tmax >= 0.0
    inv3 = tuple(1.0 / _fix(c) for c in d3)
    rec, mid = _leaf_slots(packed if has_mesh else None, tri_isect)
    rec, mid = rec.to(o.device), mid.to(o.device)

    # ---- nearest hit: mesh, then spheres, then loose triangles ----------
    best_t, bn, bmat = _nearest_mesh_plain(o3, d3, rec, mid, live)
    bnx, bny, bnz = bn.unbind(-1)
    for s in range(S):
        r = aux[1 + L + s]
        ok, ts = _sphere(o3, d3, r)
        upd = ok & (best_t > ts)
        rinv = _rsqrt(torch.clamp_min(r[3], _MIN_SQ))
        px = ox + dx * ts - r[0]
        py = oy + dy * ts - r[1]
        pz = oz + dz * ts - r[2]
        best_t = torch.where(upd, ts, best_t)
        bnx = torch.where(upd, px * rinv, bnx)
        bny = torch.where(upd, py * rinv, bny)
        bnz = torch.where(upd, pz * rinv, bnz)
        bmat = torch.where(upd, r[5], bmat)
    for k in range(T):
        r = aux[1 + L + S + k]
        ok, tt = _mt(o3, d3, r[:9])
        upd = ok & (r[12] > 0.0) & (best_t > tt)
        best_t = torch.where(upd, tt, best_t)
        bnx = torch.where(upd, r[9], bnx)
        bny = torch.where(upd, r[10], bny)
        bnz = torch.where(upd, r[11], bnz)
        bmat = torch.where(upd, r[13], bmat)

    in_box = _slab(o3, inv3, aux[0, :6], _BIG)
    hit = live & in_box & (best_t < _BIG) & (best_t >= 0.0)

    # ---- material: diffuse ambient mirror specular phong is_mirror, and
    #      for the fork transparency ior is_dielectric ---------------------
    mi = bmat.to(torch.int64)
    has_mat = (bmat >= 0.0) & (mi < n_mats) & (mi.to(bmat.dtype) == bmat)
    mrows = aux[1 + L + S + T + mi.clamp(0, max(n_mats - 1, 0)),
                :19 if fork else 14]
    mrows = torch.where(has_mat[:, None], mrows, 0.0)
    (kd_r, kd_g, kd_b, ka_r, ka_g, ka_b, km_r, km_g, km_b,
     ks_r, ks_g, ks_b, phong, is_mir) = mrows[:, :14].unbind(-1)

    t_safe = torch.where(hit, best_t, 1.0)
    px = ox + dx * t_safe
    py = oy + dy * t_safe
    pz = oz + dz * t_safe

    # ---- direct lighting ---------------------------------------------------
    col_r = ka_r * aux[0, 6]
    col_g = ka_g * aux[0, 7]
    col_b = ka_b * aux[0, 8]
    s3 = (px + bnx * SHADOW_EPS, py + bny * SHADOW_EPS,
          pz + bnz * SHADOW_EPS)
    kdks = (torch.maximum(torch.maximum(kd_r, kd_g), kd_b)
            + torch.maximum(torch.maximum(ks_r, ks_g), ks_b))
    occbits = torch.zeros_like(best_t)
    sts = []
    for l in range(L):
        r = aux[1 + l]
        ir_, ig_, ib_ = r[3], r[4], r[5]
        lvx, lvy, lvz = r[0] - px, r[1] - py, r[2] - pz
        ld2 = lvx * lvx + lvy * lvy + lvz * lvz
        ldist = _sqrt(ld2)
        linv = _rsqrt(torch.clamp_min(ld2, _MIN_SQ))
        ldx, ldy, ldz = lvx * linv, lvy * linv, lvz * linv
        ln = ldx * bnx + ldy * bny + ldz * bnz
        need = hit & (ln >= 0.0) & (r[6] > 0.0)
        if light_cull > 0.0:
            imax = torch.maximum(torch.maximum(ir_, ig_), ib_)
            need = need & (kdks * imax >= light_cull * ld2)
        query = (s3, (ldx, ldy, ldz), torch.where(need, ldist, -1.0), aux,
                 rec, L, S, T)
        if record_soft:
            occ, st = _occluded_min_plain(*query)
            sts.append(st)
        else:
            occ = _occluded_plain(*query)
        occbits = occbits + occ.to(torch.float32) * float(1 << l)
        irr = 1.0 / torch.clamp_min(ld2, _MIN_SQ)
        w = torch.where(need & ~occ, irr, 0.0)
        dterm = torch.clamp_min(ln, 0.0) * w
        col_r = col_r + kd_r * dterm * ir_
        col_g = col_g + kd_g * dterm * ig_
        col_b = col_b + kd_b * dterm * ib_
        hx, hy, hz = ldx - dx, ldy - dy, ldz - dz
        hinv = _rsqrt(torch.clamp_min(hx * hx + hy * hy + hz * hz, _MIN_SQ))
        nh = torch.clamp_min(bnx * hx * hinv + bny * hy * hinv
                             + bnz * hz * hinv, 0.0)
        sterm = torch.where(
            nh > 0.0,
            torch.exp(phong * torch.log(torch.clamp_min(nh, _TINY))),
            0.0) * w
        col_r = col_r + ks_r * sterm * ir_
        col_g = col_g + ks_g * sterm * ig_
        col_b = col_b + ks_b * sterm * ib_

    out = torch.stack([torch.where(hit, col_r, aux[0, 9]),
                       torch.where(hit, col_g, aux[0, 10]),
                       torch.where(hit, col_b, aux[0, 11])], dim=-1)
    delta = torch.where(live[:, None], thr * out, 0.0)
    bn = torch.stack([bnx, bny, bnz], dim=-1)
    p = torch.stack([px, py, pz], dim=-1)
    if fork:
        return (delta,) + _fork_children(live, hit, depth, max_bounces, o,
                                         d, thr, p, bn, mrows)

    # ---- mirror continuation ----------------------------------------------
    cont = hit & (is_mir > 0.0) & (depth < max_bounces)
    ddn = dx * bnx + dy * bny + dz * bnz
    rd = d - 2.0 * bn * ddn[:, None]
    km = torch.stack([km_r, km_g, km_b], dim=-1)
    c1 = cont[:, None]
    o2 = torch.where(live[:, None], p + bn * SHADOW_EPS, o)
    d2 = torch.where(c1, rd, d)
    thr2 = torch.where(c1, thr * km, thr)
    tmax2 = torch.where(cont, _BIG, -1.0).to(torch.float32)
    base = (delta, o2, d2, thr2, tmax2)
    if not record:
        return base
    # hit records (twin :958-974); a dead lane keeps the defaults of
    # :528-536 because it never hits and never queries a light
    rec_out = (torch.where(hit, best_t, -1.0), bn,
               torch.where(hit, bmat, -1.0), occbits)
    if record_soft:
        rec_out += (torch.stack(sts, dim=-1) if L else
                    torch.zeros((o.shape[0], 0), dtype=torch.float32,
                                device=o.device),)
    return base + (rec_out,)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _record_buffers(out, n, n_lights, soft, device):
    """The record outputs: ``out`` checked, or new tensors."""
    shapes = [(n,), (n, 3), (n,), (n,)] + ([(n, n_lights)] if soft else [])
    if out is None:
        return tuple(torch.empty(s, dtype=torch.float32, device=device)
                     for s in shapes)
    out = tuple(out)
    if len(out) != len(shapes) or any(
            t.shape != s or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous() for t, s in zip(out, shapes)):
        raise ValueError(f"trace_segment: out must be contiguous float32 "
                         f"tensors on {device} shaped {shapes}")
    return out


def _tables(packed: PackedBVH | None, route: str):
    """(node table, leaf table) the route's kernel reads: the walk rows of
    the wide or binary layout (``traverse_mk3.walk_table``: the boxes
    widened), and ``tris_bw`` or ``tris``; none when meshless."""
    if route == "meshless":
        return None, None
    leaf = packed.tris_bw if route.startswith("bw") else packed.tris
    return walk_table(packed, route.split("/")[-1]), leaf


def trace_segment(packed: PackedBVH | None, aux: torch.Tensor, depth: int,
                  o: torch.Tensor, d: torch.Tensor, thr: torch.Tensor,
                  tmax: torch.Tensor, *, n_lights: int, n_spheres: int,
                  n_tris: int, max_bounces: int, light_cull: float = 0.0,
                  record: bool = False, record_soft: bool = False,
                  fork: bool = False, has_mesh: bool = True,
                  tri_isect: str = "bw", use_wide: bool | None = None,
                  overflow: torch.Tensor | None = None, out=None,
                  counts: torch.Tensor | None = None):
    """One fused bounce segment over all rays (module docstring).

    CUDA tensors launch ``csrc/mega_segment.cu``; CPU tensors run
    ``trace_segment_plain``. ``record_soft`` implies ``record``; ``fork``
    excludes both. ``tri_isect`` ('bw' | 'mt') and ``use_wide`` pick the
    leaf test and layout (``segment_route``); ``has_mesh=False`` runs the
    meshless instance, which walks nothing. ``overflow`` is an int32 [1]
    device counter of dropped stack pushes shared by several launches; the
    caller checks it (``check_overflow``) once they are done. Without one,
    the wrapper makes its own and checks it after this launch.
    ``check_stack`` raises before the launch for a tree whose worst push
    depth on the route's layout (``PackedBVH.stack_wide`` or
    ``stack_binary``) exceeds the kernel's stack.

    ``out`` (record modes): the tensors to write the records into, in the
    order of the record tuple — e.g. one segment's rows of ``[B, N, ...]``
    buffers (``ops/replay.trace_records``); they are returned as the
    record tuple. ``counts`` (CUDA only, for measurement): an int64
    ``[len(COUNTS)]`` device tensor; the launch then runs the route's
    counting instance (only the instances ``chip_smoke.py`` reads have
    one), which adds its tallies (``COUNTS``: the slab tests,
    Baldwin–Weber leaf-slot tests, sphere tests and Möller–Trumbore tests
    it made, then their split by phase).
    """
    record = record or record_soft
    if fork and record:
        raise ValueError("fork mode is forward-only (no hit records)")
    route = segment_route(packed, tri_isect, use_wide, has_mesh)
    if record and n_lights > MAX_RECORD_LIGHTS:
        # twin :1350-1356: the bits are a float32 sum of 2^l, exact only
        # up to 2^24
        raise ValueError(
            f"record=True packs per-light occlusion bits into one f32 "
            f"(exact only for <= {MAX_RECORD_LIGHTS} lights); got "
            f"n_lights={n_lights}")
    if out is not None and not record:
        raise ValueError("trace_segment: out is for the record modes")
    mode = ("fork" if fork else "record_soft" if record_soft
            else "record" if record else "forward")
    kw = dict(n_lights=n_lights, n_spheres=n_spheres, n_tris=n_tris,
              max_bounces=max_bounces, light_cull=light_cull,
              has_mesh=has_mesh, tri_isect=tri_isect, use_wide=use_wide)
    if o.device.type == "cpu":
        if counts is not None:
            raise ValueError("trace_segment: counts needs the CUDA kernel")
        res = trace_segment_plain(packed, aux, depth, o, d, thr, tmax,
                                  record=record, record_soft=record_soft,
                                  fork=fork, **kw)
        if out is not None:
            out = _record_buffers(out, o.shape[0], n_lights, record_soft,
                                  o.device)
            for dst, src in zip(out, res[5]):
                dst.copy_(src)
            res = res[:5] + (out,)
        return res
    if o.device.type != "cuda":
        raise ValueError(f"trace_segment: unsupported device {o.device}")

    n = o.shape[0]
    table, leaf = _tables(packed, route)
    layout = route.split("/")[-1]
    if route != "meshless" and (
            packed.rows_per_leaf * PALLAS_LEAF > 255
            or packed.tris.shape[0] >= (1 << 23)):
        raise ValueError("leaf too wide or too many leaf rows for the "
                         "kernel's stack-entry encoding")
    if layout not in _LAYOUT:
        raise NotImplementedError(
            f"the CUDA kernel has instances for BVH arity 4 and 8 and the "
            f"binary layout, not {route}")
    if route != "meshless" and packed.leafbox is None:
        raise ValueError("trace_segment: PackedBVH.leafbox missing — build "
                         "the BVH with pack_rows / prepare_bvh")
    # the tables are read 16 bytes at a time
    tables = dict(aux=aux) if route == "meshless" else dict(
        aux=aux, table=table, leaf=leaf, leafmeta=packed.leafmeta,
        leafbox=packed.leafbox)
    for name, t in dict(o=o, d=d, thr=thr, tmax=tmax, **tables).items():
        if t.device != o.device or t.dtype != torch.float32 \
                or not t.is_contiguous() \
                or (name in tables and t.data_ptr() % 16):
            raise ValueError(f"trace_segment: {name} must be a contiguous "
                             f"float32 tensor on {o.device} (16-byte "
                             f"aligned for the tables)")
    if o.shape != (n, 3) or d.shape != (n, 3) or thr.shape != (n, 3) \
            or tmax.shape != (n,) or aux.shape[1] != 128 \
            or (leaf is not None and leaf.shape[1] != 128) \
            or (leaf is not None and packed.leafbox.shape
                != (packed.tris.shape[0], 16)) \
            or (route == "mt/binary" and table.shape[1] != 16):
        raise ValueError("trace_segment: bad ray, table or aux shapes")
    if layout == "binary":
        check_stack(packed.stack_binary, STACK_BINARY,
                    f"trace_segment on {route}")
    elif route != "meshless":
        check_stack(packed.stack_wide, _WIDE_STACK,
                    f"trace_segment on {route}")
    if counts is not None and (counts.shape != (len(COUNTS),) or
                               counts.dtype != torch.int64 or
                               counts.device != o.device):
        raise ValueError(f"trace_segment: counts must be an int64 "
                         f"[{len(COUNTS)}] tensor on {o.device}")

    return _launch(packed, aux, depth, o, d, thr, tmax, route, mode,
                   n_lights, n_spheres, n_tris, max_bounces, light_cull,
                   overflow, out, counts,
                   torch.cuda.current_stream(o.device).cuda_stream)


def _launch(packed, aux, depth, o, d, thr, tmax, route, mode, n_lights,
            n_spheres, n_tris, max_bounces, light_cull, overflow, out,
            counts, stream):
    """Allocate the outputs and launch the route's instance on ``stream``
    (inputs checked by ``trace_segment``)."""
    n = o.shape[0]
    table, leaf = _tables(packed, route)
    layout = route.split("/")[-1]
    record, fork = mode in ("record", "record_soft"), mode == "fork"
    own_counter = overflow is None
    if own_counter:
        overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
    delta = torch.empty_like(o)
    o2 = torch.empty_like(o)
    d2 = torch.empty_like(o)
    thr2 = torch.empty_like(o)
    tmax2 = torch.empty_like(tmax)
    rec = (_record_buffers(out, n, n_lights, mode == "record_soft",
                           o.device) if record else ())
    kids = ((torch.empty_like(o), torch.empty_like(o), torch.empty_like(o),
             torch.empty_like(tmax)) if fork else ())
    if n:
        n_mats = aux.shape[0] - (1 + n_lights + n_spheres + n_tris)
        ptr = lambda xs, i: xs[i].data_ptr() if i < len(xs) else None
        tptr = lambda t: None if t is None else t.data_ptr()
        meshed = route != "meshless"
        err = _lib.mega_lib(_LIBRARY[layout]).urt_mega_segment(
            o.data_ptr(), d.data_ptr(), thr.data_ptr(), tmax.data_ptr(),
            n, int(depth), tptr(table), _LAYOUT[layout],
            int(not route.startswith("bw")), tptr(leaf),
            tptr(packed.leafbox) if meshed else None,
            packed.rows_per_leaf if meshed else 1,
            packed.bw_rows_per_leaf if meshed else 0,
            tptr(packed.leafmeta) if meshed else None,
            packed.leafmeta.shape[1] if meshed else 0,
            aux.data_ptr(), n_lights, n_spheres, n_tris, n_mats,
            max_bounces, float(light_cull), delta.data_ptr(),
            o2.data_ptr(), d2.data_ptr(), thr2.data_ptr(), tmax2.data_ptr(),
            overflow.data_ptr(), MODES.index(mode), ptr(rec, 0),
            ptr(rec, 1), ptr(rec, 2), ptr(rec, 3), ptr(rec, 4),
            ptr(kids, 0), ptr(kids, 1), ptr(kids, 2), ptr(kids, 3),
            tptr(counts), stream)
        if err:
            raise RuntimeError(
                f"urt_mega_segment launch failed ({mode} on {route}"
                f"{', counting' if counts is not None else ''}): CUDA error "
                f"{err} (1 = no such instance)")
        launches[mode] += 1
        route_launches[mode, route] += 1
    if own_counter:
        check_overflow(overflow)
    base = (delta, o2, d2, thr2, tmax2)
    if fork:
        return base + kids
    return base + (rec,) if record else base
