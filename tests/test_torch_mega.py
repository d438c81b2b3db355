"""PyTorch port: one fused bounce segment against the JAX megakernel.

``trace_segment_plain`` (brute force over every leaf slot, no BVH walk)
is held against the JAX ``trace_segment`` run in the Pallas interpreter
on the same packed arrays, converted with ``packed_from_arrays``, on a
seeded numpy ray batch with dead lanes — in the forward mode and in the
record modes, whose hit records are compared with
``torch_parity.record_bad_lanes`` (matid and occbits exactly) — on the
Baldwin–Weber BVH4 route and on the two routes of mode (e): the
Möller–Trumbore leaf test on BVH4 rows and on the binary layout
(``bvh_arity=0``). Tolerance
rtol = atol = 5e-4 on the 0-255 outputs — the one tests/test_mega.py:211
holds the JAX 'bw' kernel to. A continuing lane must continue on both sides; its ray state
is compared where it continues. Where a lane does not continue, the two
sides write different (unused) values by design.
"""

import numpy as np
import pytest
import torch

from torch_parity import (BIG, LAYOUTS, cuda, record_bad_lanes,
                          segment_rays, small_scene)
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.convert import packed_from_arrays
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-4)
MAX_BOUNCES = 2
CFG = RenderConfig(max_bounces=MAX_BOUNCES,
                   background=(0.04, 0.05, 0.07), use_bvh=True,
                   mode="scan", bvh_leaf=14, tri_isect="bw",
                   fuse_shadows=False)
N_RAYS = 256


def _kw(scene, light_cull):
    return dict(n_lights=scene.lights.positions.shape[0],
                n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
                max_bounces=MAX_BOUNCES, light_cull=light_cull)


@pytest.fixture(scope="module")
def port_side():
    scene = small_scene(t_scene, t_meshgen, device="cpu")
    return scene, t_bvh.prepare_bvh(scene, CFG), mega.build_aux(
        scene, CFG.background)


@pytest.fixture(scope="module")
def port_layouts(port_side):
    """{layout: (scene, packed, aux, leaf-test and layout kwargs)}."""
    scene, _, aux = port_side
    return {k: (scene, t_bvh.prepare_bvh(scene, CFG.with_(bvh_arity=v[
        "bvh_arity"])), aux, dict(tri_isect=v["tri_isect"]))
        for k, v in LAYOUTS.items()}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(got, want, note=""):
    delta, o2, d2, thr2, tm2 = (_np(x) for x in want)
    g = [_np(x) for x in got]
    np.testing.assert_allclose(g[0], delta, err_msg="delta" + note, **TOL)
    np.testing.assert_array_equal(g[4] >= 0, tm2 >= 0,
                                  err_msg="continuation" + note)
    np.testing.assert_array_equal(g[4], tm2)
    cont = tm2 >= 0
    for k, (a, b) in enumerate(zip(g[1:4], (o2, d2, thr2))):
        np.testing.assert_allclose(a[cont], b[cont], err_msg=f"ray {k}" + note,
                                   **TOL)


@pytest.mark.parametrize(
    "depth,light_cull,layout",
    [(0, 0.0, "bw4"), (MAX_BOUNCES, 2.0, "bw4"), (0, 0.0, "mt4"),
     (MAX_BOUNCES, 2.0, "mt4"), (0, 0.0, "binary"),
     (MAX_BOUNCES, 2.0, "binary")],
    ids=["0-0.0", "2-2.0", "0-0.0-mt4", "2-2.0-mt4", "0-0.0-binary",
         "2-2.0-binary"])
def test_plain_matches_jax_segment(depth, light_cull, layout):
    """Mode (a) on each route: the JAX kernel in the interpreter walks the
    route's layout with its leaf test; the plain version tests every leaf
    slot of ``tris_bw`` ('bw') or ``tris`` ('mt')."""
    import jax
    import jax.numpy as jnp
    from unity_raytracer_tpu.models import meshgen, scene as j_scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.pallas import mega as j_mega

    lay = LAYOUTS[layout]
    js = small_scene(j_scene, meshgen)
    jp = j_bvh.prepare_bvh(js, CFG.with_(kernel="mega", **lay))
    jaux = j_mega.build_aux(js, CFG.background)
    o, d, thr, tmax = segment_rays(N_RAYS, seed=10 + depth)
    want = j_mega.trace_segment(
        jp, jaux, depth, jnp.asarray(o), jnp.asarray(d), jnp.asarray(thr),
        jnp.asarray(tmax), interpret=True, tile_r=N_RAYS,
        use_wide=lay["bvh_arity"] != 0, fuse_shadows=False,
        tri_isect=lay["tri_isect"], occ_mode="pack", stale_prune=False,
        **_kw(js, light_cull))

    packed = packed_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    assert (packed.wide is None) == (lay["bvh_arity"] == 0)
    aux = torch.from_numpy(np.array(jaux))
    got = mega.trace_segment_plain(
        packed, aux, depth, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(thr), torch.from_numpy(tmax),
        tri_isect=lay["tri_isect"], **_kw(js, light_cull))
    _check(got, want)
    delta = got[0].numpy()
    # the batch must exercise hits, misses, shadows and dead lanes
    assert (delta[tmax < 0] == 0).all()
    assert delta[tmax >= 0].std() > 1.0
    if depth < MAX_BOUNCES:
        assert (got[4].numpy() >= 0).sum() > 5   # mirror continuations
    else:
        assert (got[4].numpy() < 0).all()        # depth cap: none


def test_wrapper_routes_cpu_to_plain(port_side):
    scene, packed, aux = port_side
    o, d, thr, tmax = (torch.from_numpy(x) for x in segment_rays(64, 5))
    before = dict(mega.launches)
    a = mega.trace_segment(packed, aux, 1, o, d, thr, tmax,
                           **_kw(scene, 0.0))
    b = mega.trace_segment_plain(packed, aux, 1, o, d, thr, tmax,
                                 **_kw(scene, 0.0))
    assert mega.launches == before  # CPU tensors launch nothing
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_dead_lanes_pass_through(port_side):
    scene, packed, aux = port_side
    o, d, thr, tmax = (torch.from_numpy(x)
                       for x in segment_rays(32, 6, dead_every=1))
    delta, o2, d2, thr2, tm2 = mega.trace_segment_plain(
        packed, aux, 0, o, d, thr, tmax, **_kw(scene, 0.0))
    assert (delta == 0).all() and (tm2 == -1).all()
    assert torch.equal(o2, o) and torch.equal(d2, d) \
        and torch.equal(thr2, thr)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "depth,light_cull,layout",
    [(0, 0.0, "bw4"), (MAX_BOUNCES, 2.0, "bw4"), (0, 0.0, "mt4"),
     (MAX_BOUNCES, 2.0, "mt4"), (0, 0.0, "binary"),
     (MAX_BOUNCES, 2.0, "binary")],
    ids=["0-0.0", "2-2.0", "0-0.0-mt4", "2-2.0-mt4", "0-0.0-binary",
         "2-2.0-binary"])
def test_kernel_matches_plain_on_card(cuda, port_layouts, depth, light_cull,
                                      layout):
    scene, packed, aux, lay = port_layouts[layout]
    packed, aux = packed.to(cuda), aux.to(cuda)
    rays = [torch.from_numpy(x).to(cuda)
            for x in segment_rays(4096, 20 + depth)]
    kw = dict(_kw(scene, light_cull), **lay)
    route = mega.segment_route(packed, lay["tri_isect"])
    before = mega.route_launches["forward", route]
    got = mega.trace_segment(packed, aux, depth, *rays, **kw)
    torch.cuda.synchronize()
    assert mega.route_launches["forward", route] == before + 1
    want = mega.trace_segment_plain(packed, aux, depth, *rays, **kw)
    # FMA contraction on the card can flip a silhouette-edge hit: allow
    # one lane of the 4096 (the chip smoke allows 0.01% of a frame)
    g, w = [_np(x) for x in got], [_np(x) for x in want]
    cont = w[4] >= 0
    bad = ~np.isclose(g[0], w[0], **TOL).all(-1) | ((g[4] >= 0) != cont)
    for a, b in zip(g[1:4], w[1:4]):
        bad |= cont & ~np.isclose(a, b, **TOL).all(-1)
    assert bad.sum() <= 1, np.nonzero(bad)


def _jax_segment(depth, light_cull, soft, seed=None, layout="bw4"):
    import jax.numpy as jnp
    from unity_raytracer_tpu.models import meshgen, scene as j_scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.pallas import mega as j_mega

    lay = LAYOUTS[layout]
    js = small_scene(j_scene, meshgen)
    jp = j_bvh.prepare_bvh(js, CFG.with_(kernel="mega", **lay))
    jaux = j_mega.build_aux(js, CFG.background)
    rays = segment_rays(N_RAYS, seed=10 + depth if seed is None else seed)
    want = j_mega.trace_segment(
        jp, jaux, depth, *(jnp.asarray(x) for x in rays), interpret=True,
        tile_r=N_RAYS, use_wide=lay["bvh_arity"] != 0, fuse_shadows=False,
        tri_isect=lay["tri_isect"], occ_mode="pack", stale_prune=False,
        record=True, record_soft=soft, **_kw(js, light_cull))
    return rays, want


@pytest.mark.parametrize(
    "depth,light_cull,soft,layout",
    [(0, 0.0, False, "bw4"), (0, 0.0, True, "bw4"),
     (MAX_BOUNCES, 2.0, False, "bw4"), (MAX_BOUNCES, 2.0, True, "bw4"),
     (0, 0.0, False, "mt4"), (MAX_BOUNCES, 2.0, True, "mt4"),
     (MAX_BOUNCES, 2.0, False, "binary"), (0, 0.0, True, "binary")],
    ids=["0-0.0-False", "0-0.0-True", "2-2.0-False", "2-2.0-True",
         "0-0.0-False-mt4", "2-2.0-True-mt4", "2-2.0-False-binary",
         "0-0.0-True-binary"])
def test_plain_records_match_jax_segment(port_layouts, depth, light_cull,
                                         soft, layout):
    """Modes (b) record and (d) record_soft: the plain version's base
    outputs and hit records against the JAX kernel in the interpreter,
    on a batch with dead lanes, with and without the light_cull gate, on
    the Baldwin–Weber BVH4 route and the two routes of mode (e)."""
    rays, want = _jax_segment(depth, light_cull, soft, layout=layout)
    scene, packed, aux, lay = port_layouts[layout]
    got = mega.trace_segment_plain(
        packed, aux, depth, *(torch.from_numpy(x) for x in rays),
        record=not soft, record_soft=soft, **lay, **_kw(scene, light_cull))
    _check(got[:5], want[:5])
    assert len(got[5]) == len(want[5]) == (5 if soft else 4)
    bad = record_bad_lanes(got[5], want[5])
    assert not bad.any(), np.nonzero(bad)
    t, n, matid, occ = (x.numpy() for x in got[5][:4])
    dead = rays[3] < 0
    # dead lanes record exactly the defaults; the batch has hits of
    # every kind and occluded lights
    assert (t[dead] == -1).all() and (n[dead] == 0).all()
    assert (matid[dead] == -1).all() and (occ[dead] == 0).all()
    assert (matid >= 0).sum() > 20 and (occ > 0).sum() > 5
    if soft:
        st = got[5][4].numpy()
        assert (st[dead] == BIG).all() and (st < BIG).sum() > 5
        # st is below the light exactly where the bit is set
        bits = (occ[:, None].astype(np.int64) >> np.arange(2)) & 1
        np.testing.assert_array_equal(st < BIG, bits > 0)


def _sphere_t_np(o, d, sphere, fused):
    """The segment's sphere root (twin mega.py:778-785) in numpy float32:
    every operation rounded on its own, or with the multiply-adds of
    ``uoc``, ``|oc|^2`` and the discriminant fused (a float32 product is
    exact in float64, so one float64 add and one rounding give the fused
    result)."""
    f32 = np.float32
    fma = lambda a, b, c: (a.astype(np.float64) * b + c).astype(f32)
    oc = o - sphere[:3]
    if fused:
        uoc = fma(d[:, 2], oc[:, 2], fma(d[:, 1], oc[:, 1], d[:, 0] * oc[:, 0]))
        oc2 = fma(oc[:, 2], oc[:, 2],
                  fma(oc[:, 1], oc[:, 1], oc[:, 0] * oc[:, 0]))
        disc = fma(uoc, uoc, -(oc2 - sphere[3]))
    else:
        uoc = d[:, 0] * oc[:, 0] + d[:, 1] * oc[:, 1] + d[:, 2] * oc[:, 2]
        oc2 = oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2]
        disc = uoc * uoc - (oc2 - sphere[3])
    sq = np.sqrt(np.maximum(disc, f32(0.0)))
    return np.where(-uoc - sq < 0, -uoc + sq, -uoc - sq)


@pytest.mark.parametrize("seed", [41])
def test_plain_vs_jax_differ_only_by_fma(port_side, seed):
    """At this seed 2 of 256 lanes of delta differ from the JAX
    interpreter by up to 8.6e-4 relative. Each such lane hits the mirror
    sphere (phong 200) near grazing, where the root of its quadratic
    loses digits, and the two sides round it differently: the plain
    version (like the kernel, built with -fmad=false) rounds every
    float32 operation, XLA on the CPU fuses the multiply-adds. Both
    sides' t are reproduced exactly in numpy; every other lane agrees
    within TOL."""
    rays, want = _jax_segment(0, 0.0, False, seed=seed)
    scene, packed, aux = port_side
    got = mega.trace_segment_plain(packed, aux, 0,
                                   *(torch.from_numpy(x) for x in rays),
                                   record=True, **_kw(scene, 0.0))
    g, w = _np(got[0]), _np(want[0])
    bad = ~np.isclose(g, w, **TOL).all(-1)
    keep = torch.from_numpy(~bad)
    _check([x[keep] for x in got[:5]], [_np(x)[~bad] for x in want[:5]])
    sphere = _np(aux[1 + scene.lights.positions.shape[0]])
    t_plain, t_jax = _np(got[5][0]), _np(want[5][0])
    hit = (_np(got[5][2]) == 0) & (_np(want[5][2]) == 0)  # sphere = mat 0
    np.testing.assert_array_equal(
        t_plain[hit], _sphere_t_np(*rays[:2], sphere, False)[hit])
    lanes = np.nonzero(bad)[0]
    assert hit[lanes].all(), lanes
    np.testing.assert_array_equal(
        t_jax[lanes], _sphere_t_np(*rays[:2], sphere, True)[lanes])
    assert (t_jax[lanes] != t_plain[lanes]).all()
    # neither side is wrong: both lie within float32's reach of the root
    # computed in float64 from the same inputs
    o64, d64 = (x[lanes].astype(np.float64) for x in rays[:2])
    oc = o64 - sphere[:3].astype(np.float64)
    uoc = (d64 * oc).sum(-1)
    t64 = -uoc - np.sqrt(uoc * uoc - ((oc * oc).sum(-1) - sphere[3]))
    for t in (t_plain, t_jax):
        np.testing.assert_allclose(t[lanes], t64, rtol=1e-5)


def test_record_modes_keep_forward_outputs(port_side):
    """Recording changes no base output: the plain version's delta and
    continuation are bitwise those of mode (a) in modes (b) and (d)."""
    scene, packed, aux = port_side
    rays = [torch.from_numpy(x) for x in segment_rays(128, 7)]
    base = mega.trace_segment_plain(packed, aux, 0, *rays,
                                    **_kw(scene, 0.0))
    for kw in (dict(record=True), dict(record_soft=True)):
        got = mega.trace_segment_plain(packed, aux, 0, *rays, **kw,
                                       **_kw(scene, 0.0))
        for a, b in zip(got[:5], base):
            assert torch.equal(a, b)


def test_records_written_into_out(port_side):
    """``out=`` rows of [B, N, ...] buffers receive the records and come
    back as the record tuple."""
    scene, packed, aux = port_side
    rays = [torch.from_numpy(x) for x in segment_rays(64, 8)]
    bufs = (torch.zeros(3, 64), torch.zeros(3, 64, 3), torch.zeros(3, 64),
            torch.zeros(3, 64), torch.zeros(3, 64, 2))
    out = tuple(b[1] for b in bufs)
    got = mega.trace_segment(packed, aux, 0, *rays, record_soft=True,
                             out=out, **_kw(scene, 0.0))
    want = mega.trace_segment_plain(packed, aux, 0, *rays,
                                    record_soft=True, **_kw(scene, 0.0))
    for g, o, w, b in zip(got[5], out, want[5], bufs):
        assert g is o and torch.equal(g, w)
        assert (b[0] == 0).all() and (b[2] == 0).all()
    with pytest.raises(ValueError, match="out"):
        mega.trace_segment(packed, aux, 0, *rays, record=True,
                           out=out[:3], **_kw(scene, 0.0))


def test_record_light_guard_raises(port_side):
    """Occlusion bits are a float32 sum of 2^l: more than 24 lights
    cannot be recorded (twin mega.py:1350-1356)."""
    scene, packed, aux = port_side
    rays = [torch.from_numpy(x) for x in segment_rays(8, 9)]
    kw = _kw(scene, 0.0)
    kw["n_lights"] = 25
    for mode in (dict(record=True), dict(record_soft=True)):
        with pytest.raises(ValueError, match="24 lights"):
            mega.trace_segment(packed, aux, 0, *rays, **mode, **kw)


def test_ptxas_entries_parse():
    """The ptxas report reads each entry's stack and spill from its own
    properties block and its registers from its Used line, past the
    blocks of called functions."""
    from unity_raytracer_tpu_torch.ops.kernels.ptxas import entries
    k4, k8 = "_Z1kILi4EEv4Args", "_Z1kILi8EEv4Args"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{k4}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k4}",
        "    2104 bytes stack frame, 48 bytes spill stores, 48 bytes spill "
        "loads",
        "ptxas info    : Function properties for _Z6helperv",
        "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, 528 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{k8}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k8}",
        "    2088 bytes stack frame, 32 bytes spill stores, 32 bytes spill "
        "loads",
        "ptxas info    : Used 72 registers, 528 bytes cmem[0]"])
    assert entries(log) == {k4: dict(registers=64, stack=2104, spill=48),
                            k8: dict(registers=72, stack=2088, spill=32)}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bw4", "mt4", "binary"])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("depth,light_cull", [(0, 0.0), (MAX_BOUNCES, 2.0)])
def test_record_kernels_match_plain_on_card(cuda, port_layouts, depth,
                                            light_cull, soft, layout):
    scene, packed, aux, lay = port_layouts[layout]
    packed, aux = packed.to(cuda), aux.to(cuda)
    rays = [torch.from_numpy(x).to(cuda)
            for x in segment_rays(4096, 50 + depth)]
    kw = dict(_kw(scene, light_cull), **lay)
    mode = "record_soft" if soft else "record"
    before = mega.launches[mode]
    got = mega.trace_segment(packed, aux, depth, *rays, record=True,
                             record_soft=soft, **kw)
    fwd = mega.trace_segment(packed, aux, depth, *rays, **kw)
    torch.cuda.synchronize()
    assert mega.launches[mode] == before + 1
    for a, b in zip(got[:5], fwd):  # recording changes no base output
        assert torch.equal(a, b)
    want = mega.trace_segment_plain(packed, aux, depth, *rays, record=True,
                                    record_soft=soft, **kw)
    bad = record_bad_lanes(got[5], want[5])
    assert bad.sum() <= 1, np.nonzero(bad)  # the chip smoke's 0.01% gate
