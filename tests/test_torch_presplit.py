"""PyTorch port: the numpy reference builder and SBVH presplitting against the JAX package.

The port's ``build(backend='numpy')`` must give the twin's arrays exactly;
with ``presplit`` the tree is the twin's and a box differs only where the
port rounds a clipped reference box outward (ROADMAP Queue C #3): there
it is the twin's value moved one ulp outward. Presplit trees keep every
hit of the brute force, ``prepare_bvh`` packs them as the twin does, and
a presplit frame equals the unsplit one.
"""

import numpy as np
import pytest
import torch

from torch_parity import CAMERA, cuda, small_scene
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.camera import Camera
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import intersect as t_isect
from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3
from unity_raytracer_tpu_torch.ops.render import render
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

TREE = ("node_min", "node_max", "first", "count", "miss_next", "tri_verts",
        "prim_index")
BOXES = ("node_min", "node_max")
CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", block_size=16, bvh_leaf=14,
                   tri_isect="bw", fuse_shadows=False, occ_mode="pack",
                   stale_prune=False, tile_r=256)
TOL = dict(rtol=5e-4, atol=5e-4)  # the fused kernel's, tests/test_mega.py:211


def _icosphere():
    v, f = t_meshgen.icosphere(subdivisions=3, radius=2.0,
                               center=(0, 2, 8))
    return np.asarray(v)[np.asarray(f)].astype(np.float32)


def _soup(m=400, seed=7):
    """tests/test_bvh.py::test_presplit_equivalence's soup: clustered
    triangles, eight of them made huge so that splitting fires."""
    rng = np.random.default_rng(seed)
    tris = (rng.normal(size=(m, 1, 3)) * 4
            + rng.normal(size=(m, 3, 3)) * 0.7).astype(np.float32)
    c = tris[:8].mean(1, keepdims=True)
    tris[:8] = (tris[:8] - c) * 12 + c
    return tris


SOUPS = {"icosphere": _icosphere, "soup": _soup}


def _rays(n, spread, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * spread
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def _brute(tris, o, d):
    t = t_isect.ray_triangles(o, d, torch.from_numpy(tris))
    tmin, idx = t.min(dim=1)
    return tmin, torch.where(torch.isfinite(tmin), idx, -1)


@pytest.mark.parametrize("kw", [dict(), dict(leaf_size=14, sah_bins=64)],
                         ids=["leaf4", "leaf14-bins64"])
@pytest.mark.parametrize("name", sorted(SOUPS))
def test_numpy_builder_equal(name, kw):
    from unity_raytracer_tpu.ops import bvh as j_bvh
    tris = SOUPS[name]()
    got = t_bvh.build(tris, backend="numpy", **kw)
    want = j_bvh.build(tris, backend="numpy", **kw)
    for k in TREE:
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


def test_numpy_and_native_hits_equal():
    """The twin's test_native_builder_matches_numpy on the port: both
    backends give the same hits through the plain walk."""
    tris = _icosphere()
    o, noise = _rays(512, 6.0)
    centre = torch.tensor([0.0, 2.0, 8.0])
    o = o + centre  # aimed near the sphere's centre
    d = centre + 1.5 * noise - o
    d = d / d.norm(dim=1, keepdim=True)
    t1, i1, _ = t_bvh.traverse(
        t_bvh.build(tris, backend="numpy").to("cpu"), o, d)
    t2, i2, _ = t_bvh.traverse(
        t_bvh.build(tris, backend="native").to("cpu"), o, d)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    hit = torch.isfinite(t1)
    assert int(hit.sum()) > 100
    np.testing.assert_allclose(t1[hit].numpy(), t2[hit].numpy(), rtol=1e-6)


def test_backends(monkeypatch):
    """'native' raises where the C++ builder cannot be built, 'auto' then
    takes the numpy builder, and presplitting always does."""
    tris = _soup()
    numpy_tree = t_bvh.build(tris, backend="numpy")

    def no_compiler():
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(t_bvh._lib, "bvh_lib", no_compiler)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        t_bvh.build(tris, backend="native")
    auto = t_bvh.build(tris, backend="auto")
    for k in TREE:
        np.testing.assert_array_equal(getattr(auto, k),
                                      getattr(numpy_tree, k), err_msg=k)
    t_bvh.build(tris, backend="native", presplit=0.3)  # no native call
    with pytest.raises(ValueError, match="backend"):
        t_bvh.build(tris, backend="cuda")


def test_presplit_equivalence():
    """The twin's test_presplit_equivalence on the port: references
    duplicate triangles with clipped boxes, and every ray's nearest (t,
    triangle) is the brute force's."""
    tris = _soup()
    b = t_bvh.build(tris, presplit=1.0)
    assert b.tri_verts.shape[0] > tris.shape[0]      # splitting fired
    assert int(b.prim_index.max()) < tris.shape[0]   # refs map back
    assert len(np.unique(b.prim_index)) == tris.shape[0]
    o, d = _rays(512, 5.0)
    t_ref, i_ref = _brute(tris, o, d)
    t_got, i_got, _ = t_bvh.traverse(b.to("cpu"), o, d)
    np.testing.assert_array_equal(i_got.numpy(), i_ref.numpy())
    hit = torch.isfinite(t_ref)
    assert int(hit.sum()) > 50
    np.testing.assert_allclose(t_got[hit].numpy(), t_ref[hit].numpy(),
                               rtol=1e-6, atol=1e-6)


def _assert_outward(got, want, lower):
    """Each value equals the twin's or lies one ulp outward of it."""
    want = np.asarray(want)
    step = np.nextafter(want, np.float32(-np.inf if lower else np.inf))
    assert ((got == want) | (got == step)).all()
    return int((got != want).sum())


@pytest.mark.parametrize("budget", [0.3, 1.0])
@pytest.mark.parametrize("name", sorted(SOUPS))
def test_presplit_arrays_against_twin(name, budget):
    """Queue C #3: the twin rounds clipped float64 ref boxes to nearest,
    so some lie inside their float64 box; the port's never do. The tree
    is the twin's, and its node boxes differ only by one ulp outward."""
    from unity_raytracer_tpu.ops import bvh as j_bvh
    tris = SOUPS[name]()
    ref64, lo64, hi64 = t_bvh._presplit_refs64(tris, budget)
    ref, lo, hi = t_bvh.presplit_refs(tris, budget)
    j_ref, j_lo, j_hi = j_bvh.presplit_refs(tris, budget)
    np.testing.assert_array_equal(ref, j_ref)
    assert ref.dtype == np.int32 and lo.dtype == hi.dtype == np.float32
    assert ref.shape[0] > tris.shape[0]
    inward = lambda l, h: int(((l > lo64) | (h < hi64)).any(axis=1).sum())
    assert inward(lo, hi) == 0
    assert inward(np.asarray(j_lo), np.asarray(j_hi)) > 0
    assert _assert_outward(lo, j_lo, lower=True) > 0
    assert _assert_outward(hi, j_hi, lower=False) > 0

    got = t_bvh.build(tris, leaf_size=14, presplit=budget)
    want = j_bvh.build(tris, leaf_size=14, presplit=budget)
    for k in TREE:
        if k not in BOXES:
            np.testing.assert_array_equal(getattr(got, k),
                                          np.asarray(getattr(want, k)),
                                          err_msg=k)
    moved = (_assert_outward(got.node_min, want.node_min, lower=True)
             + _assert_outward(got.node_max, want.node_max, lower=False))
    assert moved > 0
    # every leaf box holds the float64 boxes of its references (the
    # build's own leaf order, from the builder it runs)
    lo32, hi32 = lo64.astype(np.float32), hi64.astype(np.float32)
    nmin, nmax, first, count, _, order = t_bvh._build_numpy(
        lo32, hi32, 0.5 * (lo32 + hi32), lo, hi, 14, True, t_bvh.SAH_BINS)
    np.testing.assert_array_equal(nmin, got.node_min)
    np.testing.assert_array_equal(nmax, got.node_max)
    for i in np.nonzero(count > 0)[0]:
        refs = order[first[i]:first[i] + count[i]]
        assert (nmin[i] <= lo64[refs]).all() and (nmax[i] >= hi64[refs]).all()


def _box_columns(width, layout):
    """Columns of packed rows that hold box minima / maxima."""
    mins = np.zeros(width, bool)
    maxs = np.zeros(width, bool)
    for b in (range(0, width, 8) if layout == "wide" else (0,)):
        mins[b:b + 3] = True
        maxs[b + 3:b + 6] = True
    return mins, maxs


@pytest.mark.parametrize("name,leaf,arity,budget", [
    ("small", 14, 4, 0.3), ("small", 14, 8, 1.0), ("small", 28, 4, 0.3),
    ("mesh10k", 98, 4, 0.3)])
def test_presplit_prepare_equal(name, leaf, arity, budget):
    """``prepare_bvh`` with ``bvh_presplit``: leaf rows, Baldwin–Weber
    records, slot map, material ids, flip and the tree arrays equal the
    twin's; node and wide rows equal them but for boxes moved one ulp
    outward; the stack depths equal those of the twin's rows."""
    from unity_raytracer_tpu.models import meshgen, presets, scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    if name == "small":
        js, cfg = small_scene(scene, meshgen), CFG
        ts = small_scene(t_scene, t_meshgen, device="cpu")
    else:
        js, _, cfg = presets.get_preset(name, width=8, height=8)
        ts = get_preset(name, width=8, height=8, device="cpu")[0]
    cfg = cfg.with_(bvh_leaf=leaf, bvh_arity=arity, bvh_presplit=budget)
    jp = j_bvh.prepare_bvh(js, cfg.with_(kernel="mega"))
    tp = t_bvh.prepare_bvh(ts, cfg)
    assert tp.bvh.tri_verts.shape[0] > ts.meshes.count
    for k in ("tris", "tris_bw", "leaf_prim", "leafmeta"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    for k in ("nodes", "wide"):
        got, want = getattr(tp, k).numpy(), np.asarray(getattr(jp, k))
        assert got.shape == want.shape, k
        mins, maxs = _box_columns(got.shape[1], k)
        rest = ~(mins | maxs)
        np.testing.assert_array_equal(got[:, rest], want[:, rest], err_msg=k)
        _assert_outward(got[:, mins], want[:, mins], lower=True)
        _assert_outward(got[:, maxs], want[:, maxs], lower=False)
    for k in ("prim_index", "tri_verts", "first", "count", "miss_next",
              "flip"):
        np.testing.assert_array_equal(getattr(tp.bvh, k),
                                      np.asarray(getattr(jp.bvh, k)),
                                      err_msg=k)
    assert tp.stack_binary == traverse_mk3.binary_stack_depth(
        np.asarray(jp.nodes))
    assert tp.stack_wide == traverse_mk3.wide_stack_depth(
        np.asarray(jp.wide))


@pytest.fixture(scope="module")
def jax_presplit_16():
    """The twin's presplit frame, composed path (its plain walk over a
    4-triangle-leaf presplit tree), 16x16."""
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.render import render as j_render
    js = small_scene(scene, meshgen)
    jc = camera.Camera.make(width=16, height=16, **CAMERA)
    cfg = CFG.with_(kernel="xla", bvh_presplit=0.3)
    return np.asarray(j_render(js, jc, cfg, bvh=j_bvh.prepare_bvh(js, cfg)))


@pytest.mark.parametrize("change", [
    dict(kernel="mega"), dict(kernel="mega", tri_isect="mt", bvh_arity=0),
    dict(kernel="xla"), dict(kernel="pallas3")],
    ids=["mega-bw4", "mega-mt-binary", "xla", "pallas3"])
def test_presplit_frame(jax_presplit_16, change):
    """The port's presplit frame on the plain versions equals its unsplit
    frame bit for bit and the twin's presplit frame within the fused
    kernel's tolerance."""
    ts = small_scene(t_scene, t_meshgen, device="cpu")
    tc = Camera.make(width=16, height=16, device="cpu", **CAMERA)
    cfg = CFG.with_(**change)
    split = render(ts, tc, cfg.with_(bvh_presplit=0.3)).numpy()
    np.testing.assert_array_equal(split, render(ts, tc, cfg).numpy())
    np.testing.assert_allclose(split, jax_presplit_16, **TOL)
    assert split.std() > 0.01


def test_bind_verts_on_presplit_tree():
    """``bind_verts`` re-derives the leaf-order table of a presplit tree
    (prim_index repeats) from the scene's verts: equal to the baked one
    at the build verts, and the epilogue's gradient reaches the verts."""
    ts = small_scene(t_scene, t_meshgen, device="cpu")
    packed = t_bvh.prepare_bvh(ts, CFG.with_(bvh_presplit=1.0))
    bound = t_bvh.bind_verts(packed, ts)
    np.testing.assert_array_equal(bound.bvh.tri_verts.numpy(),
                                  packed.bvh.tri_verts.numpy())
    v = ts.meshes.verts.clone().requires_grad_(True)
    import dataclasses
    moved = dataclasses.replace(
        ts, meshes=dataclasses.replace(ts.meshes, verts=v))
    tc = Camera.make(width=8, height=8, device="cpu", **CAMERA)
    from unity_raytracer_tpu_torch.models.camera import generate_rays
    o, d = generate_rays(tc)
    t, idx, _ = t_bvh.traverse_any(t_bvh.bind_verts(packed, moved), o, d)
    assert int((idx >= 0).sum()) > 0
    torch.where(torch.isfinite(t), t, 0.0).sum().backward()
    assert float(v.grad.abs().sum()) > 0


@pytest.mark.gpu
def test_presplit_prepare_on_card_equal(cuda):
    scene = small_scene(t_scene, t_meshgen, device="cpu")
    cfg = CFG.with_(bvh_presplit=0.3)
    on_card = t_bvh.prepare_bvh(scene.to(cuda), cfg, cuda)
    on_cpu = t_bvh.prepare_bvh(scene, cfg)
    for k in ("nodes", "wide", "tris", "tris_bw", "leaf_prim", "leafmeta",
              "leafbox"):
        np.testing.assert_array_equal(getattr(on_card, k).cpu().numpy(),
                                      getattr(on_cpu, k).numpy(), err_msg=k)
