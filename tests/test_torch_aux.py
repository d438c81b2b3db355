"""PyTorch port: debug maps, profiling, the scalar oracle, ``ray_spheres_mm`` and ``block_perm`` against the JAX package.

``debug_maps`` on the CPU against the twin's (``normal``, ``depth`` and
``shadow`` to 1e-5, ``hit_kind`` and ``hit_id`` equal); the oracle bit for
bit against the twin's, and against its stored golden; the profiling
helpers on the CPU and with a named card; the matrix form of the sphere
test and the block permutation against their twins.
"""

import os

import numpy as np
import pytest
import torch

from torch_parity import CAMERA, cuda, small_scene
from unity_raytracer_tpu_torch import oracle
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.camera import Camera
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import intersect as t_isect
from unity_raytracer_tpu_torch.ops.debugviz import debug_maps
from unity_raytracer_tpu_torch.utils import profiling, swizzle
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

MAPS_TOL = dict(rtol=1e-5, atol=1e-5)
BVH_CFG = RenderConfig(max_bounces=2, use_bvh=True, bvh_leaf=14)


def _scenes(name, size):
    """(port scene, port camera, twin scene, twin camera)."""
    from unity_raytracer_tpu.models import camera, meshgen, presets, scene
    if name == "small":
        return (small_scene(t_scene, t_meshgen, device="cpu"),
                Camera.make(width=size, height=size, device="cpu", **CAMERA),
                small_scene(scene, meshgen),
                camera.Camera.make(width=size, height=size, **CAMERA))
    ts, tc, _ = get_preset(name, width=size, height=size, device="cpu")
    js, jc, _ = presets.get_preset(name, width=size, height=size)
    return ts, tc, js, jc


@pytest.mark.parametrize("name,bvh", [
    ("three_spheres", None), ("small", None), ("small", "packed"),
    ("small", "xla")])
def test_debug_maps_match_jax(name, bvh):
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.debugviz import debug_maps as j_maps
    ts, tc, js, jc = _scenes(name, 24)
    t_tree = j_tree = None
    if bvh is not None:
        j_tree = j_bvh.prepare_bvh(js, BVH_CFG.with_(kernel="xla"))
        t_tree = t_bvh.prepare_bvh(
            ts, BVH_CFG if bvh == "packed" else BVH_CFG.with_(kernel="xla"))
    got = debug_maps(ts, tc, bvh=t_tree)
    want = j_maps(js, jc, bvh=j_tree)
    assert sorted(got) == sorted(want)
    for k in ("normal", "depth", "shadow"):
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **MAPS_TOL)
    for k in ("hit_kind", "hit_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    hit = got["hit_kind"].numpy() > 0
    assert 0.05 < hit.mean() < 1.0
    assert 0.0 < got["shadow"].numpy()[hit].mean() <= 1.0


def test_debug_maps_hash_is_uint32():
    """The hit-id colour: ``(index * 2654435761) mod 2^24`` in int64 is
    the twin's uint32 product (wrapping at 2^32) mod 2^24."""
    idx = np.array([0, 1, 1617, 102399, 2 ** 20 + 7], np.int64)
    want = (idx.astype(np.uint32) * np.uint32(2654435761)) % np.uint32(2 ** 24)
    got = (torch.from_numpy(idx) * 2654435761) & 0xFFFFFF
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_timed_and_trace_on_cpu(tmp_path):
    calls = []
    res = profiling.timed(lambda x: calls.append(x), 3, repeats=4, warmup=2)
    assert len(calls) == 6 and calls[0] == 3
    assert res.runs == 1 and 0.0 <= res.wall_s == res.per_run_s
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "tr" / files[0]) > 0


@pytest.mark.parametrize("ring", [False, True])
def test_call_times_on_cpu(ring):
    """``call_times`` on the CPU: a first call, ``warmup - 1`` more, then
    ``repeats``; a ring of inputs is taken in turn across both loops and
    every result is held until its loop ends, otherwise each is dropped."""
    class Out:
        live = 0

        def __init__(self):
            Out.live += 1

        def __del__(self):
            Out.live -= 1

    calls, live = [], []

    def fn(*a):
        calls.append(a)
        live.append(Out.live)
        return Out()

    inputs = [(i,) for i in range(3)] if ring else None
    t = profiling.call_times(fn, 4, warmup=3, inputs=inputs, device="cpu")
    if ring:
        assert calls == [(0,), (1,), (2,), (0,), (1,), (2,), (0,)]
        assert live == [0, 1, 2, 0, 1, 2, 3]
    else:
        assert calls == [()] * 7 and live == [0] * 7
    assert Out.live == 0
    assert t.first_s > 0 and t.mean_s == t.host_s > 0


@pytest.mark.parametrize("name,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0), ("Tesla V100-SXM2-16GB", None),
    (None, None)])
def test_device_hbm_gbps(monkeypatch, name, gbps):
    """Data-sheet HBM figures by device name; an unknown card or none
    gets the default (None unless given), never a TPU's figure."""
    monkeypatch.setattr(profiling, "_device_name", lambda: name)
    assert profiling.device_hbm_gbps() == gbps
    assert profiling.device_hbm_gbps(default=1.0) == (gbps or 1.0)
    if gbps is None:
        with pytest.raises(ValueError, match="HBM bandwidth"):
            profiling.roofline(1e9, 100.0)
    else:
        r = profiling.roofline(2e9, 100.0)
        assert r["hbm_gbps"] == gbps
        assert r["hbm_bound_rays_per_s"] == pytest.approx(gbps * 1e9 / 100)
        assert r["fraction_of_roofline"] == pytest.approx(
            2e9 / (gbps * 1e9 / 100))


def test_roofline_matches_twin_arithmetic(monkeypatch):
    from unity_raytracer_tpu.utils import profiling as j_prof
    monkeypatch.setattr(profiling, "_device_name", lambda: "NVIDIA H100")
    monkeypatch.setattr(j_prof, "device_hbm_gbps", lambda: 3350.0)
    got = profiling.roofline(3.7e9, 48.0)
    want = j_prof.roofline(3.7e9, 48.0)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,size,depth", [
    ("three_spheres", 8, 0), ("cornell_box", 6, 4), ("small", 6, 2)])
def test_oracle_matches_jax(name, size, depth):
    from unity_raytracer_tpu import oracle as j_oracle
    ts, tc, js, jc = _scenes(name, size)
    got = oracle.render(oracle.from_scene(ts), tc, depth,
                        background=(0.04, 0.05, 0.07))
    want = j_oracle.render(j_oracle.from_scene(js), jc, depth,
                           background=(0.04, 0.05, 0.07))
    assert got.dtype == np.float32 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0.01


def test_oracle_reproduces_golden():
    """tests/goldens/three_spheres_32x32.npy, rendered by the twin's
    oracle, bit for bit."""
    from pathlib import Path
    ts, tc, cfg = get_preset("three_spheres", width=32, height=32,
                             device="cpu")
    got = oracle.render(oracle.from_scene(ts), tc, cfg.max_bounces,
                        background=cfg.background)
    want = np.load(Path(__file__).parent / "goldens"
                   / "three_spheres_32x32.npy")
    np.testing.assert_array_equal(got, want)


def _sphere_rays(seed=5, n=256, s=7):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = rng.normal(size=(s, 3)).astype(np.float32) * 2.5
    r2 = rng.uniform(1.0, 9.0, size=(s,)).astype(np.float32)
    valid = np.arange(s) != 3
    return o, d, c, r2, valid


def test_ray_spheres_mm():
    """Equal to the twin's within 1e-5, and to ``ray_spheres`` within
    floating-point association."""
    from unity_raytracer_tpu.ops.intersect import ray_spheres_mm as j_mm
    o, d, c, r2, valid = _sphere_rays()
    args = [torch.from_numpy(a) for a in (o, d, c, r2, valid)]
    got = t_isect.ray_spheres_mm(*args).numpy()
    want = np.asarray(j_mm(o, d, c, r2, valid))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.sum() > 50 and not np.isfinite(got[:, 3]).any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    plain = t_isect.ray_spheres(*args).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(plain))
    np.testing.assert_allclose(got[fin], plain[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("w,h,bs", [(37, 23, 8), (64, 64, 32), (5, 3, 1)])
def test_block_perm(w, h, bs):
    from unity_raytracer_tpu.utils.swizzle import block_perm as j_perm
    perm, inv = swizzle.block_perm(w, h, bs)
    j_p, j_i = j_perm(w, h, bs)
    np.testing.assert_array_equal(perm, j_p)
    np.testing.assert_array_equal(inv, j_i)
    assert perm.dtype == np.int32
    np.testing.assert_array_equal(perm[inv], np.arange(w * h))


@pytest.mark.gpu
def test_debug_maps_on_card_equal(cuda):
    """The card's maps (the ordered binary walk, kernel #4) against the
    CPU's (the plain walk) on the small scene's packed BVH."""
    ts = small_scene(t_scene, t_meshgen, device="cpu")
    tc = Camera.make(width=32, height=32, device="cpu", **CAMERA)
    cpu = debug_maps(ts, tc, bvh=t_bvh.prepare_bvh(ts, BVH_CFG))
    card = debug_maps(ts.to(cuda), tc.to(cuda),
                      bvh=t_bvh.prepare_bvh(ts.to(cuda), BVH_CFG))
    for k in ("normal", "depth", "shadow"):
        np.testing.assert_allclose(card[k].cpu().numpy(), cpu[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    # the codes as integers (the card divides as a product with the
    # reciprocal, one ulp off the CPU's quotient)
    for k, f in (("hit_kind", 3.0), ("hit_id", 255.0)):
        np.testing.assert_array_equal(torch.round(card[k].cpu() * f).numpy(),
                                      torch.round(cpu[k] * f).numpy(),
                                      err_msg=k)
