"""PyTorch port: scene containers, presets, camera rays and un-swizzle
against the JAX package.

Scenes and configs must be equal exactly; primary rays bitwise on the CPU
(both sides run the same float operations in the same order,
models/camera.py); the un-swizzle is a relayout, exact. JAX is imported
inside the fixtures so that the CUDA cases also run where only PyTorch is
installed (``pytest --noconftest -m gpu``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (CAMERA, assert_same_arrays, cuda, leaves,
                          small_scene)
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.convert import scene_from_arrays
from unity_raytracer_tpu_torch.models.presets import PRESETS, get_preset
from unity_raytracer_tpu_torch.utils.swizzle import (
    padded_dims, unswizzle_image)

torch.set_num_threads(1)

# (preset, width, height): small frames, two of them not whole 32-blocks
SIZES = [("reference_demo", 50, 50), ("three_spheres", 32, 32),
         ("cornell_box", 24, 24), ("mesh10k", 40, 24),
         ("mesh100k", 64, 36)]


@pytest.fixture(scope="module")
def jx():
    import jax
    from unity_raytracer_tpu.models import camera, meshgen, presets, scene
    from unity_raytracer_tpu.utils import swizzle
    return dict(jax=jax, camera=camera, meshgen=meshgen, presets=presets,
                scene=scene, swizzle=swizzle)


def test_preset_table_matches():
    from unity_raytracer_tpu.models.presets import PRESETS as J_PRESETS
    assert sorted(PRESETS) == sorted(J_PRESETS)
    with pytest.raises(KeyError):
        get_preset("nope")


@pytest.mark.parametrize("name,w,h", SIZES)
def test_preset_equal(jx, name, w, h):
    js, jc, jcfg = jx["presets"].get_preset(name, width=w, height=h)
    ts, tc, tcfg = get_preset(name, width=w, height=h, device="cpu")
    assert_same_arrays(leaves(js), leaves(ts))
    assert_same_arrays(leaves(jc), leaves(tc))
    assert (jc.width, jc.height) == (tc.width, tc.height)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert js.has_dielectrics == ts.has_dielectrics


def test_scene_builder_padding_equal(jx):
    kw = dict(pad_spheres=3, pad_triangles=4, pad_mesh_tris=400,
              pad_meshes=2, pad_lights=4)
    js = small_scene(jx["scene"], jx["meshgen"], **kw)
    ts = small_scene(t_scene, t_meshgen, device="cpu", **kw)
    assert_same_arrays(leaves(js), leaves(ts))
    assert ts.spheres.count == 3 and ts.meshes.count == 400


def test_scene_from_arrays_equal(jx):
    js = small_scene(jx["scene"], jx["meshgen"])
    ts = scene_from_arrays(jx["jax"].tree.map(np.asarray, js), "cpu")
    assert_same_arrays(leaves(js), leaves(ts))
    assert_same_arrays(leaves(ts), leaves(small_scene(t_scene, t_meshgen,
                                                      device="cpu")))


@pytest.mark.parametrize("name,w,h", SIZES)
@pytest.mark.parametrize("bs", [32, 1])
def test_primary_rays_bitwise(jx, name, w, h, bs):
    _, jc, _ = jx["presets"].get_preset(name, width=w, height=h)
    _, tc, _ = get_preset(name, width=w, height=h, device="cpu")
    jo, jd = jx["camera"].generate_rays_blocks(jc, bs)
    to, td = generate_rays_blocks(tc, bs)
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("w,h,bs", [(48, 40, 16), (50, 50, 32), (7, 5, 1)])
def test_unswizzle_matches(jx, w, h, bs):
    assert jx["swizzle"].padded_dims(w, h, bs) == padded_dims(w, h, bs)
    wp, hp = padded_dims(w, h, bs)
    rad = np.random.default_rng(3).standard_normal(
        (wp * hp, 3)).astype(np.float32)
    want = np.asarray(jx["swizzle"].unswizzle_image(rad, w, h, bs))
    got = unswizzle_image(torch.from_numpy(rad), w, h, bs).numpy()
    np.testing.assert_array_equal(got, want)


def test_camera_to_device_roundtrip():
    cam = Camera.make(width=8, height=6, device="cpu", **CAMERA)
    back = cam.to("cpu")
    assert (back.width, back.height) == (8, 6)
    assert_same_arrays(leaves(cam), leaves(back))


@pytest.mark.gpu
def test_rays_and_unswizzle_on_card(cuda):
    _, tc, cfg = get_preset("mesh100k", width=96, height=54, device="cpu")
    o, d = generate_rays_blocks(tc, cfg.block_size)
    og, dg = generate_rays_blocks(tc.to(cuda), cfg.block_size)
    np.testing.assert_array_equal(og.cpu().numpy(), o.numpy())
    # the card may contract a*b+c into one rounding: ulp-level only
    np.testing.assert_allclose(dg.cpu().numpy(), d.numpy(), rtol=1e-6,
                               atol=1e-6)
    img = unswizzle_image(dg, 96, 54, cfg.block_size)
    np.testing.assert_array_equal(
        img.cpu().numpy(), unswizzle_image(dg.cpu(), 96, 54,
                                           cfg.block_size).numpy())
