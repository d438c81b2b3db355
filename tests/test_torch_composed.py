"""PyTorch port: the composed forward path against JAX and the oracle goldens.

The composed bounce chain (``nearest_hit`` -> ``direct_lighting`` with
light-major shadow queries -> mirror continuation) on the CPU, through
each traversal route (the plain per-lane walk, and the plain versions of
the ordered, threaded and wide walks), is held against the JAX composed
render (``kernel='xla'``) on tests/test_mega.py's scene at rtol = atol =
5e-4 on at least 99.99% of pixels (every pixel, at these sizes), and the
meshless presets against the scalar oracle's goldens with
tests/test_render_golden.py's criteria. The port's fused frame is held
against its composed frame at the same 5e-4 (tests/test_mega.py:211
holds the Baldwin–Weber leaf test against Möller–Trumbore there), and
``trace_radiance_stats``' per-segment live counts equal JAX's exactly.
With ``light_cull`` at 3 and 20 (``torch_goldens.LIGHT_CULLS``) the
composed frames (``'xla'``, ``'pallas'``) and the fused frame's plain
version are held to JAX's composed frame at the same 5e-4.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_goldens import LIGHT_CULLS
from torch_parity import CAMERA, cuda, small_scene  # noqa: F401
from unity_raytracer_tpu_torch.fit import set_params
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops.kernels import intersect_mk, traverse_mk3
from unity_raytracer_tpu_torch.ops.render import (
    render, trace_radiance, trace_radiance_stats)
from unity_raytracer_tpu_torch.utils.config import DiffConfig, RenderConfig

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-4)
MAX_BAD = 1e-4  # fraction of pixels allowed outside TOL
GOLDENS = Path(__file__).parent / "goldens"
CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", block_size=16, bvh_leaf=14,
                   tri_isect="bw")
SIZE = 32


def _bad(got, want):
    return int((~np.isclose(got, want, **TOL).all(-1)).sum())


@pytest.fixture(scope="module")
def jax_image():
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops.render import render as j_render
    js = small_scene(scene, meshgen)
    jc = camera.Camera.make(width=SIZE, height=SIZE, **CAMERA)
    return np.asarray(j_render(js, jc, CFG.with_(kernel="xla")))


@pytest.fixture(scope="module")
def jax_cull_images():
    """JAX's composed frame with ``light_cull`` at each of LIGHT_CULLS."""
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops.render import render as j_render
    js = small_scene(scene, meshgen)
    jc = camera.Camera.make(width=SIZE, height=SIZE, **CAMERA)
    return {lc: np.asarray(j_render(js, jc, CFG.with_(kernel="xla",
                                                      light_cull=lc)))
            for lc in LIGHT_CULLS}


def _port(kernel, size=SIZE, device="cpu", **kw):
    ts = small_scene(t_scene, t_meshgen, device=device)
    tc = Camera.make(width=size, height=size, device=device, **CAMERA)
    return render(ts, tc, CFG.with_(kernel=kernel, **kw)).cpu().numpy()


@pytest.mark.parametrize("kernel", ["xla", "auto", "pallas", "pallas3",
                                    "wide"])
def test_composed_render_matches_jax(jax_image, kernel):
    got = _port(kernel)
    assert got.shape == (SIZE, SIZE, 3) and np.isfinite(got).all()
    assert _bad(got, jax_image) <= MAX_BAD * SIZE * SIZE
    assert jax_image.std() > 0.01  # hits, shadows and mirror bounces


@pytest.mark.parametrize("lc", LIGHT_CULLS)
@pytest.mark.parametrize("kernel", ["xla", "pallas", "mega"])
def test_light_cull_matches_jax(jax_image, jax_cull_images, kernel, lc):
    """``light_cull`` skips the shadow query of a light whose attenuated
    contribution falls below it: the composed frames and the fused
    frame's plain version (``'mega'``) against JAX's composed frame."""
    want = jax_cull_images[lc]
    got = _port(kernel, light_cull=lc)
    assert _bad(got, want) <= MAX_BAD * SIZE * SIZE
    assert _bad(want, jax_image) > 0  # the cull changes the frame


def test_composed_binary_and_arity8_match_jax(jax_image):
    """The binary layout (bvh_arity=0, no wide rows) and BVH8 rows."""
    for kernel, arity in (("pallas", 0), ("wide", 8)):
        got = _port(kernel, bvh_arity=arity)
        assert _bad(got, jax_image) <= MAX_BAD * SIZE * SIZE, (kernel, arity)


def test_soft_straight_through_forward_is_hard(jax_image):
    """Soft hit and shadow temperatures with straight-through: the
    forward image is the hard one."""
    got = _port("pallas", diff=DiffConfig(soft_shadow_temp=1.0,
                                          soft_hit_temp=0.1,
                                          straight_through=True))
    assert _bad(got, jax_image) <= MAX_BAD * SIZE * SIZE


def test_soft_no_straight_through_matches_jax():
    """Soft visibility without straight-through blends proxy spheres and
    relaxed shadows into the forward image, as JAX's does."""
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops.render import render as j_render
    from unity_raytracer_tpu.utils.config import DiffConfig as JDiff
    soft = dict(soft_shadow_temp=0.5, soft_hit_temp=0.05,
                straight_through=False)
    want = np.asarray(j_render(
        small_scene(scene, meshgen),
        camera.Camera.make(width=16, height=16, **CAMERA),
        CFG.with_(kernel="xla", diff=JDiff(**soft))))
    got = _port("pallas", size=16, diff=DiffConfig(**soft))
    assert _bad(got, want) == 0
    assert np.abs(got - _port("pallas", size=16)).max() > 1e-3


@pytest.mark.parametrize("name,w,h", [
    ("reference_demo", 32, 32), ("reference_demo_native", 50, 50),
    ("three_spheres", 32, 32)])
def test_golden(name, w, h):
    """tests/test_render_golden.py's criteria (p99.9 error < 5e-3, mean
    error < 2e-4 + 1e-3 mean|ref|) against the oracle goldens: the
    meshless scenes and the brute-force box mesh of reference_demo."""
    scene, cam, cfg = get_preset(name.replace("_native", ""), width=w,
                                 height=h, device="cpu")
    img = render(scene, cam, cfg).numpy()
    ref = np.load(GOLDENS / f"{name}_{w}x{h}.npy")
    assert img.shape == ref.shape == (h, w, 3)
    err = np.abs(img - ref)
    assert np.quantile(err, 0.999) < 5e-3
    assert np.mean(err) < 2e-4 + 1e-3 * np.mean(np.abs(ref))
    assert img.max() > 0.05


def test_meshless_scene_with_bvh():
    """``--bvh`` on a meshless preset: the packed BVH of an empty mesh
    set is one empty root, and the frame equals the brute-force one."""
    scene, cam, cfg = get_preset("three_spheres", width=16, height=16,
                                 device="cpu")
    packed = t_bvh.prepare_bvh(scene, cfg.with_(kernel="pallas"))
    assert packed.nodes.shape[0] == 1 and packed.wide.shape[0] == 1
    want = render(scene, cam, cfg).numpy()
    for kernel in ("pallas", "pallas3", "wide", "xla"):
        got = render(scene, cam, cfg.with_(kernel=kernel, use_bvh=True)
                     ).numpy()
        np.testing.assert_array_equal(got, want)


def test_fused_matches_composed():
    """The port's fused frame (kernel='mega') against its composed frame
    on the same packed BVH."""
    fused = _port("mega")
    assert _bad(fused, _port("pallas")) <= MAX_BAD * SIZE * SIZE


def test_trace_radiance_stats_match_jax():
    """Per-segment live nearest lanes and live shadow lanes equal JAX's,
    and the radiance is the plain trace's."""
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops.bvh import prepare_bvh as j_prepare
    from unity_raytracer_tpu.ops.render import (
        trace_radiance_stats as j_stats)
    cfg = CFG.with_(kernel="pallas")
    js = small_scene(scene, meshgen)
    jc = camera.Camera.make(width=16, height=16, **CAMERA)
    jo, jd = camera.generate_rays_blocks(jc, cfg.block_size)
    _, (j_live, j_sh) = j_stats(js, jo, jd, cfg.with_(kernel="xla"),
                                bvh=j_prepare(js, cfg.with_(kernel="xla")))
    ts = small_scene(t_scene, t_meshgen, device="cpu")
    o, d = generate_rays_blocks(
        Camera.make(width=16, height=16, device="cpu", **CAMERA),
        cfg.block_size)
    packed = t_bvh.prepare_bvh(ts, cfg)
    rad, (live, sh) = trace_radiance_stats(ts, o, d, cfg, bvh=packed)
    np.testing.assert_array_equal(live.numpy(), np.asarray(j_live))
    np.testing.assert_array_equal(sh.numpy(), np.asarray(j_sh))
    assert live[0] == o.shape[0] and live[1] > 0 and sh.sum() > 0
    torch.testing.assert_close(rad, trace_radiance(ts, o, d, cfg,
                                                   bvh=packed))


def test_no_bvh_big_mesh_route(monkeypatch):
    """A mesh of >= 2048 triangles without a BVH and kernel='pallas':
    nearest hits go through the brute-force nearest-triangle kernel (its
    plain version here), shadows through the plain [L*N, M] brute force,
    and the frame equals JAX's brute-force composed frame."""
    from unity_raytracer_tpu.models.presets import get_preset as j_preset
    from unity_raytracer_tpu.ops.render import render as j_render
    calls = []
    plain = intersect_mk.nearest_triangle_plain
    monkeypatch.setattr(intersect_mk, "nearest_triangle_plain",
                        lambda *a, **k: (calls.append(1), plain(*a, **k))[1])
    cfg_kw = dict(use_bvh=False, max_bounces=1)
    scene, cam, cfg = get_preset("mesh10k", width=12, height=12,
                                 device="cpu")
    got = render(scene, cam, cfg.with_(kernel="pallas", **cfg_kw)).numpy()
    assert len(calls) == 2  # one nearest-hit query per live segment
    js, jc, jcfg = j_preset("mesh10k", width=12, height=12)
    want = np.asarray(j_render(js, jc, jcfg.with_(kernel="xla", **cfg_kw)))
    assert _bad(got, want) == 0 and want.std() > 0.01


def test_remat_forward_equals_plain():
    """cfg.remat changes residency, not values."""
    np.testing.assert_array_equal(_port("pallas", size=16, remat=True),
                                  _port("pallas", size=16))


@pytest.mark.parametrize("remat", [False, True])
def test_chain_walks_share_one_overflow_counter(monkeypatch, remat):
    """Every walk of a composed chain (nearest and shadow, in every
    segment, recomputed or not) adds to one stack-overflow counter, which
    the chain checks once, instead of a host sync per launch."""
    seen = []
    walk_raw = traverse_mk3.walk_raw

    def spy(*a, overflow=None, **k):
        seen.append(overflow)
        return walk_raw(*a, overflow=overflow, **k)

    monkeypatch.setattr(traverse_mk3, "walk_raw", spy)
    ts = small_scene(t_scene, t_meshgen, device="cpu")
    o, d = generate_rays_blocks(
        Camera.make(width=8, height=8, device="cpu", **CAMERA),
        CFG.block_size)
    cfg = CFG.with_(kernel="pallas", remat=remat)
    bvh = t_bvh.prepare_bvh(ts, cfg)
    c = ts.spheres.centers.clone().requires_grad_(True)
    ts = set_params(ts, {"sphere_centers": c})
    trace_radiance(ts, o, d, cfg, bvh=bvh).mean().backward()
    # a nearest and a shadow walk in each of the 2 live segments (the
    # third has no live lane), recomputed in backward with remat
    assert len(seen) == 4 * (2 if remat else 1)
    assert seen[0] is not None and all(x is seen[0] for x in seen)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,layout", [("pallas", "mk4"),
                                           ("pallas3", "mk3"),
                                           ("wide", "wide4")])
def test_composed_on_card_matches_cpu(cuda, kernel, layout):
    before = traverse_mk3.launches[layout]
    got = _port(kernel, size=64, device=cuda)
    torch.cuda.synchronize()
    assert traverse_mk3.launches[layout] > before
    want = _port(kernel, size=64)
    assert _bad(got, want) <= 2  # FMA-flipped edge pixels
