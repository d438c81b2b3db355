"""PyTorch port: chunked frames and the tile orchestrator.

``render`` with ``cfg.ray_chunk`` below the pixel count traces the
block-ordered rays chunk by chunk (the twin's ``_frame_chunked``). On the
fused route every lane is independent, so the chunked frame equals the
unchunked one bit for bit (the plain version here); the composed chain
within 1e-6 (tests/test_render_golden.py:62-66); against JAX's chunked
``render`` at the port's render tolerance (5e-4, tests/test_torch_render.py).
The dielectric tree applies ``tree_cap`` per chunk, as the twin does: the
chunked frame is the chunks' radiance, and the lanes dropped are the sum
of each chunk's ``trace_radiance_tree_stats``. The
fit CLI's target renders chunked, as the twin's does, and equals it. The
orchestrator's three cases are tests/test_utils.py's (``:44-100``).
"""

import numpy as np
import pytest
import torch

from torch_goldens import truncating_tree
from torch_parity import CAMERA, cuda, small_scene  # noqa: F401
from unity_raytracer_tpu_torch.__main__ import fit_setup
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.presets import (
    cornell_box, three_spheres)
from unity_raytracer_tpu_torch.ops.render import (
    render, resolve_mode, trace_radiance, trace_radiance_tree_stats)
from unity_raytracer_tpu_torch.utils.config import RenderConfig
from unity_raytracer_tpu_torch.utils.swizzle import unswizzle_image
from unity_raytracer_tpu_torch.utils.orchestrator import (
    render_tiled_orchestrated)

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-4)
CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", block_size=16, bvh_leaf=14,
                   tri_isect="bw")


def _small(size=16):
    scene = small_scene(t_scene, t_meshgen, device="cpu")
    return scene, Camera.make(width=size, height=size, device="cpu",
                              **CAMERA)


@pytest.mark.parametrize("chunk", [64, 96, 100])
def test_chunked_equals_unchunked_fused(chunk):
    """The fused chain (the segment's plain version): bit for bit, also
    with a padded last chunk (96, 100) and chunks that start mid-way
    through a 16-byte line (100)."""
    scene, cam = _small()
    cfg = CFG.with_(kernel="mega")
    whole = render(scene, cam, cfg).numpy()
    chunked = render(scene, cam, cfg.with_(ray_chunk=chunk)).numpy()
    np.testing.assert_array_equal(chunked, whole)
    assert whole.std() > 0.01


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_chunked_equals_unchunked_composed(kernel):
    """The composed chain, on the plain walk and the ordered binary
    walk's plain version: within 1e-6."""
    scene, cam = _small()
    cfg = CFG.with_(kernel=kernel)
    whole = render(scene, cam, cfg).numpy()
    chunked = render(scene, cam, cfg.with_(ray_chunk=100)).numpy()
    np.testing.assert_allclose(chunked, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset,size", [("three_spheres", 32),
                                         ("cornell_box", 24)])
def test_chunked_matches_jax(preset, size):
    """The port's chunked frame against JAX's ``render(...,
    ray_chunk=128)``: the mirror chain, and the composed dielectric tree
    with its cap applied per chunk."""
    from unity_raytracer_tpu.models import presets as j_presets
    from unity_raytracer_tpu.ops.render import render as j_render

    j_scene, j_cam, j_cfg = j_presets.get_preset(preset, width=size,
                                                 height=size)
    want = np.asarray(j_render(j_scene, j_cam, j_cfg.with_(ray_chunk=128)))
    scene, cam, cfg = (three_spheres if preset == "three_spheres"
                       else cornell_box)(width=size, height=size,
                                         device="cpu")
    got = render(scene, cam, cfg.with_(ray_chunk=128)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert want.std() > 0.01


@pytest.mark.parametrize("kernel", ["auto", "mega"])
def test_chunked_tree_counts_truncation_per_chunk(kernel):
    """A tree ``tree_cap=1`` is too small for: each chunk compacts on its
    own, so the chunked frame is the chunks' radiance un-swizzled, and
    the lanes dropped are the sum of each chunk's
    ``trace_radiance_tree_stats`` (the composed tree's sum against JAX's
    per-chunk counts, and its image against JAX's chunked frame)."""
    scene, cam, cfg = truncating_tree("torch")
    cfg = resolve_mode(scene, cfg.with_(kernel=kernel, ray_chunk=64))
    img = render(scene, cam, cfg)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    per_chunk = [trace_radiance_tree_stats(scene, o[i:i + 64], d[i:i + 64],
                                           cfg) for i in range(0, 256, 64)]
    count = sum(int(c) for _, c in per_chunk)
    assert count > 0
    np.testing.assert_array_equal(
        img.numpy(), (unswizzle_image(torch.cat([r for r, _ in per_chunk]),
                                      cam.width, cam.height, cfg.block_size)
                      / 255.0).numpy())
    if kernel == "mega":
        return
    from unity_raytracer_tpu.models.camera import generate_rays_blocks as jg
    from unity_raytracer_tpu.ops.render import (
        render as j_render, trace_radiance_tree_stats as j_stats)
    js, jc, jcfg = truncating_tree("jax")
    jcfg = jcfg.with_(mode="tree", ray_chunk=64)
    jo, jd = jg(jc, jcfg.block_size)
    want = sum(int(j_stats(js, jo[i:i + 64], jd[i:i + 64], jcfg)[1])
               for i in range(0, 256, 64))
    assert count == want
    np.testing.assert_allclose(img.numpy(),
                               np.asarray(j_render(js, jc, jcfg)), **TOL)


def test_chunked_fork_without_bvh_raises():
    """The meshless fork's ValueError (ROADMAP Queue C #2) holds in a
    chunked frame too."""
    scene, cam = _small()
    cfg = CFG.with_(kernel="mega", mode="tree", use_bvh=False, ray_chunk=64)
    with pytest.raises(ValueError, match="packed BVH"):
        render(scene, cam, cfg)


def test_fit_cli_target_equals_twin():
    """The fit CLI's composed target renders chunked (pixels / 4 rays per
    chunk) as the twin's ``cmd_fit`` does, and equals it at the port's
    fit tolerance."""
    from unity_raytracer_tpu.models.presets import get_preset as j_get
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.render import render as j_render
    from unity_raytracer_tpu.ops.render import resolve_mode as j_resolve

    size = 16
    _, _, cfg, _, target, replay = fit_setup("mesh10k", size, size, False,
                                             torch.device("cpu"))
    assert not replay and cfg.ray_chunk == size * size // 4
    js, jc, jcfg = j_get("mesh10k", width=size, height=size)
    jcfg = j_resolve(js, jcfg.with_(max_bounces=min(jcfg.max_bounces, 1),
                                    ray_chunk=size * size // 4, remat=True))
    want = np.asarray(j_render(js, jc, jcfg,
                               bvh=j_bvh.prepare_bvh(js, jcfg)))
    np.testing.assert_allclose(target.numpy(), want, **TOL)
    assert want.std() > 0.01


def test_orchestrator_matches_direct():
    scene, cam, cfg = three_spheres(width=32, height=32, device="cpu")
    ref = render(scene, cam, cfg).numpy()
    img, reports = render_tiled_orchestrated(scene, cam, cfg,
                                             rows_per_tile=10)
    assert all(r.ok for r in reports) and len(reports) == 4
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_orchestrator_retries_transient_fault():
    scene, cam, cfg = three_spheres(width=16, height=16, device="cpu")
    cfg = resolve_mode(scene, cfg)
    calls = {"n": 0}

    def flaky(s, o, d, c, b):
        calls["n"] += 1
        if calls["n"] == 2:  # fail the 2nd tile once
            raise RuntimeError("injected fault")
        return trace_radiance(s, o, d, c, bvh=b)

    img, reports = render_tiled_orchestrated(
        scene, cam, cfg, rows_per_tile=8, max_retries=2, trace_fn=flaky)
    assert all(r.ok for r in reports)
    assert [r.attempts for r in reports] == [1, 2]
    assert "injected fault" in reports[1].error and reports[0].error is None
    ref = render(scene, cam, cfg).numpy()
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_orchestrator_reports_permanent_failure():
    scene, cam, cfg = three_spheres(width=16, height=16, device="cpu")

    def dead(s, o, d, c, b):
        raise RuntimeError("always down")

    img, reports = render_tiled_orchestrated(
        scene, cam, cfg, rows_per_tile=8, max_retries=1, trace_fn=dead)
    assert not any(r.ok for r in reports)
    assert all(r.attempts == 2 and "always down" in r.error
               for r in reports)
    assert (img == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["mega", "pallas"])
def test_chunked_on_card_equals_unchunked(cuda, kernel):
    """On the card: the fused chain's chunked frame equals the unchunked
    one bit for bit, a padded last chunk included; the composed chain's
    within 1e-6, with chunks of 1001 rays, whose views start off the
    16-byte lines the walk kernels read (the walk copies them)."""
    from unity_raytracer_tpu_torch.models.presets import mesh_scene
    scene, cam, cfg = mesh_scene(10240, width=96, height=80, device=cuda)
    cfg = cfg.with_(kernel=kernel)
    whole = render(scene, cam, cfg)
    chunked = render(scene, cam, cfg.with_(ray_chunk=1001))
    if kernel == "mega":
        assert torch.equal(whole, chunked)
    else:
        torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
