"""PyTorch port: gradients of the composed path against JAX and finite differences.

On tests/test_grad.py's scenes and parameter classes (``three_spheres`` at
16x16 with 0 bounces, the mirror chain with 1, the specular probe), the
port's autograd of the mean image is held against eager ``jax.grad`` —
frozen by tests/torch_goldens.py into ``goldens/torch/composed.npz``,
because eager JAX takes ~20 s per scene — at tests/test_replay.py's
gradient tolerance (rtol 5e-3, atol 5e-4 x the largest |gradient|), and
against the port's own central finite differences at tests/test_grad.py's
``rtol=0.08``. tests/test_grad_chunked.py's contracts hold in the port
(chunked = unchunked, remat = plain, both on the hard path), and the soft
24x24 loss's gradients equal JAX's; tests/test_mesh_grad.py's mesh-vertex
gradient through ``bind_verts`` equals JAX's and its finite differences.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_goldens import (
    CHUNK_NAMES, MESH_CFG, grad_scene, load)
from torch_parity import mesh_grad_scene
from unity_raytracer_tpu_torch import fit as t_fit
from unity_raytracer_tpu_torch.models import camera as t_camera
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops.render import render, trace_radiance
from unity_raytracer_tpu_torch.utils.config import DiffConfig

torch.set_num_threads(1)

# tests/test_replay.py:106-108's gradient tolerance: rtol, atol x max |g|
G_RTOL, G_ATOL = 5e-3, 5e-4
FD_RTOL = 0.08  # tests/test_grad.py's
# (scene, class, FD step) — tests/test_grad.py's classes and steps
CASES = [("mb0", "sphere_centers", 3e-3), ("mb0", "sphere_radius_sq", 3e-3),
         ("mb0", "tri_verts", 5e-3), ("mb0", "sphere_diffuse", 1e-2),
         ("mb0", "light_intensities", 10.0),
         ("mb0", "light_positions", 5e-3), ("mb1", "sphere_mirror", 1e-2),
         ("spec", "sphere_specular", 1e-2)]


@pytest.fixture(scope="module")
def gold():
    return load("composed")


def _mean_image(which, names):
    scene, cam, cfg = grad_scene("torch", which)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in t_fit.get_params(scene, names).items()}
    return (lambda p: render(t_fit.set_params(scene, p), cam, cfg).mean(),
            params)


def _assert_grad_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=G_RTOL, atol=G_ATOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("which,name,eps", CASES)
def test_grad_matches_jax(gold, which, name, eps):
    f, params = _mean_image(which, (name,))
    loss = f(params)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), gold[f"{which}/loss"],
                               rtol=1e-5)
    want = gold[f"{which}/grad/{name}"]
    _assert_grad_close(params[name].grad.numpy(), want, name)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("which,name,eps", CASES)
def test_grad_matches_finite_differences(which, name, eps):
    """tests/test_grad.py's central-FD check on the port: every slice
    with a gradient above 1e-7 within rtol 0.08, atol 1e-5."""
    f, params = _mean_image(which, (name,))
    f(params).backward()
    g = params[name].grad.reshape(-1)
    x0 = params[name].detach()
    n_checked = 0
    with torch.no_grad():
        for i in range(x0.numel()):
            dx = torch.zeros(x0.numel())
            dx[i] = eps
            dx = dx.reshape(x0.shape)
            fd = (float(f({name: x0 + dx})) - float(f({name: x0 - dx}))) \
                / (2 * eps)
            ad = float(g[i])
            if abs(fd) < 1e-7 and abs(ad) < 1e-7:
                continue
            n_checked += 1
            assert np.isclose(ad, fd, rtol=FD_RTOL, atol=1e-5), (i, ad, fd)
    assert n_checked > 0


def test_soft_shadow_gradient_nonzero_at_silhouette():
    """tests/test_grad.py:175-196: straight-through soft shadows keep the
    forward image hard and give the occluder a gradient."""
    from unity_raytracer_tpu_torch.models.presets import three_spheres
    scene, cam, cfg = three_spheres(width=24, height=24, device="cpu")
    cfg = cfg.with_(max_bounces=0, mode="scan")
    soft = cfg.with_(diff=DiffConfig(soft_shadow_temp=0.5,
                                     straight_through=True))
    np.testing.assert_allclose(render(scene, cam, soft).numpy(),
                               render(scene, cam, cfg).numpy(), rtol=1e-6,
                               atol=1e-6)
    c = scene.spheres.centers.clone().requires_grad_(True)
    s = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, centers=c))
    render(s, cam, soft).mean().backward()
    assert torch.isfinite(c.grad).all() and c.grad.abs().max() > 0


def _chunk_setup(soft=True):
    scene, cam, cfg = grad_scene("torch", "soft")
    if not soft:
        cfg = cfg.with_(diff=DiffConfig())
    o, d = generate_rays_blocks(cam, cfg.block_size)
    params = t_fit.get_params(scene, CHUNK_NAMES)
    with torch.no_grad():
        target = trace_radiance(scene, o, d, cfg) * 0.85
    return scene, cfg, o, d, params, target


def _plain_vg(scene, cfg, o, d, target, params):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    rad = trace_radiance(t_fit.set_params(scene, leaves), o, d, cfg)
    loss = ((rad - target) ** 2).mean()
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


def _assert_tree_close(a, b, rtol=2e-4):
    """tests/test_grad_chunked.py:42-48."""
    for k in b:
        y = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        x = a[k].numpy()
        scale = max(np.abs(y).max(), 1e-8)
        np.testing.assert_allclose(x, y, rtol=rtol, atol=rtol * scale,
                                   err_msg=k)
        assert np.abs(y).max() > 0, k


def test_soft_loss_grad_matches_jax(gold):
    scene, cfg, o, d, params, target = _chunk_setup()
    # the radiance at the render tolerance (rtol = atol = 5e-4)
    np.testing.assert_allclose(target.numpy(), gold["soft/target"],
                               rtol=5e-4, atol=5e-4)
    target = torch.from_numpy(gold["soft/target"])
    loss, grads = _plain_vg(scene, cfg, o, d, target, params)
    np.testing.assert_allclose(float(loss), gold["soft/loss"], rtol=1e-4)
    for k in CHUNK_NAMES:
        _assert_grad_close(grads[k].numpy(), gold[f"soft/grad/{k}"], k)


def test_chunked_grad_matches_unchunked():
    scene, cfg, o, d, params, target = _chunk_setup()
    l0, g0 = _plain_vg(scene, cfg, o, d, target, params)
    vg = t_fit.make_chunked_value_and_grad(scene, cfg, o, d, target,
                                           chunk=128)
    l1, g1 = vg(params)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    _assert_tree_close(g1, g0)


def test_remat_grad_matches_plain():
    scene, cfg, o, d, params, target = _chunk_setup()
    l0, g0 = _plain_vg(scene, cfg, o, d, target, params)
    l1, g1 = _plain_vg(scene, cfg.with_(remat=True), o, d, target, params)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    _assert_tree_close(g1, g0, rtol=1e-5)


def test_chunked_plus_remat_hard_path():
    """bench.py's composed fwd+bwd configuration: hard temperatures,
    remat, chunks that pad."""
    scene, cfg, o, d, params, target = _chunk_setup(soft=False)
    l0, g0 = _plain_vg(scene, cfg, o, d, target, params)
    vg = t_fit.make_chunked_value_and_grad(scene, cfg.with_(remat=True), o,
                                           d, target, chunk=100)
    l1, g1 = vg(params)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    _assert_tree_close(g1, g0)


def _mesh_loss():
    scene, cam = mesh_grad_scene(t_scene, t_meshgen, t_camera, device="cpu")
    bvh = t_bvh.prepare_bvh(scene, MESH_CFG)
    o, d = generate_rays_blocks(cam, MESH_CFG.block_size)

    def f(verts):
        s = dataclasses.replace(scene, meshes=dataclasses.replace(
            scene.meshes, verts=verts))
        return trace_radiance(s, o, d, MESH_CFG,
                              bvh=t_bvh.bind_verts(bvh, s)).mean()

    return f, scene.meshes.verts


def test_mesh_verts_grad_matches_jax(gold):
    """tests/test_mesh_grad.py's mesh-vertex gradient (plain per-lane
    walk, bind_verts) equals eager JAX's."""
    f, v0 = _mesh_loss()
    v = v0.clone().requires_grad_(True)
    loss = f(v)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), gold["mesh/loss"],
                               rtol=1e-5)
    _assert_grad_close(v.grad.numpy(), gold["mesh/grad"], "mesh_verts")
    assert np.abs(gold["mesh/grad"]).max() > 0


def test_mesh_verts_fd_vs_autodiff():
    """tests/test_mesh_grad.py:53-92 on the port: the 8 largest and 4
    random components against central differences (step 2e-3, inside
    the BVH pad)."""
    f, v0 = _mesh_loss()
    v = v0.clone().requires_grad_(True)
    f(v).backward()
    g = v.grad.reshape(-1).numpy()
    order = np.argsort(-np.abs(g))
    picks = list(order[:8]) + list(np.random.default_rng(0).choice(g.size,
                                                                   4))
    eps = 2e-3
    n_checked = 0
    with torch.no_grad():
        for i in picks:
            dv = torch.zeros(g.size)
            dv[i] = eps
            dv = dv.reshape(v0.shape)
            fd = (float(f(v0 + dv)) - float(f(v0 - dv))) / (2 * eps)
            if abs(fd) < 1e-6 and abs(g[i]) < 1e-6:
                continue
            n_checked += 1
            assert abs(fd - g[i]) <= 0.1 * max(abs(fd), abs(g[i])) + 1e-4, \
                (i, fd, g[i])
    assert n_checked >= 5
