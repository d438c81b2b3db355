"""PyTorch port: the fitting loop recovers scene parameters, as the JAX package's does.

The port's twins of tests/test_fit.py::test_recover_sphere_centers and
::test_recover_sphere_diffuse (the ``three_spheres`` probe at 48x48, depth
0, the whole image) and of tests/test_fit_mesh.py (a sphere beside a BVH
mesh at depth 1, chunked gradients with remat): the same scenes, starts,
steps and learning rates, held to the same bounds on the loss and the
parameter error. These run live on the CPU; ``tests/test_torch_fit.py``
holds single steps and short fits to JAX itself.
"""

import numpy as np
import pytest
import torch

from unity_raytracer_tpu_torch.fit import FitConfig, fit, get_params
from unity_raytracer_tpu_torch.models import meshgen
from unity_raytracer_tpu_torch.models.camera import Camera
from unity_raytracer_tpu_torch.models.presets import three_spheres
from unity_raytracer_tpu_torch.models.scene import SceneBuilder, make_material
from unity_raytracer_tpu_torch.ops import bvh as bvhmod
from unity_raytracer_tpu_torch.ops.render import render, resolve_mode
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    """tests/test_fit.py's zoomed probe: the spheres fill the frame, so
    silhouette and interior gradients both live at 48x48."""
    scene, _, cfg = three_spheres(width=48, height=48, device="cpu")
    cfg = resolve_mode(scene, cfg.with_(max_bounces=0))
    cam = Camera.from_fov(position=(0, 5, 6), look_at=(0, 2.5, 26),
                          fov_y_deg=40.0, width=48, height=48, device="cpu")
    return scene, cam, cfg, render(scene, cam, cfg)


def test_recover_sphere_centers(problem):
    """Silhouette (soft-hit) gradients pull shifted spheres back home."""
    scene, cam, cfg, target = problem
    true = get_params(scene, ("sphere_centers",))["sphere_centers"]
    init = {"sphere_centers": true + torch.tensor(
        [[0.4, -0.3, 0.4], [-0.4, 0.25, -0.5], [0.3, 0.4, 0.25]])}
    fcfg = FitConfig(param_names=("sphere_centers",), learning_rate=0.02,
                     steps=300, soft_shadow_temp=1.0, soft_hit_temp=0.05,
                     log_every=0)
    res = fit(scene, cam, cfg, target, fcfg, init_params=init)
    assert res.losses[-1] < res.losses[0] * 0.15, res.losses[::50]
    err = (res.params["sphere_centers"] - true).abs().max()
    assert float(err) < 0.3


def test_recover_sphere_diffuse(problem):
    """Material recovery is essentially exact (smooth, well-conditioned)."""
    scene, cam, cfg, target = problem
    true = get_params(scene, ("sphere_diffuse",))["sphere_diffuse"]
    init = {"sphere_diffuse": torch.clamp(true + 0.2, 0.0, 1.0)}
    fcfg = FitConfig(param_names=("sphere_diffuse",), learning_rate=0.02,
                     steps=200, soft_shadow_temp=0.0, soft_hit_temp=0.0,
                     log_every=0)
    res = fit(scene, cam, cfg, target, fcfg, init_params=init)
    assert res.losses[-1] < res.losses[0] * 1e-3
    assert float((res.params["sphere_diffuse"] - true).abs().max()) < 0.02


def test_fit_mesh_bvh_depth1_chunked():
    """A sphere's centre and diffuse beside a BVH mesh, depth 1, through
    the chunked-gradient step with remat (the plain walk, as the twin's
    ``kernel='xla'``)."""
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=2.0, center=(0, 2, 10))
    b.add_mesh(v, f, make_material(diffuse=(0.7, 0.5, 0.2),
                                   ambient=(0.7, 0.5, 0.2), phong=20.0))
    b.add_sphere((-2.5, 1.2, 6.0), 1.2, make_material(
        diffuse=(0.2, 0.6, 0.3), ambient=(0.2, 0.6, 0.3), phong=10.0))
    g = 40.0
    gmat = make_material(diffuse=(0.5, 0.5, 0.55), ambient=(0.5, 0.5, 0.55),
                         phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 10, 0), 3000.0)
    b.set_ambient((40, 40, 40))
    scene = b.build(device="cpu")
    cam = Camera.make(position=(0, 3, -2), forward=(0, -0.1, 1), dist=1.0,
                      half_h=0.7, half_v=0.7, width=40, height=40,
                      device="cpu")
    rcfg = resolve_mode(scene, RenderConfig(
        max_bounces=1, background=(0.04, 0.05, 0.07), use_bvh=True,
        kernel="xla", mode="scan", block_size=8, ray_chunk=512, remat=True))
    bvh = bvhmod.prepare_bvh(scene, rcfg)
    target = render(scene, cam, rcfg, bvh=bvh)
    true = get_params(scene, ("sphere_centers", "sphere_diffuse"))
    init = {"sphere_centers": true["sphere_centers"]
            + torch.tensor([[0.3, -0.25, 0.3]]),
            "sphere_diffuse": torch.clamp(
                true["sphere_diffuse"] + torch.tensor([[0.15, -0.1, 0.12]]),
                0.0, 1.0)}
    err0 = float((init["sphere_centers"] - true["sphere_centers"]).abs().max())
    fcfg = FitConfig(param_names=("sphere_centers", "sphere_diffuse"),
                     learning_rate=0.05, steps=80, soft_shadow_temp=1.0,
                     soft_hit_temp=0.1, log_every=0)
    res = fit(scene, cam, rcfg, target, fcfg, init_params=init, bvh=bvh)
    err1 = float((res.params["sphere_centers"]
                  - true["sphere_centers"]).abs().max())
    assert res.losses[-1] < 0.35 * res.losses[0], res.losses[::10]
    assert err1 < 0.5 * err0, (err0, err1)
