"""PyTorch port: the fitting loop on the record-replay path against JAX.

On tests/test_replay.py's scene at 16x16 (``max_bounces=2``), from one
seeded perturbed start (``torch_goldens.fit_inputs``), against a 3-step
JAX ``fit(use_replay=True)`` frozen by ``tests/torch_goldens.py``
(``tests/goldens/torch/fit.npz``):

* ``fit(use_replay=True)`` for 2 steps against the JAX ``fit``: losses at
  rtol 1e-4 and parameters at rtol 1e-3, atol 1e-5. The JAX step is
  jitted, and XLA's reassociation of the gradient sums alone moves the
  mirror sphere's gradient by ~1% on this scene (tests/test_torch_replay.py
  compares against eager JAX for that reason); Adam turns a relative
  gradient difference into at most that fraction of the learning rate
  per step (here 2.4e-5 of 0.02 after two steps);
* a JAX fit's state after 2 steps (its checkpoint: parameters and optax's
  Adam moments) carried across with ``models/convert.py``, then 1 step in
  the port, against JAX's 3rd step;
* the port's own checkpoint and resume against an uninterrupted run;
* the composed path (``use_replay=False``): the CLI's ``three_spheres``
  toy at 16x16, 3 steps from ``torch_goldens.fit_toy_inputs``' seeded
  start, against a 3-step JAX composed ``fit`` frozen in
  ``tests/goldens/torch/composed.npz`` (losses at rtol 1e-4, parameters
  at rtol 1e-3, atol 1e-5); the chunked branch (``ray_chunk``) against
  the whole-image step (losses at rtol 1e-4, parameters at rtol 1e-4,
  atol 1e-6: the same sum, chunked); a mesh-vertex fit through
  ``bind_verts`` that lowers the loss;
* the ``fit`` CLI, with and without ``--replay``.

The target image is the port's render at the true parameters; the
frozen file holds the one JAX was given, and the test checks they agree.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_goldens import (
    CFG, FCFG, FIT_NAMES as NAMES, TOY_FCFG, fit_inputs, fit_toy_inputs,
    load)
from unity_raytracer_tpu_torch import fit as t_fit
from unity_raytracer_tpu_torch.models.convert import (
    adam_state_from_arrays, params_from_arrays)
from unity_raytracer_tpu_torch.utils import checkpoint as t_ckpt

torch.set_num_threads(1)

P_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def port():
    return fit_inputs()


@pytest.fixture(scope="module")
def jax_fit(port):
    """3 JAX steps from the same start, with a checkpoint after step 2
    (frozen by tests/torch_goldens.py)."""
    g = load("fit")
    np.testing.assert_array_equal(g["target"], port[3].numpy())
    for k in NAMES:
        np.testing.assert_array_equal(g[f"init/{k}"], port[4][k].numpy())
    return dict(
        losses=g["losses"], final={k: g[f"final/{k}"] for k in NAMES},
        step2=(int(g["step2"]), {k: g[f"step2/{k}"] for k in NAMES},
               (g["adam_count"], {k: g[f"mu/{k}"] for k in NAMES},
                {k: g[f"nu/{k}"] for k in NAMES})))


def test_get_set_params_roundtrip(port):
    scene = port[0]
    names = tuple(t_fit.PARAM_PATHS)
    got = t_fit.get_params(scene, names)
    new = {k: v + 1.0 if v.dtype.is_floating_point else v
           for k, v in got.items()}
    moved = t_fit.set_params(scene, new)
    for k, v in t_fit.get_params(moved, names).items():
        assert v is new[k], k
    for k, v in t_fit.get_params(scene, names).items():
        assert v is got[k], k  # the template is not changed
    assert moved.meshes.mesh_id is scene.meshes.mesh_id


def test_fit_matches_jax(port, jax_fit):
    res = t_fit.fit(port[0], port[1], CFG, port[3],
                    t_fit.FitConfig(steps=2, **FCFG), init_params=port[4],
                    bvh=port[2])
    assert res.step == 2 and res.live_prefix == CFG.max_bounces + 1
    np.testing.assert_allclose(res.losses, jax_fit["losses"][:2],
                               rtol=1e-4)
    assert res.losses[1] < res.losses[0]
    step, want, _ = jax_fit["step2"]
    assert step == 2
    for k in NAMES:
        np.testing.assert_allclose(res.params[k].numpy(), want[k],
                                   err_msg=k, **P_TOL)


def test_fit_continues_jax_state(port, jax_fit, tmp_path):
    """JAX's state after 2 steps, carried across, then 1 port step."""
    scene, cam, packed, target, _ = port
    step, p_np, (count, mu, nu) = jax_fit["step2"]
    params = params_from_arrays(p_np, "cpu")
    opt = torch.optim.Adam(list(params.values()), lr=FCFG["learning_rate"])
    adam_state_from_arrays(count, mu, nu, opt, params)
    path = tmp_path / "carried.npz"
    t_ckpt.save_checkpoint(path, step, params, opt)
    res = t_fit.fit(scene, cam, CFG, target, t_fit.FitConfig(steps=3, **FCFG),
                    bvh=packed, resume_from=str(path))
    assert res.step == 3 and len(res.losses) == 1
    np.testing.assert_allclose(res.losses[0], jax_fit["losses"][2],
                               rtol=1e-4)
    for k in NAMES:
        np.testing.assert_allclose(res.params[k].numpy(),
                                   jax_fit["final"][k], err_msg=k, **P_TOL)


def test_checkpoint_resume_equals_uninterrupted(port, tmp_path):
    scene, cam, packed, target, init = port
    path = tmp_path / "fit.npz"
    whole = t_fit.fit(scene, cam, CFG, target,
                      t_fit.FitConfig(steps=3, **FCFG), init_params=init,
                      bvh=packed)
    first = t_fit.fit(scene, cam, CFG, target,
                      t_fit.FitConfig(steps=2, checkpoint_every=2,
                                      checkpoint_path=str(path), **FCFG),
                      init_params=init, bvh=packed)
    assert path.exists() and not path.with_suffix(".tmp.npz").exists()
    step, p_np, adam = t_ckpt.load_checkpoint(path)
    assert step == 2 and adam[0] == 2 and sorted(p_np) == sorted(NAMES)
    rest = t_fit.fit(scene, cam, CFG, target,
                     t_fit.FitConfig(steps=3, **FCFG), bvh=packed,
                     resume_from=str(path))
    np.testing.assert_array_equal(
        np.concatenate([first.losses, rest.losses]), whole.losses)
    for k in NAMES:
        torch.testing.assert_close(rest.params[k], whole.params[k],
                                   rtol=0, atol=0)


def test_composed_tree_fit_step():
    """The composed path's two steps run the dielectric tree
    (cornell_box): the whole-image loss and the chunked step give the
    same finite loss and gradients (the same sum, chunked)."""
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.utils.swizzle import swizzle_image
    scene, cam, cfg = get_preset("cornell_box", width=8, height=8,
                                 device="cpu")
    target = torch.full((8, 8, 3), 0.2)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in t_fit.get_params(scene, NAMES).items()}
    loss = t_fit.make_loss_fn(scene, cam, cfg, target)(leaves)
    loss.backward()
    o, d = generate_rays_blocks(cam, cfg.block_size)
    tgt = swizzle_image(target, cfg.block_size) * 255.0
    w = swizzle_image(torch.ones((8, 8, 1)), cfg.block_size)[:, 0]
    vg = t_fit.make_chunked_value_and_grad(scene, cfg, o, d, tgt, chunk=32,
                                           weights=w)
    l_c, g_c = vg(t_fit.get_params(scene, NAMES))
    np.testing.assert_allclose(float(l_c) / 255.0 ** 2, float(loss.detach()),
                               rtol=1e-5)
    for k in NAMES:
        g = leaves[k].grad
        assert torch.isfinite(g).all() and g.abs().max() > 0, k
        np.testing.assert_allclose(g_c[k].numpy() / 255.0 ** 2, g.numpy(),
                                   rtol=1e-4, atol=1e-9, err_msg=k)


def test_composed_fit_matches_jax():
    """The composed whole-image step (the CLI default, three_spheres)."""
    g = load("composed")
    scene, cam, cfg, target, init = fit_toy_inputs()
    np.testing.assert_allclose(target.numpy(), g["toy/target"], rtol=5e-4,
                               atol=5e-4)
    for k in NAMES:
        np.testing.assert_array_equal(init[k], g[f"toy/init/{k}"])
    res = t_fit.fit(scene, cam, cfg, torch.from_numpy(g["toy/target"]),
                    t_fit.FitConfig(steps=3, **TOY_FCFG),
                    init_params={k: torch.from_numpy(v)
                                 for k, v in init.items()})
    assert res.step == 3 and res.live_prefix is None
    np.testing.assert_allclose(res.losses, g["toy/losses"], rtol=1e-4)
    assert res.losses[-1] < res.losses[0]
    for k in NAMES:
        np.testing.assert_allclose(res.params[k].numpy(), g[f"toy/final/{k}"],
                                   err_msg=k, **P_TOL)


def test_composed_fit_chunked_equals_whole():
    """``rcfg.ray_chunk`` takes the chunked branch (per-chunk backward,
    weighted mean over the image's lanes); it is the whole-image step."""
    scene, cam, cfg, target, init = fit_toy_inputs()
    init = {k: torch.from_numpy(v) for k, v in init.items()}
    fcfg = t_fit.FitConfig(steps=2, **TOY_FCFG)
    whole = t_fit.fit(scene, cam, cfg, target, fcfg, init_params=init)
    chunked = t_fit.fit(scene, cam, cfg.with_(ray_chunk=96, remat=True),
                        target, fcfg, init_params=init)
    np.testing.assert_allclose(chunked.losses, whole.losses, rtol=1e-4)
    for k in NAMES:
        np.testing.assert_allclose(chunked.params[k].numpy(),
                                   whole.params[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_mesh_verts_fit_lowers_loss():
    """``mesh_verts`` through ``bind_verts`` on the composed path
    (tests/test_mesh_grad.py's scene, BVH padded 0.5): a dented face
    pulled back lowers the loss."""
    from torch_goldens import MESH_CFG
    from torch_parity import mesh_grad_scene
    from unity_raytracer_tpu_torch.models import camera, meshgen, scene
    from unity_raytracer_tpu_torch.ops import bvh as t_bvh
    from unity_raytracer_tpu_torch.ops.render import render
    from unity_raytracer_tpu_torch.utils.config import DiffConfig
    sc, cam = mesh_grad_scene(scene, meshgen, camera, device="cpu")
    cfg = MESH_CFG.with_(bvh_pad=0.5)
    bvh = t_bvh.prepare_bvh(sc, cfg)
    target = render(sc, cam, cfg, bvh=bvh)
    v = sc.meshes.verts.clone()
    nrm = sc.meshes.normals
    face = int(torch.argmax(-nrm[:, 2]))  # the face looking at the camera
    v[face, 0] += 0.35 * nrm[face]
    res = t_fit.fit(sc, cam, cfg.with_(diff=DiffConfig()), target,
                    t_fit.FitConfig(param_names=("mesh_verts",),
                                    learning_rate=0.01, steps=8,
                                    log_every=0),
                    init_params={"mesh_verts": v}, bvh=bvh)
    assert res.losses[-1] < res.losses[0] * 0.9, res.losses


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "unity_raytracer_tpu_torch", *args],
        capture_output=True, text=True, timeout=600)


def test_cli_fit_prints_json(tmp_path):
    _cli_fit(tmp_path, "--preset", "mesh10k", "--replay")


@pytest.mark.parametrize("preset", ["three_spheres", "mesh10k",
                                    "cornell_box"])
def test_cli_fit_composed_prints_json(tmp_path, preset):
    """Without --replay: the composed toy (the default preset), the
    composed chunked/remat fit of a BVH preset, and of the dielectric
    tree."""
    _cli_fit(tmp_path, "--preset", preset)


def _cli_fit(tmp_path, *args):
    proc = _cli("fit", *args, "--size", "8", "--steps", "2", "--device",
                "cpu", "--out-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out) == ["center_err", "final_loss", "loss_ratio"]
    assert all(np.isfinite(v) for v in out.values())
    for name in ("target.png", "recovered.png"):
        assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"


@pytest.mark.parametrize("args", [
    ("--preset", "cornell_box", "--replay")])
def test_cli_fit_off_slice_raises(args):
    """The record-replay fit needs the mirror chain: on the dielectric
    tree the CLI fails with the twin's ValueError (fit.py:242-245)."""
    proc = _cli("fit", *args, "--size", "8", "--steps", "1", "--device",
                "cpu")
    assert proc.returncode != 0
    assert "ValueError" in proc.stderr and "mode='scan'" in proc.stderr


def test_cli_without_card_refuses():
    """The CLI runs on the card by default and never falls back to the
    CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    proc = _cli("render", "--preset", "mesh10k", "--width", "8",
                "--height", "8")
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
