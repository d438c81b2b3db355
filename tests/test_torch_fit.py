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
* the ``fit`` CLI.

The target image is the port's render at the true parameters; the
frozen file holds the one JAX was given, and the test checks they agree.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_goldens import CFG, FCFG, FIT_NAMES as NAMES, fit_inputs, load
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


def test_composed_path_raises(port):
    scene, cam, packed, target, init = port
    with pytest.raises(NotImplementedError, match="#10 in ROADMAP"):
        t_fit.fit(scene, cam, CFG, target,
                  t_fit.FitConfig(steps=1, **dict(FCFG, use_replay=False)),
                  bvh=packed)
    for fn in (t_fit.make_loss_fn, t_fit.make_chunked_value_and_grad):
        with pytest.raises(NotImplementedError, match="#10 in ROADMAP"):
            fn(scene, cam, CFG, target)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "unity_raytracer_tpu_torch", *args],
        capture_output=True, text=True, timeout=600)


def test_cli_fit_prints_json(tmp_path):
    proc = _cli("fit", "--preset", "mesh10k", "--replay", "--size", "8",
                "--steps", "2", "--device", "cpu", "--out-dir",
                str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out) == ["center_err", "final_loss", "loss_ratio"]
    assert all(np.isfinite(v) for v in out.values())
    for name in ("target.png", "recovered.png"):
        assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"


@pytest.mark.parametrize("args", [
    ("--preset", "three_spheres", "--replay"),
    ("--preset", "mesh10k")])
def test_cli_fit_off_slice_raises(args):
    proc = _cli("fit", *args, "--size", "8", "--steps", "1", "--device",
                "cpu")
    assert proc.returncode != 0
    assert "NotImplementedError" in proc.stderr and "#10" in proc.stderr


def test_cli_without_card_refuses():
    """The CLI runs on the card by default and never falls back to the
    CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    proc = _cli("render", "--preset", "mesh10k", "--width", "8",
                "--height", "8")
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
