"""PyTorch port: the record-replay training path against the JAX package.

On tests/test_replay.py's scene (two spheres, so sphere, loose-triangle
and mesh winners all occur) at 16x16, ``bvh_leaf=14``, ``max_bounces=2``,
against the JAX outputs frozen by ``tests/torch_goldens.py`` (JAX's
Pallas interpreter and eager autodiff, ``tests/goldens/torch/replay.npz``):

* the port's ``trace_records`` (plain segments on the CPU) against JAX's
  ``trace_records``, hard and soft: matid and occbits exactly, t sign
  exactly, t and n where t >= 0 and st where below _BIG at rtol = atol =
  5e-4, st exactly _BIG elsewhere;
* on JAX's records, the port's ``replay_radiance`` and
  ``replay_radiance_soft`` against JAX's: radiance at rtol = atol = 2e-4
  (tests/test_replay.py:75), the MSE at rtol 1e-4, and the gradients of
  all nine parameter classes of tests/test_replay.py:86-88 at rtol 5e-3,
  atol 5e-4 * max|g| (:106-109);
* the soft replay's bias counts, the chunked step, the live prefix;
* with ``light_cull`` (the per-light attenuation cull of the shadow
  queries) at 3 and 20 (``LIGHT_CULLS``, ``light_cull.npz``): the hard and
  soft records as above, and at 3 the replay radiance, MSE and the nine
  gradient classes at the same tolerances.

Nothing here imports JAX, so the ``gpu`` case also runs where only
PyTorch is installed (``pytest --noconftest -m gpu``).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_goldens import CFG, LIGHT_CULLS, NAMES, SIZE, SOFT, load
from torch_parity import CAMERA, cuda, record_bad_lanes, replay_scene
from unity_raytracer_tpu_torch.fit import get_params, set_params
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import replay as rp
from unity_raytracer_tpu_torch.utils.config import DiffConfig, RenderConfig

torch.set_num_threads(1)

RAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def jx():
    """JAX's side, frozen (tests/torch_goldens.py)."""
    return _golden_records(load("replay"))


def _golden_records(g, prefix=""):
    for kind in ("hard", "soft"):
        n = 5 if kind == "soft" else 4
        g[prefix + kind] = (g[f"{prefix}{kind}_acc"],
                            tuple(g[f"{prefix}{kind}_rec{i}"]
                                  for i in range(n)))
    return g


@pytest.fixture(scope="module")
def jx_lc():
    """JAX's records and replay with ``light_cull`` (light_cull.npz)."""
    g = load("light_cull")
    for lc in LIGHT_CULLS:
        _golden_records(g, f"lc{lc:g}/")
    return g


@pytest.fixture(scope="module")
def port():
    scene = replay_scene(t_scene, t_meshgen, device="cpu")
    cam = Camera.make(width=SIZE, height=SIZE, device="cpu", **CAMERA)
    o, d = generate_rays_blocks(cam, CFG.block_size)
    return scene, t_bvh.prepare_bvh(scene, CFG), o, d


def _check_records(jx, port, soft, cfg=CFG, prefix=""):
    """The port's trace_records on ``cfg`` against JAX's (keys under
    ``prefix``): the radiance at 5e-4 and 0 bad record lanes."""
    scene, packed, o, d = port
    np.testing.assert_array_equal(o.numpy(), jx[prefix + "o"])
    np.testing.assert_array_equal(d.numpy(), jx[prefix + "d"])
    acc, recs = rp.trace_records(scene, o, d, cfg, packed, soft=soft)
    want_acc, want = jx[prefix + ("soft" if soft else "hard")]
    np.testing.assert_allclose(acc.numpy(), want_acc, rtol=5e-4, atol=5e-4)
    assert len(recs) == len(want) == (5 if soft else 4)
    B, N = cfg.max_bounces + 1, o.shape[0]
    assert recs[0].shape == (B, N) and recs[1].shape == (B, N, 3)
    for s in range(B):
        bad = record_bad_lanes([r[s] for r in recs], [r[s] for r in want])
        assert not bad.any(), (s, np.nonzero(bad))
    assert not any(r.requires_grad for r in recs)  # facts, no gradient
    return recs


@pytest.mark.parametrize("soft", [False, True])
def test_trace_records_match_jax(jx, port, soft):
    recs = _check_records(jx, port, soft)
    # segment 0 holds winners of every kind and occluded lights
    scene = port[0]
    S, T = scene.spheres.count, scene.triangles.count
    m0 = recs[2][0].numpy()
    assert ((m0 >= 0) & (m0 < S)).any() and ((m0 >= S) & (m0 < S + T)).any()
    assert (m0 >= S + T).any() and (recs[3].numpy() > 0).any()


@pytest.mark.parametrize("lc", LIGHT_CULLS)
@pytest.mark.parametrize("soft", [False, True])
def test_trace_records_light_cull_match_jax(jx, jx_lc, port, soft, lc):
    """``light_cull`` > 0 skips the shadow query of a light whose
    attenuated contribution is below the cull, in the records pass
    (the fused kernel's plain version here) as in JAX's."""
    _check_records(jx_lc, port, soft, CFG.with_(light_cull=lc),
                   f"lc{lc:g}/")
    kind = "soft" if soft else "hard"
    assert not np.array_equal(jx_lc[f"lc{lc:g}/{kind}"][0], jx[kind][0])


@pytest.mark.parametrize("soft", [False, True])
def test_replay_value_and_grads_match_jax(jx, port, soft):
    """The replay on JAX's own records: radiance, MSE and the gradients
    of all nine parameter classes."""
    _check_replay(jx, port, soft)


@pytest.mark.parametrize("soft", [False, True])
def test_replay_light_cull_value_and_grads_match_jax(jx_lc, port, soft):
    """As test_replay_value_and_grads_match_jax, with ``light_cull`` at
    LIGHT_CULLS[0]."""
    lc = LIGHT_CULLS[0]
    _check_replay(jx_lc, port, soft, CFG.with_(light_cull=lc), f"lc{lc:g}/")


def _check_replay(jx, port, soft, base=CFG, prefix=""):
    scene, _, o, d = port
    cfg = base.with_(diff=SOFT) if soft else base
    kind = prefix + ("soft" if soft else "hard")
    rad_j, target = jx[f"{kind}_rad"], jx[f"{kind}_target"]
    loss_j = float(jx[f"{kind}_loss"])
    g_j = {k: jx[f"{kind}_grad/{k}"] for k in NAMES}
    fn = rp.replay_radiance_soft if soft else rp.replay_radiance
    recs = tuple(torch.from_numpy(r) for r in jx[kind][1])
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in get_params(scene, NAMES).items()}
    rad = fn(set_params(scene, params), o, d, recs, cfg)
    np.testing.assert_allclose(rad.detach().numpy(), rad_j, **RAD_TOL)
    assert rad_j.std() > 1.0
    loss = ((rad - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-4)
    for k in NAMES:
        a, b = params[k].grad.numpy(), g_j[k]
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=f"grad mismatch for {k}")
        if k in ("sphere_centers", "sphere_diffuse", "light_intensities"):
            assert np.abs(b).max() > 0, k


def test_soft_forward_equals_hard(port):
    """Straight-through: the soft replay's value is the hard image."""
    scene, packed, o, d = port
    hard = rp.trace_radiance_replay(scene, o, d, CFG, packed)
    soft = rp.trace_radiance_replay_soft(scene, o, d, CFG.with_(diff=SOFT),
                                         packed)
    np.testing.assert_allclose(soft.detach().numpy(), hard.detach().numpy(),
                               **RAD_TOL)


def test_soft_bias_counts_match_jax(jx, port, monkeypatch):
    """soft_replay_bias_counts against JAX's diagnostic replay (on
    JAX's records). JAX counts a lane as mesh-frozen when the recorded
    min occluder (over spheres, loose triangles and mesh) is below the
    recomputed sphere/loose one; where the nearest occluder IS a sphere
    the two are one distance computed twice, so rounding decides, and
    JAX's count must lie in the bracket of margin-free counts with the
    recorded distances nudged by +/-1e-4 relative. The port counts only
    where the record, moved ``rp.FROZEN_MARGIN`` (1e-4) farther, still
    wins: exactly the bracket's lower end, on every run. The other counts
    are exact."""
    scene, packed, o, d = port
    cfg = CFG.with_(diff=SOFT)
    got = rp.soft_replay_bias_counts(scene, o, d, cfg, packed)
    want = {k: int(jx[f"bias/{k}"]) for k in got}
    _, recs = rp.trace_records(scene, o, d, cfg, packed, soft=True)
    bracket = []
    assert rp.FROZEN_MARGIN == 1e-4
    with monkeypatch.context() as m:
        m.setattr(rp, "FROZEN_MARGIN", 0.0)
        for f in (1.0 - 1e-4, 1.0 + 1e-4):
            nudged = recs[:4] + (torch.where(recs[4] < 3.0e38, recs[4] * f,
                                             recs[4]),)
            bracket.append(rp.replay_radiance_soft(
                scene, o, d, nudged, cfg, with_diag=True)[1])
    lo, hi = bracket[1]["mesh_occ_frozen"], bracket[0]["mesh_occ_frozen"]
    assert got["mesh_occ_frozen"] == lo, (got, lo, hi)
    assert lo <= want["mesh_occ_frozen"] <= hi, (lo, want, hi)
    assert lo > 0  # the mesh does shadow this scene
    for k in ("mesh_occ_in_band", "proxy_mesh_risk"):
        assert got[k] == want[k], k
    assert want["proxy_mesh_risk"] > 0


def test_soft_chunked_matches_unchunked(port):
    """``chunk=`` back-propagates chunk by chunk into the same .grad; the
    loss and gradients equal the unchunked ones (128 divides the 256
    lanes, 100 leaves a padded chunk)."""
    scene, packed, o, d = port
    cfg = CFG.with_(diff=SOFT)
    names = ("sphere_centers", "sphere_diffuse", "light_intensities")
    params = get_params(scene, names)
    target = rp.trace_radiance_replay_soft(scene, o, d, cfg,
                                           packed).detach() * 0.9
    w = torch.ones(o.shape[0])
    w[::5] = 0.0
    l0, g0 = rp.soft_replay_value_and_grad(scene, params, o, d, target, cfg,
                                           packed, weights=w)
    for chunk in (128, 100):
        l1, g1 = rp.soft_replay_value_and_grad(
            scene, params, o, d, target, cfg, packed, weights=w,
            chunk=chunk)
        np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
        for k in names:
            np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
    assert all(not p.requires_grad and p.grad is None
               for p in params.values())  # the caller's tensors untouched


def test_live_prefix_exact(jx, port):
    """live_segments = live_depth(records) replays exactly what the full
    chain does, and so does one segment more."""
    scene, packed, o, d = port
    _, recs = rp.trace_records(scene, o, d, CFG, packed)
    k = rp.live_depth(recs)
    assert k == int(jx["live_depth"])
    assert 1 <= k < CFG.max_bounces + 1
    full = rp.replay_radiance(scene, o, d, recs, CFG)
    for n in (k, k + 1):
        torch.testing.assert_close(
            rp.replay_radiance(scene, o, d, recs, CFG, live_segments=n),
            full, rtol=0, atol=0)


def test_hard_value_and_grad_descends(port):
    """replay_value_and_grad returns (loss, grads) by name; a small step
    against the gradient lowers the loss."""
    scene, packed, o, d = port
    names = ("sphere_centers", "sphere_diffuse", "light_intensities")
    true_p = get_params(scene, names)
    target = rp.trace_radiance_replay(scene, o, d, CFG, packed).detach()
    params = {k: v + 0.05 if k != "light_intensities" else v * 1.1
              for k, v in true_p.items()}
    loss0, g = rp.replay_value_and_grad(scene, params, o, d, target, CFG,
                                        packed)
    assert sorted(g) == sorted(names)
    assert all(torch.isfinite(v).all() for v in g.values())
    step = {k: params[k] - 1e-3 * g[k] / g[k].abs().max() for k in names}
    loss1, _ = rp.replay_value_and_grad(scene, step, o, d, target, CFG,
                                        packed)
    assert float(loss1) < float(loss0)


def test_import_fit_and_replay_leave_jax_out():
    code = ("import sys\nbefore = set(sys.modules)\n"
            "import unity_raytracer_tpu_torch.fit\n"
            "import unity_raytracer_tpu_torch.ops.replay\n"
            "import unity_raytracer_tpu_torch.utils.checkpoint\n"
            "bad = sorted(m for m in set(sys.modules) - before "
            "if m == 'jax' or m.startswith('jax.') "
            "or m == 'unity_raytracer_tpu' "
            "or m.startswith('unity_raytracer_tpu.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.gpu
def test_value_and_grad_on_card_matches_cpu(cuda):
    """mesh10k 64x64, hard fwd+bwd: the card (record kernel) against the
    CPU (plain version)."""
    scene, cam, cfg = get_preset("mesh10k", width=64, height=64,
                                 device="cpu")
    names = ("sphere_centers", "sphere_diffuse", "light_intensities")
    out = []
    for dev in ("cpu", cuda):
        s, c = scene.to(dev), cam.to(dev)
        packed = t_bvh.prepare_bvh(s, cfg)
        o, d = generate_rays_blocks(c, cfg.block_size)
        target = rp.trace_radiance_replay(s, o, d, cfg, packed) * 0.9
        params = {k: v * 1.01 for k, v in get_params(s, names).items()}
        loss, g = rp.replay_value_and_grad(s, params, o, d, target, cfg,
                                           packed)
        out.append((float(loss), {k: v.cpu().numpy() for k, v in g.items()}))
    (l_cpu, g_cpu), (l_card, g_card) = out
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    for k in names:
        scale = max(np.abs(g_cpu[k]).max(), 1e-6)
        np.testing.assert_allclose(g_card[k], g_cpu[k], rtol=5e-3,
                                   atol=5e-4 * scale, err_msg=k)
