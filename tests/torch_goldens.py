"""Frozen JAX references for the port's replay and fit parity tests.

    python tests/torch_goldens.py

rewrites ``tests/goldens/torch/replay.npz`` and ``fit.npz`` from the JAX
package, on tests/test_replay.py's scene (``torch_parity.replay_scene``)
at 16x16 through ``torch_parity.CAMERA``:

* ``replay.npz``: the rays; the hard and soft records of JAX
  ``trace_records`` (Pallas interpreter) and their radiance; the eager JAX
  replay radiance, MSE against radiance x 0.9 and the gradients of
  ``NAMES`` on those records, hard and soft; the soft replay's diagnostic
  counts; ``live_depth``;
* ``fit.npz``: a 3-step JAX ``fit(use_replay=True)`` from ``fit_inputs``'
  seeded start and target image — its losses and final parameters, and
  its checkpoint after step 2 (parameters and optax's Adam count and
  moments).

Computing these live costs ~80 s of CPU per test run, so
tests/test_torch_replay.py and tests/test_torch_fit.py load them. The
constants below are those tests' recipe: change one, rerun the script.
Nothing here imports JAX until the script runs.
"""

import pathlib
import sys
import tempfile

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: the repo root is not on sys.path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from torch_parity import CAMERA, replay_scene  # noqa: E402
from unity_raytracer_tpu_torch.utils.config import (  # noqa: E402
    DiffConfig, RenderConfig)

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "goldens" / "torch"
SIZE = 16
CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", block_size=16, tile_r=256,
                   bvh_leaf=14, tri_isect="bw", fuse_shadows=False,
                   occ_mode="pack", stale_prune=False, kernel="mega")
SOFT = DiffConfig(soft_shadow_temp=1.0, soft_hit_temp=0.1,
                  straight_through=True)
# the nine parameter classes of tests/test_replay.py:86-88
NAMES = ("sphere_centers", "sphere_radius_sq", "sphere_diffuse",
         "sphere_specular", "sphere_mirror", "tri_verts", "tri_diffuse",
         "light_positions", "light_intensities")
FIT_NAMES = ("sphere_centers", "sphere_diffuse")
FCFG = dict(param_names=FIT_NAMES, learning_rate=0.02, soft_shadow_temp=1.0,
            soft_hit_temp=0.1, log_every=0, use_replay=True)
FIT_SEED = 7


def load(name: str) -> dict:
    with np.load(GOLDEN_DIR / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def fit_inputs():
    """The port's side of the fit: scene, camera, BVH, target image (the
    port's render at the true parameters) and the seeded perturbed
    start, all on the CPU."""
    from unity_raytracer_tpu_torch import fit as t_fit
    from unity_raytracer_tpu_torch.models import meshgen, scene as t_scene
    from unity_raytracer_tpu_torch.models.camera import Camera
    from unity_raytracer_tpu_torch.ops import bvh as t_bvh
    from unity_raytracer_tpu_torch.ops.render import render

    scene = replay_scene(t_scene, meshgen, device="cpu")
    cam = Camera.make(width=SIZE, height=SIZE, device="cpu", **CAMERA)
    packed = t_bvh.prepare_bvh(scene, CFG)
    target = render(scene, cam, CFG, bvh=packed)
    rng = np.random.default_rng(FIT_SEED)
    true_p = t_fit.get_params(scene, FIT_NAMES)
    noise = lambda lo, hi: torch.from_numpy(
        rng.uniform(lo, hi, (2, 3)).astype(np.float32))
    init = {"sphere_centers": true_p["sphere_centers"] + noise(-0.4, 0.4),
            "sphere_diffuse": torch.clamp(
                true_p["sphere_diffuse"] + noise(-0.2, 0.2), 0.0, 1.0)}
    return scene, cam, packed, target, init


def _replay_arrays() -> dict:
    import jax
    import jax.numpy as jnp
    from unity_raytracer_tpu import fit as j_fit
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops import replay as j_rp

    js = replay_scene(scene, meshgen)
    jc = camera.Camera.make(width=SIZE, height=SIZE, **CAMERA)
    jp = j_bvh.prepare_bvh(js, CFG)
    o, d = camera.generate_rays_blocks(jc, CFG.block_size)
    out = {"o": np.asarray(o), "d": np.asarray(d)}
    for kind, soft in (("hard", False), ("soft", True)):
        acc, recs = j_rp.trace_records(js, o, d, CFG, jp, soft=soft)
        out[f"{kind}_acc"] = np.asarray(acc)
        for i, r in enumerate(recs):
            out[f"{kind}_rec{i}"] = np.asarray(r)
        cfg = CFG.with_(diff=SOFT) if soft else CFG
        fn = j_rp.replay_radiance_soft if soft else j_rp.replay_radiance
        rad = fn(js, o, d, recs, cfg)
        target = jax.lax.stop_gradient(rad) * 0.9

        def loss(p):
            return jnp.mean((fn(j_fit.set_params(js, p), o, d, recs, cfg)
                             - target) ** 2)

        # eager: jit's reassociation alone moves the mirror sphere's
        # gradient by ~1% on this scene (phong-200 highlights); the port
        # follows the eager op order
        val, grads = jax.value_and_grad(loss)(j_fit.get_params(js, NAMES))
        out[f"{kind}_rad"] = np.asarray(rad)
        out[f"{kind}_target"] = np.asarray(target)
        out[f"{kind}_loss"] = np.asarray(val)
        for k, g in grads.items():
            out[f"{kind}_grad/{k}"] = np.asarray(g)
        if soft:
            _, diag = j_rp.replay_radiance_soft(js, o, d, recs, cfg,
                                                with_diag=True)
            for k, v in diag.items():
                out[f"bias/{k}"] = np.asarray(v)
        else:
            out["live_depth"] = np.asarray(j_rp.live_depth(recs))
    return out


def _fit_arrays() -> dict:
    import jax.numpy as jnp
    from unity_raytracer_tpu import fit as j_fit
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.utils import checkpoint as j_ckpt

    _, _, _, target, init = fit_inputs()
    js = replay_scene(scene, meshgen)
    jc = camera.Camera.make(width=SIZE, height=SIZE, **CAMERA)
    jp = j_bvh.prepare_bvh(js, CFG)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "fit.npz"
        res = j_fit.fit(js, jc, CFG, jnp.asarray(target.numpy()),
                        j_fit.FitConfig(steps=3, checkpoint_every=2,
                                        checkpoint_path=str(path), **FCFG),
                        init_params={k: jnp.asarray(v.numpy())
                                     for k, v in init.items()}, bvh=jp)
        step, params, opt_state, _, _ = j_ckpt.load_checkpoint(path)
    adam = opt_state[0]  # optax.adam = chain(scale_by_adam, scale)
    out = {"losses": np.asarray(res.losses), "step2": np.asarray(step),
           "adam_count": np.asarray(adam.count),
           "target": target.numpy()}
    for k in FIT_NAMES:
        out[f"init/{k}"] = init[k].numpy()
        out[f"final/{k}"] = np.asarray(res.params[k])
        out[f"step2/{k}"] = np.asarray(params[k])
        out[f"mu/{k}"] = np.asarray(adam.mu[k])
        out[f"nu/{k}"] = np.asarray(adam.nu[k])
    return out


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    for name, make in (("replay", _replay_arrays), ("fit", _fit_arrays)):
        np.savez_compressed(GOLDEN_DIR / f"{name}.npz", **make())
        print(GOLDEN_DIR / f"{name}.npz")


if __name__ == "__main__":
    main()
