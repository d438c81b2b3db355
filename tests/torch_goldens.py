"""Frozen JAX references for the port's replay and fit parity tests.

    python tests/torch_goldens.py [replay] [fit] [composed] [tree] [parallel]
                                  [light_cull]

rewrites (all six, or the ones named) ``tests/goldens/torch/replay.npz``,
``fit.npz``, ``composed.npz``, ``tree.npz``, ``parallel.npz`` and
``light_cull.npz`` from the JAX package. The first two are on
tests/test_replay.py's scene (``torch_parity.replay_scene``) at 16x16
through ``torch_parity.CAMERA``:

* ``replay.npz``: the rays; the hard and soft records of JAX
  ``trace_records`` (Pallas interpreter) and their radiance; the eager JAX
  replay radiance, MSE against radiance x 0.9 and the gradients of
  ``NAMES`` on those records, hard and soft; the soft replay's diagnostic
  counts; ``live_depth``;
* ``light_cull.npz``: ``replay.npz``'s hard and soft records and
  radiance with ``cfg.light_cull`` at each of ``LIGHT_CULLS``, and the
  eager replay radiance, MSE and gradients of ``NAMES`` at
  ``LIGHT_CULLS[0]``, hard and soft, keys prefixed ``lc<value>/``;
* ``fit.npz``: a 3-step JAX ``fit(use_replay=True)`` from ``fit_inputs``'
  seeded start and target image — its losses and final parameters, and
  its checkpoint after step 2 (parameters and optax's Adam count and
  moments);
* ``composed.npz``: eager ``jax.grad`` of the composed path (the
  reference tests/test_torch_grad.py holds the port's autograd to) on
  tests/test_grad.py's scenes — ``three_spheres`` at 16x16 with 0 and 1
  bounces, the specular probe, and test_grad_chunked.py's soft 24x24
  loss — and on test_mesh_grad.py's mesh-vertex scene (``bind_verts``);
  and a 3-step composed JAX ``fit`` of the CLI's ``three_spheres`` toy
  from ``fit_toy_inputs``' seeded start;
* ``tree.npz``: the dielectric tree on ``cornell_box`` — JAX ``render``
  at 24x24 (the composed ``_trace_tree``) and its ``n_truncated``; the
  twin's fused tree (``_trace_tree_mega``, Pallas interpreter) at 24x24
  for depths 1, 2 and 4; ``trace_radiance_tree_stats`` on
  ``truncating_tree`` (the count of live lanes ``tree_cap=1`` drops); and
  eager ``jax.grad`` of the mean 12x12 image for ``TREE_NAMES``;
* ``parallel.npz``: the twin's sharded functions (``parallel/shard.py``)
  on the cases of ``torch_parallel_cases.CASES``, on meshes of 4 and 2
  of 4 fake CPU devices (``_parallel_arrays``), and the SHA-256 of each
  file of ``PARALLEL_SOURCES`` and of ``_parallel_arrays``' own source
  (``parallel_source_hashes``), which tests/test_torch_parallel.py checks
  so that a change to the recipe or to the twin's ``parallel/`` without a
  rerun fails.

Computing these live costs ~80 s (replay, fit), ~95 s (composed) and
~100 s (tree) and ~150 s (parallel) of CPU per test run, so
tests/test_torch_replay.py (``replay``, ``light_cull``), tests/test_torch_fit.py,
tests/test_torch_grad.py, tests/test_torch_tree.py and
tests/test_torch_parallel.py load them. The constants below are those
tests' recipe: change one, rerun the script. Nothing here imports JAX
until the script runs.
"""

import hashlib
import inspect
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
# light_cull values the replay tests run (ROADMAP Queue C's coverage gap;
# tests/test_torch_composed.py runs its composed frames at both)
LIGHT_CULLS = (3.0, 20.0)
FIT_NAMES = ("sphere_centers", "sphere_diffuse")
FCFG = dict(param_names=FIT_NAMES, learning_rate=0.02, soft_shadow_temp=1.0,
            soft_hit_temp=0.1, log_every=0, use_replay=True)
FIT_SEED = 7
# the composed gradients (tests/test_grad.py's classes) and fit
GRAD_NAMES = ("sphere_centers", "sphere_radius_sq", "tri_verts",
              "sphere_diffuse", "sphere_specular", "sphere_mirror",
              "light_intensities", "light_positions")
CHUNK_NAMES = ("sphere_centers", "sphere_diffuse", "light_intensities")
CHUNK_SOFT = dict(soft_shadow_temp=1.0, soft_hit_temp=0.05,
                  straight_through=True)
MESH_CFG = RenderConfig(max_bounces=1, background=(0.04, 0.05, 0.07),
                        use_bvh=True, mode="scan", kernel="xla",
                        block_size=8, bvh_pad=0.2)
TOY_SIZE = 16
# the tree (cornell_box): image size, the fused tree's depths, the
# gradient's image size and classes, tests/test_tree_mega.py's lane order
TREE_SIZE = 24
TREE_DEPTHS = (1, 2, 4)
TREE_GRAD_SIZE = 12
TREE_NAMES = ("sphere_centers", "sphere_diffuse", "light_intensities")
TREE_BLOCK = dict(block_size=8, tile_r=64)
TRUNC_SIZE = 16
TOY_FCFG = dict(param_names=FIT_NAMES, learning_rate=0.02,
                soft_shadow_temp=1.0, soft_hit_temp=0.1, log_every=0)
# what parallel.npz is computed from, relative to the repo root
PARALLEL_SOURCES = ("tests/torch_parallel_cases.py",
                    "unity_raytracer_tpu/parallel/shard.py",
                    "unity_raytracer_tpu/parallel/collectives.py",
                    "unity_raytracer_tpu/parallel/mesh.py")


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


def grad_scene(pkg: str, which: str):
    """``(scene, cam, cfg)`` of one composed-gradient case, from package
    ``pkg`` ('jax' or 'torch', on the CPU): ``mb0`` / ``mb1``
    three_spheres at 16x16 with 0 / 1 bounces, ``spec`` the specular
    probe, ``soft`` test_grad_chunked.py's 24x24 soft-visibility setup."""
    import importlib
    root = "unity_raytracer_tpu" if pkg == "jax" else \
        "unity_raytracer_tpu_torch"
    mod = lambda m: importlib.import_module(f"{root}.{m}")
    kw = {} if pkg == "jax" else dict(device="cpu")
    presets, config = mod("models.presets"), mod("utils.config")
    if which == "spec":
        from torch_parity import specular_probe
        scene, cam = specular_probe(mod("models.scene"),
                                    mod("models.camera"), **kw)
        cfg = config.RenderConfig(max_bounces=0)
    elif which == "soft":
        scene, cam, cfg = presets.three_spheres(width=24, height=24, **kw)
        cfg = cfg.with_(max_bounces=1, block_size=8,
                        diff=config.DiffConfig(**CHUNK_SOFT))
    else:
        scene, cam, cfg = presets.three_spheres(width=16, height=16, **kw)
        cfg = cfg.with_(max_bounces=int(which[2]))
    return scene, cam, cfg.with_(mode="scan")


def fit_toy_inputs(pkg: str = "torch"):
    """The CLI's three_spheres toy fit at TOY_SIZE (``__main__.fit_setup``)
    and its seeded start (``run_fit``'s perturbation, seed 0), from
    package ``pkg``: ``(scene, cam, cfg, target, init)``."""
    if pkg == "torch":
        from unity_raytracer_tpu_torch.__main__ import fit_setup
        scene, cam, cfg, _, target, _ = fit_setup(
            "three_spheres", TOY_SIZE, TOY_SIZE, False, "cpu")
    else:
        from unity_raytracer_tpu.models.camera import Camera
        from unity_raytracer_tpu.models.presets import three_spheres
        from unity_raytracer_tpu.ops.render import render, resolve_mode
        scene, _, cfg = three_spheres(width=TOY_SIZE, height=TOY_SIZE)
        cfg = resolve_mode(scene, cfg.with_(max_bounces=0))
        cam = Camera.from_fov(position=(0, 5, 6), look_at=(0, 2.5, 26),
                              fov_y_deg=40.0, width=TOY_SIZE,
                              height=TOY_SIZE)
        target = render(scene, cam, cfg)
    rng = np.random.default_rng(0)
    c = np.asarray(scene.spheres.centers, np.float32)
    kd = np.asarray(scene.spheres.materials.diffuse, np.float32)
    init = {"sphere_centers": c + rng.uniform(-0.4, 0.4, c.shape)
            .astype(np.float32),
            "sphere_diffuse": np.clip(kd + rng.uniform(-0.2, 0.2, kd.shape)
                                      .astype(np.float32), 0.0, 1.0)}
    return scene, cam, cfg, target, init


def truncating_tree(pkg: str):
    """``(scene, cam, cfg)``: ``cornell_box`` at ``TRUNC_SIZE`` with its
    glass sphere grown to fill most of the view, from package ``pkg``
    ('jax' or 'torch', on the CPU): most primary rays fork into two live
    children, more than ``tree_cap=1`` keeps (~360 live lanes for 256
    rays)."""
    import importlib
    root = "unity_raytracer_tpu" if pkg == "jax" else \
        "unity_raytracer_tpu_torch"
    presets = importlib.import_module(f"{root}.models.presets")
    fit = importlib.import_module(f"{root}.fit")
    kw = {} if pkg == "jax" else dict(device="cpu")
    scene, cam, cfg = presets.cornell_box(width=TRUNC_SIZE,
                                          height=TRUNC_SIZE, **kw)
    c = np.array([[-4.0, 4.0, 13.0], [0.0, 10.0, 6.0]], np.float32)
    r2 = np.array([16.0, 49.0], np.float32)
    conv = (lambda x: x) if pkg == "jax" else torch.from_numpy
    scene = fit.set_params(scene, {"sphere_centers": conv(c),
                                   "sphere_radius_sq": conv(r2)})
    # one block per frame: no pad lanes, so the cap is 1 x the pixels
    return scene, cam, cfg.with_(block_size=TRUNC_SIZE)


def _tree_arrays() -> dict:
    import jax
    import jax.numpy as jnp
    from unity_raytracer_tpu import fit as j_fit
    from unity_raytracer_tpu.models.camera import generate_rays_blocks
    from unity_raytracer_tpu.models.presets import cornell_box
    from unity_raytracer_tpu.ops.render import (
        render, trace_radiance, trace_radiance_tree_stats)

    out = {}
    scene, cam, cfg = cornell_box(width=TREE_SIZE, height=TREE_SIZE)
    out["render"] = np.asarray(render(scene, cam, cfg))
    tcfg = cfg.with_(mode="tree", **TREE_BLOCK)
    o, d = generate_rays_blocks(cam, tcfg.block_size)
    for depth in TREE_DEPTHS:
        c = tcfg.with_(max_bounces=depth)
        _, trunc = trace_radiance_tree_stats(scene, o, d, c)
        out[f"composed_truncated/{depth}"] = np.asarray(trunc)
        out[f"fused/{depth}"] = np.asarray(trace_radiance(
            scene, o, d, c.with_(kernel="mega"), bvh=None))
    ts, tc, tcfg = truncating_tree("jax")
    to, td = generate_rays_blocks(tc, tcfg.block_size)
    rad, trunc = trace_radiance_tree_stats(ts, to, td,
                                           tcfg.with_(mode="tree"))
    out["trunc/rad"] = np.asarray(rad)
    out["trunc/count"] = np.asarray(trunc)
    gs, gc, gcfg = cornell_box(width=TREE_GRAD_SIZE, height=TREE_GRAD_SIZE)

    def loss(p):
        return jnp.mean(render(j_fit.set_params(gs, p), gc, gcfg))

    with jax.disable_jit():  # eager: the port follows its op order
        val, grads = jax.value_and_grad(loss)(j_fit.get_params(gs,
                                                               TREE_NAMES))
    out["grad/loss"] = np.asarray(val)
    for k, g in grads.items():
        out[f"grad/{k}"] = np.asarray(g)
    return out


def _composed_arrays() -> dict:
    import jax
    import jax.numpy as jnp
    from unity_raytracer_tpu import fit as j_fit
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.render import render, trace_radiance
    from torch_parity import mesh_grad_scene

    out = {}
    for which in ("mb0", "mb1", "spec"):
        js, jc, cfg = grad_scene("jax", which)
        names = ("sphere_specular",) if which == "spec" else GRAD_NAMES

        def loss(p):
            return jnp.mean(render(j_fit.set_params(js, p), jc, cfg))

        with jax.disable_jit():  # eager: the port follows its op order
            val, grads = jax.value_and_grad(loss)(j_fit.get_params(js,
                                                                   names))
        out[f"{which}/loss"] = np.asarray(val)
        for k, g in grads.items():
            out[f"{which}/grad/{k}"] = np.asarray(g)

    js, jc, cfg = grad_scene("jax", "soft")
    o, d = camera.generate_rays_blocks(jc, cfg.block_size)
    target = trace_radiance(js, o, d, cfg) * 0.85
    out["soft/target"] = np.asarray(target)

    def loss(p):
        rad = trace_radiance(j_fit.set_params(js, p), o, d, cfg)
        return jnp.mean((rad - target) ** 2)

    with jax.disable_jit():
        val, grads = jax.value_and_grad(loss)(j_fit.get_params(js,
                                                               CHUNK_NAMES))
    out["soft/loss"] = np.asarray(val)
    for k, g in grads.items():
        out[f"soft/grad/{k}"] = np.asarray(g)

    ms, mc = mesh_grad_scene(scene, meshgen, camera)
    bvh = j_bvh.prepare_bvh(ms, MESH_CFG)
    o, d = camera.generate_rays_blocks(mc, MESH_CFG.block_size)

    def mesh_loss(verts):
        import dataclasses
        s = dataclasses.replace(
            ms, meshes=dataclasses.replace(ms.meshes, verts=verts))
        rad = trace_radiance(s, o, d, MESH_CFG, bvh=j_bvh.bind_verts(bvh, s))
        return jnp.mean(rad)

    with jax.disable_jit():
        val, g = jax.value_and_grad(mesh_loss)(ms.meshes.verts)
    out["mesh/loss"] = np.asarray(val)
    out["mesh/grad"] = np.asarray(g)

    ts, tc, tcfg, target, init = fit_toy_inputs("jax")
    res = j_fit.fit(ts, tc, tcfg, target,
                    j_fit.FitConfig(steps=3, **TOY_FCFG),
                    init_params={k: jnp.asarray(v) for k, v in init.items()})
    out["toy/target"] = np.asarray(target)
    out["toy/losses"] = np.asarray(res.losses)
    for k in FIT_NAMES:
        out[f"toy/init/{k}"] = init[k]
        out[f"toy/final/{k}"] = np.asarray(res.params[k])
    return out


def _replay_arrays(base=CFG, grads=True, diag=True) -> dict:
    """``replay.npz`` on config ``base``; ``grads=False`` keeps the
    records and their radiance only, ``diag=False`` drops the soft
    replay's counts and ``live_depth``."""
    import jax
    import jax.numpy as jnp
    from unity_raytracer_tpu import fit as j_fit
    from unity_raytracer_tpu.models import camera, meshgen, scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops import replay as j_rp

    js = replay_scene(scene, meshgen)
    jc = camera.Camera.make(width=SIZE, height=SIZE, **CAMERA)
    jp = j_bvh.prepare_bvh(js, base)
    o, d = camera.generate_rays_blocks(jc, base.block_size)
    out = {"o": np.asarray(o), "d": np.asarray(d)}
    for kind, soft in (("hard", False), ("soft", True)):
        acc, recs = j_rp.trace_records(js, o, d, base, jp, soft=soft)
        out[f"{kind}_acc"] = np.asarray(acc)
        for i, r in enumerate(recs):
            out[f"{kind}_rec{i}"] = np.asarray(r)
        if not grads:
            continue
        cfg = base.with_(diff=SOFT) if soft else base
        fn = j_rp.replay_radiance_soft if soft else j_rp.replay_radiance
        rad = fn(js, o, d, recs, cfg)
        target = jax.lax.stop_gradient(rad) * 0.9

        def loss(p):
            return jnp.mean((fn(j_fit.set_params(js, p), o, d, recs, cfg)
                             - target) ** 2)

        # eager: jit's reassociation alone moves the mirror sphere's
        # gradient by ~1% on this scene (phong-200 highlights); the port
        # follows the eager op order
        val, g_all = jax.value_and_grad(loss)(j_fit.get_params(js, NAMES))
        out[f"{kind}_rad"] = np.asarray(rad)
        out[f"{kind}_target"] = np.asarray(target)
        out[f"{kind}_loss"] = np.asarray(val)
        for k, g in g_all.items():
            out[f"{kind}_grad/{k}"] = np.asarray(g)
        if not diag:
            continue
        if soft:
            _, counts = j_rp.replay_radiance_soft(js, o, d, recs, cfg,
                                                  with_diag=True)
            for k, v in counts.items():
                out[f"bias/{k}"] = np.asarray(v)
        else:
            out["live_depth"] = np.asarray(j_rp.live_depth(recs))
    return out


def _light_cull_arrays() -> dict:
    out = {}
    for i, lc in enumerate(LIGHT_CULLS):
        arrays = _replay_arrays(CFG.with_(light_cull=lc), grads=i == 0,
                                diag=False)
        out.update({f"lc{lc:g}/{k}": v for k, v in arrays.items()})
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


def parallel_source_hashes() -> dict:
    """``{"sources/<path>": SHA-256 hex}`` of each of ``PARALLEL_SOURCES``
    and of ``_parallel_arrays``' source (key
    ``sources/tests/torch_goldens.py:_parallel_arrays``)."""
    root = GOLDEN_DIR.parents[2]
    sha = lambda b: hashlib.sha256(b).hexdigest()
    out = {f"sources/{p}": sha((root / p).read_bytes())
           for p in PARALLEL_SOURCES}
    out["sources/tests/torch_goldens.py:_parallel_arrays"] = sha(
        inspect.getsource(_parallel_arrays).encode())
    return out


def _parallel_arrays() -> dict:
    """The twin's ``shard_map`` functions on the cases of
    ``torch_parallel_cases.CASES``, each on ``make_mesh(shape,
    devices=jax.devices()[:world])``; keys ``world/shape/case/field``,
    and ``parallel_source_hashes``."""
    import jax
    import jax.numpy as jnp
    import optax
    from torch_parallel_cases import (CASES, FIT_LR, FIT_STEPS, SWAP_ROWS,
                                      TRAIN_LR, inputs, shape_key,
                                      start_params)
    from unity_raytracer_tpu.models.camera import generate_rays
    from unity_raytracer_tpu.ops.render import render
    from unity_raytracer_tpu.parallel import mesh as meshmod
    from unity_raytracer_tpu.parallel import shard as shardmod

    hit = lambda h: {k: getattr(h, k) for k in ("t", "kind", "index",
                                                "mesh_index", "mesh_n")}
    out = {}
    for world, meshes in CASES.items():
        for shape, cases in meshes.items():
            mesh = meshmod.make_mesh(shape, devices=jax.devices()[:world])
            for case in cases:
                if case in ("combine", "mesh_error", "placed"):
                    continue  # nothing of the twin's to hold them to
                if case == "swap":
                    x = jnp.arange(SWAP_ROWS * 3,
                                   dtype=jnp.float32).reshape(-1, 3)
                    res = {"y": shardmod.swap_shard_axes(x, mesh, "dp",
                                                         "tp")}
                else:
                    scene, cam, cfg, bvh = inputs("jax", case)
                    o, d = generate_rays(cam)
                    if case in ("tiled", "tiled_bvh", "tiled_pallas",
                                "tiled_mega", "tiled_tiny"):
                        res = {"img": shardmod.render_tiled(
                            scene, cam, cfg, mesh, bvh=bvh)}
                    elif case == "auto":
                        res = {"img": shardmod.render_auto(scene, cam, cfg,
                                                           mesh)}
                    elif case in ("ssh", "ssh_padded"):
                        res = hit(shardmod.scene_sharded_hit(scene, o, d,
                                                             mesh))
                    elif case in ("ssh_bvh", "ssh_bvh_meshes"):
                        sb = shardmod.build_shard_bvhs(scene, shape[1])
                        res = hit(shardmod.scene_sharded_hit_bvh(
                            scene, o, d, mesh, sb))
                    elif case == "ring":
                        t, i = shardmod.nearest_mesh_hit_ring(scene, o, d,
                                                              mesh)
                        res = {"t": t, "i": i}
                    elif case == "ring_hit":
                        res = hit(shardmod.nearest_hit_ring(scene, o, d,
                                                            mesh))
                    else:  # train, fit
                        tgt = render(scene, cam, cfg, bvh=bvh).reshape(-1, 3)
                        p = start_params("jax", case, scene)
                        tx = optax.adam(TRAIN_LR if case == "train"
                                        else FIT_LR)
                        step = shardmod.make_sharded_train_step(
                            scene, cam, cfg, tgt, mesh, tuple(p), tx,
                            bvh=bvh)
                        st, losses = tx.init(p), []
                        for _ in range(1 if case == "train" else FIT_STEPS):
                            p, st, loss = step(p, st, o, d, tgt)
                            losses.append(loss)
                        res = {"losses": jnp.stack(losses),
                               **{f"p/{k}": v for k, v in p.items()}}
                for k, v in res.items():
                    out[f"{world}/{shape_key(shape)}/{case}/{k}"] = \
                        np.asarray(v)
                print(world, shape, case, flush=True)
    out.update({k: np.array(v) for k, v in parallel_source_hashes().items()})
    return out


def main():
    which = sys.argv[1:] or ["replay", "fit", "composed", "tree",
                             "parallel", "light_cull"]
    if "parallel" in which:  # the twin's meshes: 4 fake CPU devices
        import os
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count"
                                   "=4")
    import jax
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    makers = {"replay": _replay_arrays, "fit": _fit_arrays,
              "composed": _composed_arrays, "tree": _tree_arrays,
              "parallel": _parallel_arrays,
              "light_cull": _light_cull_arrays}
    for name in which:
        np.savez_compressed(GOLDEN_DIR / f"{name}.npz", **makers[name]())
        print(GOLDEN_DIR / f"{name}.npz")


if __name__ == "__main__":
    main()
