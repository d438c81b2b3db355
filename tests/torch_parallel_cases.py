"""The sharded cases of the port's parallel tests, shared by both sides.

``run_rank`` is what each spawned rank of a gloo group runs
(``parallel/bootstrap.launch``): every case of ``CASES`` for its world
size, on a CPU mesh of the case's shape, each rank's outputs saved to
``<out>/<world>/<shape>/<case>.rank<r>.npz``. ``inputs`` builds the same
scene, camera and config from the port or the JAX package, so
``tests/torch_goldens.py parallel`` can run the twin's ``shard_map``
functions on the same meshes. The cases mirror tests/test_parallel.py's.
Nothing here imports JAX unless asked for the JAX side.
"""

import pathlib

import numpy as np
import torch

# world size -> mesh shape -> cases run on that mesh
CASES = {
    4: {(4, 1): ("tiled", "auto", "tiled_bvh", "tiled_pallas", "tiled_mega",
                 "tiled_tiny", "ring", "ring_hit", "combine", "train", "fit",
                 "mesh_error"),
        (2, 2): ("tiled", "ssh", "ssh_bvh", "placed", "swap",
                 "ssh_bvh_meshes")},
    2: {(2, 1): ("tiled", "ring_hit", "train"),
        (1, 2): ("ssh", "ssh_bvh", "ssh_padded")},
}
SIZE = 16           # mesh_scene(100) and train-step frames
TOY = 32            # three_spheres frames of the render cases
FIT_STEPS = 3
TRAIN_LR, FIT_LR = 0.02, 0.03
SWAP_ROWS = 4 * 2 * 6


def shape_key(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _pkg(side: str):
    """The (presets, camera, render, bvh, fit) modules of one side."""
    import importlib
    root = "unity_raytracer_tpu" if side == "jax" else \
        "unity_raytracer_tpu_torch"
    return tuple(importlib.import_module(f"{root}.{m}") for m in (
        "models.presets", "models.camera", "ops.render", "ops.bvh", "fit"))


def inputs(side: str, case: str):
    """``(scene, cam, cfg, bvh)`` of a case on ``side`` ('torch' on the
    CPU, or 'jax')."""
    presets, camera, render, bvh_mod, _ = _pkg(side)
    kw = {} if side == "jax" else dict(device="cpu")
    if case in ("tiled", "auto", "tiled_tiny"):
        # tiled_tiny: 2 rays over dp = 4, two ranks trace only filler
        w, h = (2, 1) if case == "tiled_tiny" else (TOY, TOY)
        scene, cam, cfg = presets.three_spheres(width=w, height=h, **kw)
        return scene, cam, cfg, None
    if case == "train":
        scene, _, cfg = presets.three_spheres(width=SIZE, height=SIZE, **kw)
        cam = camera.Camera.from_fov(position=(0, 5, 6), look_at=(0, 2.5, 26),
                                     fov_y_deg=40.0, width=SIZE, height=SIZE,
                                     **kw)
        return scene, cam, render.resolve_mode(
            scene, cfg.with_(max_bounces=0)), None
    n_tris = 10240 if case == "ssh_bvh_meshes" else 100
    size = 8 if case == "ssh_bvh_meshes" else SIZE
    scene, cam, cfg = presets.mesh_scene(n_tris, width=size, height=size,
                                         **kw)
    change = {"tiled_bvh": dict(use_bvh=True, kernel="xla"),
              "tiled_pallas": dict(use_bvh=True, kernel="pallas",
                                   max_bounces=1),
              "tiled_mega": dict(use_bvh=True, kernel="mega", max_bounces=1,
                                 tile_r=32, block_size=4),
              "fit": dict(use_bvh=True, kernel="pallas",
                          max_bounces=1)}.get(case)
    if case == "ssh_padded":  # the second tp shard is all padding
        import dataclasses
        m = scene.meshes
        keep = np.arange(m.count) < m.count // 2
        valid = m.valid & (keep if side == "jax" else torch.from_numpy(keep))
        scene = dataclasses.replace(scene, meshes=dataclasses.replace(
            m, valid=valid))
    if change is None:
        return scene, cam, cfg, None
    cfg = render.resolve_mode(scene, cfg.with_(**change))
    return scene, cam, cfg, bvh_mod.prepare_bvh(scene, cfg)


def start_params(side: str, case: str, scene):
    """The train-step and fit cases' start (tests/test_parallel.py)."""
    _, _, _, _, fit = _pkg(side)
    if case == "train":
        p = fit.get_params(scene, ("sphere_centers",))
        return {k: v + 0.3 for k, v in p.items()}
    p = fit.get_params(scene, ("sphere_centers", "sphere_diffuse"))
    if side == "jax":
        import jax.numpy as jnp
        clip = lambda x: jnp.clip(x, 0.0, 1.0)
    else:
        clip = lambda x: torch.clamp(x, 0.0, 1.0)
    return {"sphere_centers": p["sphere_centers"] + 0.25,
            "sphere_diffuse": clip(p["sphere_diffuse"] + 0.1)}


def _hit(h) -> dict:
    return {k: getattr(h, k) for k in ("t", "kind", "index", "mesh_index",
                                       "mesh_n")}


def run_case(case: str, mesh) -> dict:
    """One case on the port, on this rank: its outputs as tensors."""
    from unity_raytracer_tpu_torch.models.camera import generate_rays
    from unity_raytracer_tpu_torch.ops.render import render
    from unity_raytracer_tpu_torch.parallel import collectives
    from unity_raytracer_tpu_torch.parallel import mesh as meshmod
    from unity_raytracer_tpu_torch.parallel import shard as shardmod

    if case == "mesh_error":
        try:
            meshmod.make_mesh((3, 1), device="cpu")
        except ValueError as e:
            return {"raised": torch.tensor(1), "msg_ok": torch.tensor(
                int("!= 4 devices" in str(e)))}
        return {"raised": torch.tensor(0)}
    if case == "combine":
        rank = torch.distributed.get_rank()
        t = torch.ones(4)
        key = torch.full((4,), rank + 1, dtype=torch.int32)
        t_out, k_out = collectives.min_hit_combine(
            t, key, meshmod.axis_group(mesh, "dp"))
        return {"t": t_out, "key": k_out}
    if case == "swap":
        x = torch.arange(SWAP_ROWS * 3, dtype=torch.float32).reshape(-1, 3)
        y = shardmod.swap_shard_axes(x, mesh, "dp", "tp")
        return {"y": y, "back": shardmod.swap_shard_axes(y, mesh, "tp",
                                                         "dp")}
    scene, cam, cfg, bvh = inputs("torch", case)
    if case in ("tiled", "tiled_bvh", "tiled_pallas", "tiled_mega",
                "tiled_tiny"):
        return {"img": shardmod.render_tiled(scene, cam, cfg, mesh, bvh=bvh)}
    if case == "auto":
        return {"img": shardmod.render_auto(scene, cam, cfg, mesh)}
    o, d = generate_rays(cam)
    if case == "placed":
        placed = shardmod.shard_scene_mesh_tris(scene, mesh)
        rest = shardmod._rest_scene(scene)
        return {"rows": torch.tensor([placed.meshes.verts.shape[0],
                                      placed.meshes.normals.shape[0],
                                      rest.meshes.verts.shape[0],
                                      rest.meshes.valid.shape[0]])}
    if case in ("ssh", "ssh_padded"):
        return _hit(shardmod.scene_sharded_hit(scene, o, d, mesh))
    if case in ("ssh_bvh", "ssh_bvh_meshes"):
        tp = meshmod.axis_size(mesh, "tp")
        sb = shardmod.build_shard_bvhs(scene, tp)
        return _hit(shardmod.scene_sharded_hit_bvh(scene, o, d, mesh, sb))
    if case == "ring":
        t, i = shardmod.nearest_mesh_hit_ring(scene, o, d, mesh)
        return {"t": t, "i": i}
    if case == "ring_hit":
        return _hit(shardmod.nearest_hit_ring(scene, o, d, mesh))
    # the training cases: the target is the render at the true parameters
    target = render(scene, cam, cfg, bvh=bvh)
    tgt = target.reshape(-1, 3)
    start = start_params("torch", case, scene)
    lr = TRAIN_LR if case == "train" else FIT_LR
    step = shardmod.make_sharded_train_step(
        scene, cam, cfg, tgt, mesh, tuple(start),
        lambda ps: torch.optim.Adam(ps, lr=lr), bvh=bvh)
    params, state, losses = start, None, []
    for _ in range(1 if case == "train" else FIT_STEPS):
        params, state, loss = step(params, state, o, d, tgt)
        losses.append(loss)
    return {"losses": torch.stack(losses),
            **{f"p/{k}": v for k, v in params.items()}}


def run_rank(rank: int, world: int, out: str) -> None:
    """Every case of ``CASES[world]``, on each of its meshes, saved."""
    from unity_raytracer_tpu_torch.parallel import mesh as meshmod
    for shape, cases in CASES[world].items():
        mesh = meshmod.make_mesh(shape, device="cpu")
        for case in cases:
            res = run_case(case, mesh)
            path = (pathlib.Path(out) / str(world) / shape_key(shape)
                    / f"{case}.rank{rank}.npz")
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(path, **{k: v.detach().numpy() for k, v in res.items()})
