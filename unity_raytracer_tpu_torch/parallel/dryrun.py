"""Multi-device dry run: the whole distributed step on tiny shapes.

Twin: ``__graft_entry__.dryrun_multichip`` (``:28-152``), which the twin's
CLI runs on fake CPU devices. The port runs the same steps as SPMD ranks
of a ``torch.distributed`` group (``bootstrap.launch``): NCCL with one
process per card, or gloo processes on the CPU.

Axes exercised — the ones that mean something for a ray tracer:

* ``dp`` — rays and image tiles (also the sequence-parallel axis: the
  wavefront's ray dimension is the sequence), with the loss and gradient
  all-reduce of the training step;
* ``tp`` — the scene (mesh triangles) sharded, with the lexicographic
  nearest-hit combine, by brute force and by per-shard BVH walks;
* the ring — triangle shards rotating over ``dp`` (the ring-attention
  analogue).
"""

from __future__ import annotations

import math

import torch


def dryrun_rank(rank: int, n_devices: int, device: str) -> None:
    """One rank's dry run (the twin's steps, in its order); asserts as the
    twin asserts and prints the twin's summary line on rank 0."""
    from unity_raytracer_tpu_torch.fit import get_params
    from unity_raytracer_tpu_torch.models.camera import Camera, generate_rays
    from unity_raytracer_tpu_torch.models.presets import mesh_scene
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.render import render, resolve_mode
    from unity_raytracer_tpu_torch.parallel import mesh as meshmod
    from unity_raytracer_tpu_torch.parallel import shard as shardmod

    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.device(device).type == "cuda" else torch.device(device))
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // tp
    mesh = meshmod.make_mesh((dp, tp), device=dev.type)

    # tiny scene whose mesh-triangle count divides every axis size
    scene, _, cfg = mesh_scene(100, width=8 * dp, height=8, device=dev)
    cfg = resolve_mode(scene, cfg.with_(max_bounces=1))
    assert scene.meshes.count % n_devices == 0, scene.meshes.count
    cam = Camera.from_fov(position=(0, 7, -2), look_at=(0, 5, 26),
                          fov_y_deg=45.0, width=8 * dp, height=8, device=dev)
    target = render(scene, cam, cfg)
    o, d = generate_rays(cam)
    tgt = target.reshape(-1, 3)

    # dp training step: sharded loss, loss and gradient all-reduce
    names = ("sphere_centers", "sphere_diffuse")
    params = get_params(scene, names)
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-2)
    step = shardmod.make_sharded_train_step(scene, cam, cfg, tgt, mesh,
                                            names, adam)
    _, _, loss = step(params, None, o, d, tgt)
    assert math.isfinite(float(loss))

    # tp: scene-sharded nearest hit, the shards the only copy of the
    # [M]-row mesh arrays; brute force and per-shard BVH walks
    hit = shardmod.scene_sharded_hit(scene, o, d, mesh)
    assert hit.t.shape == (o.shape[0],)
    sb = shardmod.build_shard_bvhs(scene, tp=tp)
    hit_b = shardmod.scene_sharded_hit_bvh(scene, o, d, mesh, sb)
    assert hit_b.t.shape == (o.shape[0],)

    # ring: triangle shards rotate over dp (rays and scene co-sharded)
    if scene.meshes.count % dp == 0 and o.shape[0] % dp == 0:
        t_ring, _ = shardmod.nearest_mesh_hit_ring(scene, o, d, mesh)
        assert t_ring.shape == (o.shape[0],)

    # config-5 shape: depth-4 BVH render, tiles over dp, BVH replicated,
    # on the ordered binary walk ('pallas') and on the fused segment
    # kernel ('mega'); 14-triangle leaves for the 1,280-triangle scene
    cfg5 = resolve_mode(scene, cfg.with_(max_bounces=4, use_bvh=True,
                                         kernel="pallas", tile_r=64,
                                         block_size=8, bvh_leaf=14))
    bvh5 = bvhmod.prepare_bvh(scene, cfg5)
    for kernel in ("pallas", "mega"):
        img5 = shardmod.render_tiled(scene, cam, cfg5.with_(kernel=kernel),
                                     mesh, bvh=bvh5)
        assert bool(torch.isfinite(img5).all()), kernel

    # config-5 fit in miniature: tile-sharded steps with the BVH walk,
    # three steps, the loss must descend
    cfg5f = cfg5.with_(max_bounces=1)
    tgt5 = render(scene, cam, cfg5f, bvh=bvh5).reshape(-1, 3)
    step5 = shardmod.make_sharded_train_step(scene, cam, cfg5f, tgt5, mesh,
                                             names, adam, bvh=bvh5)
    p5 = {k: v + 0.2 for k, v in params.items()}
    st5 = None
    fit_losses = []
    for _ in range(3):
        p5, st5, l5 = step5(p5, st5, o, d, tgt5)
        fit_losses.append(float(l5))
    assert fit_losses[-1] < fit_losses[0], fit_losses

    # mesh-vertex gradients (ops/bvh.bind_verts): one step of the [M,3,3]
    # parameter, whose gradient all-reduce is the bandwidth-bound one
    cfg_mv = resolve_mode(scene, cfg.with_(use_bvh=True, kernel="xla",
                                           bvh_pad=0.1))
    bvh_mv = bvhmod.prepare_bvh(scene, cfg_mv)
    tgt_mv = render(scene, cam, cfg_mv, bvh=bvh_mv).reshape(-1, 3)
    step_mv = shardmod.make_sharded_train_step(
        scene, cam, cfg_mv, tgt_mv, mesh, ("mesh_verts",), adam, bvh=bvh_mv)
    p_mv = {"mesh_verts": scene.meshes.verts + 0.01}
    pm2, _, lmv = step_mv(p_mv, None, o, d, tgt_mv)
    assert math.isfinite(float(lmv))
    assert float((pm2["mesh_verts"] - p_mv["mesh_verts"]).abs().max()) > 0.0

    if rank == 0:
        print(f"dryrun_multichip ok: mesh=({dp},{tp}) loss={float(loss):.6f} "
              f"sharded_fit_loss {fit_losses[0]:.3e}->{fit_losses[-1]:.3e} "
              f"mesh_verts_grad_step ok on {n_devices} x {dev.type}",
              flush=True)


def dryrun(n_devices: int, device: str = "cuda",
           timeout_s: float = 900.0) -> None:
    """The dry run on ``n_devices`` ranks (``bootstrap.launch``): one
    process per card with NCCL, or gloo processes with ``device='cpu'``."""
    from unity_raytracer_tpu_torch.parallel.bootstrap import launch
    launch(dryrun_rank, n_devices, device, args=(n_devices, device),
           timeout_s=timeout_s)
