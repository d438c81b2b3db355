"""Sharded rendering and the distributed training step, in SPMD form.

Twin: ``unity_raytracer_tpu/parallel/shard.py:44-522``. The twin writes
each regime as one ``shard_map`` over a device mesh; the port runs it as
SPMD over a ``torch.distributed`` mesh (``mesh.make_mesh``): every rank
calls the function with the same global inputs, works on its own shard,
and returns what the twin returns globally (the sharded outputs
all-gathered). Every rank must make every call, in the same order, also a
rank whose ray shard is only padding. Four regimes:

1. ``render_tiled`` (and ``render_auto``) — rays sharded over ``dp``,
   scene replicated; one all-gather of the radiance at the end.
2. ``scene_sharded_hit`` / ``scene_sharded_hit_bvh`` — mesh triangles
   sharded over ``tp``, rays replicated; each rank's partial nearest hit
   combines with the lexicographic (t, key) min
   (``collectives.min_hit_combine``), the winner's mesh id and normal
   ride an ``all_reduce(SUM)`` from the one rank that holds them.
3. ``nearest_mesh_hit_ring`` / ``nearest_hit_ring`` — rays and triangles
   co-sharded on one axis; triangle shards rotate around the ring
   (``collectives.ring_shift``) while each ray shard folds its running
   nearest hit: ring attention's KV rotation with a min in place of the
   softmax accumulation.
4. ``swap_shard_axes`` — the Ulysses reshard between the two axes.

``make_sharded_train_step`` is inverse rendering with rays over ``dp``:
each rank's share of the loss and its gradients, then one
``all_reduce(SUM)`` of the loss and one of the gradients, bucketed into a
flat tensor, then the optimizer step.

On the card the shards run through the kernels that compute them: the
brute-force triangle fold of regimes 2 and 3 is the nearest-triangle
kernel (``ops/kernels/intersect_mk``, through
``ops/intersect.nearest_mesh_triangle``, the route ``nearest_hit`` takes
for a large mesh without a BVH, where the twin calls ``nearest_hit`` or
``ray_triangles``), each rank's walk in ``scene_sharded_hit_bvh`` is the
threaded binary walk (``traverse_packet3`` via ``ops/bvh.traverse_any``)
on its shard's packed rows, and the traces are ``trace_radiance``'s. On
the CPU their plain versions run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from unity_raytracer_tpu_torch.models.camera import Camera, generate_rays
from unity_raytracer_tpu_torch.models.scene import Scene
from unity_raytracer_tpu_torch.ops import bvh as bvhmod
from unity_raytracer_tpu_torch.ops.intersect import (
    INF, KIND_MESH, KIND_NONE, Hit, nearest_hit, nearest_mesh_triangle,
    ray_aabb)
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import pack_rows
from unity_raytracer_tpu_torch.ops.render import (
    resolve_mode, trace_radiance)
from unity_raytracer_tpu_torch.parallel import collectives
from unity_raytracer_tpu_torch.parallel.mesh import (
    RAY_AXIS, SCENE_AXIS, axis_group, axis_index, axis_size, ray_sharding)
from unity_raytracer_tpu_torch.utils.config import RenderConfig


def _pad_rays(o, d, multiple: int):
    """Pad the rays to a multiple of ``multiple`` with filler rays (origin
    0, direction +z); returns ``(o, d, n)`` with ``n`` the real count."""
    n = o.shape[0]
    pad = (-n) % multiple
    if pad:
        filler_d = torch.zeros((pad, 3), dtype=d.dtype, device=d.device)
        filler_d[:, 2] = 1.0
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype,
                                      device=o.device)])
        d = torch.cat([d, filler_d])
    return o, d, n


def render_tiled(scene: Scene, cam: Camera, cfg: RenderConfig, mesh,
                 bvh=None) -> torch.Tensor:
    """Regime 1: rays over ``dp`` (padded to whole shards), each rank
    traces its rows with ``trace_radiance``, one all-gather over ``dp``.
    Returns the [H,W,3] display-scale image on every rank; the scene (and
    BVH) are replicated."""
    cfg = resolve_mode(scene, cfg)
    o, d = generate_rays(cam)
    o, d, n = _pad_rays(o, d, axis_size(mesh, RAY_AXIS))
    lo, hi = ray_sharding(mesh, o.shape[0])
    rad = trace_radiance(scene, o[lo:hi], d[lo:hi], cfg, bvh=bvh)
    rad = collectives.all_gather_rows(rad, axis_group(mesh, RAY_AXIS))[:n]
    return rad.reshape(cam.height, cam.width, 3) / 255.0


def render_auto(scene: Scene, cam: Camera, cfg: RenderConfig, mesh,
                bvh=None) -> torch.Tensor:
    """Regime 1 as the twin's GSPMD path, where XLA partitions a program
    annotated with ray shardings. PyTorch has no GSPMD: the rays are
    placed on the mesh's ``dp`` rows (``mesh.ray_sharding``) and traced
    exactly as ``render_tiled`` traces them."""
    return render_tiled(scene, cam, cfg, mesh, bvh=bvh)


# ---------------------------------------------------------------------------
# Regime 2: scene sharded (TP analogue)
# ---------------------------------------------------------------------------

def _rest_scene(scene: Scene) -> Scene:
    """The replicated part of a scene-sharded computation: everything
    except the per-triangle mesh arrays, which become 1-row dummies (an
    invalid all-zero triangle). The [M]-row arrays travel only as shards;
    the small per-mesh side tables (boxes, materials) stay replicated."""
    m = scene.meshes
    dev = m.verts.device
    dummy = dataclasses.replace(
        m,
        verts=torch.zeros((1, 3, 3), dtype=torch.float32, device=dev),
        normals=torch.zeros((1, 3), dtype=torch.float32, device=dev),
        mesh_id=torch.zeros((1,), dtype=torch.int32, device=dev),
        valid=torch.zeros((1,), dtype=torch.bool, device=dev))
    return dataclasses.replace(scene, meshes=dummy)


def _tp_shard(scene: Scene, mesh) -> Tuple[int, int]:
    """(this rank's triangle shard along ``tp``, rows per shard)."""
    tp = axis_size(mesh, SCENE_AXIS)
    if scene.meshes.count % tp:
        raise ValueError(f"{scene.meshes.count} mesh triangles do not "
                         f"split over tp = {tp}: pad them to a multiple")
    return axis_index(mesh, SCENE_AXIS), scene.meshes.count // tp


def shard_scene_mesh_tris(scene: Scene, mesh) -> Scene:
    """The scene with only this rank's ``tp`` shard of the mesh-triangle
    arrays (rows ``[s*M/tp, (s+1)*M/tp)``); everything else replicated.
    Requires M % tp == 0 (pad the builder)."""
    s, rows = _tp_shard(scene, mesh)
    m = scene.meshes
    sl = slice(s * rows, (s + 1) * rows)
    return dataclasses.replace(scene, meshes=dataclasses.replace(
        m, verts=m.verts[sl], normals=m.normals[sl],
        mesh_id=m.mesh_id[sl], valid=m.valid[sl]))


def _fold_rest(rest: Scene, o, d, t_m, i_m):
    """Fold mesh candidates ``(t_m, i_m)`` into the replicated categories
    (``nearest_hit`` on the rest scene), as the reference orders them:
    the scene-box gate (``Scene.gate_min`` / ``gate_max``, which
    ``_rest_scene`` carries) applies to mesh candidates too (Scene.cs:54),
    and mesh triangles are tested first, so a later category wins only on
    a strictly smaller t (Scene.cs:94,107): an equal-t mesh candidate
    keeps the win. Returns ``(t, kind, index, mesh_wins)``."""
    in_box = ray_aabb(o, d, rest.gate_min[None, :], rest.gate_max[None, :])
    t_m = torch.where(in_box, t_m, INF)
    hit_rest = nearest_hit(rest, o, d)
    mesh_wins = (t_m <= hit_rest.t) & torch.isfinite(t_m)
    kind = torch.where(mesh_wins, KIND_MESH, hit_rest.kind).to(torch.int32)
    index = torch.where(mesh_wins, i_m.to(torch.int32), hit_rest.index)
    t = torch.where(mesh_wins, t_m, hit_rest.t)
    return t, kind, index, mesh_wins


def _combine_partial_hits(t, kind, index_gl, mesh_index, normal, group):
    """Lexicographic (t, key) min over ``group`` plus the winner's carry.

    ``index_gl`` must be global (unique across shards), so the packed key
    names exactly one shard; the winner's mesh index and shading normal
    then ride an ``all_reduce(SUM)`` (zero from every losing rank).
    Sphere and loose winners are computed alike on every rank, so only
    mesh winners are carried."""
    key = collectives.pack_hit(kind, index_gl.clamp_min(0))
    key = torch.where(kind == KIND_NONE, collectives.KEY_NONE, key)
    t_g, key_g = collectives.min_hit_combine(t, key, group)
    kind_g, index_g = collectives.unpack_hit(key_g)
    missed = key_g == collectives.KEY_NONE
    kind_g = torch.where(missed, KIND_NONE, kind_g).to(torch.int32)
    index_g = torch.where(missed, -1, index_g).to(torch.int32)
    won_mesh = ((key == key_g) & (t == t_g) & (kind == KIND_MESH)
                & (kind_g == KIND_MESH))
    mesh_index_g = torch.where(won_mesh, mesh_index + 1, 0).to(torch.int32)
    dist.all_reduce(mesh_index_g, op=dist.ReduceOp.SUM, group=group)
    normal_g = torch.where(won_mesh[:, None], normal, 0.0)
    dist.all_reduce(normal_g, op=dist.ReduceOp.SUM, group=group)
    mesh_index_g = torch.where(kind_g == KIND_MESH, mesh_index_g - 1,
                               -1).to(torch.int32)
    return Hit(t=t_g, kind=kind_g, index=index_g, mesh_index=mesh_index_g,
               mesh_n=normal_g)


def scene_sharded_hit(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                      mesh) -> Hit:
    """Regime 2 (brute force): the nearest hit of rays ``o, d`` (the same
    on every rank) with the mesh triangles sharded over ``tp``: each rank
    folds its triangle shard with the nearest-triangle kernel, folds in
    the replicated spheres and loose triangles, and the partial winners
    combine over ``tp`` (``_combine_partial_hits``). Equal to the
    single-device result, category tie order included (keys pack
    kind-major); ``mesh_n`` is the winner's stored normal.

    Each lane's result depends on its own ray only, so the ray order is
    the caller's. On the card, pass a frame's rays in block order
    (``camera.generate_rays_blocks``): the kernel culls triangles per
    block of 256 rays, and a 32x8 tile keeps far fewer than a strip of
    one image row does (PERF.md §5 has both on the flagship frame)."""
    s, rows = _tp_shard(scene, mesh)
    local = shard_scene_mesh_tris(scene, mesh).meshes
    t_m, i_loc = nearest_mesh_triangle(o, d, local.verts, local.valid)
    t, kind, index, won = _fold_rest(_rest_scene(scene), o, d, t_m, i_loc)
    safe = i_loc.clamp(0, rows - 1).long()
    mesh_index = torch.where(won, local.mesh_id[safe], -1)
    gl_index = torch.where(kind == KIND_MESH, index + s * rows, index)
    return _combine_partial_hits(t, kind, gl_index, mesh_index,
                                 local.normals[safe],
                                 axis_group(mesh, SCENE_AXIS))


def build_shard_bvhs(scene: Scene, tp: int) -> Dict:
    """Host side: one BVH per contiguous triangle shard (the native build,
    winding canonicalized), padded to common node counts and stacked on a
    leading ``tp`` dim — arrays equal to the twin's, as tensors on the
    scene's device, and ``leaf_size``. Pad nodes are never visited (the
    threaded miss chain ends inside the real subtree). ``packed`` adds
    each shard's packed rows (``pack_rows``), which the walk kernel reads
    (not in the twin)."""
    verts = bvhmod.canonical_winding(scene.meshes.verts.cpu().numpy(),
                                     scene.meshes.normals.cpu().numpy())
    valid = scene.meshes.valid.cpu().numpy()
    mid = scene.meshes.mesh_id.cpu().numpy()
    m_total = verts.shape[0]
    if m_total % tp:
        raise ValueError(f"{m_total} mesh triangles do not split over "
                         f"tp = {tp}")
    rows = m_total // tp
    shards = [dataclasses.replace(
        bvhmod.build(verts[s * rows:(s + 1) * rows],
                     valid[s * rows:(s + 1) * rows]), canonical=True)
              for s in range(tp)]
    nn_max = max(b.n_nodes for b in shards)

    def pad_nodes(a, fill):
        out = np.full((nn_max,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    stacked = {
        "node_min": np.stack([pad_nodes(b.node_min, np.inf)
                              for b in shards]),
        "node_max": np.stack([pad_nodes(b.node_max, -np.inf)
                              for b in shards]),
        "first": np.stack([pad_nodes(b.first, 0) for b in shards]),
        "count": np.stack([pad_nodes(b.count, 0) for b in shards]),
        "miss_next": np.stack([pad_nodes(b.miss_next, -1) for b in shards]),
        # leaf-order triangles, their shard-local rows and mesh ids
        "tri_verts": np.stack([b.tri_verts for b in shards]),
        "prim_index": np.stack([b.prim_index for b in shards]),
        "prim_mesh_id": np.stack(
            [mid[s * rows:(s + 1) * rows][b.prim_index]
             for s, b in enumerate(shards)]),
    }
    dev = scene.aabb_min.device
    out = {k: torch.as_tensor(v, device=dev) for k, v in stacked.items()}
    out["leaf_size"] = shards[0].leaf_size
    out["packed"] = tuple(pack_rows(b).to(dev) for b in shards)
    return out


def scene_sharded_hit_bvh(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                          mesh, shard_bvhs: Dict) -> Hit:
    """Regime 2 (BVH): like ``scene_sharded_hit``, but each rank walks its
    own shard's BVH (``build_shard_bvhs``) with the threaded binary walk
    instead of folding every triangle — the TP path for large scenes.
    ``mesh_n`` is the walk's shading normal of the winner.

    The winner's mesh id is the shard's ``mesh_id`` row of the walk's
    shard-local triangle; the twin reads its leaf-order ``prim_mesh_id``
    at that row instead, which differs when a shard holds two meshes
    (ROADMAP Queue C #13)."""
    s, rows = _tp_shard(scene, mesh)
    t_m, i_loc, nrm = bvhmod.traverse_any(shard_bvhs["packed"][s], o, d,
                                          kernel="pallas3")
    t, kind, index, won = _fold_rest(_rest_scene(scene), o, d, t_m, i_loc)
    mid = scene.meshes.mesh_id[s * rows:(s + 1) * rows]
    mesh_index = torch.where(won & (i_loc >= 0),
                             mid[i_loc.clamp(0, rows - 1).long()], -1)
    gl_index = torch.where(kind == KIND_MESH, index + s * rows, index)
    return _combine_partial_hits(t, kind, gl_index, mesh_index, nrm,
                                 axis_group(mesh, SCENE_AXIS))


# ---------------------------------------------------------------------------
# Regime 4: Ulysses-style reshard (axis swap between phases)
# ---------------------------------------------------------------------------

def swap_shard_axes(x: torch.Tensor, mesh, from_axis: str,
                    to_axis: str) -> torch.Tensor:
    """Reshard a [N, ...] tensor from ``from_axis`` to ``to_axis`` — the
    Ulysses pattern: when consecutive phases prefer different layouts,
    swap the sharded axis without holding the whole tensor on a rank
    between them. Rank (i on ``from_axis``, j on ``to_axis``) holds block
    i, keeps its j-th chunk and gathers the j-th chunk of every
    ``from_axis`` peer: global block j of the result. The SPMD form then
    gathers the blocks over ``to_axis`` and returns the whole result.

    The result's order is the fixed block interleave
    ``x.reshape(pf, pt, -1, ...).swapaxes(0, 1).reshape(N, ...)``; a
    second call with the axes swapped restores ``x`` exactly (an
    involution). Requires N divisible by pf * pt."""
    p_from = axis_size(mesh, from_axis)
    p_to = axis_size(mesh, to_axis)
    n = x.shape[0]
    if n % (p_from * p_to):
        raise ValueError(f"{n} rows do not split over {p_from} x {p_to}")
    blk = n // p_from
    c = blk // p_to
    lo = axis_index(mesh, from_axis) * blk + axis_index(mesh, to_axis) * c
    mine = x[lo:lo + c]
    block = collectives.all_gather_rows(mine, axis_group(mesh, from_axis))
    return collectives.all_gather_rows(block, axis_group(mesh, to_axis))


# ---------------------------------------------------------------------------
# Regime 3: ring pass (rays and scene both sharded on one axis)
# ---------------------------------------------------------------------------

def _ring_shards(scene: Scene, o, d, mesh, axis: str):
    """This rank's ring shards: ``(group, size, o, d, rows, shard id, its
    mesh-triangle arrays)`` — rays and triangles split evenly over
    ``axis``, the shard id a tensor that rotates with its triangles."""
    size = axis_size(mesh, axis)
    if scene.meshes.count % size or o.shape[0] % size:
        raise ValueError(f"{scene.meshes.count} triangles and "
                         f"{o.shape[0]} rays must split over {axis} = "
                         f"{size}")
    my = axis_index(mesh, axis)
    n_loc = o.shape[0] // size
    rows = scene.meshes.count // size
    m = scene.meshes
    sl = slice(my * rows, (my + 1) * rows)
    shard_id = torch.tensor([my], dtype=torch.int32, device=o.device)
    return (axis_group(mesh, axis), size, o[my * n_loc:(my + 1) * n_loc],
            d[my * n_loc:(my + 1) * n_loc], rows, shard_id,
            (m.verts[sl], m.normals[sl], m.mesh_id[sl], m.valid[sl]))


def nearest_mesh_hit_ring(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                          mesh, axis: str = RAY_AXIS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring traversal of the mesh-triangle soup: ray shards stay, triangle
    shards rotate (``collectives.ring_shift``); each of the ``size`` steps
    folds the resident shard with the nearest-triangle kernel
    (``nearest_mesh_triangle``) into the running best (t, global index),
    then rotates. Returns ``(t [N],
    global mesh-triangle index [N] or -1)``, gathered over ``axis``. Pass
    rays in block order on the card, as for ``scene_sharded_hit``."""
    group, size, o_, d_, rows, shard_id, (verts, _, _, valid) = \
        _ring_shards(scene, o, d, mesh, axis)
    best_t = torch.full((o_.shape[0],), INF, dtype=torch.float32,
                        device=o.device)
    best_i = torch.full((o_.shape[0],), -1, dtype=torch.int32,
                        device=o.device)
    for _ in range(size):
        t_loc, i_loc = nearest_mesh_triangle(o_, d_, verts, valid)
        upd = t_loc < best_t
        best_t = torch.where(upd, t_loc, best_t)
        best_i = torch.where(upd, i_loc + shard_id * rows, best_i)
        verts, valid, shard_id = collectives.ring_shift(
            [verts, valid, shard_id], group)
    return (collectives.all_gather_rows(best_t, group),
            collectives.all_gather_rows(best_i, group))


def nearest_hit_ring(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                     mesh, axis: str = RAY_AXIS) -> Hit:
    """Regime 3 with full ``Hit`` semantics: rays and mesh triangles
    co-sharded on ``axis``; triangle shards (verts, normals, mesh ids,
    validity and the shard id) rotate around the ring while each ray
    shard folds the running global best, then the scene-box gate and the
    replicated spheres and loose triangles fold in locally — a drop-in
    ``nearest_hit`` (``mesh_n``: the winner's stored normal), gathered
    over ``axis``. Per rank: N/p rays and M/p triangles, the regime for
    when neither fits replicated. Pass rays in block order on the card,
    as for ``scene_sharded_hit``."""
    group, size, o_, d_, rows, shard_id, (verts, norm, mids, valid) = \
        _ring_shards(scene, o, d, mesh, axis)
    n_loc = o_.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    best_t = torch.full((n_loc,), INF, **f32)
    best_i = torch.full((n_loc,), -1, dtype=torch.int32, device=o.device)
    best_mid = torch.full((n_loc,), -1, dtype=torch.int32, device=o.device)
    best_n = torch.zeros((n_loc, 3), **f32)
    for _ in range(size):
        t_loc, i_loc = nearest_mesh_triangle(o_, d_, verts, valid)
        upd = t_loc < best_t
        safe = i_loc.clamp_min(0).long()
        best_t = torch.where(upd, t_loc, best_t)
        best_i = torch.where(upd, i_loc + shard_id * rows, best_i)
        best_mid = torch.where(upd, mids[safe], best_mid)
        best_n = torch.where(upd[:, None], norm[safe], best_n)
        verts, norm, mids, valid, shard_id = collectives.ring_shift(
            [verts, norm, mids, valid, shard_id], group)
    t, kind, index, won = _fold_rest(_rest_scene(scene), o_, d_, best_t,
                                     best_i)
    mesh_index = torch.where(won, best_mid, -1).to(torch.int32)
    gather = lambda x: collectives.all_gather_rows(x, group)
    return Hit(t=gather(t), kind=gather(kind), index=gather(index),
               mesh_index=gather(mesh_index), mesh_n=gather(best_n))


def make_sharded_train_step(template: Scene, cam: Camera, rcfg: RenderConfig,
                            target: torch.Tensor, mesh,
                            param_names: Tuple[str, ...],
                            optimizer_factory: Callable,
                            bvh=None) -> Callable:
    """Distributed inverse-rendering step, rays over ``dp``.

    Returns ``step(params, opt_state, o, d, tgt) -> (params, opt_state,
    loss)``: ``o, d`` the flat primary rays and ``tgt`` the target
    ([N,3], display scale), the same on every rank (``target`` is the
    twin's argument, unused as in the twin). ``opt_state`` is the
    optimizer of the previous step, or None to start one:
    ``optimizer_factory(leaves)`` over copies of ``params`` (e.g.
    ``torch.optim.Adam``, whose defaults are optax's adam's, as in
    ``fit.py``). Each step: this rank's rows (padded to whole shards,
    padding weighted 0) through ``fit.make_chunked_value_and_grad`` —
    the composed path, chunked by ``rcfg.ray_chunk`` — as its share of
    the global mean, SSE / (N * 3); one ``all_reduce(SUM)`` over ``dp`` of
    the loss and one of the gradients, bucketed into one flat tensor;
    then the optimizer step. ``bvh``: a prebuilt BVH, replicated and
    re-bound to each step's mesh verts (``ops/bvh.bind_verts``) for the
    ``mesh_verts`` parameter. Returns the parameters after the step and
    the loss before it."""
    from unity_raytracer_tpu_torch.fit import make_chunked_value_and_grad

    rcfg = resolve_mode(template, rcfg)
    n_total = cam.width * cam.height
    group = axis_group(mesh, RAY_AXIS)
    scale = 1.0 / (255.0 * 255.0)  # radiance-scale MSE -> image MSE

    def step(params, opt_state, o, d, tgt):
        if opt_state is None:
            opt_state = optimizer_factory(
                [params[k].detach().clone().requires_grad_(True)
                 for k in param_names])
        leaves = dict(zip(param_names, opt_state.param_groups[0]["params"]))
        with torch.no_grad():
            for k, v in leaves.items():
                v.copy_(params[k])
        o, d, n = _pad_rays(o, d, axis_size(mesh, RAY_AXIS))
        pad = o.shape[0] - n
        tgt = torch.cat([tgt, tgt.new_zeros((pad, 3))])
        w = torch.cat([torch.ones(n, device=o.device),
                       torch.zeros(pad, device=o.device)])
        lo, hi = ray_sharding(mesh, o.shape[0])
        loss, grads = make_chunked_value_and_grad(
            template, rcfg, o[lo:hi], d[lo:hi], tgt[lo:hi] * 255.0, bvh=bvh,
            weights=w[lo:hi], denom=n_total * 3.0)(leaves)
        loss = loss * scale
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        flat = torch.cat([grads[k].reshape(-1) for k in param_names]) * scale
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for k, g in zip(param_names, flat.split(
                [leaves[k].numel() for k in param_names])):
            leaves[k].grad = g.view_as(leaves[k])
        opt_state.step()
        return ({k: v.detach().clone() for k, v in leaves.items()},
                opt_state, loss)

    return step
