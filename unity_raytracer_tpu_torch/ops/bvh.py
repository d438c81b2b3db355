"""BVH host side: the native SAH build, canonical winding and ``prepare_bvh``.

Twin: ``unity_raytracer_tpu/ops/bvh.py`` — ``MeshBVH`` (here a dataclass
of numpy arrays: the tree is host data), ``build`` on its native path only
(``:274-327``), ``_mt_one`` (``:522-538``, the differentiable per-ray
Möller–Trumbore the record replay uses), ``canonical_winding``
(``:632-644``) and the ``mega`` branch of ``prepare_bvh``
(``:680-726``). The C++ builder is compiled
from ``native/bvh_builder.cc`` into ``build/`` (``ops/kernels/_lib.py``);
the tracked ``native/libbvh.so`` is never loaded. Equal inputs give arrays
equal to the JAX package's (``tests/test_torch_bvh.py``).

Not ported here: the numpy reference builder and SBVH ``presplit_refs``
(ROADMAP Queue A #14), the device traversals ``traverse`` /
``traverse_any`` (Queue A #10 and #12) and ``bind_verts`` (Queue A #10).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from unity_raytracer_tpu_torch.ops.intersect import dot3
from unity_raytracer_tpu_torch.ops.kernels import _lib
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import (
    EPS, PALLAS_LEAF, PackedBVH, pack_bw, pack_rows)
from unity_raytracer_tpu_torch.ops.kernels.traverse_wide import widen

LEAF_SIZE = 4
SAH_BINS = 16


@dataclass(frozen=True)
class MeshBVH:
    """Flat threaded BVH over the scene's concatenated mesh triangles
    (host numpy). ``tri_verts`` are the triangles in leaf order;
    ``prim_index`` maps leaf-order rows back to ``MeshSet`` rows."""

    node_min: np.ndarray    # [Nn,3] f32
    node_max: np.ndarray    # [Nn,3] f32
    first: np.ndarray       # [Nn] i32 leaf: first prim; interior: -1
    count: np.ndarray       # [Nn] i32 leaf: prim count; interior: 0
    miss_next: np.ndarray   # [Nn] i32 skip pointer, -1 terminates
    tri_verts: np.ndarray   # [M,3,3] f32 leaf-ordered triangles
    prim_index: np.ndarray  # [M] i32 leaf order -> original MeshSet row
    leaf_size: int = LEAF_SIZE
    # winding canonicalized so the shading normal is the -cross bake
    # convention of the stored normals (see canonical_winding)
    canonical: bool = False
    flip: Optional[np.ndarray] = None  # [M_total] bool rows swapped v1<->v2


def build(verts: np.ndarray, valid: np.ndarray | None = None,
          leaf_size: int = LEAF_SIZE, use_sah: bool = True,
          sah_bins: int = SAH_BINS, aabb_pad: float = 0.0) -> MeshBVH:
    """Binned-SAH build over triangles [M,3,3] with the native builder;
    invalid rows are excluded. ``aabb_pad`` inflates every node box."""
    verts = np.asarray(verts, np.float32)
    if valid is None:
        valid = np.ones((verts.shape[0],), bool)
    orig_idx = np.nonzero(np.asarray(valid))[0].astype(np.int32)
    tris = verts[orig_idx]
    m = tris.shape[0]
    if m == 0:
        raise NotImplementedError(
            "a scene without mesh triangles has no BVH; its brute-force "
            "path is ROADMAP Queue A #10")

    tris_f = np.ascontiguousarray(tris.reshape(m, 9), np.float32)
    max_nodes = 2 * m - 1
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty((max_nodes,), np.int32)
    count = np.empty((max_nodes,), np.int32)
    miss = np.empty((max_nodes,), np.int32)
    order = np.empty((m,), np.int32)
    n = _lib.bvh_lib().urt_build_bvh_ex(
        tris_f.ctypes.data, m, leaf_size, int(use_sah), int(sah_bins),
        node_min.ctypes.data, node_max.ctypes.data, first.ctypes.data,
        count.ctypes.data, miss.ctypes.data, order.ctypes.data)
    if n <= 0:
        raise RuntimeError(f"native BVH build failed (returned {n})")
    node_min, node_max = node_min[:n], node_max[:n]
    if aabb_pad:
        node_min = node_min - aabb_pad
        node_max = node_max + aabb_pad
    return MeshBVH(node_min=node_min, node_max=node_max, first=first[:n],
                   count=count[:n], miss_next=miss[:n],
                   tri_verts=tris[order], prim_index=orig_idx[order],
                   leaf_size=leaf_size)


def _mt_one(o, d, v0, v1, v2):
    """Möller–Trumbore for one triangle per ray (``[N,3]`` each), +inf on
    a miss; differentiable in every input where it hits. Same rejects and
    epsilon as the fused segment's test."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = torch.linalg.cross(d, e2, dim=-1)
    a = dot3(e1, h)
    parallel = a.abs() < EPS
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = o - v0
    u = f * dot3(s, h)
    q = torch.linalg.cross(s, e1, dim=-1)
    v = f * dot3(d, q)
    t = f * dot3(e2, q)
    miss = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (t <= EPS))
    return torch.where(miss, torch.inf, t)


def canonical_winding(verts: np.ndarray, normals: np.ndarray,
                      return_flip: bool = False):
    """Swap v1/v2 of triangles whose derived normal
    ``-cross(v2-v0, v1-v0)`` opposes the stored shading normal (the swap
    never changes the intersection set). ``return_flip`` also returns the
    per-row swap mask."""
    v = np.array(verts, np.float32, copy=True)
    nc = -np.cross(v[:, 2] - v[:, 0], v[:, 1] - v[:, 0])
    flip = np.sum(nc * np.asarray(normals, np.float32), axis=-1) < 0.0
    v[flip] = v[flip][:, [0, 2, 1]]
    return (v, flip) if return_flip else v


def prepare_bvh(scene, cfg, device=None) -> PackedBVH:
    """Build the fused segment kernel's BVH for ``scene`` on the host and
    move it to ``device`` (default: the scene's device): native SAH build
    with ``cfg.bvh_leaf``-triangle
    leaves and ``cfg.bvh_bins`` bins, ``pack_rows``, ``widen`` to
    ``cfg.bvh_arity``, ``pack_bw``, and the per-leaf-slot combined
    material ids (``leafmeta``, table order spheres ++ loose triangles ++
    meshes, as ``ops/kernels/mega.build_aux`` lays it out)."""
    if getattr(cfg, "bvh_presplit", 0.0):
        raise NotImplementedError(
            "bvh_presplit (SBVH presplitting and the numpy builder) is "
            "ROADMAP Queue A #14")
    verts, flip = canonical_winding(scene.meshes.verts.cpu().numpy(),
                                    scene.meshes.normals.cpu().numpy(),
                                    return_flip=True)
    leaf = getattr(cfg, "bvh_leaf", PALLAS_LEAF) or PALLAS_LEAF
    bins = getattr(cfg, "bvh_bins", SAH_BINS) or SAH_BINS
    pad = getattr(cfg, "bvh_pad", 0.0) or 0.0
    b = build(verts, scene.meshes.valid.cpu().numpy(), leaf_size=leaf,
              sah_bins=bins, aabb_pad=pad)
    b = dataclasses.replace(b, canonical=True, flip=flip)
    packed = pack_bw(widen(pack_rows(b, leaf_slots=leaf),
                           arity=getattr(cfg, "bvh_arity", 4)))
    lp = packed.leaf_prim.numpy()
    mid = scene.meshes.mesh_id.cpu().numpy()
    matid = (scene.spheres.count + scene.triangles.count
             + mid[b.prim_index[np.clip(lp, 0, None)]])
    mwidth = max(16, -(-lp.shape[1] // 8) * 8)
    leafmeta = np.zeros((lp.shape[0], mwidth), np.float32)
    leafmeta[:, : lp.shape[1]] = matid.astype(np.float32)
    return packed.replace(leafmeta=torch.from_numpy(leafmeta)).to(
        scene.aabb_min.device if device is None else device)
