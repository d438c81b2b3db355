"""Carry state across from the JAX package: scene, BVHs and fit state to tensors.

No single JAX twin: this is the renderer's "weights" converter. A scene
and its packed BVH are the state a render runs on, and these functions
take them from any object with the JAX ``Scene`` / ``PackedBVH``
attribute tree — each leaf read with ``np.asarray``, so a JAX object
mapped through ``jax.tree.map(np.asarray, ...)`` works, and so does any
other object of the same shape — and return the port's containers on
``device``. A fit's state (its parameters and optax's Adam moments) comes
across with ``params_from_arrays`` and ``adam_state_from_arrays``, so a
fit begun in JAX continues in the port. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from unity_raytracer_tpu_torch.models.scene import (
    Lights, Materials, MeshSet, Scene, Spheres, Triangles)
from unity_raytracer_tpu_torch.ops.bvh import MeshBVH
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import PackedBVH
from unity_raytracer_tpu_torch.utils.boxes import pad_box


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def _materials(m, device) -> Materials:
    return Materials(**{k: _t(getattr(m, k), device) for k in (
        "diffuse", "ambient", "mirror", "specular", "phong", "is_mirror",
        "transparency", "ior", "is_dielectric")})


def scene_from_arrays(obj, device="cuda") -> Scene:
    """A port ``Scene`` from an object with the JAX ``Scene`` attributes;
    its gate box (``Scene.gate_min`` / ``gate_max``) is padded on the
    host."""
    s, t, m, lt = obj.spheres, obj.triangles, obj.meshes, obj.lights
    gate = pad_box(np.array(obj.aabb_min, np.float32),
                   np.array(obj.aabb_max, np.float32))
    return Scene(
        spheres=Spheres(centers=_t(s.centers, device),
                        radius_sq=_t(s.radius_sq, device),
                        materials=_materials(s.materials, device),
                        valid=_t(s.valid, device)),
        triangles=Triangles(verts=_t(t.verts, device),
                            normals=_t(t.normals, device),
                            materials=_materials(t.materials, device),
                            valid=_t(t.valid, device)),
        meshes=MeshSet(verts=_t(m.verts, device),
                       normals=_t(m.normals, device),
                       mesh_id=_t(m.mesh_id, device),
                       valid=_t(m.valid, device),
                       mesh_aabb_min=_t(m.mesh_aabb_min, device),
                       mesh_aabb_max=_t(m.mesh_aabb_max, device),
                       mesh_materials=_materials(m.mesh_materials, device),
                       mesh_valid=_t(m.mesh_valid, device)),
        lights=Lights(positions=_t(lt.positions, device),
                      intensities=_t(lt.intensities, device),
                      valid=_t(lt.valid, device),
                      ambient=_t(lt.ambient, device)),
        aabb_min=_t(obj.aabb_min, device),
        aabb_max=_t(obj.aabb_max, device),
        gate_min=_t(gate[0], device), gate_max=_t(gate[1], device))


def mesh_bvh_from_arrays(obj, device=None) -> MeshBVH:
    """A port ``MeshBVH`` from an object with the JAX ``MeshBVH``
    attributes — the plain tree ``kernel='xla'`` walks: host numpy, or
    tensors on ``device`` when one is given."""
    a = lambda k: np.array(getattr(obj, k))
    flip = getattr(obj, "flip", None)
    bvh = MeshBVH(node_min=a("node_min"), node_max=a("node_max"),
                  first=a("first"), count=a("count"),
                  miss_next=a("miss_next"), tri_verts=a("tri_verts"),
                  prim_index=a("prim_index"),
                  leaf_size=int(getattr(obj, "leaf_size")),
                  canonical=bool(getattr(obj, "canonical", False)),
                  flip=None if flip is None else np.array(flip))
    return bvh if device is None else bvh.to(device)


def packed_from_arrays(obj, device="cuda") -> PackedBVH:
    """A port ``PackedBVH`` from an object with the JAX ``PackedBVH``
    attributes, its ``MeshBVH`` too (the traversal epilogue reads its
    ``tri_verts`` and ``prim_index`` on the device). The rows-per-leaf
    counts come from the shape tags (``leaf_tag``, ``bw_tag``) the JAX
    layout carries them in; the port's own group boxes, walk rows and stack
    depths are computed from the arrays."""
    opt = lambda k: (None if getattr(obj, k, None) is None
                     else _t(getattr(obj, k), device))
    from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import (
        binary_stack_depth, group_boxes, node_walk_rows, wide_stack_depth,
        wide_walk_rows)
    leaf_tag = getattr(obj, "leaf_tag", None)
    bw_tag = getattr(obj, "bw_tag", None)
    wide = getattr(obj, "wide", None)
    return PackedBVH(
        nodes=_t(obj.nodes, device), tris=_t(obj.tris, device),
        leaf_prim=_t(obj.leaf_prim, device),
        bvh=mesh_bvh_from_arrays(obj.bvh, device),
        leafmeta=opt("leafmeta"), wide=opt("wide"),
        rows_per_leaf=1 if leaf_tag is None else int(np.shape(leaf_tag)[0]),
        tris_bw=opt("tris_bw"),
        bw_rows_per_leaf=0 if bw_tag is None else int(np.shape(bw_tag)[0]),
        leafbox=_t(group_boxes(obj.tris, obj.leaf_prim), device),
        nodes_walk=_t(node_walk_rows(obj.nodes), device),
        wide_walk=None if wide is None else _t(wide_walk_rows(wide), device),
        stack_binary=binary_stack_depth(obj.nodes),
        stack_wide=-1 if wide is None else wide_stack_depth(wide))


def params_from_arrays(d, device="cuda") -> Dict[str, torch.Tensor]:
    """Fit parameters from a {name: array} dict (the JAX ``get_params``
    dict mapped through ``np.asarray``, or a checkpoint's) -> leaf tensors
    on ``device`` that require grad."""
    return {k: _t(v, device).requires_grad_(True) for k, v in d.items()}


def adam_state_from_arrays(count, mu, nu, optimizer: torch.optim.Adam,
                           params: Dict[str, torch.Tensor]) -> None:
    """Install an Adam state into ``optimizer`` for ``params`` (the
    tensors it optimizes, by name): ``count`` is the step count and
    ``mu`` / ``nu`` the first / second moments by name — optax's
    ``ScaleByAdamState`` leaves (``count``, ``mu``, ``nu``) as numpy, or a
    checkpoint's. optax's adam defaults (b1 0.9, b2 0.999, eps 1e-8, eps
    outside the square root) are ``torch.optim.Adam``'s, so the next step
    continues the same sequence."""
    for k, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32),
            "exp_avg": _t(np.asarray(mu[k], np.float32), p.device),
            "exp_avg_sq": _t(np.asarray(nu[k], np.float32), p.device)}
