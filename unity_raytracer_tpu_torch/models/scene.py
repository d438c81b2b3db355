"""SoA scene representation as frozen dataclasses of tensors.

Twin: ``unity_raytracer_tpu/models/scene.py`` (``Materials`` … ``Scene``,
``make_material``, ``triangle_normal``, ``SceneBuilder``). Same fields,
same shapes and dtypes, same padding rules, so a scene built by either
package holds equal arrays (``tests/test_torch_scene.py``).

Every primitive category is padded to a fixed capacity with a boolean
validity mask; the reference's category model (mesh triangles, then
spheres, then loose triangles — Data/Objects/Scene.cs:64-115) decides hit
identity and tie-break order. Geometry is float32 throughout.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from unity_raytracer_tpu_torch.utils.boxes import pad_box

# marks a field the twin's container does not have (the parity tests'
# field walk, tests/torch_parity.leaves, leaves it out)
PORT_ONLY = {"port_only": True}


def _to(obj, device):
    """Move every tensor field of a dataclass (recursively) to ``device``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _to(v, device)
        kw[f.name] = v
    return type(obj)(**kw)


class _Movable:
    def to(self, device):
        return _to(self, device)


@dataclass(frozen=True)
class Materials(_Movable):
    """Blinn-Phong material table, SoA over N primitives
    (Data/Shading/MaterialData.cs:7-15, plus the dielectric extension)."""

    diffuse: torch.Tensor        # [N,3]
    ambient: torch.Tensor        # [N,3]
    mirror: torch.Tensor         # [N,3]
    specular: torch.Tensor       # [N,3]
    phong: torch.Tensor          # [N]
    is_mirror: torch.Tensor      # [N] bool
    transparency: torch.Tensor   # [N,3]
    ior: torch.Tensor            # [N]
    is_dielectric: torch.Tensor  # [N] bool


@dataclass(frozen=True)
class Spheres(_Movable):
    centers: torch.Tensor     # [S,3]
    radius_sq: torch.Tensor   # [S] pre-squared (Sphere.cs:11)
    materials: Materials      # [S]
    valid: torch.Tensor       # [S] bool

    @property
    def count(self) -> int:
        return self.radius_sq.shape[0]


@dataclass(frozen=True)
class Triangles(_Movable):
    """Loose triangles with explicit per-triangle shading normals."""

    verts: torch.Tensor       # [T,3,3]
    normals: torch.Tensor     # [T,3]
    materials: Materials      # [T]
    valid: torch.Tensor       # [T] bool

    @property
    def count(self) -> int:
        return self.verts.shape[0]


@dataclass(frozen=True)
class MeshSet(_Movable):
    """All mesh triangles concatenated, with per-mesh side tables."""

    verts: torch.Tensor          # [M,3,3]
    normals: torch.Tensor        # [M,3]
    mesh_id: torch.Tensor        # [M] int32
    valid: torch.Tensor          # [M] bool
    mesh_aabb_min: torch.Tensor  # [K,3]
    mesh_aabb_max: torch.Tensor  # [K,3]
    mesh_materials: Materials    # [K]
    mesh_valid: torch.Tensor     # [K] bool

    @property
    def count(self) -> int:
        return self.verts.shape[0]


@dataclass(frozen=True)
class Lights(_Movable):
    """Point lights (1/d^2 falloff) plus one ambient term."""

    positions: torch.Tensor    # [L,3]
    intensities: torch.Tensor  # [L,3]
    valid: torch.Tensor        # [L] bool
    ambient: torch.Tensor      # [3]


@dataclass(frozen=True)
class Scene(_Movable):
    """Three primitive categories + lights + the scene AABB (Scene.cs:17-41).

    ``aabb_min`` / ``aabb_max`` hold the twin's exact box. Every scene-box
    gate tests ``gate_min`` / ``gate_max`` instead: the same box widened
    by ``utils/boxes.pad_box``, as the walks' node boxes are, so that a
    hit a few ulps outside the exact box (on a face or corner it shares
    with the geometry) is not culled. The builders compute it once on the
    host; ``.to()`` and ``dataclasses.replace`` carry it, so a replace of
    the exact box must pass its gate box too. An empty scene's box (min
    +finfo.max, max -finfo.max) stays inverted, as the twin's does."""

    spheres: Spheres
    triangles: Triangles
    meshes: MeshSet
    lights: Lights
    aabb_min: torch.Tensor  # [3]
    aabb_max: torch.Tensor  # [3]
    gate_min: torch.Tensor = field(metadata=PORT_ONLY)  # [3]
    gate_max: torch.Tensor = field(metadata=PORT_ONLY)  # [3]

    @property
    def has_dielectrics(self) -> bool:
        return bool(self.spheres.materials.is_dielectric.any()
                    or self.triangles.materials.is_dielectric.any()
                    or self.meshes.mesh_materials.is_dielectric.any())


# ---------------------------------------------------------------------------
# Builder (host-side numpy, then one copy to the device)
# ---------------------------------------------------------------------------

_MAT_DEFAULTS = dict(
    diffuse=(0.0, 0.0, 0.0),
    ambient=(0.0, 0.0, 0.0),
    mirror=(0.0, 0.0, 0.0),
    specular=(0.0, 0.0, 0.0),
    phong=1.0,
    is_mirror=False,
    transparency=(0.0, 0.0, 0.0),
    ior=1.0,
    is_dielectric=False,
)


def make_material(**kw) -> dict:
    """A material record; unspecified fields take reference-default zeros."""
    bad = set(kw) - set(_MAT_DEFAULTS)
    if bad:
        raise ValueError(f"unknown material fields: {bad}")
    out = dict(_MAT_DEFAULTS)
    out.update(kw)
    return out


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype), device=device)


def _mat_soa(records: Sequence[dict], pad_to: int, device) -> Materials:
    n = max(pad_to, 1)
    recs = list(records) + [dict(_MAT_DEFAULTS)] * (n - len(records))
    f32 = lambda k: _t([r[k] for r in recs], device, np.float32)
    b = lambda k: _t([bool(r[k]) for r in recs], device, bool)
    return Materials(
        diffuse=f32("diffuse"), ambient=f32("ambient"), mirror=f32("mirror"),
        specular=f32("specular"), phong=f32("phong"),
        is_mirror=b("is_mirror"), transparency=f32("transparency"),
        ior=f32("ior"), is_dielectric=b("is_dielectric"))


def triangle_normal(v0, v1, v2) -> np.ndarray:
    """Reference normal convention: cross(v2-v0, v1-v0) normalized
    (Data/Objects/Triangle.cs:14-21)."""
    v = np.cross(np.asarray(v2, np.float32) - v0,
                 np.asarray(v1, np.float32) - v0)
    return (v / np.linalg.norm(v)).astype(np.float32)


class SceneBuilder:
    """Accumulates primitives host-side, then freezes into a padded Scene
    on ``device`` (same padding rules as the JAX ``SceneBuilder.build``)."""

    def __init__(self):
        self._spheres: List[Tuple[np.ndarray, float]] = []
        self._sphere_mats: List[dict] = []
        self._tris: List[np.ndarray] = []
        self._tri_normals: List[np.ndarray] = []
        self._tri_mats: List[dict] = []
        self._mesh_tris: List[np.ndarray] = []
        self._mesh_normals: List[np.ndarray] = []
        self._mesh_mats: List[dict] = []
        self._light_pos: List[np.ndarray] = []
        self._light_int: List[np.ndarray] = []
        self._ambient = np.zeros(3, np.float32)

    def add_sphere(self, center, radius: float,
                   material: dict) -> "SceneBuilder":
        self._spheres.append((np.asarray(center, np.float32),
                              float(radius) ** 2))
        self._sphere_mats.append(material)
        return self

    def add_triangle(self, v0, v1, v2, material: dict,
                     normal=None) -> "SceneBuilder":
        self._tris.append(np.asarray([v0, v1, v2], np.float32))
        n = (triangle_normal(v0, v1, v2) if normal is None
             else np.asarray(normal, np.float32))
        self._tri_normals.append(n)
        self._tri_mats.append(material)
        return self

    def add_mesh(self, verts: np.ndarray, faces: np.ndarray, material: dict,
                 flip_normals: bool = True) -> "SceneBuilder":
        """Add an indexed triangle mesh; ``flip_normals`` negates the derived
        normal like the reference mesh bake (SceneMesh.cs:43)."""
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        tris = verts[faces]
        e1 = tris[:, 2] - tris[:, 0]
        e2 = tris[:, 1] - tris[:, 0]
        n = np.cross(e1, e2)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        if flip_normals:
            n = -n
        self._mesh_tris.append(tris.astype(np.float32))
        self._mesh_normals.append(n.astype(np.float32))
        self._mesh_mats.append(material)
        return self

    def add_point_light(self, position, intensity) -> "SceneBuilder":
        self._light_pos.append(np.asarray(position, np.float32))
        i = np.asarray(intensity, np.float32)
        if i.ndim == 0:  # scalar broadcast, as ScenePointLight.cs:9-13 does
            i = np.full(3, float(i), np.float32)
        self._light_int.append(i)
        return self

    def set_ambient(self, radiance) -> "SceneBuilder":
        self._ambient = np.asarray(radiance, np.float32)
        return self

    def build(self, pad_spheres: int = 0, pad_triangles: int = 0,
              pad_mesh_tris: int = 0, pad_meshes: int = 0,
              pad_lights: int = 0, device="cuda") -> Scene:
        S = max(len(self._spheres), pad_spheres, 1)
        T = max(len(self._tris), pad_triangles, 1)
        K = max(len(self._mesh_tris), pad_meshes, 1)
        L = max(len(self._light_pos), pad_lights, 1)

        sc = np.zeros((S, 3), np.float32)
        sr = np.full((S,), 1.0, np.float32)
        sv = np.zeros((S,), bool)
        for i, (c, r2) in enumerate(self._spheres):
            sc[i], sr[i], sv[i] = c, r2, True
        spheres = Spheres(centers=_t(sc, device), radius_sq=_t(sr, device),
                          materials=_mat_soa(self._sphere_mats, S, device),
                          valid=_t(sv, device))

        # degenerate padding triangles at the origin never hit (det 0)
        tv = np.zeros((T, 3, 3), np.float32)
        tn = np.tile(np.array([0, 0, 1], np.float32), (T, 1))
        tvalid = np.zeros((T,), bool)
        for i, tri in enumerate(self._tris):
            tv[i], tn[i], tvalid[i] = tri, self._tri_normals[i], True
        triangles = Triangles(verts=_t(tv, device), normals=_t(tn, device),
                              materials=_mat_soa(self._tri_mats, T, device),
                              valid=_t(tvalid, device))

        if self._mesh_tris:
            mv = np.concatenate(self._mesh_tris, axis=0)
            mn = np.concatenate(self._mesh_normals, axis=0)
            mid = np.concatenate([np.full(len(t), k, np.int32)
                                  for k, t in enumerate(self._mesh_tris)])
        else:
            mv = np.zeros((0, 3, 3), np.float32)
            mn = np.zeros((0, 3), np.float32)
            mid = np.zeros((0,), np.int32)
        M = max(mv.shape[0], pad_mesh_tris, 1)
        mvp = np.zeros((M, 3, 3), np.float32)
        mnp_ = np.tile(np.array([0, 0, 1], np.float32), (M, 1))
        midp = np.zeros((M,), np.int32)
        mvalid = np.zeros((M,), bool)
        mvp[: mv.shape[0]] = mv
        mnp_[: mn.shape[0]] = mn
        midp[: mid.shape[0]] = mid
        mvalid[: mv.shape[0]] = True

        amin = np.full((K, 3), np.inf, np.float32)
        amax = np.full((K, 3), -np.inf, np.float32)
        kvalid = np.zeros((K,), bool)
        for k, t in enumerate(self._mesh_tris):
            amin[k] = t.reshape(-1, 3).min(axis=0)
            amax[k] = t.reshape(-1, 3).max(axis=0)
            kvalid[k] = True
        meshes = MeshSet(
            verts=_t(mvp, device), normals=_t(mnp_, device),
            mesh_id=_t(midp, device), valid=_t(mvalid, device),
            mesh_aabb_min=_t(amin, device), mesh_aabb_max=_t(amax, device),
            mesh_materials=_mat_soa(self._mesh_mats, K, device),
            mesh_valid=_t(kvalid, device))

        lp = np.zeros((L, 3), np.float32)
        li = np.zeros((L, 3), np.float32)
        lv = np.zeros((L,), bool)
        for i, p in enumerate(self._light_pos):
            lp[i], li[i], lv[i] = p, self._light_int[i], True
        lights = Lights(positions=_t(lp, device), intensities=_t(li, device),
                        valid=_t(lv, device),
                        ambient=_t(self._ambient, device, np.float32))

        # scene AABB over valid geometry (Scene.cs:17-41)
        pts = [mv.reshape(-1, 3)] if mv.size else []
        if self._tris:
            pts.append(np.stack(self._tris).reshape(-1, 3))
        for (c, r2) in self._spheres:
            r = np.sqrt(r2)
            pts.append((c - r)[None])
            pts.append((c + r)[None])
        if pts:
            allp = np.concatenate(pts, axis=0)
            aabb_min, aabb_max = allp.min(axis=0), allp.max(axis=0)
        else:
            aabb_min = np.full(3, np.float32(np.finfo(np.float32).max))
            aabb_max = np.full(3, np.float32(np.finfo(np.float32).min))

        aabb_min = aabb_min.astype(np.float32)
        aabb_max = aabb_max.astype(np.float32)
        gate_min, gate_max = pad_box(aabb_min, aabb_max)
        return Scene(spheres=spheres, triangles=triangles, meshes=meshes,
                     lights=lights, aabb_min=_t(aabb_min, device),
                     aabb_max=_t(aabb_max, device),
                     gate_min=_t(gate_min, device),
                     gate_max=_t(gate_max, device))
