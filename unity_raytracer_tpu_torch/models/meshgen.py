"""Procedural mesh generation (host-side numpy) — a copy of
``unity_raytracer_tpu/models/meshgen.py``, which cannot be imported
without JAX (its package ``__init__`` imports the JAX scene).

The reference gets meshes from Unity assets (SceneComponents/SceneMesh.cs
bakes MeshFilter buffers); this framework generates test geometry
procedurally so every benchmark config is reproducible from code: boxes,
icospheres (subdividable to 10k/100k-triangle budgets), and quads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def quat_rotate(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Rotate points p [*,3] by unit quaternion q=(x,y,z,w) (Unity order)."""
    x, y, z, w = float(q[0]), float(q[1]), float(q[2]), float(q[3])
    u = np.array([x, y, z], np.float64)
    uv = np.cross(u, p)
    uuv = np.cross(u, uv)
    return (p + 2.0 * (w * uv + uuv)).astype(np.float32)


def box_mesh(center=(0.0, 0.0, 0.0), size=(1.0, 1.0, 1.0),
             rotation: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box (optionally rotated): 8 verts, 12 tris.

    Faces wound so that the reference mesh-normal convention — derived
    normal ``cross(v2-v0, v1-v0)`` then negated (SceneMesh.cs:43) — yields
    outward-pointing shading normals.
    """
    hx, hy, hz = [s * 0.5 for s in size]
    corners = np.array([
        [-hx, -hy, -hz], [hx, -hy, -hz], [hx, hy, -hz], [-hx, hy, -hz],
        [-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz],
    ], np.float32)
    # quads (a,b,c,d) CCW viewed from outside
    quads = [
        (0, 3, 2, 1),  # -z
        (4, 5, 6, 7),  # +z
        (0, 4, 7, 3),  # -x
        (1, 2, 6, 5),  # +x
        (0, 1, 5, 4),  # -y
        (3, 7, 6, 2),  # +y
    ]
    faces = []
    for a, b, c, d in quads:
        faces.append((a, b, c))
        faces.append((a, c, d))
    verts = corners
    if rotation is not None:
        verts = quat_rotate(np.asarray(rotation, np.float64), verts)
    verts = verts + np.asarray(center, np.float32)
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def quad_mesh(p0, p1, p2, p3) -> Tuple[np.ndarray, np.ndarray]:
    """Two-triangle quad; corners CCW viewed from the front side."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    faces = np.asarray([(0, 1, 2), (0, 2, 3)], np.int64)
    return verts, faces


def icosphere(subdivisions: int = 3, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Icosphere with 20 * 4^subdivisions triangles.

    subdivisions=4 -> 5120 tris, 5 -> 20480, 6 -> 81920: the knobs for the
    baseline's 10k- and 100k-triangle scenes.
    Faces are wound CCW viewed from outside (so the flipped reference
    convention gives outward normals, as in box_mesh).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        edge_mid: dict = {}
        new_faces = []
        vlist = [v for v in verts]

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = vlist[i] + vlist[j]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    verts = verts * radius + np.asarray(center, np.float64)
    return verts.astype(np.float32), faces


def grid_terrain(nx: int, nz: int, extent: float = 100.0,
                 height: float = 8.0, seed: int = 0,
                 center=(0.0, 0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Bumpy heightfield grid: 2*(nx-1)*(nz-1) triangles. Deterministic."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent / 2, extent / 2, nx)
    zs = np.linspace(-extent / 2, extent / 2, nz)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    # sum of a few random sinusoids — smooth, deterministic terrain
    yy = np.zeros_like(xx)
    for _ in range(6):
        fx, fz = rng.uniform(0.02, 0.15, 2)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.2, 1.0)
        yy += amp * np.sin(fx * xx * 2 * np.pi + ph) * np.cos(fz * zz * 2 * np.pi)
    yy *= height / max(1e-9, np.abs(yy).max())
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    verts = (verts + np.asarray(center, np.float64)).astype(np.float32)

    faces = []
    for i in range(nx - 1):
        for j in range(nz - 1):
            a = i * nz + j
            b = (i + 1) * nz + j
            c = (i + 1) * nz + j + 1
            d = i * nz + j + 1
            faces.append((a, c, b))
            faces.append((a, d, c))
    return verts, np.asarray(faces, np.int64)
