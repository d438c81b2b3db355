"""Deployments from their configuration files: the scene and its camera.

A configuration's ``scene`` block describes the world as data: named
materials, meshes (procedural icospheres), spheres, loose triangles,
point lights and the ambient term. ``build`` turns it into host arrays
that the benchmark hands to both sides: the port receives them through
its public ``SceneBuilder`` (``drivers/frames.py``), the reference
(``reference.py``) derives what it needs from them itself.

``icosphere`` is a copy of the port's ``models/meshgen.icosphere`` (the
baseline scenes' mesh generator), so that the benchmark makes its own
inputs; a CPU test holds the arrays to the port's presets.
"""

from __future__ import annotations

import numpy as np

MAT_DEFAULTS = dict(
    diffuse=(0.0, 0.0, 0.0), ambient=(0.0, 0.0, 0.0),
    mirror=(0.0, 0.0, 0.0), specular=(0.0, 0.0, 0.0), phong=1.0,
    is_mirror=False, transparency=(0.0, 0.0, 0.0), ior=1.0,
    is_dielectric=False)
MAT_FIELDS = tuple(MAT_DEFAULTS)


def icosphere(subdivisions: int, radius: float, center):
    """Icosphere with 20 * 4^subdivisions triangles, faces wound CCW seen
    from outside: ``(verts [V,3] float32, faces [F,3] int64)``."""
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
        vlist = list(verts)

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


def material(spec: dict) -> dict:
    bad = set(spec) - set(MAT_DEFAULTS)
    if bad:
        raise ValueError(f"unknown material fields: {sorted(bad)}")
    return {**MAT_DEFAULTS, **spec}


def build(config: dict) -> dict:
    """The deployment of ``config``: ``meshes`` [(verts, faces, material)],
    ``spheres`` [(center, radius, material)], ``triangles`` [((v0, v1,
    v2), material)], ``lights`` [(position, intensity [3])], ``ambient``,
    ``background`` (display scale)."""
    sc = config["scene"]
    mats = {k: material(v) for k, v in sc["materials"].items()}
    meshes = []
    for m in sc.get("meshes", []):
        ico = m["icosphere"]
        v, f = icosphere(ico["subdivisions"], ico["radius"], ico["center"])
        meshes.append((v, f, mats[m["material"]]))
    spheres = [(np.asarray(s["center"], np.float32), float(s["radius"]),
                mats[s["material"]]) for s in sc.get("spheres", [])]
    tris = [(np.asarray(t["verts"], np.float32), mats[t["material"]])
            for t in sc.get("triangles", [])]
    lights = [(np.asarray(li["position"], np.float32),
               np.full(3, float(li["intensity"]), np.float32))
              for li in sc["lights"]]
    return dict(meshes=meshes, spheres=spheres, triangles=tris,
                lights=lights,
                ambient=np.asarray(sc["ambient"], np.float32),
                background=tuple(float(x) for x in
                                 config["render"]["background"]))


def arrays(dep: dict) -> dict:
    """Flat float32 arrays of a deployment, one material table for every
    primitive (``mat_*`` [K]) and per-primitive indices into it."""
    table, mesh_v, mesh_m, sph_c, sph_r2, sph_m, tri_v, tri_m = \
        [], [], [], [], [], [], [], []
    for v, f, mat in dep["meshes"]:
        mesh_v.append(v[f])
        mesh_m.append(np.full(len(f), len(table), np.int64))
        table.append(mat)
    for c, r, mat in dep["spheres"]:
        sph_c.append(c)
        sph_r2.append(np.float32(r ** 2))
        sph_m.append(len(table))
        table.append(mat)
    for v, mat in dep["triangles"]:
        tri_v.append(v)
        tri_m.append(len(table))
        table.append(mat)
    f32 = lambda xs, shape: (np.asarray(xs, np.float32) if len(xs)
                             else np.zeros(shape, np.float32))
    out = dict(
        mesh_verts=(np.concatenate(mesh_v).astype(np.float32) if mesh_v
                    else np.zeros((0, 3, 3), np.float32)),
        mesh_mat=(np.concatenate(mesh_m) if mesh_m
                  else np.zeros((0,), np.int64)),
        sph_center=f32(sph_c, (0, 3)), sph_r2=f32(sph_r2, (0,)),
        sph_mat=np.asarray(sph_m, np.int64),
        tri_verts=f32(tri_v, (0, 3, 3)), tri_mat=np.asarray(tri_m, np.int64),
        light_pos=f32([p for p, _ in dep["lights"]], (0, 3)),
        light_int=f32([i for _, i in dep["lights"]], (0, 3)),
        ambient=dep["ambient"],
        background=np.asarray(dep["background"], np.float32))
    for k in MAT_FIELDS:
        dt = bool if k.startswith("is_") else np.float32
        out["mat_" + k] = np.asarray([m[k] for m in table], dt)
    return out


def camera(config: dict) -> dict:
    """The configuration's camera as plain numbers (``half_v`` 'aspect'
    is ``half_h * height / width``)."""
    cam = dict(config["camera"])
    if cam["half_v"] == "aspect":
        cam["half_v"] = cam["half_h"] * config["height"] / config["width"]
    return cam
