"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

The same scene is built by the JAX package and by the port from one
recipe, so the two sides hold equal arrays; ray batches are made with
numpy from a seed and handed to both.
"""

import dataclasses

import numpy as np
import pytest
import torch


def small_scene(mod_scene, mod_meshgen, glass=False, glass_mesh=False,
                **build_kw):
    """tests/test_mega.py's scene: two-light icosphere mesh, mirror
    sphere, two ground triangles — every feature of the fused segment
    (BVH mesh, sphere, loose tris, shadows, mirror bounce, misses).
    ``glass`` adds cornell_box's glass sphere (ior 1.5, transparency
    0.95): a mesh scene for the dielectric tree. ``glass_mesh`` gives the
    icosphere that glass instead (refracted lanes walk the BVH from inside
    the mesh)."""
    b = mod_scene.SceneBuilder()
    mm = mod_scene.make_material
    glass_mat = lambda: mm(
        specular=(0.6, 0.6, 0.6), phong=300.0,
        transparency=(0.95, 0.95, 0.95), ior=1.5, is_dielectric=True)
    v, f = mod_meshgen.icosphere(subdivisions=2, radius=2.0,
                                 center=(0, 2, 8))
    b.add_mesh(v, f, glass_mat() if glass_mesh else mm(
        diffuse=(0.7, 0.5, 0.2), ambient=(0.7, 0.5, 0.2),
        specular=(0.6, 0.6, 0.6), phong=40.0))
    b.add_sphere((-3, 1.5, 6), 1.5, mm(
        diffuse=(0.1, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
        specular=(1, 1, 1), phong=200.0, mirror=(0.9, 0.9, 0.9),
        is_mirror=True))
    if glass:
        b.add_sphere((4.5, 3.0, 9.0), 3.0, glass_mat())
    g = 30.0
    gmat = mm(diffuse=(0.5, 0.5, 0.55), ambient=(0.5, 0.5, 0.55),
              phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 8, 0), 800.0)
    b.add_point_light((-6, 7, 10), 500.0)
    b.set_ambient((8, 8, 8))
    return b.build(**build_kw)


def replay_scene(mod_scene, mod_meshgen, **build_kw):
    """tests/test_replay.py's scene (:27-55): the small scene plus a
    second, diffuse sphere, so sphere, loose-triangle and mesh winners,
    occluded and lit lights, a mirror chain and misses all show up in a
    16x16 frame through ``CAMERA``."""
    b = mod_scene.SceneBuilder()
    mm = mod_scene.make_material
    v, f = mod_meshgen.icosphere(subdivisions=2, radius=2.0,
                                 center=(0, 2, 8))
    b.add_mesh(v, f, mm(diffuse=(0.7, 0.5, 0.2), ambient=(0.7, 0.5, 0.2),
                        specular=(0.6, 0.6, 0.6), phong=40.0))
    b.add_sphere((-3, 1.5, 6), 1.5, mm(
        diffuse=(0.2, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
        specular=(1, 1, 1), phong=200.0, mirror=(0.9, 0.9, 0.9),
        is_mirror=True))
    b.add_sphere((2.5, 1.0, 4.5), 1.0, mm(
        diffuse=(0.2, 0.6, 0.3), ambient=(0.2, 0.6, 0.3), phong=10.0))
    g = 30.0
    gmat = mm(diffuse=(0.5, 0.5, 0.55), ambient=(0.5, 0.5, 0.55),
              phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 8, 0), 800.0)
    b.add_point_light((-6, 7, 10), 500.0)
    b.set_ambient((8, 8, 8))
    return b.build(**build_kw)


CAMERA = dict(position=(0, 3, -4), forward=(0, -0.15, 1), dist=1.0,
              half_h=0.8, half_v=0.8)


def specular_probe(mod_scene, mod_camera, **kw):
    """tests/test_grad.py:116-141's probe: one big sphere and an
    off-axis light, so a specular highlight covers pixels at 16x16."""
    b = mod_scene.SceneBuilder()
    b.add_sphere((0, 0, 10), 3.0, mod_scene.make_material(
        diffuse=(0.2, 0.2, 0.2), ambient=(0.1, 0.1, 0.1),
        specular=(0.9, 0.9, 0.9), phong=30.0))
    b.add_point_light((3, 4, 0), 20000.0)
    b.set_ambient((10, 10, 10))
    cam = mod_camera.Camera.make(position=(0, 0, 0), forward=(0, 0, 1),
                                 dist=1.0, half_h=0.5, half_v=0.5, width=16,
                                 height=16, **kw)
    return b.build(**kw), cam


def mesh_grad_scene(mod_scene, mod_meshgen, mod_camera, **kw):
    """tests/test_mesh_grad.py:33-50's scene: a 80-triangle icosphere over
    a ground plane, one light, 24x24."""
    b = mod_scene.SceneBuilder()
    mm = mod_scene.make_material
    v, f = mod_meshgen.icosphere(subdivisions=1, radius=2.0,
                                 center=(0, 2, 8))
    b.add_mesh(v, f, mm(diffuse=(0.7, 0.5, 0.2), ambient=(0.7, 0.5, 0.2),
                        specular=(0.4, 0.4, 0.4), phong=30.0))
    g = 30.0
    gmat = mm(diffuse=(0.5, 0.5, 0.55), ambient=(0.5, 0.5, 0.55), phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 9, 2), 900.0)
    b.set_ambient((8, 8, 8))
    cam = mod_camera.Camera.make(position=(0, 2.5, 2), forward=(0, -0.05, 1),
                                 dist=1.0, half_h=0.5, half_v=0.5, width=24,
                                 height=24, **kw)
    return b.build(**kw), cam


def leaves(obj, prefix=""):
    """{path: numpy array} over the array fields of a (nested) dataclass
    — JAX pytrees and port containers share field names; a port field
    the twin lacks (metadata ``port_only``, ``Scene.gate_min`` /
    ``gate_max``) is left out and tested on its own."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.metadata.get("port_only"):
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(leaves(v, prefix + f.name + "."))
        elif isinstance(v, torch.Tensor):
            out[prefix + f.name] = v.cpu().numpy()
        elif hasattr(v, "shape"):
            out[prefix + f.name] = np.asarray(v)
    return out


def assert_same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# the fused kernel's routes the parity tests run: the Baldwin–Weber BVH4
# route and the two of mode (e), Möller–Trumbore on BVH4 rows and on the
# binary layout
LAYOUTS = {"bw4": dict(tri_isect="bw", bvh_arity=4),
           "mt4": dict(tri_isect="mt", bvh_arity=4),
           "binary": dict(tri_isect="mt", bvh_arity=0)}

REC_TOL = dict(rtol=5e-4, atol=5e-4)
BIG = 3.0e38


def record_bad_lanes(got, want):
    """[...lanes] bool mask of hit records that disagree: ``matid`` and
    ``occbits`` exactly, the sign of ``t`` exactly, ``t`` and ``n`` at
    rtol = atol = 5e-4 where ``want`` hits, and ``st`` (when present) at
    that tolerance where below _BIG and exactly _BIG elsewhere."""
    g = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
         for x in got]
    w = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
         for x in want]
    hit = w[0] >= 0
    bad = (g[2] != w[2]) | (g[3] != w[3]) | ((g[0] >= 0) != hit)
    bad |= hit & ~np.isclose(g[0], w[0], **REC_TOL)
    bad |= hit & ~np.isclose(g[1], w[1], **REC_TOL).all(-1)
    if len(w) > 4:
        fin = w[4] < BIG
        st_bad = np.where(fin, ~np.isclose(g[4], w[4], **REC_TOL),
                          g[4] != w[4])
        bad |= st_bad.any(-1)
    return bad


def segment_rays(n, seed, dead_every=7):
    """A numpy ray batch through the small scene from around its camera:
    ``(o, d, thr, tmax)`` with every ``dead_every``-th lane dead
    (tmax = -1) and the rest live (tmax = 3e38)."""
    rng = np.random.default_rng(seed)
    o = (np.array(CAMERA["position"], np.float32)
         + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
    target = np.stack([rng.uniform(-6, 6, n), rng.uniform(-1, 5, n),
                       rng.uniform(4, 12, n)], -1).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    thr = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    tmax = np.full((n,), 3.0e38, np.float32)
    tmax[::dead_every] = -1.0
    return o, d, thr, tmax


@pytest.fixture
def cuda():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (marker gpu)")
    return torch.device("cuda")
