"""PyTorch port: the scene-box gates test the widened box (Queue C #15).

Every gate of the composed path that tests a ray against the scene's
box — ``nearest_hit``, ``shadow_min_t``, the soft replay's shadow gate
(``ops/replay._soft_lighting``), the scene-sharded fold
(``parallel/shard._fold_rest``) — reads ``Scene.gate_min`` /
``gate_max``: the exact box widened once by ``utils/boxes.pad_box``.
The soft replay's ``proxy_risk`` diagnostic widens its mesh-soup box by
the scene gate's pad (``replay._soup_box``). Each gate is driven here
through its own code on the CPU with three boxes — the exact box, the padded one
and none at all (an infinite box: the gate-free brute force) — on rays
made from a seed with numpy and aimed at the box's boundary
(``box_rays``): at its corners, at points of its edges, at the vertices
(mesh, ground) that set a face, and along a face plane at those vertices
(a ray with ``o.y == aabb_max.y`` and ``d.y == 0`` gives ``0 * inf =
NaN`` in the slab test, which culls it). A lane is culled where the
gated result differs from the gate-free one.

Lanes the exact box culls, of the seeded rays (``RAYS`` on the small
scene, ``RAYS_10K`` on ``mesh10k``), and with the padded box:

====================  ============  =============  ======
gate                  small scene   mesh10k        padded
====================  ============  =============  ======
nearest_hit           820 of 4096   402 of 2048    0
shadow_min_t          820           402            0
_fold_rest            820           402            0
replay shadow gate    0             0              0
proxy_risk            0             0              0
====================  ============  =============  ======

The replay's shadow rays and the proxy test's run from points beyond
the targets toward the scenes' lights, which lie outside the box above
it: such a ray passes through the box's inside, so no seeded lane meets
the box at a single point and the exact box culls none. The built
``wall`` scene has the case where it must: a vertical quad (a mesh, and
a loose copy behind it) whose top edge sets ``aabb_max.y``, a light at
that height, and rays in the plane of the top face that hit the edge
(Möller–Trumbore's ``u + v`` is exactly 1 there). The exact box culls
every one of its ``WALL_LANES`` lanes in all five gates, the padded box
none.

``nearest_hit`` and ``shadow_min_t`` are held against the twin's
(``unity_raytracer_tpu/ops/intersect.py:282``, ``ops/shade.py:115``),
which tests the exact box: the lanes that differ are exactly the lanes
the exact box culls, and every other lane agrees at rtol = atol = 5e-4
(kind and index exactly). The lanes that differ are printed (``-s``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import small_scene
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.convert import scene_from_arrays
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import intersect as isect
from unity_raytracer_tpu_torch.ops import replay as rp
from unity_raytracer_tpu_torch.ops import shade
from unity_raytracer_tpu_torch.utils.boxes import box_rays, pad_box
from unity_raytracer_tpu_torch.parallel import shard
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-4)
RAYS, RAYS_10K, SEED = 4096, 2048, 15
# the built case: rays along the top face plane at these x, all hitting
# the wall's top edge, and a light at each x at that height
WALL_X = (0.25, -0.5, 0.5, 0.75)
WALL_LANES = len(WALL_X)
GATES = ("nearest_hit", "shadow_min_t", "fold_rest", "replay", "proxy")


def wall_scene(mod_scene):
    """A vertical quad in z = 5 (a mesh) and its loose copy in z = 6, both
    x in [-1, 1], y in [0, 1]: their top edges set ``aabb_max.y``; a
    light at that height beyond the walls at each ``WALL_X``."""
    b = mod_scene.SceneBuilder()
    mat = mod_scene.make_material(diffuse=(0.5, 0.5, 0.5),
                                  ambient=(0.5, 0.5, 0.5))
    quad = lambda z: np.array([(-1, 0, z), (1, 0, z), (1, 1, z), (-1, 1, z)],
                              np.float32)
    b.add_mesh(quad(5.0), np.array([(0, 1, 2), (0, 2, 3)], np.int32), mat)
    q = quad(6.0)
    b.add_triangle(q[0], q[1], q[2], mat)
    b.add_triangle(q[0], q[2], q[3], mat)
    for x in WALL_X:
        b.add_point_light((x, 1.0, 10.0), 100.0)
    return b


def _scene(name):
    if name == "small":
        return small_scene(t_scene, t_meshgen, device="cpu")
    if name == "mesh10k":
        return get_preset("mesh10k", width=8, height=8, device="cpu")[0]
    return wall_scene(t_scene).build(device="cpu")


def wall_rays():
    """The built case's rays: in the plane y = 1 (the wall's top edge,
    ``aabb_max.y``), from z = 0 along +z at ``WALL_X``."""
    o = np.array([(x, 1.0, 0.0) for x in WALL_X], np.float32)
    d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (WALL_LANES, 1))
    return o, d


def _boxes(scene):
    """The scene with its gate box exact, padded (as built) and infinite."""
    inf = torch.full((3,), torch.inf)
    return {"exact": dataclasses.replace(scene, gate_min=scene.aabb_min,
                                         gate_max=scene.aabb_max),
            "padded": scene,
            "free": dataclasses.replace(scene, gate_min=-inf,
                                        gate_max=inf)}


def _differ(a, b):
    """[N] bool: lanes where two gate results differ (inf equal inf)."""
    out = torch.zeros(a[0].shape[0], dtype=torch.bool)
    for x, y in zip(a, b):
        same = (x == y) | (torch.isinf(x) & torch.isinf(y) & (x == y))
        out |= ~(same.reshape(same.shape[0], -1).all(-1))
    return out


def _shadow_points(scene, tgt, seed):
    """Points beyond ``tgt`` on the line from a light (lane i takes light
    i mod L) through it: their shadow ray toward that light passes
    through ``tgt``."""
    rng = np.random.default_rng(seed)
    lp = scene.lights.positions.numpy()[scene.lights.valid.numpy()]
    light = lp[np.arange(tgt.shape[0]) % lp.shape[0]].astype(np.float64)
    s = rng.uniform(0.05, 1.0, (tgt.shape[0], 1))
    return (tgt + s * (tgt - light)).astype(np.float32)


def _shadow_normals(scene, p):
    """Per lane the unit vector toward its light (lane i takes light i
    mod L): the normal its shadow origin is offset along, so that the
    ray from it toward that light stays on the line through ``p`` and
    the light lights it (``ln`` = 1)."""
    lp = scene.lights.positions[scene.lights.valid]
    v = lp[torch.arange(p.shape[0]) % lp.shape[0]] - p
    return v * torch.rsqrt(isect.dot3(v, v))[:, None]


def _replay_lanes(scene, p, diag=False, box=None):
    """The soft replay's direct lighting at points ``p`` (normals
    ``_shadow_normals``, the loose triangles' material, no mesh record):
    ``(colour,)``, or with ``diag`` its ``proxy_risk`` lanes for the
    mesh-soup box ``box``."""
    n = p.shape[0]
    view = torch.tensor([0.0, 0.0, -1.0]).expand(n, 3)
    mats = rp._take(rp.combined_materials(scene), torch.full(
        (n,), scene.spheres.count, dtype=torch.int64))
    st = torch.full((n, scene.lights.positions.shape[0]), rp._BIG)
    args = (scene, p, _shadow_normals(scene, p), view, mats, st,
            RenderConfig())
    if not diag:
        return (rp._soft_lighting(*args),)
    return rp._soft_lighting(*args, diag_proxy=torch.ones(
        n, dtype=torch.bool), diag_box=box)[3]


def _proxy_under(scene, p, box):
    """[N] bool: lanes whose shadow ray toward a valid light it faces
    meets a mesh triangle by brute force (the gate-free hit) and that the
    ``proxy_risk`` test with ``box`` does not count."""
    risk = _replay_lanes(scene, p, diag=True, box=box)
    nrm = _shadow_normals(scene, p)
    so = p + nrm * rp.SHADOW_EPS
    met = torch.zeros(p.shape[0], dtype=torch.bool)
    for lp, ok in zip(scene.lights.positions, scene.lights.valid):
        ldir = lp[None, :] - p
        ldir = ldir * torch.rsqrt(isect.dot3(ldir, ldir))[:, None]
        t = isect.ray_triangles(so, ldir, scene.meshes.verts,
                                scene.meshes.valid).amin(dim=1)
        met |= bool(ok) & (isect.dot3(ldir, nrm) >= 0.0) & torch.isfinite(t)
    return met & ~risk


def _gate_results(scene, o, d, p):
    """{gate: {box: culled lanes [N] bool}} for the five gates."""
    boxes = _boxes(scene)
    runs = {
        "nearest_hit": lambda sc: (lambda h: (h.t, h.kind, h.index))(
            isect.nearest_hit(sc, o, d)),
        "shadow_min_t": lambda sc: (shade.shadow_min_t(sc, o, d),),
        "fold_rest": lambda sc: shard._fold_rest(
            shard._rest_scene(sc), o, d, *isect._best(isect.ray_triangles(
                o, d, sc.meshes.verts, sc.meshes.valid)))[:3],
        "replay": lambda sc: _replay_lanes(sc, p),
    }
    out = {}
    for gate, run in runs.items():
        res = {k: run(sc) for k, sc in boxes.items()}
        out[gate] = {k: _differ(res[k], res["free"])
                     for k in ("exact", "padded")}
    mv = scene.meshes.verts
    mvalid = scene.meshes.valid[:, None, None]
    exact = (torch.where(mvalid, mv, torch.inf).amin(dim=(0, 1)),
             torch.where(mvalid, mv, -torch.inf).amax(dim=(0, 1)))
    out["proxy"] = {"exact": _proxy_under(scene, p, exact),
                    "padded": _proxy_under(scene, p, rp._soup_box(scene))}
    return out


@pytest.fixture(scope="module")
def gated():
    """Per scene: (rays, {gate: {box: culled lanes}})."""
    out = {}
    for name, n in (("small", RAYS), ("mesh10k", RAYS_10K), ("wall", 0)):
        sc = _scene(name)
        if name == "wall":
            o, d = wall_rays()
            p = o.copy()
        else:
            o, d, tgt = box_rays(sc, n, SEED)
            p = _shadow_points(sc, tgt, SEED)
        o, d, p = (torch.from_numpy(x) for x in (o, d, p))
        out[name] = (sc, o, d, _gate_results(sc, o, d, p))
    return out


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("name", ["small", "mesh10k", "wall"])
def test_padded_gate_culls_no_lane(gated, name, gate):
    sc, o, d, res = gated[name]
    culled = {k: int(v.sum()) for k, v in res[gate].items()}
    print(f"{name} {gate}: exact box culls {culled['exact']} of "
          f"{o.shape[0]} lanes, padded {culled['padded']}")
    assert culled["padded"] == 0
    if name == "wall":   # the built case: the exact box culls every lane
        assert culled["exact"] == WALL_LANES


def _twin_scene(name):
    from unity_raytracer_tpu.models import meshgen, presets, scene
    if name == "small":
        return small_scene(scene, meshgen)
    if name == "mesh10k":
        return presets.get_preset("mesh10k", width=8, height=8)[0]
    return wall_scene(scene).build()


@pytest.mark.parametrize("fn", ["nearest_hit", "shadow_min_t"])
@pytest.mark.parametrize("name", ["small", "mesh10k", "wall"])
def test_gates_against_twin(gated, name, fn):
    """The port (padded box) against the twin (exact box): the lanes that
    differ are the lanes the exact box culls; every other lane agrees at
    5e-4, kind and index exactly."""
    from unity_raytracer_tpu.ops import intersect as j_isect
    from unity_raytracer_tpu.ops import shade as j_shade
    sc, o, d, res = gated[name]
    import jax.numpy as jnp
    js = _twin_scene(name)
    on, dn = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    if fn == "nearest_hit":
        h, jh = isect.nearest_hit(sc, o, d), j_isect.nearest_hit(js, on, dn)
        got = (h.t.numpy(), h.kind.numpy(), h.index.numpy())
        want = tuple(np.asarray(x) for x in (jh.t, jh.kind, jh.index))
    else:
        got = (shade.shadow_min_t(sc, o, d).numpy(),)
        want = (np.asarray(j_shade.shadow_min_t(js, on, dn)),)
    both_inf = np.isinf(got[0]) & np.isinf(want[0])
    off = ~(both_inf | np.isclose(got[0], want[0], **TOL))
    for g, w in zip(got[1:], want[1:]):
        off |= g != w
    culled = res[fn]["exact"].numpy()
    lanes = np.nonzero(off)[0]
    print(f"{name} {fn}: {lanes.size} lanes differ from the twin's "
          f"(first {lanes[:8].tolist()}), the exact box culls "
          f"{int(culled.sum())}")
    np.testing.assert_array_equal(off, culled)


@pytest.mark.parametrize("name", ["small", "mesh10k", "wall", "empty"])
def test_gate_box_is_the_padded_exact_box(name):
    """``gate_min`` / ``gate_max`` are ``pad_box`` of the exact box, bit for
    bit, however the scene is made (the builder, ``scene_from_arrays``,
    ``.to()``, the scene-sharded rest scene), and the exact box is the
    twin's; the fused kernel's aux row 0 holds the same box. An empty
    scene's box stays inverted."""
    from unity_raytracer_tpu_torch.ops.kernels import mega
    if name == "empty":
        sc = t_scene.SceneBuilder().build(device="cpu")
        js = None
    else:
        sc, js = _scene(name), _twin_scene(name)
    lo, hi = pad_box(sc.aabb_min.numpy(), sc.aabb_max.numpy())
    for s in (sc, sc.to("cpu"), shard._rest_scene(sc)):
        np.testing.assert_array_equal(s.gate_min.numpy(), lo)
        np.testing.assert_array_equal(s.gate_max.numpy(), hi)
    aux = mega.build_aux(sc, (0.0, 0.0, 0.0))
    np.testing.assert_array_equal(aux[0, 0:3].numpy(), lo)
    np.testing.assert_array_equal(aux[0, 3:6].numpy(), hi)
    if js is not None:
        np.testing.assert_array_equal(sc.aabb_min.numpy(), js.aabb_min)
        np.testing.assert_array_equal(sc.aabb_max.numpy(), js.aabb_max)
        ca = scene_from_arrays(js, "cpu")
        np.testing.assert_array_equal(ca.gate_min.numpy(), lo)
        np.testing.assert_array_equal(ca.gate_max.numpy(), hi)
        assert (lo < sc.aabb_min.numpy()).all()
        assert (hi > sc.aabb_max.numpy()).all()
    else:
        assert (lo > hi).all()


@pytest.mark.parametrize("name", ["small", "mesh10k", "wall", "empty"])
def test_soup_box_holds_the_padded_soup_box(name):
    """``replay._soup_box`` (the mesh-soup box widened by the scene gate's
    pad) holds ``pad_box`` of the exact soup box on each scene, so the
    ``proxy_risk`` diagnostic counts at least the lanes that rule would;
    an empty mesh keeps an empty box."""
    sc = (t_scene.SceneBuilder().build(device="cpu") if name == "empty"
          else _scene(name))
    mv, ok = sc.meshes.verts, sc.meshes.valid[:, None, None]
    exact = (torch.where(ok, mv, torch.inf).amin(dim=(0, 1)),
             torch.where(ok, mv, -torch.inf).amax(dim=(0, 1)))
    lo, hi = rp._soup_box(sc)
    if name == "empty":
        assert (lo > hi).all()
        return
    want_lo, want_hi = pad_box(*exact)
    assert (lo <= want_lo).all() and (hi >= want_hi).all()
    assert (lo < exact[0]).all() and (hi > exact[1]).all()
