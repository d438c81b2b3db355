"""PyTorch port: the BVH walks and the brute-force nearest triangle against JAX.

The port's traversal wrappers (``traverse_packet3``, ``traverse_packet4``,
``traverse_wide`` at arity 4 and 8) run their plain versions on the CPU
(brute force over every leaf slot); the JAX kernels they replace run in
the Pallas interpreter, as tests/test_pallas_traverse.py and
tests/test_pallas.py run them, and the JAX per-lane ``traverse`` is the
reference the JAX suite holds those kernels to. Every contract of
tests/test_pallas_traverse.py is held here for each layout: nearest hit,
full leaves, ``t_max`` seed and negative cull, any-hit occlusion, an
all-dead batch. Tolerances: hit indices equal except on lanes whose t
ties with another triangle's (counted; none on these meshes), t at rtol
1e-6 (the JAX suite's own), the occlusion predicate exact. The
``gpu``-marked cases hold the CUDA kernels to the plain versions on the
card: t and indices bitwise.
"""

import numpy as np
import pytest
import torch

from torch_parity import cuda  # noqa: F401  (fixture)
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models.convert import (
    mesh_bvh_from_arrays, packed_from_arrays)
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops.kernels import intersect_mk as t_imk
from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as t_mk3
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk4 import (
    traverse_packet4 as t_packet4)
from unity_raytracer_tpu_torch.ops.kernels.traverse_wide import (
    traverse_wide as t_wide)

try:
    import jax
    import jax.numpy as jnp

    from unity_raytracer_tpu.models import meshgen
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.pallas.traverse_mk3 import (
        PALLAS_LEAF, pack_rows, traverse_packet3)
    from unity_raytracer_tpu.ops.pallas.traverse_mk4 import traverse_packet4
    from unity_raytracer_tpu.ops.pallas.traverse_wide import (
        traverse_wide, widen)
except ImportError:  # a machine without JAX runs only the gpu cases
    traverse_packet3 = traverse_packet4 = traverse_wide = None

torch.set_num_threads(1)

T_RTOL = 1e-6
# name -> (port wrapper, JAX kernel, arity)
WALKS = {"mk3": (t_mk3.traverse_packet3, traverse_packet3, 4),
         "mk4": (t_packet4, traverse_packet4, 4),
         "wide4": (t_wide, traverse_wide, 4),
         "wide8": (t_wide, traverse_wide, 8)}


@pytest.fixture
def rng():
    """Seeded per test, so a test's rays do not depend on the order."""
    return np.random.default_rng(3)


def _rays(rng, n, spread=3.0):
    o = rng.normal(size=(n, 3)).astype(np.float32) * spread
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jax_packed(tris, arity):
    b = j_bvh.build(np.asarray(tris), None, leaf_size=PALLAS_LEAF)
    return widen(pack_rows(b), arity=arity)


def _port(jp, device="cpu"):
    return packed_from_arrays(jax.tree.map(np.asarray, jp), device)


@pytest.fixture(scope="module")
def ico():
    v, f = meshgen.icosphere(subdivisions=3, radius=2.0)
    jps = {a: _jax_packed(v[f], a) for a in (4, 8)}
    return jps, {a: _port(jp) for a, jp in jps.items()}


def _walk(name, ico, o, d, **kw):
    fn, _, arity = WALKS[name]
    t, i, _ = fn(ico[1][arity], torch.from_numpy(o), torch.from_numpy(d),
                 **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                    else v for k, v in kw.items()})
    return t.numpy(), i.numpy()


def _ties(t_ref, tris, o, d):
    """Lanes whose nearest t is reached by more than one triangle."""
    from unity_raytracer_tpu.ops.intersect import ray_triangles
    t_all = np.asarray(ray_triangles(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(tris)))
    return np.isfinite(t_ref) & ((t_all == t_ref[:, None]).sum(1) > 1)


def _assert_same_hits(t, i, t_ref, i_ref, tie):
    hit = np.isfinite(t_ref)
    assert (np.isfinite(t) == hit).all()
    off = (i != i_ref) & ~tie
    assert not off.any(), np.nonzero(off)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=T_RTOL)


@pytest.mark.parametrize("name", list(WALKS))
def test_nearest_matches_jax_traverse(rng, ico, name):
    """Nearest (t, MeshSet row) equal to JAX's per-lane ``traverse`` —
    700 rays, not a multiple of the TPU tile."""
    jp = ico[0][WALKS[name][2]]
    o, d = _rays(rng, 700)
    t_ref, i_ref, n_ref = (np.asarray(x) for x in j_bvh.traverse(
        jp.bvh, jnp.asarray(o), jnp.asarray(d)))
    t, i = _walk(name, ico, o, d)
    tie = _ties(t_ref, np.asarray(jp.bvh.tri_verts), o, d)
    _assert_same_hits(t, i, t_ref, i_ref, tie)
    assert np.isfinite(t_ref).mean() > 0.05 and tie.sum() == 0


@pytest.mark.parametrize("name", ["mk3", "mk4", "wide4"])
def test_nearest_matches_pallas_interpreter(rng, ico, name):
    """The same against the JAX kernel itself (Pallas interpreter), on
    256 rays with a t_max cull on every 5th lane."""
    fn_t, fn_j, arity = WALKS[name]
    o, d = _rays(rng, 256)
    tm = np.full((256,), 1e30, np.float32)
    tm[::5] = -1.0
    t_ref, i_ref, n_ref = (np.asarray(x) for x in fn_j(
        ico[0][arity], jnp.asarray(o), jnp.asarray(d),
        t_max=jnp.asarray(tm), interpret=True))
    t, i, n = fn_t(ico[1][arity], torch.from_numpy(o), torch.from_numpy(d),
                   t_max=torch.from_numpy(tm))
    _assert_same_hits(t.numpy(), i.numpy(), t_ref, i_ref,
                      np.zeros(256, bool))
    hit = np.isfinite(t_ref)
    np.testing.assert_allclose(n.numpy()[hit], n_ref[hit], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(WALKS))
def test_random_soup_full_leaves(rng, name):
    """A soup with full leaves (count == PALLAS_LEAF): the leaf loop's
    boundary."""
    m = 420
    tris = (rng.normal(size=(m, 1, 3)) * 4
            + rng.normal(size=(m, 3, 3)) * 0.7).astype(np.float32)
    jp = _jax_packed(tris, WALKS[name][2])
    assert np.asarray(jp.bvh.count).max() == PALLAS_LEAF
    o, d = _rays(rng, 512, spread=5.0)
    t_ref, i_ref, _ = (np.asarray(x) for x in j_bvh.traverse(
        jp.bvh, jnp.asarray(o), jnp.asarray(d)))
    t, i, _ = WALKS[name][0](_port(jp), torch.from_numpy(o),
                             torch.from_numpy(d))
    _assert_same_hits(t.numpy(), i.numpy(), t_ref, i_ref,
                      _ties(t_ref, tris, o, d))


@pytest.mark.parametrize("name", list(WALKS))
def test_tmax_seed_and_negative_cull(rng, ico, name):
    """Hits at or beyond t_max are misses; a negative t_max culls the
    lane outright."""
    jp = ico[0][WALKS[name][2]]
    n = 256
    o, d = _rays(rng, n)
    t_ref, i_ref, _ = (np.asarray(x) for x in j_bvh.traverse(
        jp.bvh, jnp.asarray(o), jnp.asarray(d)))
    hit = np.isfinite(t_ref)
    tm = np.full((n,), 1e30, np.float32)
    below = hit & (np.arange(n) % 2 == 0)
    tm[below] = t_ref[below] * 0.5
    culled = np.arange(n) % 3 == 0
    tm[culled] = -1.0
    t, i = _walk(name, ico, o, d, t_max=tm)
    assert (i[culled] == -1).all() and not np.isfinite(t[culled]).any()
    assert (i[below & ~culled] == -1).all()
    keep = hit & ~below & ~culled
    np.testing.assert_array_equal(i[keep], i_ref[keep])
    np.testing.assert_allclose(t[keep], t_ref[keep], rtol=T_RTOL)


@pytest.mark.parametrize("name", list(WALKS))
def test_any_hit_occlusion(rng, ico, name):
    """any_hit: the occlusion predicate equals the nearest-hit one lane
    for lane, and a reported t is a genuine hit below t_max."""
    jp = ico[0][WALKS[name][2]]
    n = 512
    o, d = _rays(rng, n)
    t_ref = np.asarray(j_bvh.traverse(jp.bvh, jnp.asarray(o),
                                      jnp.asarray(d))[0])
    tm = np.full((n,), 4.0, np.float32)
    t, _ = _walk(name, ico, o, d, t_max=tm, any_hit=True)
    occ = np.isfinite(t) & (t < tm)
    np.testing.assert_array_equal(occ, np.isfinite(t_ref) & (t_ref < tm))
    assert occ.any() and (t[occ] > 0).all()


@pytest.mark.parametrize("name", list(WALKS))
def test_all_dead_batch(rng, ico, name):
    """Every lane culled: every lane reports a miss."""
    o, d = _rays(rng, 128)
    t, i = _walk(name, ico, o, d, t_max=np.full((128,), -1.0, np.float32))
    assert (i == -1).all() and not np.isfinite(t).any()


def test_plain_traverse_matches_jax(rng, ico):
    """``kernel='xla'``: the port's per-lane threaded walk on a plain
    MeshBVH equals JAX's (t, row, shading normal), nearest and any-hit."""
    jp = ico[0][4]
    tb = mesh_bvh_from_arrays(jax.tree.map(np.asarray, jp.bvh), "cpu")
    o, d = _rays(rng, 300)
    tm = np.full((300,), 4.0, np.float32)
    tm[::4] = -1.0
    for kw in (dict(), dict(t_max=tm, any_hit=True)):
        want = [np.asarray(x) for x in j_bvh.traverse(
            jp.bvh, jnp.asarray(o), jnp.asarray(d),
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})]
        got = [x.numpy() for x in t_bvh.traverse(
            tb, torch.from_numpy(o), torch.from_numpy(d),
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})]
        np.testing.assert_array_equal(got[1], want[1])
        hit = want[1] >= 0
        np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=T_RTOL)
        np.testing.assert_allclose(got[2][hit], want[2][hit], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kernel,layout", [
    ("pallas", "mk4"), ("mega", "mk4"), ("auto", None), ("pallas3", "mk3"),
    ("wide", "wide4"), ("xla", None)])
def test_traverse_any_dispatch(rng, ico, monkeypatch, kernel, layout):
    """``traverse_any`` routes each kernel name to its walk ('auto' is the
    plain per-lane walk off the card) and every route gives JAX's hits."""
    seen = []

    def spy(lay, *a, **k):
        seen.append(lay)
        return walk_raw(lay, *a, **k)

    walk_raw = t_mk3.walk_raw
    monkeypatch.setattr(t_mk3, "walk_raw", spy)
    o, d = _rays(rng, 200)
    t, i, _ = t_bvh.traverse_any(ico[1][4], torch.from_numpy(o),
                                 torch.from_numpy(d), kernel=kernel)
    _, i_ref, _ = j_bvh.traverse(ico[0][4].bvh, jnp.asarray(o),
                                 jnp.asarray(d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    assert seen == ([] if layout is None else [layout])


def test_nearest_triangle_matches_jax(rng):
    """Brute-force nearest triangle: a valid mask (half the sphere gone)
    and duplicated triangles, where the first of equal t must win — the
    JAX kernel in the Pallas interpreter, (t, index) equal."""
    v, f = meshgen.icosphere(subdivisions=2, radius=2.0)
    tris = v[f]
    tris = np.concatenate([tris, tris[:40]]).astype(np.float32)
    valid = np.arange(tris.shape[0]) % 2 == 0
    o, d = _rays(rng, 600)
    from unity_raytracer_tpu.ops.pallas.intersect_mk import (
        nearest_triangle_pallas)
    t_ref, i_ref = (np.asarray(x) for x in nearest_triangle_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
        jnp.asarray(valid), interpret=True))
    t, i = t_imk.nearest_triangle_pallas(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tris),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(i.numpy(), i_ref)
    # t to an ulp or two: XLA on the CPU contracts the multiply-adds the
    # port rounds one by one (ROADMAP Queue C #7)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=T_RTOL)
    hit = i_ref >= 0
    assert hit.any() and (i_ref[hit] < 320).all() and valid[i_ref[hit]].all()


@pytest.mark.parametrize("route", ["brute", "bvh", "kernel"])
def test_nearest_hit_matches_jax(rng, route):
    """``nearest_hit`` on its three routes against JAX's: brute force
    (small mesh, no BVH), the BVH walk (kernel='pallas', the plain
    version here), and the brute-force nearest-triangle kernel (a mesh
    of >= 2048 triangles, no BVH, kernel='pallas') — kind, index and
    mesh index equal, t at rtol 1e-6, and the t gradient w.r.t. the mesh
    verts finite and non-zero."""
    from torch_parity import small_scene
    from unity_raytracer_tpu.models import scene as j_scene
    from unity_raytracer_tpu.ops.intersect import nearest_hit as j_nh
    from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
    from unity_raytracer_tpu_torch.models import scene as t_scene
    from unity_raytracer_tpu_torch.ops.intersect import nearest_hit as t_nh
    from unity_raytracer_tpu_torch.utils.config import RenderConfig

    def build(mod_scene, mod_meshgen, **kw):
        if route != "kernel":
            return small_scene(mod_scene, mod_meshgen, **kw)
        b = mod_scene.SceneBuilder()
        v, f = mod_meshgen.icosphere(subdivisions=4, radius=2.0,
                                     center=(0, 2, 8))
        b.add_mesh(v, f, mod_scene.make_material(diffuse=(1, 0, 0)))
        b.add_sphere((-3, 1.5, 6), 1.5, mod_scene.make_material())
        b.add_point_light((0, 5, 0), 100.0)
        return b.build(**kw)

    js = build(j_scene, meshgen)
    ts = build(t_scene, t_meshgen, device="cpu")
    o = (np.array([0, 3, -4], np.float32)
         + rng.uniform(-0.5, 0.5, (400, 3)).astype(np.float32))
    tgt = np.stack([rng.uniform(-5, 5, 400), rng.uniform(-1, 5, 400),
                    rng.uniform(4, 12, 400)], -1).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cfg = RenderConfig(use_bvh=True, bvh_leaf=14, kernel="pallas")
    jb = j_bvh.prepare_bvh(js, cfg) if route == "bvh" else None
    tb = t_bvh.prepare_bvh(ts, cfg) if route == "bvh" else None
    want = j_nh(js, jnp.asarray(o), jnp.asarray(d), bvh=jb,
                kernel="xla" if route == "brute" else "pallas")
    verts = ts.meshes.verts.clone().requires_grad_(True)
    import dataclasses
    ts = dataclasses.replace(ts, meshes=dataclasses.replace(ts.meshes,
                                                            verts=verts))
    got = t_nh(ts, torch.from_numpy(o), torch.from_numpy(d), bvh=tb,
               kernel="xla" if route == "brute" else "pallas")
    for k in ("kind", "index", "mesh_index"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    hit = np.asarray(want.kind) != 0
    np.testing.assert_allclose(got.t.detach().numpy()[hit],
                               np.asarray(want.t)[hit], rtol=T_RTOL)
    assert (np.asarray(want.kind) == 1).any()
    if route != "bvh":  # the BVH epilogue reads bvh.tri_verts (bind_verts)
        fin = torch.isfinite(got.t)
        torch.where(fin, got.t, 0.0).sum().backward()
        assert torch.isfinite(verts.grad).all() and verts.grad.abs().max() > 0


def test_bind_verts_matches_jax():
    """``bind_verts`` gathers the epilogue's triangles from the scene's
    verts through the winding flip, as JAX's does."""
    from torch_parity import small_scene
    from unity_raytracer_tpu.models import scene as j_scene
    from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
    from unity_raytracer_tpu_torch.models import scene as t_scene
    from unity_raytracer_tpu_torch.utils.config import RenderConfig
    import dataclasses
    cfg = RenderConfig(use_bvh=True, bvh_leaf=14, kernel="xla")

    def flipped(s):  # every 3rd mesh row wound against its normal
        v = s.meshes.verts
        v3 = v[:, (0, 2, 1)]
        keep = (np.arange(v.shape[0]) % 3 != 0)[:, None, None]
        v = (np.where(keep, np.asarray(v), np.asarray(v3))
             if not isinstance(v, torch.Tensor)
             else torch.where(torch.from_numpy(keep), v, v3))
        return dataclasses.replace(s, meshes=dataclasses.replace(
            s.meshes, verts=v if isinstance(v, torch.Tensor)
            else jnp.asarray(v)))

    js = flipped(small_scene(j_scene, meshgen))
    ts = flipped(small_scene(t_scene, t_meshgen, device="cpu"))
    jb, tb = j_bvh.prepare_bvh(js, cfg), t_bvh.prepare_bvh(ts, cfg)
    assert np.asarray(jb.flip).any()
    np.testing.assert_array_equal(
        t_bvh.bind_verts(tb, ts).tri_verts.numpy(),
        np.asarray(j_bvh.bind_verts(jb, js).tri_verts))
    pk = t_bvh.prepare_bvh(ts, cfg.with_(kernel="pallas"))
    np.testing.assert_array_equal(t_bvh.bind_verts(pk, ts).bvh.tri_verts
                                  .numpy(), pk.bvh.tri_verts.numpy())


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

def _card_packed(arity, device):
    """A subdivision-4 icosphere's packed BVH built by the port alone."""
    from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import pack_rows
    from unity_raytracer_tpu_torch.ops.kernels.traverse_wide import widen
    v, f = t_meshgen.icosphere(subdivisions=4, radius=2.0)
    b = t_bvh.build(v[f], leaf_size=t_mk3.PALLAS_LEAF)
    return widen(pack_rows(b), arity=arity).to(device), v[f]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(t_mk3.LAYOUTS))
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain_on_card(cuda, rng, layout, any_hit):
    packed, _ = _card_packed(8 if layout == "wide8" else 4, cuda)
    o, d = (torch.from_numpy(x).to(cuda) for x in _rays(rng, 3000))
    tm = torch.full((3000,), 3.0 if any_hit else 3e38, device=cuda)
    tm[::7] = -1.0
    before = t_mk3.launches[layout]
    got = t_mk3.walk_raw(layout, packed, o, d, tm, any_hit)
    assert t_mk3.launches[layout] == before + 1
    want = t_mk3.traverse_plain(packed, o, d, tm, any_hit)
    if any_hit:
        assert torch.equal(got[0] < 0, want[0] < 0)
    else:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_nearest_triangle_on_card(cuda, rng):
    _, tris = _card_packed(4, cuda)
    tris = torch.from_numpy(tris.astype(np.float32)).to(cuda)
    valid = torch.arange(tris.shape[0], device=cuda) % 3 != 0
    o, d = (torch.from_numpy(x).to(cuda) for x in _rays(rng, 3000))
    before = t_imk.launches["nearest_triangle"]
    got = t_imk.nearest_triangle_pallas(o, d, tris, valid)
    assert t_imk.launches["nearest_triangle"] == before + 1
    want = t_imk.nearest_triangle_plain(o, d, tris, valid)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def _dup_packed(arity, leaf, device):
    """A subdivision-3 icosphere with every third triangle twice (exact t
    ties inside and across leaves), packed with ``leaf``-slot leaves (98:
    7 rows and 14 slot groups per leaf, most leaves shorter than that)."""
    from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import pack_rows
    from unity_raytracer_tpu_torch.ops.kernels.traverse_wide import widen
    v, f = t_meshgen.icosphere(subdivisions=3, radius=2.0)
    tris = np.concatenate([v[f], v[f][::3]]).astype(np.float32)
    b = t_bvh.build(tris, leaf_size=leaf)
    return widen(pack_rows(b, leaf_slots=max(leaf, t_mk3.PALLAS_LEAF)),
                 arity=arity).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["mk3", "wide4", "wide8"])
@pytest.mark.parametrize("leaf", [14, 98])
@pytest.mark.parametrize("any_hit", [False, True])
def test_cooperative_leaf_walks_match_plain_on_card(cuda, rng, layout, leaf,
                                                    any_hit):
    """The walks with the warp-cooperative leaf phase (MK3, WIDE) on
    multi-row leaves and duplicated triangles: t bitwise; the triangle the
    plain version's first-in-(row, slot) order picks wherever no other
    triangle ties its t, and a triangle at exactly that t where one does;
    the occlusion predicate exactly."""
    packed = _dup_packed(8 if layout == "wide8" else 4, leaf, cuda)
    o, _ = _rays(rng, 4000)
    d = rng.normal(size=(4000, 3)).astype(np.float32) * 1.2 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)   # toward the sphere
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    tm = torch.full((4000,), 3e38, device=cuda)
    tm[1::3] = 2.5 if any_hit else 4.0
    tm[::7] = -1.0
    got = t_mk3.walk_raw(layout, packed, o, d, tm, any_hit)
    want = t_mk3.traverse_plain(packed, o, d, tm, any_hit)
    if any_hit:
        assert torch.equal(got[0] < 0, want[0] < 0)
        assert torch.equal(got[1] >= 0, want[1] >= 0)
        return
    assert torch.equal(got[0], want[0])
    same = (got[1] == want[1]) & (got[2] == want[2])
    i = torch.nonzero(~same).squeeze(1)
    from unity_raytracer_tpu_torch.ops.kernels.mega import _mt
    v = packed.tris[got[2][i].long(), :126].reshape(-1, 14, 9)[
        torch.arange(i.numel(), device=cuda), got[1][i].long()]
    ok, t_k = _mt(tuple(c[i] for c in o.unbind(-1)),
                  tuple(c[i] for c in d.unbind(-1)), v.T)
    assert bool((ok & (t_k == want[0][i])).all())
    assert int((want[1] >= 0).sum()) > 1000
