"""The BVH refit (``ops/bvh.refit``) and mesh-geometry fits (``mesh_positions``).

The refit rewrites every row of a tree built by ``prepare_bvh`` from the
scene's current mesh verts, on the device: the CPU cases hold each array
to what the host packers (``pack_rows``, ``widen``, ``pack_bw``) write for
the moved verts under the same topology, the plain walk over a refit tree
to brute force, and the scene's gates to a scene built from the moved
mesh. ``mesh_positions`` moves a mesh's shared vertices: its gradient is
the sum of its corners' ``mesh_verts`` gradients, a fit moving it follows
the benchmark's plain reference (``raybench/reference_mesh``), and the
benchmark's geometry-fit cell reads ``correct`` false with the refit
switched off. The ``gpu`` cases hold the CUDA refit to the CPU's bit for
bit, and the card's walks (mk4, wide4, wide8) and kernel #1's forward
segment over a refit tree to their plain versions on lanes aimed at the
moved triangles' corners; they skip without a card (decided inside the
test).
"""

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from unity_raytracer_tpu_torch import fit as t_fit
from unity_raytracer_tpu_torch.models import meshgen
from unity_raytracer_tpu_torch.models.camera import Camera
from unity_raytracer_tpu_torch.models.scene import SceneBuilder, make_material
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import intersect as isect
from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
from unity_raytracer_tpu_torch.ops.kernels.traverse_wide import widen
from unity_raytracer_tpu_torch.ops.render import render, resolve_mode
from unity_raytracer_tpu_torch.utils import profiling
from unity_raytracer_tpu_torch.utils.config import RenderConfig

MESHES = ((2, 6.0, (0, 6, 30)), (1, 3.0, (9, 3, 22)))
AMBER = make_material(diffuse=(0.75, 0.55, 0.25), ambient=(0.75, 0.55, 0.25),
                      specular=(0.6, 0.6, 0.6), phong=40.0)


def _scene(positions=None, meshes=MESHES, device="cpu"):
    """Icospheres (``positions``: their vertices in place of the
    generator's), a mirror sphere, the ground, three lights."""
    b = SceneBuilder()
    at = 0
    for sub, rad, c in meshes:
        v, f = meshgen.icosphere(subdivisions=sub, radius=rad, center=c)
        if positions is not None:
            v = positions[at: at + len(v)]
        at += len(v)
        b.add_mesh(v, f, AMBER)
    b.add_sphere((-8, 4, 26), 4.0, make_material(
        diffuse=(0.1, 0.1, 0.1), ambient=(0.1, 0.1, 0.1), specular=(1, 1, 1),
        phong=200.0, mirror=(0.85, 0.85, 0.85), is_mirror=True))
    g = make_material(diffuse=(0.6, 0.6, 0.62), ambient=(0.6, 0.6, 0.62))
    b.add_triangle((-80, 0, -80), (80, 0, -80), (80, 0, 80), g)
    b.add_triangle((-80, 0, -80), (80, 0, 80), (-80, 0, 80), g)
    for p, i in (((15, 25, 5), 12000.0), ((-20, 18, 35), 6000.0),
                 ((0, 30, 50), 8000.0)):
        b.add_point_light(p, i)
    b.set_ambient((6, 6, 6))
    return b.build(device=device)


def _moved(scene, seed, amp=0.3):
    """The scene's shared vertices moved by seeded offsets in +-amp."""
    pos = scene.meshes.positions.cpu().numpy()
    rng = np.random.default_rng(seed)
    return (pos + rng.uniform(-amp, amp, pos.shape)).astype(np.float32)


def _host_rows(packed, moved, leaf, arity):
    """What the host packers write for ``moved``'s mesh under ``packed``'s
    topology: node boxes over each node's triangles in leaf order, then
    ``pack_rows``, ``widen`` and ``pack_bw`` (or the bare tree)."""
    inner = packed.bvh if isinstance(packed, m3.PackedBVH) else packed
    tv = t_bvh.canonical_winding(moved.meshes.verts.numpy(),
                                 moved.meshes.normals.numpy())
    tv = tv[np.asarray(inner.prim_index)]
    first, count = np.asarray(inner.first), np.asarray(inner.count)
    miss = np.asarray(inner.miss_next)
    nn = len(first)
    span = {}
    for i in range(nn - 1, -1, -1):
        if count[i] > 0:
            span[i] = (first[i], first[i] + count[i])
        else:
            span[i] = (span[i + 1][0], span[int(miss[i + 1])][1])
    nmin = np.stack([tv[a:b].reshape(-1, 3).min(0) for a, b in
                     (span[i] for i in range(nn))]) - inner.aabb_pad
    nmax = np.stack([tv[a:b].reshape(-1, 3).max(0) for a, b in
                     (span[i] for i in range(nn))]) + inner.aabb_pad
    mb = dataclasses.replace(inner, node_min=nmin.astype(np.float32),
                             node_max=nmax.astype(np.float32), tri_verts=tv,
                             refit_tables=None)
    if not isinstance(packed, m3.PackedBVH):
        return mb
    rows = m3.pack_rows(mb, leaf_slots=leaf)
    return m3.pack_bw(widen(rows, arity=arity))


ROUTES = {  # kernel, bvh_leaf, bvh_arity, bvh_pad
    "bvh4_leaf98": ("mega", 98, 4, 0.0),
    "bvh8_leaf14": ("mega", 14, 8, 0.0),
    "binary_leaf14": ("mega", 14, 0, 0.0),
    "bvh4_padded": ("pallas", 14, 4, 0.25),
    "plain_tree": ("xla", 4, 4, 0.0),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_refit_rows_equal_host_packers(route):
    kernel, leaf, arity, pad = ROUTES[route]
    scene = _scene()
    cfg = RenderConfig(use_bvh=True, kernel=kernel, bvh_leaf=leaf,
                       bvh_arity=arity, bvh_pad=pad, tri_isect="bw")
    built = t_bvh.prepare_bvh(scene, cfg, "cpu")
    moved = _scene(_moved(scene, 3))
    got, _ = t_bvh.refit(built, moved)
    want = _host_rows(built, moved, leaf, arity)
    inner = got.bvh if kernel != "xla" else got
    w_inner = want.bvh if kernel != "xla" else want
    for k in ("node_min", "node_max", "tri_verts"):
        assert torch.equal(getattr(inner, k),
                           torch.as_tensor(getattr(w_inner, k))), k
    if kernel == "xla":
        return
    for k in ("nodes", "nodes_walk", "tris", "leafbox", "tris_bw", "wide",
              "wide_walk"):
        if getattr(want, k) is None:          # a binary tree has no wide rows
            assert getattr(got, k) is None, k
        else:
            assert torch.equal(getattr(got, k), getattr(want, k)), k
    # what the refit keeps
    for k in ("leaf_prim", "leafmeta", "wide_node"):
        assert getattr(got, k) is getattr(built, k), k
    assert (got.stack_binary, got.stack_wide) == (built.stack_binary,
                                                  built.stack_wide)
    # refit back to the build's verts: the prepared tree, every array
    back, _ = t_bvh.refit(got, scene)
    for k in ("nodes", "nodes_walk", "tris", "leafbox", "tris_bw", "wide",
              "wide_walk"):
        if getattr(built, k) is not None:
            assert torch.equal(getattr(back, k), getattr(built, k)), k


def test_refit_of_a_padded_scene_is_the_build():
    """A scene built with pad rows and pad meshes, refit to its own verts:
    the tree's rows and the scene's exact, gate and mesh boxes as built
    (a pad mesh keeps its empty box)."""
    b = SceneBuilder()
    for sub, rad, c in MESHES:
        v, f = meshgen.icosphere(subdivisions=sub, radius=rad, center=c)
        b.add_mesh(v, f, AMBER)
    b.add_sphere((-8, 4, 26), 4.0, AMBER)
    b.add_point_light((15, 25, 5), 12000.0)
    scene = b.build(device="cpu", pad_mesh_tris=500, pad_meshes=4)
    assert not scene.meshes.mesh_valid[2:].any()
    cfg = RenderConfig(use_bvh=True, kernel="mega", bvh_leaf=14)
    built = t_bvh.prepare_bvh(scene, cfg, "cpu")
    tree, got = t_bvh.refit(built, scene)
    for k in ("nodes", "nodes_walk", "tris", "leafbox", "tris_bw", "wide",
              "wide_walk"):
        assert torch.equal(getattr(tree, k), getattr(built, k)), k
    for k in ("aabb_min", "aabb_max", "gate_min", "gate_max"):
        assert torch.equal(getattr(got, k), getattr(scene, k)), k
    for k in ("mesh_aabb_min", "mesh_aabb_max"):
        assert torch.equal(getattr(got.meshes, k),
                           getattr(scene.meshes, k)), k


def test_refit_refuses_a_presplit_tree():
    scene = _scene()
    cfg = RenderConfig(use_bvh=True, kernel="mega", bvh_leaf=14,
                       bvh_presplit=0.3)
    with pytest.raises(ValueError, match="presplit"):
        t_bvh.refit(t_bvh.prepare_bvh(scene, cfg, "cpu"), scene)


def _aimed_rays(scene, n, seed):
    """Seeded rays from around the meshes toward points of random mesh
    triangles near their corners and edges (Dirichlet weights 0.05)."""
    rng = np.random.default_rng(seed)
    tri = scene.meshes.verts.cpu().numpy()[scene.meshes.valid.cpu().numpy()]
    pick = rng.integers(0, len(tri), n)
    w = rng.dirichlet([0.05] * 3, n)
    tgt = (w[:, :, None] * tri[pick]).sum(1)
    c = tri.reshape(-1, 3).mean(0)
    u = rng.standard_normal((n, 3))
    o = c + 30.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dev = scene.aabb_min.device
    return (torch.as_tensor(o, dtype=torch.float32, device=dev),
            torch.as_tensor(d, dtype=torch.float32, device=dev))


def _brute(scene, o, d):
    """Nearest mesh triangle by brute force: (t, MeshSet row)."""
    t = isect.ray_triangles(o, d, scene.meshes.verts, scene.meshes.valid)
    tmin, i = t.min(dim=1)
    return tmin, torch.where(torch.isfinite(tmin), i, -1)


def test_plain_walk_over_a_refit_tree_is_brute_force():
    """The plain per-lane walk (``traverse``, node boxes and leaf order)
    over the refit tree finds the brute-force nearest triangle of the
    moved mesh on lanes aimed at its corners and edges; over the tree as
    built it does not."""
    scene = _scene()
    cfg = RenderConfig(use_bvh=True, kernel="xla")
    built = t_bvh.prepare_bvh(scene, cfg, "cpu")
    moved = _scene(_moved(scene, 5))
    tree, _ = t_bvh.refit(built, moved)
    o, d = _aimed_rays(moved, 4096, 7)
    t_b, i_b = _brute(moved, o, d)
    t_w, i_w, _ = t_bvh.traverse(tree, o, d)
    assert torch.equal(torch.isfinite(t_w), torch.isfinite(t_b))
    hit = torch.isfinite(t_b)
    # another triangle only at the same t (a shared edge or corner)
    torch.testing.assert_close(t_w[hit], t_b[hit], rtol=1e-6, atol=1e-6)
    stale, _, _ = t_bvh.traverse(dataclasses.replace(
        built, tri_verts=tree.tri_verts), o, d)
    assert (stale != t_b).sum() > 100


def test_gates_follow_the_vertices():
    """The refit scene's exact and gate boxes and mesh boxes are those a
    scene built from the moved mesh has, and ``nearest_hit`` keeps a hit
    that lies outside the build's box."""
    scene = _scene()
    pos = scene.meshes.positions.numpy().copy()
    top = int(np.argmax(pos[:, 1]))
    pos[top, 1] += 10.0           # above everything the build bounded
    moved = _scene(pos)
    cfg = RenderConfig(use_bvh=True, kernel="mega", bvh_leaf=14)
    tree, refit_scene = t_bvh.refit(t_bvh.prepare_bvh(scene, cfg, "cpu"),
                                    moved)
    for k in ("aabb_min", "aabb_max", "gate_min", "gate_max"):
        assert torch.equal(getattr(refit_scene, k), getattr(moved, k)), k
    for k in ("mesh_aabb_min", "mesh_aabb_max"):
        assert torch.equal(getattr(refit_scene.meshes, k),
                           getattr(moved.meshes, k)), k
    assert refit_scene.aabb_max[1] > scene.aabb_max[1] + 5.0
    # a level ray at the raised vertex's spike, above the build's box
    face = moved.meshes.faces[(moved.meshes.faces == top).any(1)][0]
    aim = (0.8 * torch.as_tensor(pos[top]) + 0.1 * torch.as_tensor(
        pos[[int(i) for i in face if int(i) != top]]).sum(0))
    assert aim[1] > scene.aabb_max[1] + 2.0
    o = (aim - torch.tensor([10.0, 0.0, 0.0]))[None]
    d = torch.tensor([[1.0, 0.0, 0.0]])
    stale_scene = dataclasses.replace(refit_scene, aabb_min=scene.aabb_min,
                                      aabb_max=scene.aabb_max,
                                      gate_min=scene.gate_min,
                                      gate_max=scene.gate_max)
    want, _ = _brute(moved, o, d)
    got = isect.nearest_hit(refit_scene, o, d, bvh=tree, kernel="pallas")
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got.t, want, rtol=1e-6, atol=1e-6)
    assert not torch.isfinite(isect.nearest_hit(
        stale_scene, o, d, bvh=tree, kernel="pallas").t).any()


def _small_fit_scene(device="cpu", seed=0):
    """One subdivision-1 icosphere over the ground with a mirror sphere,
    three lights; a 32x32 camera; the shared vertices moved by seeded
    offsets (0.1)."""
    meshes = ((1, 2.0, (0, 2, 10)),)
    scene = _scene(meshes=meshes, device=device)
    cam = Camera.make(position=(0, 3, 2), forward=(0, -0.1, 1), dist=1.0,
                      half_h=0.35, half_v=0.35, width=32, height=32,
                      device=device)
    start = torch.as_tensor(_moved(scene, seed, 0.1), device=device)
    return scene, cam, start


def test_mesh_positions_gradient_sums_the_corners():
    """``mesh_positions``' gradient is the sum, over the corners that
    share a vertex, of ``mesh_verts``' gradient of the same render."""
    scene, cam, start = _small_fit_scene()
    cfg = resolve_mode(scene, RenderConfig(max_bounces=1, use_bvh=True,
                                           kernel="pallas", bvh_leaf=14))
    tree, moved = t_bvh.refit(t_bvh.prepare_bvh(scene, cfg, "cpu"),
                              t_fit.set_params(scene, {"mesh_positions":
                                                       start}))
    p = start.clone().requires_grad_(True)
    s_p = t_fit.set_params(moved, {"mesh_positions": p})
    render(s_p, cam, cfg, bvh=t_bvh.bind_verts(tree, s_p)).sum().backward()
    v = moved.meshes.verts.detach().clone().requires_grad_(True)
    s_v = t_fit.set_params(moved, {"mesh_verts": v})
    render(s_v, cam, cfg, bvh=t_bvh.bind_verts(tree, s_v)).sum().backward()
    summed = torch.zeros_like(p).index_add_(
        0, moved.meshes.faces.reshape(-1), v.grad.reshape(-1, 3))
    assert p.grad.abs().max() > 0
    torch.testing.assert_close(p.grad, summed, rtol=1e-5, atol=1e-6)


def test_fit_follows_the_plain_reference():
    """Three steps of ``fit.fit`` on ``mesh_positions`` (the composed
    chunked path, the refit every step) against
    ``raybench/reference_mesh``: the losses, the first gradient and the
    positions after the steps."""
    from raybench import reference as ref_mod, scene as scn
    from raybench.reference_mesh import MeshFit
    scene, cam, start = _small_fit_scene(seed=1)
    cfg = resolve_mode(scene, RenderConfig(
        max_bounces=1, background=(0.04, 0.05, 0.07), use_bvh=True,
        kernel="pallas", bvh_leaf=14, ray_chunk=256, remat=True))
    bvh = t_bvh.prepare_bvh(scene, cfg, "cpu")
    target = render(scene, cam, cfg, bvh=bvh)
    first = {}

    def keep(grads, params):
        first.setdefault("g", grads["mesh_positions"].clone())
        return grads

    res = t_fit.fit(scene, cam, cfg, target, t_fit.FitConfig(
        param_names=("mesh_positions",), learning_rate=0.005, steps=3,
        soft_shadow_temp=1.0, soft_hit_temp=0.1, log_every=0),
        init_params={"mesh_positions": start}, bvh=bvh, grad_transform=keep)
    # the reference, from the deployment's own arrays
    dep = {"meshes": [], "spheres": [], "triangles": [], "lights": []}
    for sub, rad, c in ((1, 2.0, (0, 2, 10)),):
        v, f = meshgen.icosphere(subdivisions=sub, radius=rad, center=c)
        dep["meshes"].append((v, f, scn.material(AMBER)))
    dep["spheres"].append((np.float32([-8, 4, 26]), 4.0, scn.material(
        dict(diffuse=(0.1, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
             specular=(1, 1, 1), phong=200.0, mirror=(0.85, 0.85, 0.85),
             is_mirror=True))))
    gmat = scn.material(dict(diffuse=(0.6, 0.6, 0.62),
                             ambient=(0.6, 0.6, 0.62)))
    for t in (((-80, 0, -80), (80, 0, -80), (80, 0, 80)),
              ((-80, 0, -80), (80, 0, 80), (-80, 0, 80))):
        dep["triangles"].append((np.float32(t), gmat))
    for p, i in (((15, 25, 5), 12000.0), ((-20, 18, 35), 6000.0),
                 ((0, 30, 50), 8000.0)):
        dep["lights"].append((np.float32(p), np.full(3, i, np.float32)))
    dep.update(ambient=np.float32([6, 6, 6]), background=(0.04, 0.05, 0.07))
    mf = MeshFit(scn.arrays(dep), dep["meshes"][0][1], 1, "cpu", 0.1, 1.0)
    idx = np.arange(32 * 32)
    cp = dict(position=(0, 3, 2), forward=(0, -0.1, 1), up=(0, 1, 0),
              dist=1.0, half_h=0.35, half_v=0.35)
    o, d = ref_mod.camera_rays(cp, 32, 32, idx % 32, idx // 32, "cpu")
    losses, g, p = mf.steps(start, o, d, mf.target(o, d), 3, 0.005)
    np.testing.assert_allclose(res.losses, losses, rtol=1e-4)
    gap = torch.linalg.vector_norm(first["g"] - g) / torch.linalg.vector_norm(g)
    assert gap < 1e-3, gap
    torch.testing.assert_close(res.params["mesh_positions"], p, rtol=0,
                               atol=1e-5)


def _tiny_cell():
    """The benchmark's mesh10k.fit_mesh cell at 32x32, icospheres of
    subdivision 1, 14-triangle leaves, the walks' plain versions."""
    from raybench import run
    spec = copy.deepcopy(run.cell_spec("mesh10k.fit_mesh"))
    conf = spec["config"]
    conf["width"] = conf["height"] = 32
    for m in conf["scene"]["meshes"]:
        m["icosphere"]["subdivisions"] = 1
    conf["render"]["bvh_leaf"] = 14
    spec["traffic"]["render"]["kernel"] = "pallas"
    return spec


class _NoStep(torch.optim.Adam):
    def step(self, closure=None):   # the state comes back unchanged
        return None


@pytest.mark.parametrize("fault", [None, "refit_off", "unchanged",
                                   "half_batch"])
def test_fit_mesh_cell_without_the_refit_is_not_correct(fault, monkeypatch):
    """The geometry-fit cell, driven on the CPU: sound it reads correct;
    its check fails with the refit switched off (the tree and gates of
    the build kept for every step), with Adam's step a no-op (the state
    unchanged), and with the loss and gradient taken over the first half
    of the image's lanes only (the lane weights of the second half
    zeroed, as the fit cells' fault tests plant it)."""
    from raybench import guard, run
    # the suite's conftest loads JAX; the program under test does not
    monkeypatch.setattr(guard, "check", lambda: None)

    def hook(drv):
        if fault == "refit_off":
            monkeypatch.setattr(drv.fitmod, "refit",
                                lambda bvh, scene: (bvh, scene))
        elif fault == "unchanged":
            monkeypatch.setattr(drv.fitmod.torch.optim, "Adam", _NoStep)
        elif fault == "half_batch":
            weights = drv.fitmod._lane_weights

            def half(cam, rcfg, dev):
                w = weights(cam, rcfg, dev).clone()
                w[w.shape[0] // 2:] = 0.0
                return w
            monkeypatch.setattr(drv.fitmod, "_lane_weights", half)

    res = run.execute(_tiny_cell(), 2 ** 31 + 99, 0.3, False, "cpu",
                      time.perf_counter(), driver_hook=hook)
    assert res["correct"] is (fault is None), res["checks"]
    assert "fit_step_s" in res["metrics"]


def test_refit_spans_and_counter():
    """A mesh fit's step refits once under ``bvh.refit`` (stages leaves,
    nodes, gates) and counts nothing there (a recorded step makes the
    launches an unrecorded one makes); a fit of the spheres alone opens
    no refit span."""
    scene, cam, start = _small_fit_scene()
    cfg = resolve_mode(scene, RenderConfig(
        max_bounces=0, use_bvh=True, kernel="pallas", bvh_leaf=14,
        ray_chunk=512, remat=True))
    bvh = t_bvh.prepare_bvh(scene, cfg, "cpu")
    target = render(scene, cam, cfg, bvh=bvh)
    fc = dict(learning_rate=0.005, steps=2, log_every=0)
    with profiling.recording() as rec:
        t_fit.fit(scene, cam, cfg, target, t_fit.FitConfig(
            param_names=("mesh_positions",), **fc),
            init_params={"mesh_positions": start}, bvh=bvh)
    names = [s["name"] for s in rec.spans]
    assert names.count("bvh.refit") == 2
    for stage in ("leaves", "nodes", "gates"):
        assert names.count(f"bvh.refit.{stage}") == 2
    by_id = {s["id"]: s for s in rec.spans}
    for s in rec.spans:
        if s["name"] == "bvh.refit":
            assert by_id[s["parent"]]["name"] == "fit.value_and_grad"
    refit_ids = {s["id"] for s in rec.spans
                 if s["name"].startswith("bvh.refit")}
    assert not [c for c in rec.counts if c["span"] in refit_ids]
    with profiling.recording() as rec:
        t_fit.fit(scene, cam, cfg, target, t_fit.FitConfig(
            param_names=("sphere_centers",), **fc), bvh=bvh)
    assert not [s for s in rec.spans if s["name"].startswith("bvh.refit")]


# -- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mesh10k_moved(dev, arity=4, seed=9):
    """The mesh10k preset's tree (98-triangle leaves, BW records) and its
    scene with every shared vertex moved by seeded offsets in +-0.1."""
    from unity_raytracer_tpu_torch.models.presets import mesh10k
    scene, _, cfg = mesh10k(64, 64, device=dev)
    cfg = cfg.with_(bvh_arity=arity)
    built = t_bvh.prepare_bvh(scene, cfg, dev)
    pos = _moved(scene, seed, 0.1)
    moved = t_fit.set_params(scene, {"mesh_positions": torch.as_tensor(
        pos, device=dev)})
    return scene, cfg, built, moved


@pytest.mark.gpu
@pytest.mark.parametrize("arity", [4, 8])
def test_card_refit_equals_the_cpu_refit(arity):
    """Every array of the refit on the card (its gathers, reductions and
    the Baldwin–Weber kernel) equals the CPU refit's, bit for bit."""
    dev = _cuda()
    scene, cfg, built, moved = _mesh10k_moved(dev, arity)
    got, g_scene = t_bvh.refit(built, moved)
    want, w_scene = t_bvh.refit(built.to("cpu"), moved.to("cpu"))
    for k in ("nodes", "nodes_walk", "wide", "wide_walk", "tris", "leafbox",
              "tris_bw"):
        a, b = getattr(got, k).cpu(), getattr(want, k)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
    for k in ("node_min", "node_max", "tri_verts"):
        assert torch.equal(getattr(got.bvh, k).cpu(),
                           getattr(want.bvh, k)), k
    for k in ("aabb_min", "aabb_max", "gate_min", "gate_max"):
        assert torch.equal(getattr(g_scene, k).cpu(),
                           getattr(w_scene, k)), k


@pytest.mark.gpu
def test_card_walks_over_a_refit_tree_match_their_plain_versions():
    """mk4, wide4 and wide8 (nearest) and kernel #1's forward segment (BW
    BVH4) over the refit mesh10k tree, on lanes aimed at the moved
    triangles' corners and edges, against their plain versions (brute
    force over the refit rows): the walks' t equal on every lane, #1's
    colour off only on lanes tied under its leaf test; the tree as built
    misses hits there."""
    from unity_raytracer_tpu_torch.ops.kernels import mega
    dev = _cuda()
    out = {}
    for arity in (4, 8):
        scene, cfg, built, moved = _mesh10k_moved(dev, arity)
        tree, rs = t_bvh.refit(built, moved)
        o, d = _aimed_rays(moved, 16384, 21)
        big = torch.full((o.shape[0],), m3._BIG, device=dev)
        plain = m3.traverse_plain(tree, o, d, big)
        for layout in (("mk4", f"wide{arity}") if arity == 4
                       else (f"wide{arity}",)):
            t, slot, leaf = m3.walk_raw(layout, tree, o, d, big)
            assert int((t != plain[0]).sum()) == 0, (
                layout, int((t != plain[0]).sum()))
            stale = m3.walk_raw(layout, built, o, d, big)[0]
            out[layout] = int((stale != plain[0]).sum())
        if arity == 4:
            aux = mega.build_aux(rs, cfg.background)
            thr = torch.ones_like(o)
            kw = dict(n_lights=rs.lights.positions.shape[0],
                      n_spheres=rs.spheres.count, n_tris=rs.triangles.count,
                      max_bounces=cfg.max_bounces,
                      light_cull=cfg.light_cull, tri_isect="bw",
                      use_wide=True)
            got = mega.trace_segment(tree, aux, 0, o, d, thr, big, **kw)
            want = mega.trace_segment_plain(tree, aux, 0, o, d, thr, big,
                                            **kw)
            # a lane off only where two BW slots meet it at the same t
            # (a walk in another order keeps another triangle)
            from chip_smoke import tied_lanes
            off = ~torch.isclose(got[0], want[0], rtol=5e-4,
                                 atol=5e-4).all(-1)
            tie = tied_lanes(tree, o, d, "bw")
            assert int((off & ~tie).sum()) == 0, (int(off.sum()),
                                                  int(tie.sum()))
    assert min(out.values()) > 100, out


def test_refit_readers_read_nothing_without_the_refit():
    """The benchmark's refit metrics read None from a stretch without the
    program's refit (a program before it), and their numbers from one."""
    from raybench import run, yardstick
    names = ("bvh_refit_us.fit", "bvh_refit_roofline",
             "bvh_refit_area_growth")
    for trace in (None, {"units": 3}, {"refit": {
            "device_us_per_step": 0.0, "bytes": 10, "area": None,
            "fresh_area": None}}):
        assert [run.reader(n)({"trace": trace}) for n in names] == \
            [None] * 3
    r = {"device_us_per_step": 20.0, "bytes": 3_350_000, "area": 12.0,
         "fresh_area": 10.0}
    got = [run.reader(n)({"trace": {"refit": r}}) for n in names]
    assert got[0] == 20.0
    assert got[1] == pytest.approx(100 * 3_350_000 / yardstick.HBM_BPS
                                   / 20e-6)
    assert got[2] == pytest.approx(1.2)


def test_refit_bytes_count_every_row():
    """``raybench/refit_work.refit_bytes``: the corners read and each row
    of the tree written once."""
    from raybench.refit_work import refit_bytes
    scene = _scene()
    cfg = RenderConfig(use_bvh=True, kernel="mega", bvh_leaf=14)
    tree = t_bvh.prepare_bvh(scene, cfg, "cpu")
    rows = sum(getattr(tree, k).numel() for k in (
        "nodes", "nodes_walk", "wide", "wide_walk", "tris", "leafbox",
        "tris_bw")) + sum(getattr(tree.bvh, k).numel() for k in (
            "tri_verts", "node_min", "node_max"))
    assert refit_bytes(scene.meshes.count, tree, 2) == 4 * (
        9 * scene.meshes.count + rows + 12 + 12)


@pytest.mark.gpu
def test_card_refit_makes_no_sync_or_copy():
    """Inside the ``bvh.refit`` spans of three refits on the card the host
    makes no synchronize call and no copy to the host (its tables made
    before), and the refit makes at most 40 device activities."""
    import json
    import os
    import tempfile

    from raybench import spans as rs
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda()
    _, _, built, moved = _mesh10k_moved(dev)
    tree = t_bvh.with_refit_tables(built, moved)
    t_bvh.refit(tree, moved)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            for _ in range(3):
                t_bvh.refit(tree, moved)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    ev = data["traceEvents"]
    base = int(data.get("baseTimeNanoseconds", 0))
    spans = rs.clipped_spans(rec.spans, base, -1e30, 1e30)
    outer = [s for s in spans if s["name"] == "bvh.refit"]
    assert len(outer) == 3
    calls = [e for e in ev if e.get("ph") == "X"
             and e.get("cat") in rs.RUNTIME_CATS]
    inside = lambda e: any(s["s"] <= float(e["ts"]) <= s["e"]
                           for s in outer)
    assert not [e["name"] for e in calls if inside(e)
                and rs.is_sync_call(e["name"])]
    mine = {e["args"]["correlation"] for e in calls if inside(e)
            and "correlation" in e.get("args", {})}
    dev_ops = [e["name"] for e in ev if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and e.get("args", {}).get("correlation") in mine]
    assert not [n for n in dev_ops if "DtoH" in n or "to Host" in n], \
        dev_ops
    assert len(dev_ops) <= 3 * 40, len(dev_ops)
