"""PyTorch port: a glass mesh, the dielectric tree walking a BVH
(``mesh100k_glass``, ``raybench/configs/mesh100k_glass.json``).

On the CPU (tier 1), on the configuration cut to a subdivision-2 glass
icosphere at 48x48 (``_glass``), with the camera either the
configuration's or moved up to the glass so that it fills the frame:

* the fused tree (the plain versions of kernel #1's fork, ``kernel
  'mega'``) and the composed tree (``'auto'``) against the benchmark's
  plain reference (``raybench/reference.py``) on every pixel, at the
  frame cells' ``pixel_tol`` (1/255), on both cameras;
* the icosphere's baked shading normals point outward, on the
  Baldwin–Weber records and on the Möller–Trumbore rows: every primary
  ray that hits the glass from outside is ``entering`` (``d . n < 0``);
* ``tree.dropped`` reads 0 at a lossless cap, and at cap 1 on the
  close camera it equals ``trace_radiance_tree_stats``' ``n_truncated``
  (> 0), on both routes;
* the fused tree's ``stage`` hook sees each level's fork launch, and
  each compaction, in a stage of its own with its level; the image is the
  one ``span`` gives, bit for bit;
* the harness: ``drivers/frames_ext`` lays a mix's ``render`` over the
  configuration's and leaves one without as ``frames`` does;
  ``mesh100k_glass.json`` builds the glass on the 81,920-triangle mesh;
  the tree cell's check, driven on the CPU at a tiny size, reads
  ``correct`` false where the cap drops lanes; the tree's readers read
  nothing from a run without the tree's readings; ``tree_work`` counts
  the fork's bytes.

On the card (``gpu``): the glass mesh's recorded graphed frame, whose
capture is cut at each fork and compaction, against the whole frame's
graph, as closely as the whole graph agrees with itself, and each
replayed fork graph inside its ``tree.fork`` span.

Nothing here imports JAX.
"""

import contextlib
import copy
import time

import numpy as np
import pytest
import torch

from torch_parity import cuda  # noqa: F401  (fixture)
from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import render as rd
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.utils import profiling as pf
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

CELL = "mesh100k_glass.tree"
NEAR = [0.0, 6.0, 20.0]     # 10 units from the glass's centre: it fills
SIZE = 48


def _conf(near: bool = False, size: int = SIZE, **render) -> dict:
    """The cell's configuration, its glass icosphere of subdivision 2, the
    other of 1, 14-triangle leaves, ``size`` x ``size``; ``near``: the
    camera moved up to the glass, looking along +z."""
    from raybench import run
    conf = copy.deepcopy(run.cell_spec(CELL)["config"])
    conf["width"] = conf["height"] = size
    glass, blue = conf["scene"]["meshes"]
    glass["icosphere"]["subdivisions"] = 2
    blue["icosphere"]["subdivisions"] = 1
    conf["render"]["bvh_leaf"] = 14
    conf["render"].update(render)
    if near:
        conf["camera"].update(position=NEAR, forward=[0.0, 0.0, 1.0])
    return conf


def _port(conf: dict):
    """``(scene, cam, cfg, bvh, deployment)`` of ``conf`` on the CPU."""
    from raybench import scene as scn
    from raybench.drivers.frames import _port_scene
    dep = scn.build(conf)
    scene = _port_scene(dep, "cpu")
    rc = dict(conf["render"], background=tuple(conf["render"]["background"]))
    cfg = rd.resolve_mode(scene, RenderConfig(**rc))
    c = scn.camera(conf)
    cam = Camera.make(position=c["position"], forward=c["forward"],
                      up=c["up"], dist=c["dist"], half_h=c["half_h"],
                      half_v=c["half_v"], width=conf["width"],
                      height=conf["height"], device="cpu")
    return scene, cam, cfg, t_bvh.prepare_bvh(scene, cfg, "cpu"), dep


def _reference(conf: dict, dep) -> np.ndarray:
    """The plain reference's image of ``conf`` on the display scale,
    [H*W, 3]."""
    from raybench import reference, scene as scn
    w, h = conf["width"], conf["height"]
    idx = np.arange(w * h)
    o, d = reference.camera_rays(scn.camera(conf), w, h, idx % w, idx // w,
                                 "cpu")
    ref = reference.Reference(scn.arrays(dep),
                              conf["render"]["max_bounces"], "cpu")
    return (ref.trace(o, d) / 255.0).numpy()


@pytest.mark.parametrize("near", [False, True], ids=["orbit", "near"])
@pytest.mark.parametrize("kernel", ["mega", "auto"],
                         ids=["fused", "composed"])
def test_glass_mesh_matches_the_reference(kernel, near):
    from raybench import run
    tol = run.cell_spec(CELL)["cell"]["check"]["pixel_tol"]
    conf = _conf(near, kernel=kernel)
    scene, cam, cfg, bvh, dep = _port(conf)
    assert cfg.mode == "tree" and rd.uses_fused(cfg, bvh) is (
        kernel == "mega")
    img = rd.render(scene, cam, cfg, bvh=bvh).reshape(-1, 3).numpy()
    diff = np.abs(img - _reference(conf, dep)).max(axis=-1)
    assert int((diff > tol).sum()) == 0, float(diff.max())


@pytest.mark.parametrize("tri_isect", ["bw", "mt"])
def test_glass_normals_point_outward(tri_isect):
    """Primary rays from the near camera: every one that hits the glass
    (its material id) has ``d . n < 0`` on the fused segment's recorded
    shading normal, so it enters the glass."""
    scene, cam, cfg, bvh, _ = _port(_conf(True, tri_isect=tri_isect))
    o, d = generate_rays_blocks(cam, cfg.block_size)
    n = o.shape[0]
    thr = torch.ones((n, 3))
    tmax = torch.full((n,), 3.0e38)
    aux = mega.build_aux(scene, cfg.background)
    *_, (t, nrm, matid, _) = mega.trace_segment(
        bvh, aux, 0, o, d, thr, tmax, record=True,
        **rd._segment_kw(scene, cfg))
    # the aux block's material rows follow its gate, light, sphere and
    # loose-triangle rows; column 18 is is_dielectric
    first = 1 + scene.lights.positions.shape[0] + scene.spheres.count \
        + scene.triangles.count
    m = matid.long()
    glass = (m >= 0) & (aux[first + m.clamp_min(0), 18] > 0)
    assert int(glass.sum()) > cam.width * cam.height // 2
    ddn = (d * nrm).sum(-1)
    assert bool((ddn[glass] < 0).all())


@pytest.mark.parametrize("kernel", ["mega", "auto"],
                         ids=["fused", "composed"])
def test_dropped_counter_is_the_truncation(kernel):
    """``tree.dropped`` summed over a frame equals ``n_truncated``: 0 at
    the default cap, and the live lanes cap 1 cut on the near camera."""
    scene, cam, cfg, bvh, _ = _port(_conf(True, kernel=kernel))
    o, d = generate_rays_blocks(cam, cfg.block_size)
    got = {}
    for cap in (4, 1):
        with pf.recording() as rec:
            _, cut = rd.trace_radiance_tree_stats(
                scene, o, d, cfg.with_(tree_cap=cap), bvh)
        dropped = sum(c["value"] for c in rec.counts
                      if c["name"] == "tree.dropped")
        assert dropped == int(cut)
        got[cap] = dropped
    assert got[4] == 0 and got[1] > 0


def test_fused_tree_stages_each_fork_and_compaction(monkeypatch):
    """At the default cap 4 and depth 4 the levels hand 1, 2, 4, 4 and 4
    times the pixels to their fork launches: levels 2 and 3 compact.
    Each fork launch, and nothing else of the kernel, runs in a
    ``tree.fork`` stage, each compaction in a ``tree.compact`` one, with
    its level; the image is ``span``'s bit for bit."""
    scene, cam, cfg, bvh, _ = _port(_conf(False))
    staged, inside, launched = [], [], []
    segment = mega.trace_segment

    def counted(*a, **kw):
        launched.append(list(inside))
        return segment(*a, **kw)

    @contextlib.contextmanager
    def stage(what, **attrs):
        inside.append(what)
        yield
        inside.pop()
        staged.append((what, attrs))

    monkeypatch.setattr(mega, "trace_segment", counted)
    bg = mega.background_row(cfg.background, "cpu")
    img, _ = rd._frame_fused(scene, cam, cfg, bvh, bg, stage)
    want = [("tree.fork", {"level": 0}), ("tree.fork", {"level": 1}),
            ("tree.fork", {"level": 2}), ("tree.compact", {"level": 2}),
            ("tree.fork", {"level": 3}), ("tree.compact", {"level": 3}),
            ("tree.fork", {"level": 4})]
    assert staged == want
    assert launched == [["tree.fork"]] * 5
    monkeypatch.undo()
    plain, _ = rd._frame_fused(scene, cam, cfg, bvh, bg)
    assert torch.equal(img, plain)


# -- the harness --------------------------------------------------------------

def test_frames_ext_lays_the_mix_render_over_the_configuration():
    from raybench import run
    from raybench.drivers import frames, frames_ext
    mt = run.cell_spec("mesh100k.frame_mt")
    assert mt["traffic"]["driver"] == "frames_ext"
    drv = frames_ext.Driver(mt["config"], mt["traffic"], mt["cell"], "cpu")
    assert drv.config["render"] == dict(mt["config"]["render"],
                                        tri_isect="mt", bvh_arity=8)
    assert mt["config"]["render"]["tri_isect"] == "bw"   # left as it was
    glass = run.cell_spec(CELL)
    assert "render" not in glass["traffic"]
    got = frames_ext.Driver(glass["config"], glass["traffic"], glass["cell"],
                            "cpu")
    want = frames.Driver(glass["config"], glass["traffic"], glass["cell"],
                         "cpu")
    assert got.config == want.config == glass["config"]


def test_glass_configuration_builds_glass_on_the_large_mesh():
    from raybench import run, scene as scn
    conf = run.cell_spec(CELL)["config"]
    dep = scn.build(conf)
    (v, f, glass), (_, f2, blue) = dep["meshes"]
    assert len(f) == 81_920 and len(f2) == 20_480
    assert glass["is_dielectric"] and glass["ior"] == 1.5
    assert tuple(glass["transparency"]) == (0.95, 0.95, 0.95)
    assert not blue["is_dielectric"]
    arr = scn.arrays(dep)
    die = arr["mat_is_dielectric"][arr["mesh_mat"]]
    assert int(die.sum()) == 81_920 and len(die) == 102_400
    assert conf["render"]["tree_cap"] == 4


def _tiny_spec(near: bool) -> dict:
    from raybench import run
    spec = copy.deepcopy(run.cell_spec(CELL))
    spec["config"] = _conf(near, size=32)
    spec["traffic"]["cameras"] = 2
    spec["cell"]["check"]["pixels"] = 512
    return spec


@pytest.mark.parametrize("cap", [4, 1])
def test_tree_cell_is_not_correct_where_the_cap_drops_lanes(cap,
                                                            monkeypatch):
    """The tree cell driven on the CPU at 32x32 with the near camera: at
    the configuration's cap it reads ``correct`` with no lane dropped; at
    cap 1, which cuts live lanes there, ``lanes_dropped`` is above its
    limit 0 and the run is not correct."""
    from raybench import guard, run
    # the suite's conftest loads JAX; the program under test does not
    monkeypatch.setattr(guard, "check", lambda: None)
    spec = _tiny_spec(True)
    spec["config"]["render"]["tree_cap"] = cap
    res = run.execute(spec, 2 ** 31 + 7, 0.2, False, "cpu",
                      time.perf_counter())
    checks = res["checks"]
    assert checks["lanes_dropped"]["limit"] == 0
    assert (checks["lanes_dropped"]["value"] > 0) is (cap == 1)
    assert res["correct"] is (cap == 4), checks


def test_tree_readers_read_nothing_without_the_tree_readings():
    """A traced run whose program opened no ``tree.fork`` or
    ``tree.compact`` span, or counted no live lanes per launch (the
    parent's, where the tree is one graph), gives the tree's readers
    nothing; with readings they read them."""
    from raybench import run, yardstick
    names = ("tree_fork_us.frame", "tree_fork_roofline",
             "tree_compact_us.frame", "tree_live_lane_share")
    silent = {"fork_us_per_frame": 0.0, "compact_us_per_frame": 0.0,
              "fork_bytes_per_frame": 1e9, "live_share": None}
    for trace in (None, {}, {"tree": silent}):
        ctx = dict(config={}, arrays={}, spans={}, trace=trace)
        assert [run.reader(m)(ctx) for m in names] == [None] * 4
    tree = {"fork_us_per_frame": 2000.0, "compact_us_per_frame": 500.0,
            "fork_bytes_per_frame": 1e9, "live_share": 0.25}
    ctx = dict(config={}, arrays={}, spans={}, trace={"tree": tree})
    got = [run.reader(m)(ctx) for m in names]
    assert got == [2000.0, pytest.approx(100.0 * 1e9 / yardstick.HBM_BPS
                                         / 2e-3), 500.0, 0.25]


def test_fork_bytes_count_lanes_and_tables():
    """``tree_work``: 40 + 92 bytes a launched lane; each launch reads
    the aux rows and its route's walk rows, leaf rows, group boxes and
    leaf material ids once."""
    from raybench import tree_work
    scene, _, cfg, bvh, _ = _port(_conf(False))
    size = lambda *ts: 4 * sum(int(t.numel()) for t in ts)
    bw = tree_work.table_bytes(bvh, "bw", 4, 10)
    assert bw == 4 * 10 * 128 + size(bvh.wide_walk, bvh.tris_bw,
                                      bvh.leafbox, bvh.leafmeta)
    assert tree_work.table_bytes(bvh, "mt", 0, 10) == 4 * 10 * 128 + size(
        bvh.nodes_walk, bvh.tris, bvh.leafbox, bvh.leafmeta)
    assert tree_work.table_bytes(None, "mt", 4, 3) == 4 * 3 * 128
    assert tree_work.fork_bytes(1000, 5, bw) == 132 * 1000 + 5 * bw


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_card_cut_tree_capture_equals_the_uncut(cuda):
    """The glass mesh at 256x256 on the card: frames of ``render_frame``
    recorded (replays of the capture cut at each fork and compaction into
    15 graphs) against frames replayed while nothing records (the whole
    frame's one graph) on orbiting cameras, as closely as two replays of
    the whole graph agree: the folds' ``index_add`` adds a pixel's live
    lanes of a level in the order its atomics land, so no route fixes the
    last bit (at least 8 ulps of the frame's largest value). A recorded
    replay opens a ``tree.fork`` span (its ``level``) around each fork's
    graph, inside ``render.graph``, and recounts the tree's counts."""
    from raybench import scene as scn
    from raybench.drivers.frames import _port_scene
    conf = _conf(False, size=256)
    conf["scene"]["meshes"][0]["icosphere"]["subdivisions"] = 4
    dep = scn.build(conf)
    scene = _port_scene(dep, cuda)
    rc = dict(conf["render"], background=tuple(conf["render"]["background"]))
    cfg = rd.resolve_mode(scene, RenderConfig(**rc))
    bvh = t_bvh.prepare_bvh(scene, cfg, cuda)
    c = scn.camera(conf)

    def cam(yaw):
        a = np.deg2rad(yaw)
        centre = np.asarray(conf["orbit"]["center"], np.float64)
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]])
        p = centre + rot @ (np.asarray(c["position"]) - centre)
        return Camera.make(position=p, forward=rot @ np.asarray(c["forward"]),
                           up=c["up"], dist=c["dist"], half_h=c["half_h"],
                           half_v=c["half_v"], width=256, height=256,
                           device=cuda)

    rd.FRAME_GRAPHS.clear()
    rd.render_frame(scene, cam(0), cfg, bvh)         # the key's eager frame
    for y in [0, 5, -20, 20, 5]:
        with pf.recording():
            got = rd.render_frame(scene, cam(y), cfg, bvh)
        want = rd.render_frame(scene, cam(y), cfg, bvh)
        again = rd.render_frame(scene, cam(y), cfg, bvh)
        ulps = 8 * float(torch.finfo(torch.float32).eps * want.abs().max())
        bound = max(float((again - want).abs().max()), ulps)
        assert float((got - want).abs().max()) <= bound, y
    (graph,) = rd.FRAME_GRAPHS.graphs.values()
    cut, whole = graph.graphs[True], graph.graphs[False]
    stages = [p[0] for p in cut.pieces if p[0] is not None]
    assert [s[0] for s in stages] == ["tree.fork"] * 3 + [
        "tree.compact", "tree.fork", "tree.compact", "tree.fork"]
    assert len(cut.pieces) == 15 and len(whole.pieces) == 1
    with pf.recording() as rec:
        rd.render_frame(scene, cam(5), cfg, bvh)
    by_id = {s["id"]: s for s in rec.spans}
    forks = [s for s in rec.spans if s["name"] == "tree.fork"]
    assert [s["attrs"]["level"] for s in forks] == list(range(5))
    assert {by_id[s["parent"]]["name"] for s in forks} == {"render.graph"}
    names = [x["name"] for x in rec.counts]
    assert names.count("tree.lanes") == names.count("tree.live") == 5
    assert names.count("tree.dropped") == 2
    assert sum(x["value"] for x in rec.counts
               if x["name"] == "tree.dropped") == 0
    rd.FRAME_GRAPHS.clear()
