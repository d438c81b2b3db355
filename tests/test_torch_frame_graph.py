"""PyTorch port: the fused frame as CUDA graph replays
(``ops/graphs``, ``ops/render.render_frame``).

On the CPU (tier 1):

* the key changes when a scene or BVH tensor is replaced or reshaped,
  when the config or the image size changes, and not for another camera;
  it is the scene's and the BVH's identity;
* ``FrameGraphs.plan``: a key's first frame is eager, its second
  captures, later ones replay; a forgotten key starts again; a first
  frame that raised is not remembered; a float64 camera runs eagerly; a
  scene freed after its first frame is not taken for another that gets
  its identity;
* a CPU render never enters the graph path (no key kept, no graph span
  or counter);
* what the graph holds (``render._frame_fused``), run eagerly on the CPU,
  is the eager frame bit for bit, on the chain and on the tree, and makes
  the same counts; it runs each chain segment, and nothing else, in its
  ``stage``, and each tree level's fork launch and compaction in theirs;
  ``FrameGraphs.eager`` is it and the overflow read;
* ``profiling.collect_counts`` / ``recount``.

On the card (``gpu``; ``mesh10k`` at 64x64 and ``cornell_box`` at
128x128, on orbiting cameras):

* graphed against eager: the chain bit for bit, the tree as closely as
  two eager frames agree (``index_add``'s atomics);
* kept outputs stay distinct and correct after later replays;
* a planted stack overflow still raises, on every replay; a mesh
  without its BVH on the fused tree raises on every frame, never captured;
* ``capture_segments`` sees every segment of a key that has a graph;
* ``mega.launches`` counts the 5 segment launches of a replayed frame;
* one capture per key, a replay per frame from the capture on, and the
  replayed tree's ``tree.lanes`` / ``tree.live`` counts;
* a key's frames replay one whole graph while nothing records; a
  recorded frame captures the frame cut into 11 graphs, into the same
  pool, and its replay opens a ``chain.segment`` span for each segment's
  graph;
* a replaced scene captures again;
* a captured mk4 walk's launch is taken back at the capture and added to
  ``traverse_mk3.launches`` at each replay (``graphs.TABLES``).

Nothing here imports JAX, so the ``gpu`` cases also run where only
PyTorch is installed (``pytest --noconftest -m gpu``).
"""

import contextlib
import dataclasses
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

from torch_parity import cuda  # noqa: F401  (fixture)
from unity_raytracer_tpu_torch.models.camera import Camera
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import graphs as fg
from unity_raytracer_tpu_torch.ops import render as rd
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.utils import profiling as pf

torch.set_num_threads(1)

GRAPH_SPANS = ("render.graph", "render.capture", "render.sync")


def _orbit(cam, k: int) -> Camera:
    """``cam`` yawed by 4 k degrees about a point 20 units ahead of it."""
    pos = cam.position.cpu().numpy().astype(np.float64)
    fwd = cam.forward.cpu().numpy().astype(np.float64)
    centre = pos + 20.0 * fwd
    a = np.deg2rad(4.0 * k)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
    p = centre + rot @ (pos - centre)
    return Camera.make(position=p, forward=rot @ fwd, up=(0, 1, 0),
                       dist=float(cam.dist), half_h=float(cam.half_h),
                       half_v=float(cam.half_v), width=cam.width,
                       height=cam.height, device=cam.position.device)


def _mesh(device, size=64):
    scene, cam, cfg = get_preset("mesh10k", width=size, height=size,
                                 device=device)
    cfg = cfg.with_(kernel="mega", mode="scan")
    return scene, cam, cfg, t_bvh.prepare_bvh(scene, cfg)


def _cornell(device, size=128):
    scene, cam, cfg = get_preset("cornell_box", width=size, height=size,
                                 device=device)
    return scene, cam, rd.resolve_mode(scene, cfg.with_(kernel="mega")), None


@pytest.fixture(scope="module")
def cpu_mesh():
    return _mesh("cpu", 8)


# -- on the CPU ---------------------------------------------------------------

def test_key_follows_what_the_graph_reads(cpu_mesh):
    scene, cam, cfg, bvh = cpu_mesh
    key = fg.frame_key(scene, cam, cfg, bvh)
    assert fg.frame_key(scene, _orbit(cam, 3), cfg, bvh) == key
    hash(key)
    lights = scene.lights
    changed = {
        "scene tensor replaced": (dataclasses.replace(
            scene, lights=dataclasses.replace(
                lights, intensities=lights.intensities.clone())), bvh, cfg,
            cam),
        "scene tensor reshaped": (dataclasses.replace(
            scene, aabb_min=scene.aabb_min.reshape(1, 3)), bvh, cfg, cam),
        "bvh tensor replaced": (scene, bvh.replace(
            leafbox=bvh.leafbox.clone()), cfg, cam),
        "bvh tensor reshaped": (scene, bvh.replace(
            leafmeta=bvh.leafmeta.reshape(-1)), cfg, cam),
        "bvh field": (scene, bvh.replace(stack_wide=bvh.stack_wide + 1),
                      cfg, cam),
        "cfg": (scene, bvh, cfg.with_(max_bounces=2), cam),
        "width": (scene, bvh, cfg, dataclasses.replace(cam, width=16)),
        "height": (scene, bvh, cfg, dataclasses.replace(cam, height=4)),
        "camera dtype": (scene, bvh, cfg, dataclasses.replace(
            cam, dist=cam.dist.double())),
    }
    for what, (s, b, c, k) in changed.items():
        assert fg.frame_key(s, k, c, b) != key, what
    assert fg.frame_key(scene, cam, cfg, bvh) == key
    same = dataclasses.replace(scene)       # the same tensors, a new object
    assert fg.frame_key(same, cam, cfg, bvh) != key


class _Held:
    """A stand-in scene or BVH: any object a weak reference can hold."""


def test_plan_waits_for_a_keys_second_frame():
    g = fg.FrameGraphs(None)
    scene, bvh = _Held(), _Held()
    assert g.plan("a", scene, bvh) == "eager"
    g.note("a", scene, bvh)       # its eager frame ran
    assert g.plan("a", scene, bvh) == "capture"
    assert g.plan("a", scene, None) == "eager"     # not the same objects
    g.graphs["a"] = object()      # what __call__ keeps after a capture
    assert [g.plan("a", scene, bvh)] * 2 == ["replay", "replay"]
    others = [f"k{i}" for i in range(fg.SEEN)]
    for k in others:
        assert g.plan(k, scene, None) == "eager"
        g.note(k, scene, None)
    assert g.plan(others[0], scene, None) == "capture"  # SEEN remembered
    g.note("one more", scene, None)
    assert g.plan(others[0], scene, None) == "eager"   # the oldest forgotten
    assert g.plan(others[1], scene, None) == "capture"
    g.clear()
    assert g.plan("a", scene, bvh) == "eager"


def test_a_freed_scene_is_not_taken_for_its_key():
    """The key holds identities: a scene freed after its first frame
    leaves its key unmatched, whatever object comes to have its
    identity."""
    g = fg.FrameGraphs(None)
    scene, bvh = _Held(), _Held()
    g.note("k", scene, bvh)
    del scene
    assert g.plan("k", _Held(), bvh) == "eager"


def test_a_raising_eager_frame_is_not_remembered(cpu_mesh):
    """A key's first frame must run before its second captures: one that
    raised (a mesh without its BVH on the fused tree) leaves the key
    unknown. Driven through ``__call__`` on CPU tensors, which reach no
    capture while every frame is a first."""
    scene, cam, cfg, bvh = cpu_mesh
    calls = []

    def eager(*a):
        calls.append(a)
        if len(calls) == 1:
            raise ValueError("planted")
        return "image", torch.zeros(1, dtype=torch.int32)

    g = fg.FrameGraphs(eager)
    with pytest.raises(ValueError, match="planted"):
        g(scene, cam, cfg, bvh)
    key = fg.frame_key(scene, cam, cfg, bvh)
    assert g.plan(key, scene, bvh) == "eager" and not g.seen
    assert g(scene, cam, cfg, bvh) == "image"
    assert g.plan(key, scene, bvh) == "capture"
    g.seen.clear()
    wide = dataclasses.replace(cam, dist=cam.dist.double())
    assert g(scene, wide, cfg, bvh) == "image"    # not float32: eager
    assert not g.seen


@pytest.mark.parametrize("name", ["mesh", "cornell"])
def test_cpu_render_never_enters_the_graph(name):
    scene, cam, cfg, bvh = (_mesh("cpu", 8) if name == "mesh"
                            else _cornell("cpu", 8))
    assert rd.uses_fused(cfg, bvh)
    rd.FRAME_GRAPHS.clear()
    with pf.recording() as rec:
        imgs = [rd.render(scene, cam, cfg, bvh=bvh) for _ in range(3)]
    assert not rd.FRAME_GRAPHS.seen and not rd.FRAME_GRAPHS.graphs
    for img in imgs[1:]:
        assert torch.equal(img, imgs[0])
    assert not [s for s in rec.spans if s["name"] in GRAPH_SPANS]
    assert not [c for c in rec.counts
                if c["name"].startswith("render.graph")]


def _counts(rec):
    return [(c["name"], c["value"]) for c in rec.counts]


@pytest.mark.parametrize("name", ["mesh", "cornell"])
def test_captured_frame_equals_eager_on_cpu(name):
    """``_frame_fused`` (the graph's contents) run eagerly on the CPU: the
    eager frame bit for bit, the overflow counter zero and unread, and the
    same counts (the tree's per level) as the eager frame makes."""
    scene, cam, cfg, bvh = (_mesh("cpu", 8) if name == "mesh"
                            else _cornell("cpu", 16))
    for k in (0, 2):
        c = _orbit(cam, k)
        with pf.recording() as eager:
            want = rd._frame_eager(scene, c, cfg, bvh)
        with pf.recording() as rec, pf.collect_counts() as got:
            img, ovf = rd._frame_fused(
                scene, c, cfg, bvh, mega.background_row(cfg.background,
                                                        "cpu"))
        assert torch.equal(img, want)
        assert ovf.shape == (1,) and int(ovf) == 0
        assert not rec.counts          # all diverted to the collection
        assert [(n, int(v)) for n, v in got] == _counts(eager)
        if name == "cornell":
            assert [n for n, _ in got][:3] == ["tree.live", "tree.lanes",
                                               "tree.live"]


@pytest.mark.parametrize("name", ["mesh", "cornell"])
def test_stage_holds_each_chain_segment(name, monkeypatch):
    """``_frame_fused`` runs each chain segment launch, and nothing else,
    inside its ``stage`` (where a capture cuts its graphs); the tree each
    level's fork launch in a ``tree.fork`` stage and each compaction in a
    ``tree.compact`` one (cap 1: every level but the last compacts).
    ``FrameGraphs.eager`` is that frame with ``span`` and the overflow
    read."""
    scene, cam, cfg, bvh = (_mesh("cpu", 8) if name == "mesh"
                            else _cornell("cpu", 16))
    staged, inside, launched = [], [], []
    segment = mega.trace_segment

    def counted(*a, **kw):
        launched.append(bool(inside))
        return segment(*a, **kw)

    @contextlib.contextmanager
    def stage(what, **attrs):
        inside.append(what)
        n = len(launched)
        yield
        inside.pop()
        staged.append((what, attrs, len(launched) - n))

    monkeypatch.setattr(mega, "trace_segment", counted)
    bg = mega.background_row(cfg.background, "cpu")
    img, _ = rd._frame_fused(scene, cam, cfg, bvh, bg, stage)
    n = cfg.max_bounces + 1
    if name == "mesh":
        assert staged == [("chain.segment", {"depth": k}, 1)
                          for k in range(n)]
        assert launched == [True] * n
    else:
        assert cfg.tree_cap == 1
        assert staged == [x for k in range(n) for x in (
            ("tree.fork", {"level": k}, 1),
            ("tree.compact", {"level": k}, 0))][:-1]
        assert launched == [True] * n
    monkeypatch.undo()
    with pf.recording() as rec:
        got = fg.FrameGraphs(rd._frame_fused).eager(scene, cam, cfg, bvh)
    assert torch.equal(got, img)
    assert [s["name"] for s in rec.spans][-1] == "render.sync"


def test_build_aux_takes_its_background_row(cpu_mesh):
    scene, _, cfg, _ = cpu_mesh
    bg = mega.background_row(cfg.background, "cpu")
    assert torch.equal(mega.build_aux(scene, cfg.background, bg),
                       mega.build_aux(scene, cfg.background))


def test_a_dropped_frame_graph_is_freed_at_once(cpu_mesh):
    """A key's ``FrameGraph`` holds no reference cycle, so dropping it
    frees it (and, on the card, its CUDA graphs) at once: a cycle would
    leave them to a garbage collection that can fall inside another key's
    capture, where freeing a CUDA graph breaks that capture."""
    scene, cam, cfg, bvh = cpu_mesh
    graph = fg.FrameGraph(rd._frame_fused, scene, cam, cfg, bvh)
    ref = weakref.ref(graph)
    del graph
    assert ref() is None


def test_recount_copies_device_counts():
    v = torch.tensor(7)
    with pf.collect_counts() as got:
        pf.count("a", 3)
        pf.count("b", v)
    assert got == [("a", 3), ("b", v)]
    pf.recount(got)                       # not recording: nothing kept
    with pf.recording() as rec:
        pf.recount(got)
        v.fill_(9)                        # the next replay's write
        pf.recount(got)
    assert _counts(rec) == [("a", 3), ("b", 7), ("a", 3), ("b", 9)]
    with pf.collect_counts() as again:    # diverted, not recording
        pf.recount(got)
    v.fill_(11)
    assert [(n, int(x)) for n, x in again] == [("a", 3), ("b", 9)]


# -- on the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (marker gpu)")
    return _mesh("cuda")


@pytest.fixture(scope="module")
def card_cornell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (marker gpu)")
    return _cornell("cuda")


def _frames(case, ks, graphs=None):
    """Frames of ``render_frame`` on the orbit cameras ``ks`` (a fresh
    graph cache first), each beside the eager frame of its camera."""
    scene, cam, cfg, bvh = case
    graphs = graphs or rd.FRAME_GRAPHS
    graphs.clear()
    out = []
    for k in ks:
        c = _orbit(cam, k)
        got = graphs(scene, c, cfg, bvh)
        out.append((k, got, rd._frame_eager(scene, c, cfg, bvh)))
    return out


@pytest.mark.gpu
def test_chain_graph_equals_eager_bit_for_bit(cuda, card_mesh):
    out = _frames(card_mesh, [0, 0, 1, 2, 5, 1])
    for k, got, want in out:
        assert torch.equal(got, want), k
    assert len(rd.FRAME_GRAPHS.graphs) == 1
    assert not torch.equal(out[2][1], out[3][1])


@pytest.mark.gpu
def test_tree_graph_agrees_as_eager_frames_do(cuda, card_cornell):
    scene, cam, cfg, _ = card_cornell
    eager_gap = max(float((rd._frame_eager(scene, _orbit(cam, k), cfg, None)
                           - rd._frame_eager(scene, _orbit(cam, k), cfg,
                                             None)).abs().max())
                    for k in (0, 3))
    out = _frames(card_cornell, [0, 0, 1, 3, 0])
    assert len(rd.FRAME_GRAPHS.graphs) == 1
    for k, got, want in out:     # at least 8 ulps of the frame's largest
        ulps = 8 * float(torch.finfo(torch.float32).eps * want.abs().max())
        assert float((got - want).abs().max()) <= max(eager_gap, ulps), k


@pytest.mark.gpu
def test_kept_outputs_stay_distinct(cuda, card_mesh):
    out = _frames(card_mesh, [0, 1, 2, 3, 4])
    ptrs = {got.data_ptr() for _, got, _ in out}
    assert len(ptrs) == len(out)
    for k, got, want in out:     # after every later replay
        assert torch.equal(got, want), k


@pytest.mark.gpu
def test_planted_overflow_raises_on_every_replay(cuda, card_mesh):
    def planted(*a):
        img, ovf = rd._frame_fused(*a)
        if torch.cuda.is_current_stream_capturing():
            ovf.add_(1)            # one dropped push, inside the graph
        return img, ovf

    scene, cam, cfg, bvh = card_mesh
    graphs = fg.FrameGraphs(planted)
    graphs(scene, cam, cfg, bvh)   # eager: the kernels drop nothing
    for _ in range(3):             # the capture frame's replay, then two
        with pytest.raises(RuntimeError, match="dropped 1 stack pushes"):
            graphs(scene, cam, cfg, bvh)
    assert len(graphs.graphs) == 1


@pytest.mark.gpu
def test_mesh_without_bvh_on_the_tree_never_captures(cuda, card_mesh):
    scene, cam, cfg, _ = card_mesh
    rd.FRAME_GRAPHS.clear()
    for _ in range(3):
        with pytest.raises(ValueError, match="mesh triangles"):
            rd.render_frame(scene, cam, cfg.with_(mode="tree"), None)
    assert not rd.FRAME_GRAPHS.graphs and not rd.FRAME_GRAPHS.seen


@pytest.mark.gpu
def test_capture_segments_sees_every_segment(cuda, card_mesh):
    scene, cam, cfg, bvh = card_mesh
    _frames(card_mesh, [0, 0, 0])
    assert len(rd.FRAME_GRAPHS.graphs) == 1
    segs = pf.capture_segments(lambda: rd.render_frame(scene, cam, cfg,
                                                       bvh))
    assert [depth for depth, _ in segs] == list(range(cfg.max_bounces + 1))


@pytest.mark.gpu
def test_replay_counts_its_launches(cuda, card_mesh):
    scene, cam, cfg, bvh = card_mesh
    _frames(card_mesh, [0, 0])
    route = mega.segment_route(bvh, cfg.tri_isect, cfg.bvh_arity != 0)
    for k in mega.launches:
        mega.launches[k] = 0
    for k in mega.route_launches:
        mega.route_launches[k] = 0
    for j in range(3):
        rd.render_frame(scene, _orbit(cam, j), cfg, bvh)
    assert mega.launches["forward"] == 3 * (cfg.max_bounces + 1)
    assert mega.route_launches["forward", route] == 3 * (cfg.max_bounces
                                                         + 1)
    assert sum(mega.launches.values()) == 3 * (cfg.max_bounces + 1)


def _sum(rec, name):
    return sum(c["value"] for c in rec.counts if c["name"] == name)


@pytest.mark.gpu
def test_counters_and_tree_counts(cuda, card_cornell):
    """Recorded frames: a capture on the second, a replay per frame from
    it on; each replayed frame's ``tree.lanes`` / ``tree.live`` are the
    eager frame's, under its own ``render`` unit."""
    scene, cam, cfg, _ = card_cornell
    rd.FRAME_GRAPHS.clear()
    with pf.recording() as rec:
        for k in (0, 0, 1, 2):
            with pf.span("render"):
                rd.render_frame(scene, _orbit(cam, k), cfg, None)
    assert _sum(rec, "render.graph.captures") == 1
    assert _sum(rec, "render.graph.replays") == 3
    names = Counter(s["name"] for s in rec.spans)
    assert names["render.capture"] == 1 and names["render.graph"] == 3
    # the eager first frame reads its overflow counter in render.sync too
    assert names["render.sync"] == 4 and names["tree.level"] == 2 * 5
    units = [s["id"] for s in rec.spans if s["name"] == "render"]
    per_unit = [[(c["name"], c["value"]) for c in rec.counts
                 if c["unit"] == u and c["name"].startswith("tree.")]
                for u in units]
    with pf.recording() as eager:
        rd._frame_eager(scene, _orbit(cam, 2), cfg, None)
    assert per_unit[3] == _counts(eager)
    assert per_unit[1] == per_unit[0]     # the capture frame's, replayed


@pytest.mark.gpu
def test_replaced_scene_captures_again(cuda, card_mesh):
    scene, cam, cfg, bvh = card_mesh
    lights = scene.lights
    dim = dataclasses.replace(scene, lights=dataclasses.replace(
        lights, intensities=lights.intensities * 0.5))
    rd.FRAME_GRAPHS.clear()
    with pf.recording() as rec:
        for s in (scene, scene, dim, dim, dim, scene):
            got = rd.render_frame(s, cam, cfg, bvh)
            assert torch.equal(got, rd._frame_eager(s, cam, cfg, bvh))
    assert _sum(rec, "render.graph.captures") == 2
    assert _sum(rec, "render.graph.replays") == 4
    assert len(rd.FRAME_GRAPHS.graphs) == 2
    assert not torch.equal(rd.render_frame(dim, cam, cfg, bvh),
                           rd.render_frame(scene, cam, cfg, bvh))


@pytest.mark.gpu
def test_replayed_chain_keeps_its_segment_spans(cuda, card_mesh):
    """A key's frames replayed while nothing records run one whole graph.
    The first recorded frame captures the frame cut into a graph before,
    after and between the segments and one for each segment, in the
    whole graph's pool; a recorded replay opens a ``chain.segment`` span
    (its ``depth``) around each segment's graph, inside ``render.graph``,
    so the trace names kernel #1's launches by it. All are the eager
    frame bit for bit. A dropped key's graphs are freed at once (no
    reference cycle), so no later garbage collection frees a CUDA graph
    inside another key's capture."""
    scene, cam, cfg, bvh = card_mesh
    n = cfg.max_bounces + 1
    _frames(card_mesh, [0, 0])
    (graph,) = rd.FRAME_GRAPHS.graphs.values()
    assert list(graph.graphs) == [False]
    assert [p[0] for p in graph.graphs[False].pieces] == [None]
    with pf.recording() as rec:
        got = rd.render_frame(scene, _orbit(cam, 1), cfg, bvh)
    assert torch.equal(got, rd._frame_eager(scene, _orbit(cam, 1), cfg,
                                            bvh))
    assert _sum(rec, "render.graph.captures") == 1
    cut = graph.graphs[True]
    assert [p[0] for p in cut.pieces] == [None] + [
        x for k in range(n) for x in (("chain.segment", {"depth": k}),
                                      None)]
    assert cut.pool == graph.graphs[False].pool
    whole = rd.render_frame(scene, _orbit(cam, 2), cfg, bvh)
    assert torch.equal(whole, rd._frame_eager(scene, _orbit(cam, 2), cfg,
                                              bvh))
    with pf.recording() as rec:
        got = rd.render_frame(scene, _orbit(cam, 3), cfg, bvh)
    assert torch.equal(got, rd._frame_eager(scene, _orbit(cam, 3), cfg,
                                            bvh))
    assert _sum(rec, "render.graph.captures") == 0
    by_id = {s["id"]: s for s in rec.spans}
    segs = [s for s in rec.spans if s["name"] == "chain.segment"]
    assert [s["attrs"]["depth"] for s in segs] == list(range(n))
    assert {by_id[s["parent"]]["name"] for s in segs} == {"render.graph"}
    ref = weakref.ref(graph)
    del graph, cut
    rd.FRAME_GRAPHS.clear()
    assert ref() is None


@pytest.mark.gpu
def test_replay_adds_every_launch_table(cuda, card_mesh):
    """A graph whose captured code launches the mk4 walk (its own
    overflow counter: no sync): the capture takes its launch back, each
    replay adds it to ``traverse_mk3.launches``, and the replayed walk
    is the eager one."""
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    scene, cam, cfg, bvh = card_mesh
    o, d = generate_rays_blocks(cam, cfg.block_size)
    tmax = torch.full((o.shape[0],), m3._BIG, device=o.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
    walk = lambda stage: m3.walk_raw("mk4", bvh, o, d, tmax,
                                     overflow=overflow)
    want = walk(None)                     # eager first: the kernel loaded
    before = dict(m3.launches)
    g = fg.CapturedGraph("walk", walk, o.device)
    assert m3.launches == before
    for _ in range(3):
        g.replay()
    assert m3.launches == {**before, "mk4": before["mk4"] + 3}
    for got, ref in zip(g.out, want):
        assert torch.equal(got, ref)
    assert int(overflow) == 0
