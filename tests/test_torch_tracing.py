"""PyTorch port: the program's spans and counters (``utils/profiling``).

* Off (no ``recording()`` running) a span is the shared do-nothing
  context: no span object, no record, no tensor op; a count touches
  nothing.
* On, a CPU render of ``cornell_box`` on the fused tree and of a mirror
  chain on the fused kernel, and 2-step CPU fits on the chunked composed
  path and on the chunked replay, give the documented span tree: names,
  nesting, attributes, one unit id per frame or step.
* Recording changes no output bit and dispatches the same torch ops.
* ``tree.live`` paired with ``tree.lanes`` is the live lanes each fork
  launch runs over, counted directly at the launch.
* The clock: a span encloses the profiler's events of the same block,
  read through the Chrome trace's ``baseTimeNanoseconds``; and on the
  card every ``chain.sync`` / ``tree.sync`` span encloses its
  synchronize call.
* ``profiling.trace`` writes the spans and counts into its Chrome trace.
"""

import json
import os
import sys
import time
from collections import Counter

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_goldens import CFG, FCFG, TOY_FCFG, fit_inputs, fit_toy_inputs
from torch_parity import cuda  # noqa: F401
from unity_raytracer_tpu_torch import fit as t_fit
from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
from unity_raytracer_tpu_torch.models.presets import get_preset, mesh_scene
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import render as t_render
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.utils import profiling as pf

torch.set_num_threads(1)

DEPTH = 2


def _cornell(device="cpu", size=16):
    scene, cam, cfg = get_preset("cornell_box", width=size, height=size,
                                 device=device)
    return scene, cam, cfg.with_(kernel="mega", max_bounces=DEPTH), None


def _chain(device="cpu", size=16):
    scene, cam, cfg = mesh_scene(320, size, size, device=device)
    cfg = cfg.with_(kernel="mega", max_bounces=DEPTH)
    return scene, cam, cfg, t_bvh.prepare_bvh(scene, cfg)


SCENES = {"tree": _cornell, "chain": _chain}


class _Ops(TorchDispatchMode):
    """Counts the torch ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _tree(rec):
    """``{id: span}`` and ``{id: [child names]}`` of a recording."""
    by_id = {s["id"]: s for s in rec.spans}
    kids = {i: [] for i in by_id}
    for s in sorted(rec.spans, key=lambda s: s["start_ns"]):
        if s["parent"] is not None:
            kids[s["parent"]].append(s["name"])
    return by_id, kids


def _named(rec, name):
    return sorted((s for s in rec.spans if s["name"] == name),
                  key=lambda s: s["start_ns"])


def test_off_is_one_flag_check(monkeypatch):
    """With nothing recording, ``span`` returns the one shared null
    context and builds no span; ``count`` reads nothing; a frame and a
    fit step run through every instrumented stage without a record."""
    assert not pf._on
    assert pf.span("a", x=1) is pf.span("b") is pf._NULL
    assert pf.count("c", torch.ones(())) is None

    def boom(*a, **k):
        raise AssertionError("a span was built with recording off")

    monkeypatch.setattr(pf, "_Span", boom)
    monkeypatch.setattr(pf, "_rec", None)
    for make in SCENES.values():
        scene, cam, cfg, bvh = make()
        t_render.render(scene, cam, cfg, bvh=bvh)
    scene, cam, cfg, target, init = fit_toy_inputs()
    t_fit.fit(scene, cam, cfg.with_(ray_chunk=96, remat=True), target,
              t_fit.FitConfig(steps=1, **TOY_FCFG),
              init_params={k: torch.from_numpy(v) for k, v in init.items()})


@pytest.mark.parametrize("route", sorted(SCENES))
def test_frame_span_tree(route):
    """One frame: ``render`` over raygen, the route's span and unswizzle;
    the route's children in order; every span in one unit; the image
    and the dispatched ops identical with recording on and off."""
    scene, cam, cfg, bvh = SCENES[route]()
    with _Ops() as off_ops:
        off = t_render.render(scene, cam, cfg, bvh=bvh)
    with pf.recording() as rec, _Ops() as on_ops:
        on = t_render.render(scene, cam, cfg, bvh=bvh)
    assert torch.equal(on, off)
    assert on_ops.ops == off_ops.ops
    by_id, kids = _tree(rec)
    (root,) = [s for s in rec.spans if s["parent"] is None]
    assert root["name"] == "render" and root["unit"] == root["id"]
    assert {s["unit"] for s in rec.spans} == {root["id"]}
    assert kids[root["id"]] == ["render.raygen", route, "render.unswizzle"]
    (top,) = _named(rec, route)
    levels = list(range(DEPTH + 1))
    if route == "chain":
        assert kids[top["id"]] == ["chain.aux"] + ["chain.segment"] * len(
            levels)
        assert [s["attrs"]["depth"] for s in _named(rec, "chain.segment")] \
            == levels
        assert not rec.counts
    else:
        assert kids[top["id"]] == ["tree.aux"] + ["tree.level"] * len(levels)
        lv = _named(rec, "tree.level")
        assert [s["attrs"]["level"] for s in lv] == levels
        for s in lv[:-1]:
            assert kids[s["id"]] == ["tree.fork", "tree.fold", "tree.compact"]
        assert kids[lv[-1]["id"]] == ["tree.fork", "tree.fold"]
        names = [c["name"] for c in rec.counts]
        assert names.count("tree.lanes") == names.count("tree.live") \
            == len(levels)
        for c in rec.counts:
            assert isinstance(c["value"], int)
            assert by_id[c["span"]]["name"] in ("tree", "tree.fork",
                                                "tree.compact")
    for s in rec.spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]


def test_tree_live_is_the_launch_live_count(monkeypatch):
    """``tree.live`` (up to the launch's lanes) paired in order with
    ``tree.lanes`` equals the lanes with ``tmax >= 0`` that each fork
    launch is handed, counted at the launch."""
    scene, cam, cfg, _ = _cornell(size=24)
    cfg = cfg.with_(max_bounces=4)
    seen, launch = [], mega.trace_segment

    def spy(packed, aux, depth, o, d, thr, tmax, **kw):
        seen.append((o.shape[0], int((tmax >= 0).sum())))
        return launch(packed, aux, depth, o, d, thr, tmax, **kw)

    monkeypatch.setattr(mega, "trace_segment", spy)
    with pf.recording() as rec:
        t_render.render(scene, cam, cfg)
    lanes = [c["value"] for c in rec.counts if c["name"] == "tree.lanes"]
    live = [c["value"] for c in rec.counts if c["name"] == "tree.live"]
    assert lanes == [n for n, _ in seen]
    assert [min(a, b) for a, b in zip(live, lanes)] == [k for _, k in seen]
    assert 0 < sum(k for _, k in seen) < sum(lanes)


def _fit_case(path):
    """``(scene, cam, cfg, target, fit config, init, chunks)`` of a 2-step
    CPU fit on the chunked composed path or the chunked replay."""
    if path == "composed":
        scene, cam, cfg, target, init = fit_toy_inputs()
        init = {k: torch.from_numpy(v) for k, v in init.items()}
        cfg, fcfg, bvh = cfg.with_(ray_chunk=96, remat=True), TOY_FCFG, None
    else:
        scene, cam, bvh, target, init = fit_inputs()
        cfg, fcfg = CFG.with_(ray_chunk=128), FCFG
    n = generate_rays_blocks(cam, cfg.block_size)[0].shape[0]
    return (scene, cam, cfg, target, t_fit.FitConfig(steps=2, **fcfg), init,
            -(-n // cfg.ray_chunk), bvh)


@pytest.mark.parametrize("path", ["composed", "replay"])
def test_fit_span_tree(path):
    """Two fit steps: a ``fit.step`` each (its own unit) over
    value-and-grad, the hook, Adam and the loss read back; the chunked
    step's chunks with their forward and backward; the composed chain's
    segments, live tests and counters; the same losses and parameters
    with recording on and off."""
    scene, cam, cfg, target, fcfg, init, chunks, bvh = _fit_case(path)
    hook = lambda g, p: g
    kw = dict(init_params=init, bvh=bvh, grad_transform=hook)
    off = t_fit.fit(scene, cam, cfg, target, fcfg, **kw)
    with pf.recording() as rec:
        on = t_fit.fit(scene, cam, cfg, target, fcfg, **kw)
    assert (on.losses == off.losses).all()
    for k in on.params:
        assert torch.equal(on.params[k], off.params[k]), k
    by_id, kids = _tree(rec)
    steps = _named(rec, "fit.step")
    assert [s["attrs"]["step"] for s in steps] == [0, 1]
    for s in steps:
        assert s["parent"] is None and s["unit"] == s["id"]
        assert kids[s["id"]] == ["fit.value_and_grad", "fit.grad_transform",
                                 "fit.adam", "fit.sync"]
    for s in rec.spans:
        root = s
        while root["parent"] is not None:
            root = by_id[root["parent"]]
        assert root["name"] == "fit.step" and s["unit"] == root["id"]
    vg = _named(rec, "fit.value_and_grad")
    pre = "composed" if path == "composed" else "replay"
    for v in vg:
        want = ([] if path == "composed" else ["replay.records"]) + \
            [f"{pre}.chunk"] * chunks
        assert kids[v["id"]] == want
    for c in _named(rec, f"{pre}.chunk"):
        assert kids[c["id"]] == [f"{pre}.forward", f"{pre}.backward"]
    assert [c["attrs"]["i"] for c in _named(rec, f"{pre}.chunk")] == \
        list(range(chunks)) * 2
    if path == "composed":
        for f in _named(rec, "composed.forward"):
            assert kids[f["id"]] == ["chain"]
        depth = cfg.max_bounces + 1
        for ch in _named(rec, "chain"):
            assert kids[ch["id"]] == ["chain.sync", "chain.segment"] * depth
        names = Counter(c["name"] for c in rec.counts)
        assert names == {"chain.live": 2 * chunks * depth,
                         "chain.shadow": 2 * chunks * depth}
        for c in rec.counts:
            assert by_id[c["span"]]["name"] == "chain.segment"
            assert isinstance(c["value"], int) and c["value"] >= 0


def test_recording_edges():
    """Spans opened before the block are not kept (their children are
    outermost); spans open when it ends are kept, ending there; a
    second ``recording()`` inside the first raises."""
    with pf.span("before"):
        with pf.recording() as rec:
            with pf.span("child", k=3):
                pass
            outer = pf.span("open")
            outer.__enter__()
            with pytest.raises(RuntimeError):
                with pf.recording():
                    pass
            t_end = time.time_ns()
        outer.__exit__(None, None, None)
    names = {s["name"]: s for s in rec.spans}
    assert set(names) == {"child", "open"}
    assert names["child"]["parent"] is None
    assert names["child"]["attrs"] == {"k": 3}
    assert names["open"]["end_ns"] >= t_end


def _profile(acts, fn):
    from torch.profiler import profile
    with profile(activities=acts) as prof:
        with pf.recording() as rec:
            fn()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"clock-{os.getpid()}-{time.time_ns()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.remove(path)
    return rec, data["traceEvents"], int(data["baseTimeNanoseconds"])


def test_spans_share_the_profiler_clock():
    """A span encloses the profiler's CPU events of its block once both
    sit on one timeline: ``ts`` (us) after ``baseTimeNanoseconds``."""
    from torch.profiler import ProfilerActivity

    def work():
        x = torch.ones(4096)
        with pf.span("block"):
            y = torch.sin(x) + 1.0
            torch.cumsum(y, 0)
        torch.cos(x)

    rec, events, base = _profile([ProfilerActivity.CPU], work)
    (s,) = rec.spans
    a, z = (s["start_ns"] - base) / 1e3, (s["end_ns"] - base) / 1e3
    inside = [e for e in events if e.get("ph") == "X"
              and e.get("name") in ("aten::sin", "aten::cumsum")]
    outside = [e for e in events if e.get("ph") == "X"
               and e.get("name") == "aten::cos"]
    assert len(inside) == 2 and outside
    for e in inside:
        assert a <= float(e["ts"]) and float(e["ts"]) + e["dur"] <= z
    for e in outside:
        assert float(e["ts"]) >= z


def test_trace_file_holds_the_spans(tmp_path):
    """``profiling.trace`` around a fused tree frame writes the frame's
    spans as complete events of the program's category and its counts
    as counter events, beside the profiler's own events."""
    scene, cam, cfg, bvh = _cornell()
    with pf.trace(str(tmp_path)):
        t_render.render(scene, cam, cfg, bvh=bvh)
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == pf.SPAN_CAT]
    spans = [e for e in mine if e["ph"] == "X"]
    assert {e["name"] for e in spans} >= {"render", "tree", "tree.fork"}
    assert sum(e["ph"] == "C" and e["name"] == "tree.lanes"
               for e in mine) == DEPTH + 1
    (root,) = [e for e in spans if e["name"] == "render"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("ph") == "X"]
    assert any(root["ts"] <= float(e["ts"]) <= root["ts"] + root["dur"]
               for e in ops)


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(SCENES))
def test_sync_spans_enclose_their_sync_on_the_card(route, cuda):
    """On the card, each ``*.sync`` span of a fused frame encloses the
    runtime's synchronize call of its overflow read-back, on the trace's
    own clock."""
    from torch.profiler import ProfilerActivity
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from raybench import spans as rs

    scene, cam, cfg, bvh = SCENES[route](device=cuda, size=64)
    t_render.render(scene, cam, cfg, bvh=bvh)
    torch.cuda.synchronize()
    rec, events, base = _profile(
        [ProfilerActivity.CPU, ProfilerActivity.CUDA],
        lambda: t_render.render(scene, cam, cfg, bvh=bvh))
    got = rs.sync_margins(events, base, rec.spans, -1e30, 1e30)
    assert got["n"] == 1 and got["missing"] == 0 and got["worst_us"] >= 0
