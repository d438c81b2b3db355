"""The port's CUDA graphs: one capture mechanism, and the fused frame's graphs.

Three pieces of work run as CUDA graph replays on the card: each fused
frame (``ops/render.render_frame``, through ``FrameGraphs`` below), each
chunk of the soft replay fit step (``ops/replay.GraphedSoftReplay``) and
each composed chunked fit step (``fit.GraphedComposedStep``). All capture
through ``CapturedGraph``, under one rule: a graph is captured only after
the same code has run eagerly once (a frame key's first frame; the
replay's chunk 0 and the composed fit's first step, run on the capture's
side stream, as autograd's backward needs), so every kernel is loaded,
and the capture then records that code without running it.

``CapturedGraph(name, fn, device)`` captures ``fn(stage)``:

* on a side stream that waits for the work already queued, by
  ``torch.cuda.CUDAGraph``'s own calls, without the entry of the
  ``torch.cuda.graph`` context (a device synchronize, ``gc.collect`` and
  ``empty_cache``: ~0.9 s a ``fit.fit`` call in the replay fit);
* cut at each ``stage(name, **attrs)`` context that ``fn`` opens, into a
  sequence of graphs that share one memory pool (with ``like``, another
  capture's);
* ``replay()`` runs the pieces in order, each stage's inside a span of its
  name (a profiler trace names a graph's kernels by the span their launch
  was made in, so kernel #1's launches keep ``chain.segment`` or
  ``tree.fork``, and the tree's compactions ``tree.compact``), counts
  ``<name>.graph.replays``, adds to every kernel launch table (``TABLES``)
  what the captured code added to it (the capture launched nothing, so it
  takes those additions back), and, while a recording runs or a
  ``profiling.collect_counts`` block diverts the counts, counts again
  what the captured code counted (``collect_counts`` / ``recount``);
* the capture counts ``<name>.graph.captures``; ``out`` is what ``fn``
  returned: tensors of the pool that every replay writes again.

The fused frame (``FrameGraphs``): the frame's raygen, aux block, segment
launches with their ``acc`` adds (the chain) or fork launches with their
folds, ``cat``s and compactions (the tree), and the unswizzle, captured once
per key and replayed for every later frame of that key. The graphs hold the
same kernels in the same order on the same inputs as the eager frame, so a
chain frame is the eager frame's bit for bit; the tree's ``index_add``
folds sum in an order neither route fixes.

* **The key** (``frame_key``): the scene's and the BVH's identity, the
  config, the image size, and the camera tensors' shapes, dtypes and
  device. Scene and BVH are frozen dataclasses, so their identity fixes
  every tensor (address, shape, strides) and every other field that the
  graph reads or bakes in; a graph holds its scene and BVH, so their
  addresses stay valid and their identity is not reused while it lives.
  A new key captures again.
* **The camera** is the graph's input: its seven tensors are copied (one
  ``cat``) into a static buffer before each replay; nothing of it is
  baked into the capture.
* **Engagement**: the first frame of a key runs eagerly and records the
  key, its second captures, later ones replay; so a one-off render (the
  ``render`` CLI, a fit's target) never pays a capture, and the gain needs
  frames that repeat their key. A frame also runs eagerly while
  ``mega.trace_segment`` is not the module's own
  (``utils/profiling.capture_segments`` inspects each launch's inputs that
  way) or a camera tensor is not float32. The CPU never comes here. The
  eager frame is what the capture holds (``frame``), then the read of its
  stack-overflow counter.
* **Two captures of a key** (``FrameGraph``), each made at the first
  replay that needs it: a frame replayed while nothing records runs the
  whole frame as one graph; one replayed while a recording runs, the
  frame cut at each ``stage`` that ``frame`` opens, each stage's graph
  replayed inside a span of its name. The chain's stages are its segment
  launches (``chain.segment``, with their ``depth``: 11 graphs); the
  tree's, each level's fork launch (``tree.fork``) and compaction
  (``tree.compact``), with their ``level``: 19 graphs at
  ``cornell_box``'s cap 1 and depth 4, 15 at the default cap 4, where
  levels 0 and 1 hand on their children uncompacted. The cut capture
  runs the whole one's kernels in its order, so the image is its own.
  Its launch a piece is host time that the whole frame does not pay,
  and short pieces leave the card waiting for it (19 graphs cost
  ``cornell_box.tree`` ~6% of its rays/s on an H100, PERF.md §6), so
  only a recording, which reads the stages, pays it.
* **Each call** returns a new image (a clone of the graphs' output) and
  reads the stack-overflow counter the graphs zero and the kernels add to
  (one sync a frame, as the eager frame's; it raises as ``check_overflow``
  does). The capture frame's image comes from the first replay.
* **Spans**: ``render.capture`` (a capture), ``render.graph`` (the
  camera copy and the replay), ``render.sync`` (the overflow read).
  Counters: ``render.graph.captures``, ``render.graph.replays`` (each
  replay, the capture frame's included), and the recounted ``tree.lanes``
  / ``tree.live`` / ``tree.dropped`` of a replayed tree.
* **Memory**: a key's captures keep a frame's intermediates in one
  private pool (~420 MB at 1920x1080 on ``mesh100k``), the second reusing
  the blocks the first freed (same side stream); ``FrameGraphs`` keeps
  the graphs of the ``KEEP`` most recently used keys (``clear`` frees
  them) and remembers ``SEEN`` keys seen once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
import weakref
from collections import OrderedDict

import torch

from unity_raytracer_tpu_torch.ops import bvh as bvhmod
from unity_raytracer_tpu_torch.ops.kernels import (
    intersect_mk, mega, traverse_mk3)
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import check_overflow
from unity_raytracer_tpu_torch.utils import profiling
from unity_raytracer_tpu_torch.utils.profiling import count, span

# every kernel launch table of the port; a replay adds the capture's share
TABLES = (mega.launches, mega.route_launches, traverse_mk3.launches,
          intersect_mk.launches, bvhmod.launches)
CAMERA = ("position", "forward", "right", "up", "dist", "half_h", "half_v")
KEEP = 2     # keys whose graphs are kept, least recently used dropped first
SEEN = 8     # keys remembered from one eager frame
_SEGMENT = mega.trace_segment
_META = operator.attrgetter("shape", "dtype", "device")


class CapturedGraph:
    """``fn(stage)`` captured as CUDA graphs on ``device`` and replayed by
    ``replay()`` (module docstring). ``warm``: run ``fn(span)`` eagerly on
    the capture's side stream first, its work and counts real. ``like``:
    a graph never replayed while this one runs, whose side stream and
    memory pool this one takes (the allocator reuses a pool's freed
    blocks only on the stream that freed them)."""

    def __init__(self, name: str, fn, device, warm: bool = False,
                 like: CapturedGraph | None = None):
        self.name = name
        self.pieces = []      # (the stage's (name, attrs) or None, graph)
        self.pool = None if like is None else like.pool
        main = torch.cuda.current_stream(device)
        self.side = side = (torch.cuda.Stream(device=device) if like is None
                            else like.side)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            if warm:
                fn(span)
            before = [dict(t) for t in TABLES]
            try:
                with profiling.collect_counts() as counts:
                    self._begin()
                    try:
                        self.out = fn(self._stage)
                    finally:
                        self._end(None)
            finally:
                self.launches = [{k: v - b[k] for k, v in t.items()
                                  if v != b[k]}
                                 for t, b in zip(TABLES, before)]
                for t, b in zip(TABLES, before):
                    t.update(b)
        main.wait_stream(side)
        self.counts = counts
        count(f"{name}.graph.captures", 1)

    def _begin(self) -> None:
        self._open = torch.cuda.CUDAGraph()
        self._open.capture_begin(pool=self.pool)

    def _end(self, stage) -> None:
        self._open.capture_end()
        self.pieces.append((stage, self._open))
        if self.pool is None:
            self.pool = self._open.pool()

    @contextlib.contextmanager
    def _stage(self, name: str, **attrs):
        """``span(name, **attrs)`` whose launches are a graph of their
        own, replayed inside a span of that name."""
        self._end(None)
        self._begin()
        with span(name, **attrs):
            yield
        self._end((name, attrs))
        self._begin()

    def replay(self) -> None:
        """Replay the pieces in order and carry the capture's launches and
        counts (module docstring)."""
        for stage, graph in self.pieces:
            if stage is None:
                graph.replay()
            else:
                with span(stage[0], **stage[1]):
                    graph.replay()
        count(f"{self.name}.graph.replays", 1)
        for table, added in zip(TABLES, self.launches):
            for k, v in added.items():
                table[k] += v
        profiling.recount(self.counts)


def frame_key(scene, cam, cfg, bvh) -> tuple:
    """The key of a frame's graphs (module docstring)."""
    return (id(scene), id(bvh), cfg, cam.width, cam.height,
            tuple(_META(getattr(cam, f)) for f in CAMERA))


def _ref(obj):
    """A weak reference to ``obj``; for None, a call that returns None."""
    return (lambda: None) if obj is None else weakref.ref(obj)


def _camera_flat(cam) -> list:
    return [getattr(cam, f).reshape(-1) for f in CAMERA]


class FrameGraph:
    """One key's frame: ``frame(scene, cam, cfg, bvh, bg, stage) ->
    (image, overflow)`` on a camera made of views into a static buffer,
    replayed by ``__call__(cam)`` from its whole capture, or, while a
    recording runs, from its capture cut at each stage; each captured at
    its first replay, into one memory pool (module docstring)."""

    def __init__(self, frame, scene, cam, cfg, bvh):
        self.scene, self.bvh = scene, bvh     # read by address
        self.device = dev = cam.position.device
        self.cam_buf = torch.cat(_camera_flat(cam))
        views, at = {}, 0
        for f in CAMERA:
            t = getattr(cam, f)
            views[f] = self.cam_buf[at:at + t.numel()].view(t.shape)
            at += t.numel()
        cam_in = dataclasses.replace(cam, **views)
        self.bg = bg = mega.background_row(cfg.background, dev)

        # no reference back to self: a dropped key's graphs must go at
        # once, not in a later garbage collection that may fall inside
        # another key's capture (a CUDA graph freed then breaks it)
        def held(stage):
            with torch.no_grad():
                return frame(scene, cam_in, cfg, bvh, bg, stage)

        self.held = held
        self.graphs = {}      # cut at each stage? -> CapturedGraph

    def graph(self, cut: bool) -> CapturedGraph:
        """The capture cut at each stage (``cut``) or whole, made now if
        it does not exist yet."""
        if cut not in self.graphs:
            fn = self.held if cut else (lambda stage: self.held(span))
            like = next(iter(self.graphs.values()), None)
            with span("render.capture"):
                self.graphs[cut] = CapturedGraph("render", fn, self.device,
                                                 like=like)
        return self.graphs[cut]

    def __call__(self, cam) -> torch.Tensor:
        graph = self.graph(profiling.is_recording())
        with span("render.graph"):
            with torch.cuda.device(self.device):
                torch.cat(_camera_flat(cam), out=self.cam_buf)
                graph.replay()
        out, overflow = graph.out
        img = out.clone()
        with span("render.sync"):
            check_overflow(overflow)
        return img


class FrameGraphs:
    """The graphs of the fused frames by key, and the rule that engages
    them (module docstring). ``frame``: the frame as the graphs hold it
    (``(scene, cam, cfg, bvh, bg, stage) -> (image, overflow)``, no host
    sync; ``stage`` a context like ``span``)."""

    def __init__(self, frame):
        self.frame = frame
        self.graphs: OrderedDict = OrderedDict()    # key -> FrameGraph
        self.seen: OrderedDict = OrderedDict()      # key -> weak references

    def plan(self, key, scene, bvh) -> str:
        """What a frame of ``key`` on ``scene`` and ``bvh`` does: 'replay'
        (its graphs exist), 'capture' (a frame of it ran eagerly on these
        very objects) or 'eager'."""
        if key in self.graphs:
            return "replay"
        refs = self.seen.get(key)
        if refs is not None and refs[0]() is scene and refs[1]() is bvh:
            return "capture"
        return "eager"

    def note(self, key, scene, bvh) -> None:
        """Remember ``key`` after a frame of it ran eagerly (one that
        raised is not remembered: its next frame runs eagerly again)."""
        self.seen[key] = (_ref(scene), _ref(bvh))
        self.seen.move_to_end(key)
        while len(self.seen) > SEEN:
            self.seen.popitem(last=False)

    def eager(self, scene, cam, cfg, bvh) -> torch.Tensor:
        """The frame without a graph: ``frame`` as the capture holds it,
        then the read of its stack-overflow counter."""
        img, overflow = self.frame(
            scene, cam, cfg, bvh,
            mega.background_row(cfg.background, cam.position.device), span)
        with span("render.sync"):
            check_overflow(overflow)
        return img

    def __call__(self, scene, cam, cfg, bvh) -> torch.Tensor:
        if mega.trace_segment is not _SEGMENT or any(
                getattr(cam, f).dtype != torch.float32 for f in CAMERA):
            return self.eager(scene, cam, cfg, bvh)
        key = frame_key(scene, cam, cfg, bvh)
        plan = self.plan(key, scene, bvh)
        if plan == "eager":
            img = self.eager(scene, cam, cfg, bvh)
            self.note(key, scene, bvh)
            return img
        if plan == "capture":
            del self.seen[key]
            while len(self.graphs) >= KEEP:   # free a pool first
                self.graphs.popitem(last=False)
            self.graphs[key] = FrameGraph(self.frame, scene, cam, cfg, bvh)
        else:
            self.graphs.move_to_end(key)
        return self.graphs[key](cam)

    def clear(self) -> None:
        """Drop every graph (freeing its pool) and forget every key."""
        self.graphs.clear()
        self.seen.clear()
