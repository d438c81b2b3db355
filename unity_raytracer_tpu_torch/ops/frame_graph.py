"""The fused frame as CUDA graph replays.

On the card, ``ops/render.render_frame`` hands each frame of the fused
route (``render.uses_fused``; ``render`` unchunked) to a ``FrameGraphs``:
the frame's raygen, aux block, segment launches with their ``acc`` adds
(the chain) or fork launches with their folds, ``cat``s and compactions
(the tree), and the unswizzle, captured once per key and replayed for
every later frame of that key. The graphs hold the same kernels in the
same order on the same inputs as the eager frame, so a chain frame is the
eager frame's bit for bit; the tree's ``index_add`` folds sum in an order
neither route fixes.

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
* **The pieces**: the capture is cut at each chain segment (the ``stage``
  that ``frame`` runs each segment launch in) into a sequence of graphs
  that share one memory pool, replayed in order, each segment's inside a
  ``chain.segment`` span: a profiler trace names a graph's kernels by the
  span its launch was made in, so kernel #1's launches keep their span.
* **Each call** returns a new image (a clone of the graphs' output), reads
  the stack-overflow counter the graphs zero and the kernels add to (one
  sync a frame, as the eager frame's; it raises as ``check_overflow``
  does) and adds the captured launches to ``mega.launches`` /
  ``mega.route_launches``. The capture frame's image comes from the
  first replay.
* **Spans**: ``render.capture`` (the capture), ``render.graph`` (the
  camera copy and the replay), ``render.sync`` (the overflow read).
  Counters: ``render.graph.captures``, ``render.graph.replays`` (each
  replay, the capture frame's included), and, while a recording runs, the
  frame's own counts of the captured code (the tree's ``tree.lanes`` /
  ``tree.live``) again after each replay (``profiling.recount``).
* **Memory**: each key's graphs keep a frame's intermediates in their
  private pool (~420 MB at 1920x1080 on ``mesh100k``); ``FrameGraphs``
  keeps the graphs of the ``KEEP`` most recently used keys (``clear``
  frees them) and remembers ``SEEN`` keys seen once.

The capture runs on a side stream between ``capture_begin`` and
``capture_end``, without ``torch.cuda.graph``'s entry (a device
synchronize, ``gc.collect`` and ``empty_cache``, ~0.9 s in the replay fit):
the eager frame before it has loaded every kernel, and the side stream
waits for the work already queued.
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
import weakref
from collections import OrderedDict

import torch

from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import check_overflow
from unity_raytracer_tpu_torch.utils import profiling
from unity_raytracer_tpu_torch.utils.profiling import count, span

CAMERA = ("position", "forward", "right", "up", "dist", "half_h", "half_v")
KEEP = 2     # keys whose graphs are kept, least recently used dropped first
SEEN = 8     # keys remembered from one eager frame
_SEGMENT = mega.trace_segment
_META = operator.attrgetter("shape", "dtype", "device")


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
    """One captured frame: ``frame(scene, cam, cfg, bvh, bg, stage) ->
    (image, overflow)`` recorded once on a camera made of views into a
    static buffer, in pieces cut at each ``stage``, replayed by
    ``__call__(cam)``."""

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
        self.bg = mega.background_row(cfg.background, dev)
        self.pieces = []      # (the stage's (name, attrs) or None, graph)
        before = dict(mega.launches), dict(mega.route_launches)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side), torch.no_grad(), \
                    profiling.collect_counts() as counts:
                self._begin()
                try:
                    self.out, self.overflow = frame(scene, cam_in, cfg, bvh,
                                                    self.bg, self._stage)
                finally:
                    self._end(None)
        finally:
            # the capture launched nothing: each replay adds these
            self.launches = {k: v - before[0][k]
                             for k, v in mega.launches.items()
                             if v != before[0][k]}
            self.route_launches = {k: v - before[1][k]
                                   for k, v in mega.route_launches.items()
                                   if v != before[1][k]}
            mega.launches.update(before[0])
            mega.route_launches.update(before[1])
        main.wait_stream(side)
        self.counts = counts
        count("render.graph.captures", 1)

    def _begin(self) -> None:
        self._open = torch.cuda.CUDAGraph()
        self._open.capture_begin(
            pool=self.pieces[0][1].pool() if self.pieces else None)

    def _end(self, stage) -> None:
        self._open.capture_end()
        self.pieces.append((stage, self._open))

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

    def __call__(self, cam) -> torch.Tensor:
        with span("render.graph"):
            with torch.cuda.device(self.device):
                torch.cat(_camera_flat(cam), out=self.cam_buf)
                for stage, graph in self.pieces:
                    if stage is None:
                        graph.replay()
                    else:
                        with span(stage[0], **stage[1]):
                            graph.replay()
            count("render.graph.replays", 1)
        for k, v in self.launches.items():
            mega.launches[k] += v
        for k, v in self.route_launches.items():
            mega.route_launches[k] += v
        img = self.out.clone()
        profiling.recount(self.counts)
        with span("render.sync"):
            check_overflow(self.overflow)
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
            with span("render.capture"):
                self.graphs[key] = FrameGraph(self.frame, scene, cam, cfg,
                                              bvh)
        else:
            self.graphs.move_to_end(key)
        return self.graphs[key](cam)

    def clear(self) -> None:
        """Drop every graph (freeing its pool) and forget every key."""
        self.graphs.clear()
        self.seen.clear()
