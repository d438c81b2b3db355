"""Frame cells with the mix's own render settings, and the dielectric tree's readings.

The frame cells' driver (``drivers/frames.py``) with three additions:

* **The mix's render settings.** A traffic file's ``render`` block, if it
  has one, is laid over the configuration's (the mix's keys win): a mix
  picks, say, the leaf test and BVH layout (``orbit_mt``). A mix without
  one runs the configuration's, as ``frames`` does.
* **The tree's readings** (a configuration with a dielectric, whose
  frames the port renders as the dielectric tree). In a ``--trace 1``
  run the ``RECORDED_FRAMES`` frames after the traced stretch (the frame
  cells' stretch: CUDA activities alone, nothing recorded in the program)
  run under a second stretch that also records the program's spans and
  counts (``spans.Stretch``), reduced by ``spans.reduce`` into
  ``trace['tree']``: the device microseconds a frame of the launches made
  inside ``tree.fork`` spans (each level's fork launch: on a replayed
  frame, its graph replayed inside the span; the port replays a frame cut
  at its stages only while it records, so one recorded frame before the
  stretch makes any capture that takes) and inside ``tree.compact``
  spans, the sums of the ``tree.lanes``, ``tree.live`` and
  ``tree.dropped`` counts, the live lanes' share of the launched ones
  (``spans.tree_live_lane_share``), and the fork launches' least bytes a
  frame (``raybench/tree_work``). A program that opens no such span, or
  makes no such count, gives nothing to read there.
* **The dropped lanes' check** (same configurations): after the window,
  before ``free``, each checked frame's camera is rendered once more
  inside ``collect_counts``, which takes the program's counts without
  recording: the port then replays the very graph the timed frames
  replay (the whole frame, under the same key) and hands on the counts
  its capture made, and the ``tree.dropped`` ones (the live lanes the
  tree's cap cut, counted by the port's own compaction) are summed.
  ``lanes_dropped`` is their sum over the checked frames; a checked frame
  fails where its pixels or its dropped lanes exceed their limits.
"""

from __future__ import annotations

from raybench import spans as spn
from raybench import traffic as trf
from raybench import tree_work
from raybench.drivers import frames

# frames recorded for the tree's readings, after the traced stretch
RECORDED_FRAMES = 8


def _sum(counts: list, name: str) -> int:
    return sum(int(c["value"]) for c in counts if c["name"] == name)


class Driver(frames.Driver):

    def __init__(self, config: dict, traffic: dict, cell: dict, device):
        if traffic.get("render"):
            config = dict(config, render=dict(config["render"],
                                              **traffic["render"]))
        super().__init__(config, traffic, cell, device)
        self.is_tree = False

    def setup(self) -> None:
        super().setup()
        self.is_tree = self.cfg.mode == "tree"

    def window(self, seed: int, seconds: float, trace_s: float = 0.0):
        """The frame cells' window; in a traced run of a tree, their
        stretch, then ``RECORDED_FRAMES`` frames recorded for the tree's
        readings."""
        win = super().window(seed, seconds, trace_s)
        if win["trace"] is not None and self.is_tree:
            win["trace"]["tree"] = self._tree_readings(seed)
        return win

    def _tree_readings(self, seed: int) -> dict:
        """``trace['tree']`` (module docstring) over ``RECORDED_FRAMES``
        recorded frames of the orbit, in a seeded order."""
        from unity_raytracer_tpu_torch.utils.profiling import recording
        order = trf.Order(len(self.cams), seed)
        with recording():      # a recorded frame first: any capture it
            self._frame(self.cams[0])    # makes stays outside the stretch
        rec = spn.Stretch(self.on_card, self._sync)
        rec.start()
        for _ in range(RECORDED_FRAMES):
            self._frame(self.cams[next(order)])
        rec.stop(RECORDED_FRAMES)
        red = spn.reduce(rec.events, rec.base_ns, rec.window_s,
                         rec.recording.spans, rec.units)
        per = {} if red is None else red["per_span"]
        device_us = lambda name: sum(s["device_us"] for s in per.values()
                                     if s["name"] == name)
        counts = rec.recording.counts
        lanes = _sum(counts, "tree.lanes")
        launches = sum(1 for c in counts if c["name"] == "tree.lanes")
        a = self.arrays
        aux_rows = (1 + len(a["light_pos"]) + len(a["sph_center"])
                    + len(a["tri_verts"]) + len(a["mat_diffuse"]))
        tables = tree_work.table_bytes(self.bvh, self.cfg.tri_isect,
                                       self.cfg.bvh_arity, aux_rows)
        n = RECORDED_FRAMES
        return {"frames": n,
                "fork_us_per_frame": device_us("tree.fork") / n,
                "compact_us_per_frame": device_us("tree.compact") / n,
                "lanes": lanes, "live": _sum(counts, "tree.live"),
                "dropped": _sum(counts, "tree.dropped"),
                "fork_launches_per_frame": launches / n,
                "live_share": spn.tree_live_lane_share(counts, rec.t0_ns,
                                                       rec.t1_ns),
                "fork_bytes_per_frame": tree_work.fork_bytes(
                    lanes / n, launches / n, tables)}

    # -- the check --------------------------------------------------------
    def samples(self, seed: int, win: dict) -> list:
        """The frame cells' samples; for a tree, each with ``dropped``: the
        live lanes the cap cut when its camera is rendered again."""
        out = super().samples(seed, win)
        if self.is_tree:
            from unity_raytracer_tpu_torch.utils.profiling import (
                collect_counts)
            for s in out:
                with collect_counts() as got:
                    self._frame(self.cams[s["cam"]])
                s["dropped"] = sum(int(v) for name, v in got
                                   if name == "tree.dropped")
        return out

    def check(self, samples: list, control: bool = False):
        """The frame cells' check; for a tree, with ``lanes_dropped`` (the
        checked frames' sum) and each checked frame failed where either
        number exceeds its limit."""
        values, failed = super().check(samples, control)
        if not self.is_tree:
            return values, failed
        limits = self.cell["check"]["limits"]
        pix = float(limits["pixels_off_pct"])
        lim = float(limits["lanes_dropped"])
        values["lanes_dropped"] = sum(s["dropped"] for s in samples)
        failed = sum(1 for s, st in zip(samples, self.stats)
                     if not (100.0 * (st["off"] / st["pixels"]) <= pix
                             and s["dropped"] <= lim))
        return values, failed
