"""Frame cells: one client in a closed loop renders frames through the port.

Set-up builds the deployment's scene through the port's public
``SceneBuilder``, prepares its BVH (``ops/bvh.prepare_bvh``, timed as
``bvh_prepare_s``), makes the mix's cameras and renders each camera once,
so every shape and allocation of the window has been seen. The window
calls ``ops.render.render`` frame after frame, each frame waited for on
the device before the next starts, and keeps a seeded sample of the
frames' images for the check. Nothing of the program's output is copied
to the host inside the window.

Each frame's latency is read between two CUDA events recorded on the
stream around the call (the device's clock; on the CPU, the host's): it
spans the host's work inside ``render`` and the device's. The window's
rate is the issued rays of the frames completed over the host clock of
the whole window.

The check (``check``) renders the sampled pixels of the sampled frames
with the plain reference (``raybench/reference.py``) and counts the
pixels whose colour differs from the program's by more than the cell's
``pixel_tol`` in some channel (on the display's 0-1 scale).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from raybench import reference, scene as scn, trace as trc
from raybench import traffic as trf, yardstick

REF_BLOCK = 1 << 16      # rays the reference traces at once


def _port_scene(dep: dict, device):
    from unity_raytracer_tpu_torch.models.scene import (
        SceneBuilder, make_material)
    b = SceneBuilder()
    for v, f, mat in dep["meshes"]:
        b.add_mesh(v, f, make_material(**mat))
    for c, r, mat in dep["spheres"]:
        b.add_sphere(c, r, make_material(**mat))
    for v, mat in dep["triangles"]:
        b.add_triangle(v[0], v[1], v[2], make_material(**mat))
    for p, i in dep["lights"]:
        b.add_point_light(p, i)
    b.set_ambient(dep["ambient"])
    return b.build(device=device)


class Driver:
    unit = "frame"

    def __init__(self, config: dict, traffic: dict, cell: dict, device):
        self.config, self.traffic, self.cell = config, traffic, cell
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.w, self.h = int(config["width"]), int(config["height"])
        self.dep = scn.build(config)
        self.arrays = scn.arrays(self.dep)
        self.cam_params = trf.orbit_cameras(traffic, config,
                                            scn.camera(config))
        self.spans: dict = {}

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def _since(self, name: str, t0: float) -> float:
        """Record the host seconds since ``t0`` as span ``name``."""
        self._sync()
        now = time.perf_counter()
        self.spans[name] = now - t0
        return now

    def setup(self) -> None:
        t0 = time.perf_counter()
        from unity_raytracer_tpu_torch.models.camera import Camera
        from unity_raytracer_tpu_torch.ops import bvh as bvhmod
        from unity_raytracer_tpu_torch.ops.render import (
            check_supported, render, resolve_mode)
        from unity_raytracer_tpu_torch.utils.config import RenderConfig

        self._render = render
        t0 = self._since("import_s", t0)
        self.scene = _port_scene(self.dep, self.device)
        t0 = self._since("scene_s", t0)
        rc = dict(self.config["render"])
        rc["background"] = tuple(rc["background"])
        self.cfg = resolve_mode(self.scene, RenderConfig(**rc))
        check_supported(self.cfg)
        self.bvh = None
        if self.cfg.use_bvh:
            self.bvh = bvhmod.prepare_bvh(self.scene, self.cfg, self.device)
            t0 = self._since("bvh_prepare_s", t0)
        self.cams = [Camera.make(
            position=p["position"], forward=p["forward"], up=p["up"],
            dist=p["dist"], half_h=p["half_h"], half_v=p["half_v"],
            width=self.w, height=self.h, device=self.device)
            for p in self.cam_params]
        # every camera once, holding as many images as the window's sample
        held = []
        for cam in self.cams:
            held = held[-self.cell["check"]["frames"]:] + [self._frame(cam)]
        self._since("warmup_s", t0)

    def start(self, seed: int) -> None:
        """Nothing of a frame cell's set-up depends on the seed."""

    def _frame(self, cam):
        return self._render(self.scene, cam, self.cfg, bvh=self.bvh)

    def window(self, seed: int, seconds: float, trace_s: float = 0.0):
        """Frames for ``seconds - trace_s``, then for ``trace_s`` under
        the profiler: a dict of the frames (``done``), the untraced
        window's host seconds, per-frame latencies (s), the kept sample
        and the trace's summary."""
        order = trf.Order(len(self.cams), seed)
        keep = trf.Reservoir(self.cell["check"]["frames"], seed)
        pairs, lat = [], []

        def frame():
            c = next(order)
            if self.on_card:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                img = self._frame(self.cams[c])
                b.record()
                b.synchronize()
                pairs.append((a, b))
            else:
                h0 = time.perf_counter()
                img = self._frame(self.cams[c])
                lat.append(time.perf_counter() - h0)
            keep.offer((keep.seen, c, img))

        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds - trace_s:
            frame()
        t1 = time.perf_counter()
        summary = self._traced(frame, trace_s) if trace_s > 0 else None
        lat += [a.elapsed_time(b) / 1e3 for a, b in pairs]
        return dict(done=keep.seen, window_s=t1 - t0, latencies=lat,
                    kept=keep.items, trace=summary)

    def _traced(self, unit, seconds: float) -> dict:
        """Run ``unit`` under the profiler for at least ``seconds`` and at
        least once; the stretch's summary (``trace.Stretch``)."""
        stretch = trc.Stretch(self.on_card, self._sync)
        stretch.start()
        n = 0
        while n == 0 or time.perf_counter() - stretch.h0 < seconds:
            unit()
            n += 1
        return stretch.stop(n)

    def end_to_end(self, win: dict) -> dict:
        issued = yardstick.count_rays(self.config["render"]["max_bounces"],
                                      self.w, self.h,
                                      len(self.dep["lights"]))
        return {"rays_per_s": issued * win["done"] / win["window_s"],
                "frame_ms_p95": float(np.percentile(win["latencies"], 95))
                * 1e3}

    # -- the check --------------------------------------------------------
    def samples(self, seed: int, win: dict) -> list:
        """The program's colours at the seeded pixel sample of each kept
        frame, on the host: dicts of ``cam``, ``idx`` and ``values``."""
        rng = trf.rng(seed, 3)
        n_pix = self.w * self.h
        want = self.cell["check"]["pixels"]
        out = []
        for _, c, img in sorted(win["kept"], key=lambda k: k[0]):
            idx = (np.arange(n_pix) if want is None else
                   np.sort(rng.choice(n_pix, size=min(want, n_pix),
                                      replace=False)))
            t = torch.as_tensor(idx, device=img.device)
            out.append(dict(cam=c, idx=idx, values=img.reshape(-1, 3)[t]
                            .float().cpu().numpy()))
        return out

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.scene = self.bvh = self.cams = None
        if self.on_card:
            torch.cuda.empty_cache()

    def _render_ref(self, ref, cam: dict, idx, dtype) -> np.ndarray:
        out = []
        for s in range(0, len(idx), REF_BLOCK):
            part = idx[s:s + REF_BLOCK]
            o, d = reference.camera_rays(cam, self.w, self.h, part % self.w,
                                         part // self.w, self.device, dtype)
            out.append((ref.trace(o, d) / 255.0).cpu().numpy())
        return np.concatenate(out)

    def check(self, samples: list, control: bool = False):
        """``({'pixels_off_pct': worst frame's}, frames over the limit)``:
        per sampled frame, the percentage of its compared pixels that
        differ from the reference by more than ``pixel_tol``. With
        ``control`` the reference in bfloat16 stands in the program's
        place."""
        depth = self.config["render"]["max_bounces"]
        ref = reference.Reference(self.arrays, depth, self.device)
        low = (reference.Reference(self.arrays, depth, self.device,
                                   torch.bfloat16) if control else None)
        tol = float(self.cell["check"]["pixel_tol"])
        out, self.stats = [], []
        for s in samples:
            cam = self.cam_params[s["cam"]]
            want = self._render_ref(ref, cam, s["idx"], torch.float32)
            got = (self._render_ref(low, cam, s["idx"], torch.bfloat16)
                   if control else s["values"])
            diff = np.abs(got - want).max(axis=-1)
            off = ~(diff <= tol)
            out.append(100.0 * float(off.mean()))
            self.stats.append({"pixels": int(off.size), "off": int(off.sum()),
                               "max_diff": float(np.nanmax(diff))})
        limit = float(self.cell["check"]["limits"]["pixels_off_pct"])
        return ({"pixels_off_pct": max(out)},
                sum(1 for r in out if not r <= limit))
