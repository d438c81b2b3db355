"""Fit cells: inverse rendering through the port's ``fit.fit``, steps back to back.

Set-up builds the deployment through the port's ``SceneBuilder``, applies
the mix's route to the configuration's render settings (the composed fit:
depth ``max_bounces``, chunks of ``ray_chunk_share`` of the pixels,
rematerialised segments; the replay: the configuration's depth on the
fused kernel it records with), prepares the BVH (``bvh_prepare_s``) and
renders the target at the true parameters, as the port's ``fit`` command
sets a fit up. It then warms up with a fit of ``warmup_steps`` steps from
the true parameters, whose median step sets how many steps fill the
window.

The window is one ``fit.fit`` call from the seeded start
(``traffic.fit_start``) of as many steps as fill ``--seconds`` at the
warm-up's pace; ``fit_step_s`` is its host time over those steps. A hook
on the gradients (``grad_transform``) copies, with no synchronisation,
the first step's gradients and the parameters once ``checked_steps``
steps are done; in a ``--trace 1`` run it also profiles a stretch of
steps near the end of the same call (``trace.Stretch``).

The check (``check``) follows the window's first ``checked_steps`` steps
with the plain reference (``reference.SoftFit``, its own target, its own
Adam; on the replay with the replay's frozen mesh-shadow terms) and
compares, by the worst leaf: the first loss, the first gradient, and the
change of the parameters over the checked steps (``gaps``).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from raybench import reference, scene as scn, trace as trc
from raybench import traffic as trf
from raybench.drivers.frames import Driver as _Frames, _port_scene

NAMES = ("sphere_centers", "sphere_diffuse")
REF_BLOCK = 1 << 18      # rays per backward of the reference


def adam(params: dict, grads: dict, state: dict, lr: float) -> dict:
    """One plain Adam step (b1 0.9, b2 0.999, eps 1e-8 outside the root)."""
    t = state.get("t", 0) + 1
    state["t"] = t
    out = {}
    for k, p in params.items():
        g = grads[k]
        m = 0.9 * state.get(("m", k), torch.zeros_like(g)) + 0.1 * g
        v = 0.999 * state.get(("v", k), torch.zeros_like(g)) + 0.001 * g * g
        state[("m", k)], state[("v", k)] = m, v
        out[k] = p - lr * (m / (1 - 0.9 ** t)) / (
            torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
    return out


def gaps(prog: dict, ref: dict) -> dict:
    """Per leaf, ``| |prog| - |ref| |`` over the larger of ``|ref|`` and the
    median leaf's ``|ref|``; the worst leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
             ref.items()}
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.vector_norm(prog[k].double()))
                   - norms[k]) / max(norms[k], med, 1e-30) for k in ref)


def scalar_change_gap(prog: dict, ref: dict, init: dict,
                      ref_grads: dict) -> float:
    """Median over the scalar parameters of ``| |dp| - |dr| |`` over the
    larger of ``|dr|`` and the median ``|dr|``, where ``dp`` and ``dr`` are
    the program's and the reference's change from ``init``. Scalars whose
    reference first gradient is under a thousandth of the median
    scalar's move under Adam by round-off alone and are left out."""
    flat = lambda d: torch.cat([d[k].reshape(-1).double() for k in ref])
    g = flat(ref_grads).abs()
    dr = (flat(ref) - flat(init)).abs()
    dp = (flat(prog) - flat(init)).abs()
    keep = g >= 1e-3 * statistics.median(g.tolist())
    med = statistics.median(dr[keep].tolist())
    return statistics.median(
        (abs(a - b) / max(b, med, 1e-30)) for a, b in
        zip(dp[keep].tolist(), dr[keep].tolist()))


class Driver(_Frames):
    unit = "step"

    def __init__(self, config: dict, traffic: dict, cell: dict, device):
        self.config, self.traffic, self.cell = config, traffic, cell
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.w, self.h = int(config["width"]), int(config["height"])
        self.dep = scn.build(config)
        self.arrays = scn.arrays(self.dep)
        self.cam_params = [scn.camera(config)]
        self.depth = min(int(config["render"]["max_bounces"]),
                         int(traffic["max_bounces"]))
        self.spans = {}

    def setup(self) -> None:
        t0 = time.perf_counter()
        from unity_raytracer_tpu_torch import fit as fitmod
        from unity_raytracer_tpu_torch.models.camera import Camera
        from unity_raytracer_tpu_torch.ops import bvh as bvhmod
        from unity_raytracer_tpu_torch.ops.render import (
            check_supported, render, resolve_mode)
        from unity_raytracer_tpu_torch.utils.config import RenderConfig

        self.fitmod = fitmod
        t0 = self._since("import_s", t0)
        self.scene = _port_scene(self.dep, self.device)
        t0 = self._since("scene_s", t0)
        rc = dict(self.config["render"], **self.traffic["render"])
        rc["background"] = tuple(rc["background"])
        rc["max_bounces"] = self.depth
        rc["ray_chunk"] = int(self.w * self.h
                              * self.traffic["ray_chunk_share"]) or None
        self.cfg = resolve_mode(self.scene, RenderConfig(**rc))
        check_supported(self.cfg)
        self.bvh = bvhmod.prepare_bvh(self.scene, self.cfg, self.device)
        t0 = self._since("bvh_prepare_s", t0)
        p = self.cam_params[0]
        self.cam = Camera.make(
            position=p["position"], forward=p["forward"], up=p["up"],
            dist=p["dist"], half_h=p["half_h"], half_v=p["half_v"],
            width=self.w, height=self.h, device=self.device)
        self.target = render(self.scene, self.cam, self.cfg, bvh=self.bvh)
        self.true = {k: v.detach().clone() for k, v in
                     fitmod.get_params(self.scene, NAMES).items()}
        t0 = self._since("target_s", t0)
        stamps = []

        def stamp(grads, params):
            self._sync()
            stamps.append(time.perf_counter())
            return grads

        fitmod.fit(self.scene, self.cam, self.cfg, self.target,
                   self._fcfg(int(self.traffic["warmup_steps"])),
                   init_params=self.true, bvh=self.bvh, grad_transform=stamp)
        self.step_s = float(np.median(np.diff(stamps)))
        self._since("warmup_s", t0)

    def _fcfg(self, steps: int):
        t = self.traffic
        return self.fitmod.FitConfig(
            param_names=NAMES, learning_rate=t["learning_rate"], steps=steps,
            soft_shadow_temp=t["soft_shadow_temp"],
            soft_hit_temp=t["soft_hit_temp"], log_every=0,
            prefix_guard_every=t["prefix_guard_every"],
            use_replay=t["use_replay"])

    def start(self, seed: int) -> None:
        """The seeded start (``traffic.fit_start``)."""
        off = trf.fit_start(self.traffic, self.true["sphere_centers"].shape[0],
                            seed)
        u = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
             for k, v in off.items()}
        self.init = {
            "sphere_centers": self.true["sphere_centers"]
            + u["sphere_centers"],
            "sphere_diffuse": torch.clamp(self.true["sphere_diffuse"]
                                          + u["sphere_diffuse"], 0, 1)}

    def window(self, seed: int, seconds: float, trace_s: float = 0.0):
        """One ``fit.fit`` call from the seeded start, of as many steps as
        fill ``seconds`` at the warm-up's pace (at least ``checked_steps``
        + 1); with ``trace_s``, the steps that fill it, up to the
        window's last, run under the profiler."""
        k = int(self.traffic["checked_steps"])
        n = max(k + 1, round(seconds / self.step_s))
        m = max(1, round(trace_s / self.step_s)) if trace_s > 0 else 0
        if m:
            n = max(n, m + 2)
        j0 = n - 1 - m               # the hook call that starts the stretch
        seen = {"calls": 0, "trace": None}
        stretch = trc.Stretch(self.on_card, self._sync)

        def hook(grads, params):
            i = seen["calls"]
            if i == 0:
                seen["grads"] = {n_: g.detach().clone()
                                 for n_, g in grads.items()}
            if i == k:
                seen["params"] = {n_: v.detach().clone()
                                  for n_, v in params.items()}
            if m and i == j0:
                stretch.start()
            if m and i == j0 + m:
                seen["trace"] = stretch.stop(m)
            seen["calls"] = i + 1
            return grads

        self._sync()
        t0 = time.perf_counter()
        res = self.fitmod.fit(self.scene, self.cam, self.cfg, self.target,
                              self._fcfg(n), init_params=self.init,
                              bvh=self.bvh, grad_transform=hook)
        self._sync()
        t1 = time.perf_counter()
        self.first = dict(losses=np.asarray(res.losses[:k], np.float64),
                          grads=seen["grads"], params=seen["params"])
        return dict(done=n, window_s=t1 - t0, trace=seen["trace"])

    def end_to_end(self, win: dict) -> dict:
        return {"fit_step_s": win["window_s"] / win["done"]}

    # -- the check --------------------------------------------------------
    def samples(self, seed: int, win: dict) -> dict:
        """The seeded start and what the window's first steps produced:
        losses, first gradients, parameters after ``checked_steps``."""
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}
        return dict(init=cpu(self.init), losses=self.first["losses"],
                    grads=cpu(self.first["grads"]),
                    params=cpu(self.first["params"]))

    def free(self) -> None:
        self.scene = self.bvh = self.target = None
        if self.on_card:
            torch.cuda.empty_cache()

    def _follow(self, dtype, fault=None) -> dict:
        """The reference's own target and its first steps from the same
        start: losses, first gradients, parameters after the steps.
        ``fault='half'`` leaves out the second half of the pixels and
        takes the mean over the rest."""
        dev = self.device
        ref = reference.Reference(self.arrays, self.depth, dev, dtype)
        soft = reference.SoftFit(ref, self.traffic["soft_hit_temp"],
                                 self.traffic["soft_shadow_temp"],
                                 replay=bool(self.traffic["use_replay"]))
        idx = np.arange(self.w * self.h)
        if fault == "half":
            idx = idx[: len(idx) // 2]
        o, d = reference.camera_rays(self.cam_params[0], self.w, self.h,
                                     idx % self.w, idx // self.w, dev, dtype)
        with torch.no_grad():
            target = torch.cat([ref.trace(o[s:s + REF_BLOCK],
                                          d[s:s + REF_BLOCK])
                                for s in range(0, len(idx), REF_BLOCK)])
            target = (target / 255.0).to(dtype)
        p = {k: v.to(dev, dtype) for k, v in self.samples_init.items()}
        state, losses, first = {}, [], None
        for _ in range(int(self.traffic["checked_steps"])):
            loss, gc, gk = soft.value_and_grad(
                p["sphere_centers"], p["sphere_diffuse"], o, d, target,
                self.depth, REF_BLOCK)
            g = {"sphere_centers": gc, "sphere_diffuse": gk}
            first = first or {k: v.float().cpu() for k, v in g.items()}
            losses.append(loss)
            p = adam(p, g, state, self.traffic["learning_rate"])
        return dict(losses=np.asarray(losses), grads=first,
                    params={k: v.float().cpu() for k, v in p.items()})

    def check(self, samples: dict, control: bool = False, fault=None):
        """``({number: value}, failed)``: the first step's loss gap
        (relative), the first gradient's gap (worst leaf) and the gap of
        the change of the parameters over the checked steps (the median
        scalar, ``scalar_change_gap``). The later steps' losses and the
        worst leaf's change are reported beside them, not compared: on
        some seeds Adam's per-component scaling turns a lane-level
        difference in the second step's gradient of a small component into
        a 1% difference of its change (PERF.md). With ``control`` the
        reference in bfloat16 stands in the program's place; ``fault``
        plants a fault in that stand-in (in float32)."""
        self.samples_init = samples["init"]
        want = self._follow(torch.float32)
        got = samples
        if control or fault:
            got = self._follow(torch.bfloat16 if control else torch.float32,
                               fault)
        init = {k: v.float() for k, v in samples["init"].items()}
        rel = np.abs(got["losses"] - want["losses"]) / np.abs(want["losses"])
        values = {
            "loss_gap": float(rel[0]),
            "grad_gap": gaps(got["grads"], want["grads"]),
            "change_gap": scalar_change_gap(got["params"], want["params"],
                                            init, want["grads"]),
        }
        delta = lambda ps: {k: ps[k].float() - init[k] for k in ps}
        self.stats = [dict(values, loss_gap_every_step=rel.tolist(),
                           change_gap_worst_leaf=gaps(
                               delta(got["params"]), delta(want["params"])),
                           prog_losses=list(got["losses"]),
                           ref_losses=list(want["losses"]))]
        limits = self.cell["check"]["limits"]
        failed = sum(1 for k, v in values.items()
                     if not v <= float(limits[k]))
        return values, failed
