"""Mesh-geometry fit cells: the port's ``fit.fit`` moving a mesh's shared vertices.

The fit cells' driver (``drivers/fit.py``) with the mesh as the unknown:
the parameters are the shared vertices of every mesh of the deployment
(``fit.PARAM_PATHS['mesh_positions']``), the route the composed chunked
fit of the mix (its depth, ``ray_chunk_share``, remat, ``kernel``). Each
step of the program refits the BVH to the step's mesh on the device
(``ops/bvh.refit``) before its chunks run.

Set-up builds the deployment, prepares the BVH once at the true mesh
(``bvh_prepare_s``), renders the target at the true mesh and warms up
with ``warmup_steps`` steps from it. A program without the parameter
class stops here, at once, with an error.

The start (``mesh_start``, seeded): every used vertex moved along its
vertex normal (the normalised sum of its faces' outward normals) by a
draw uniform in +-``vertex_share`` of its mesh's mean edge.

The window, the hook and ``fit_step_s`` are the fit cells'. In a
``--trace 1`` run the fit cells' stretch (``trace.Stretch``: CUDA
activities alone, nothing recorded in the program) gives the shared
metrics; the ``REFIT_STEPS`` steps after it run under a second stretch
that also records the program's spans (``spans.Stretch``), reduced by
``spans.reduce``: ``trace['refit']`` holds the device time per step of
the launches inside ``bvh.refit`` spans and the refit's least bytes
(``raybench/refit_work``). After the window, the summed interior box
area of the program's refit (``ops/bvh.refit``) at the last recorded
step's vertices, and the same sum over a tree the program's
``prepare_bvh`` builds afresh from them.

The check follows the window's first ``checked_steps`` steps with the
plain reference (``reference_mesh.MeshFit``) from the same start, its
face table the deployment's own (each mesh's faces offset by the
vertices before it, as ``SceneBuilder`` lays them out), and compares
the first loss (relative), the first gradient (the norm of the
difference over the reference's norm) and the change of the positions
over the checked steps (``moved_change_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from raybench import reference, reference_mesh, refit_work
from raybench import spans as spn
from raybench import trace as trc
from raybench.drivers import fit as fitdrv
from raybench.drivers.frames import _port_scene

NAMES = ("mesh_positions",)
# steps recorded for the refit's readings, after the traced stretch
REFIT_STEPS = 2


def mesh_start(dep: dict, share: float, seed: int):
    """The seeded start of the deployment's shared vertices, [V,3]
    float64 in ``SceneBuilder``'s order (every mesh's vertices in turn)."""
    out = []
    rng = np.random.default_rng([abs(int(seed)), int(seed < 0), 5])
    for v, f, _ in dep["meshes"]:
        v = np.asarray(v, np.float64)
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        vn = np.zeros_like(v)
        np.add.at(vn, f.reshape(-1), np.repeat(n, 3, axis=0))
        vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
        edge = np.linalg.norm(v[f] - v[np.roll(f, 1, axis=1)], axis=-1)
        u = rng.uniform(-1.0, 1.0, len(v))
        used = np.zeros(len(v), bool)
        used[f.reshape(-1)] = True
        out.append(v + np.where(used, share * edge.mean() * u, 0.0)[:, None]
                   * vn)
    return np.concatenate(out)


def moved_change_gap(prog, ref, init, ref_grad) -> float:
    """Median over the vertex scalars that the reference's first gradient
    moves (``|g|`` above a thousandth of the median nonzero ``|g|``) of
    ``|dp - dr|`` over the larger of ``|dr|`` and the median ``|dr|``,
    where ``dp`` and ``dr`` are the program's and the reference's signed
    change from ``init``: 1 for a state left unchanged, 2 for one moved
    the wrong way. Most of a mesh's scalars get no gradient and move on
    neither side; the fit cells' measure
    (``drivers/fit.scalar_change_gap``: unsigned, its median over every
    scalar) reads 0 there whatever the program does."""
    g = ref_grad.reshape(-1).double().abs()
    dr = (ref - init).reshape(-1).double()
    dp = (prog - init).reshape(-1).double()
    nz = g[g > 0]
    if not len(nz):
        return float("inf")
    keep = g >= max(1e-3 * float(nz.median()), float(nz.min()))
    med = float(dr[keep].abs().median())
    return float(((dp[keep] - dr[keep]).abs()
                  / dr[keep].abs().clamp_min(max(med, 1e-30))).median())


def interior_area(nodes) -> float:
    """The summed surface area of the interior node boxes of node rows
    ``nodes [Nn,16]`` (lanes 0-5 the box, lane 7 the leaf count), in
    float64."""
    n = np.asarray(nodes, np.float64)
    e = np.maximum(n[n[:, 7] <= 0, 3:6] - n[n[:, 7] <= 0, 0:3], 0.0)
    return float(2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                        + e[:, 2] * e[:, 0]).sum())


class Driver(fitdrv.Driver):

    def setup(self) -> None:
        t0 = time.perf_counter()
        from unity_raytracer_tpu_torch import fit as fitmod
        if "mesh_positions" not in fitmod.PARAM_PATHS:
            raise RuntimeError("the program has no mesh_positions parameter "
                               "class: it cannot fit mesh geometry")
        from unity_raytracer_tpu_torch.models.camera import Camera
        from unity_raytracer_tpu_torch.ops import bvh as bvhmod
        from unity_raytracer_tpu_torch.ops.render import (
            check_supported, render, resolve_mode)
        from unity_raytracer_tpu_torch.utils.config import RenderConfig

        self.fitmod, self.bvhmod = fitmod, bvhmod
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
        base = np.cumsum([0] + [len(v) for v, _, _ in self.dep["meshes"]])
        self.faces = torch.as_tensor(np.concatenate(
            [np.asarray(f, np.int64).reshape(-1, 3) + b
             for (_, f, _), b in zip(self.dep["meshes"], base)]))
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
            prefix_guard_every=0, use_replay=False)

    def start(self, seed: int) -> None:
        pos = mesh_start(self.dep, float(self.traffic["vertex_share"]), seed)
        init = self.true["mesh_positions"].clone()
        init[: len(pos)] = torch.as_tensor(pos, dtype=torch.float32,
                                           device=self.device)
        self.init = {"mesh_positions": init}

    def window(self, seed: int, seconds: float, trace_s: float = 0.0):
        """The fit cells' window; in a traced run their stretch, then the
        ``REFIT_STEPS`` steps after it recorded for the refit."""
        k = int(self.traffic["checked_steps"])
        n = max(k + 1, round(seconds / self.step_s))
        m = max(1, round(trace_s / self.step_s)) if trace_s > 0 else 0
        r = REFIT_STEPS if m else 0
        if m:
            n = max(n, m + r + 2)
        j0 = n - 1 - m - r
        seen = {"calls": 0, "trace": None}
        stretch = trc.Stretch(self.on_card, self._sync)
        recorded = spn.Stretch(self.on_card, self._sync)

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
                recorded.start()
            if m and i == j0 + m + r:
                recorded.stop(r)
                seen["last"] = params["mesh_positions"].detach().clone()
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
        self.last_loss = float(res.losses[-1])
        if seen["trace"] is not None:
            seen["trace"]["refit"] = self._refit_readings(recorded,
                                                          seen["last"])
        return dict(done=n, window_s=t1 - t0, trace=seen["trace"])

    def _refit_readings(self, recorded, last) -> dict:
        """The refit's device time per recorded step and least bytes; the
        box area of the program's refit at ``last`` against a fresh
        build's (nothing where the recorded steps made no refit
        launch)."""
        red = spn.reduce(recorded.events, recorded.base_ns,
                         recorded.window_s, recorded.recording.spans,
                         recorded.units)
        dev_us = 0.0 if red is None else sum(
            s["device_us"] for s in red["per_span"].values()
            if s["name"].startswith("bvh.refit"))
        out = {"device_us_per_step": dev_us / recorded.units,
               "bytes": refit_work.refit_bytes(
                   self.scene.meshes.count, self.bvh,
                   self.scene.meshes.mesh_valid.shape[0]),
               "area": None, "fresh_area": None}
        if dev_us > 0:
            scene = self.fitmod.set_params(self.scene,
                                           {"mesh_positions": last})
            tree, _ = self.bvhmod.refit(self.bvh, scene)
            fresh = self.bvhmod.prepare_bvh(scene, self.cfg, self.device)
            out["area"] = interior_area(tree.nodes.cpu().numpy())
            out["fresh_area"] = interior_area(fresh.nodes.cpu().numpy())
        return out

    def end_to_end(self, win: dict) -> dict:
        return {"fit_step_s": win["window_s"] / win["done"]}

    def _follow(self, dtype, fault=None) -> dict:
        """The reference's own target and its first steps from the same
        start: losses, first gradient, positions after the steps."""
        dev = self.device
        fit = reference_mesh.MeshFit(
            self.arrays, self.faces, self.depth, dev,
            self.traffic["soft_hit_temp"], self.traffic["soft_shadow_temp"],
            dtype)
        idx = np.arange(self.w * self.h)
        o, d = reference.camera_rays(self.cam_params[0], self.w, self.h,
                                     idx % self.w, idx // self.w, dev, dtype)
        target = fit.target(o, d)
        pos = self.samples_init["mesh_positions"]
        losses, g, p = fit.steps(pos[: int(self.faces.max()) + 1], o, d,
                                 target, int(self.traffic["checked_steps"]),
                                 self.traffic["learning_rate"])
        return dict(losses=losses,
                    grads={"mesh_positions": g.float().cpu()},
                    params={"mesh_positions": p.float().cpu()})

    def check(self, samples: dict, control: bool = False):
        """``({number: value}, failed)``: the first loss's gap (relative),
        the first gradient's (``|g - g_ref| / |g_ref|``) and the moved
        scalars' gap of the change over the checked steps
        (``moved_change_gap``). With ``control`` the reference in
        bfloat16 stands in the program's place."""
        self.samples_init = samples["init"]
        want = self._follow(torch.float32)
        used = int(self.faces.max()) + 1
        got = dict(samples, grads={k: v[:used] for k, v in
                                   samples["grads"].items()},
                   params={k: v[:used] for k, v in
                           samples["params"].items()})
        if control:
            got = self._follow(torch.bfloat16)
        init = {k: v[:used].float() for k, v in samples["init"].items()}
        gp = got["grads"]["mesh_positions"].double()
        gr = want["grads"]["mesh_positions"].double()
        rel = np.abs(got["losses"] - want["losses"]) / np.abs(want["losses"])
        values = {
            "loss_gap": float(rel[0]),
            "grad_gap": float(torch.linalg.vector_norm(gp - gr)
                              / torch.linalg.vector_norm(gr)),
            "change_gap": moved_change_gap(
                got["params"]["mesh_positions"].double(),
                want["params"]["mesh_positions"].double(),
                init["mesh_positions"].double(),
                want["grads"]["mesh_positions"]),
        }
        self.stats = [dict(values, loss_gap_every_step=rel.tolist(),
                           grad_norm_gap=fitdrv.gaps(got["grads"],
                                                     want["grads"]),
                           prog_losses=list(got["losses"]),
                           ref_losses=list(want["losses"]),
                           window_last_loss=getattr(self, "last_loss",
                                                    None))]
        limits = self.cell["check"]["limits"]
        failed = sum(1 for k, v in values.items()
                     if not v <= float(limits[k]))
        return values, failed
