"""Differentiable inverse rendering: the composed path and the record-replay path.

Twin: ``unity_raytracer_tpu/fit.py`` — ``PARAM_PATHS``, ``get_params``,
``set_params`` and ``_replace_path`` (``:34-76``), ``FitConfig`` and
``FitResult`` (``:79-111``), ``make_loss_fn`` (``:114-131``), ``_bind``
(``:134-141``), ``make_chunked_value_and_grad`` (``:144-211``) and
``fit`` (``:214-365``). Recover scene parameters (sphere positions,
materials, light intensities, mesh vertices) from a target image by
pixel-gradient descent, on one of three steps:

* the composed path, whole image (the default): autograd through
  ``ops/render.render`` — the composed bounce chain around the traversal
  kernels, with soft visibility for silhouette gradients;
* the composed path, chunked (``rcfg.ray_chunk`` set): per chunk of rays
  the gradient of its squared error (``autograd.grad``) added into
  accumulated sums, then the weighted mean (``make_chunked_value_and_grad``);
  with ``rcfg.remat`` each bounce segment is recomputed in the backward.
  On the card ``fit`` runs the mirror chain's chunked step as one CUDA
  graph replay (``GraphedComposedStep``: the refit of a mesh fit and every
  chunk's forward and backward, captured in the first step of each
  ``fit`` call; the chain runs every segment and nothing inside the step
  syncs, so the host issues Adam's launches and reads the loss and the
  stack-overflow counter once a step). It needs the walk kernels on a
  ``PackedBVH`` (``ops/bvh.kernel_walk``); the CPU, the dielectric tree,
  the plain walk (``kernel='xla'``), a fit without a BVH, the whole-image
  step and the other callers of ``make_chunked_value_and_grad``
  (``parallel/shard``, ``bench.py``) run it eagerly;
* the record-replay path (``FitConfig.use_replay``): each step records
  the bounce chain with the fused kernel at the current parameters and
  back-propagates through the soft shading replay
  (``ops/replay.soft_replay_value_and_grad``; on the card
  ``ops/replay.GraphedSoftReplay``, each chunk one CUDA graph replay).

The parameters are leaf tensors with ``requires_grad``, installed into a
template scene with ``dataclasses.replace``; the optimizer is
``torch.optim.Adam`` (optax's adam defaults are its defaults). Mesh
geometry moves as the shared vertices (``mesh_positions``, the port's own
class: each triangle's corners re-derived from them, so the mesh stays
closed) or as free corners (``mesh_verts``); either way each step first
refits the BVH to the step's mesh (``ops/bvh.refit``: boxes, rows, leaf
records and the scene's gates, on the device), and the corners reach the
traversal epilogue through ``ops/bvh.bind_verts``. A fit that moves no
mesh refits nothing.

Spans (``utils/profiling.span``): each step of ``fit`` is a ``fit.step``
(attribute ``step``) over ``fit.value_and_grad`` (a mesh fit's
``bvh.refit`` first), ``fit.grad_transform``
(the caller's hook), ``fit.adam``, ``fit.sync`` (the loss read back),
``fit.prefix_guard`` and ``fit.checkpoint`` where they run; the chunked
composed step splits into ``composed.chunk`` (attribute ``i``) over
``composed.forward`` and ``composed.backward``. The graphed step's call is
``composed.capture`` (its first: the eager warm-up step and the capture,
the spans above inside it) or ``composed.graph`` (the parameters copied
in, the replay, a mesh fit's refit replayed inside a ``bvh.refit`` span);
counters ``composed.graph.captures`` (1 a ``fit`` call) and
``composed.graph.replays`` (1 a later step); the overflow read sits in
``fit.sync``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.convert import (
    adam_state_from_arrays, params_from_arrays)
from unity_raytracer_tpu_torch.models.scene import Scene
from unity_raytracer_tpu_torch.ops import replay as rp
from unity_raytracer_tpu_torch.ops.bvh import (
    bind_verts, kernel_walk, refit, with_refit_tables)
from unity_raytracer_tpu_torch.ops.graphs import CapturedGraph
from unity_raytracer_tpu_torch.ops.kernels.mega import background_row
from unity_raytracer_tpu_torch.ops.kernels.traverse_mk3 import check_overflow
from unity_raytracer_tpu_torch.ops.render import (
    render, resolve_mode, trace_radiance)
from unity_raytracer_tpu_torch.utils import checkpoint as ckpt
from unity_raytracer_tpu_torch.utils.config import DiffConfig, RenderConfig
from unity_raytracer_tpu_torch.utils.profiling import span
from unity_raytracer_tpu_torch.utils.swizzle import swizzle_image

# Parameter classes that can be optimized; each names a leaf of the scene.
PARAM_PATHS = {
    "sphere_centers": ("spheres", "centers"),
    "sphere_radius_sq": ("spheres", "radius_sq"),
    "sphere_diffuse": ("spheres", "materials", "diffuse"),
    "sphere_ambient": ("spheres", "materials", "ambient"),
    "sphere_specular": ("spheres", "materials", "specular"),
    "sphere_mirror": ("spheres", "materials", "mirror"),
    "tri_verts": ("triangles", "verts"),
    "tri_diffuse": ("triangles", "materials", "diffuse"),
    "light_positions": ("lights", "positions"),
    "light_intensities": ("lights", "intensities"),
    # mesh geometry, on the composed path: fit refits the BVH to each
    # step's mesh (ops/bvh.refit) and re-binds the epilogue's triangles
    # (bind_verts). mesh_verts moves each triangle's corners on their own;
    # mesh_positions moves the shared vertices (MeshSet.positions), from
    # which set_params re-derives the corners
    "mesh_verts": ("meshes", "verts"),
    "mesh_positions": ("meshes", "positions"),
}
MESH_PARAMS = ("mesh_verts", "mesh_positions")


def get_params(scene: Scene, names: Tuple[str, ...]
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for name in names:
        node = scene
        for attr in PARAM_PATHS[name]:
            node = getattr(node, attr)
        out[name] = node
    return out


def set_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    """``scene`` with ``params`` installed; with ``mesh_positions`` (and
    no ``mesh_verts`` given beside it) the mesh corners are
    ``positions[faces]``, so a shared vertex's gradient is the sum of its
    corners' (an atomic ``index_add_``: the backward of ``index_select``)."""
    for name, value in params.items():
        scene = _replace_path(scene, PARAM_PATHS[name], value)
    if "mesh_positions" in params and "mesh_verts" not in params:
        m = scene.meshes
        verts = torch.index_select(m.positions, 0, m.faces.reshape(-1))
        scene = dataclasses.replace(scene, meshes=dataclasses.replace(
            m, verts=verts.view(-1, 3, 3)))
    return scene


def _refit(bvh, template: Scene, params: Dict[str, torch.Tensor],
           stage: Optional[Callable] = None):
    """``(bvh, template)`` refit to the mesh of ``params`` (detached):
    ``ops/bvh.refit``, once a step, before the step's rays; inside
    ``stage('bvh.refit')`` where a stage is given (a graph's piece of its
    own)."""
    with torch.no_grad():
        scene = set_params(template, {k: v.detach() for k, v in
                                      params.items()})
        with stage("bvh.refit") if stage else contextlib.nullcontext():
            return refit(bvh, scene)


def _replace_path(node, path, value):
    if len(path) == 1:
        return dataclasses.replace(node, **{path[0]: value})
    child = getattr(node, path[0])
    return dataclasses.replace(
        node, **{path[0]: _replace_path(child, path[1:], value)})


@dataclass(frozen=True)
class FitConfig:
    param_names: Tuple[str, ...] = ("sphere_centers", "sphere_diffuse")
    learning_rate: float = 0.05
    steps: int = 200
    soft_shadow_temp: float = 1.0
    soft_hit_temp: float = 0.05
    log_every: int = 20
    checkpoint_every: int = 0          # 0 = disabled
    checkpoint_path: Optional[str] = None
    use_replay: bool = False           # the soft record-replay step
    #   (ops/replay.soft_replay_value_and_grad): fused-kernel records
    #   with min-mode shadow walks + the differentiable soft replay;
    #   False runs the composed path
    prefix_guard_every: int = 25       # every K steps, re-measure the
    #   live bounce depth on the current params; if the mirror chain
    #   deepened past the replay's live-segment prefix (which would
    #   silently drop radiance and gradients), widen the prefix. 0
    #   disables the guard.


class FitResult(NamedTuple):
    scene: Scene
    params: Dict[str, torch.Tensor]
    losses: np.ndarray
    step: int
    # the final live-segment prefix of the replay; above the first
    # measurement iff the prefix guard widened it mid-fit
    live_prefix: Optional[int] = None


def make_loss_fn(template: Scene, cam: Camera, rcfg: RenderConfig,
                 target: torch.Tensor, bvh=None,
                 refit_bvh: bool = False) -> Callable:
    """Pixel-MSE loss of ``render`` against ``target`` ([H,W,3], display
    scale). ``rcfg`` should carry a soft ``DiffConfig`` so silhouette
    gradients exist; with ``straight_through`` the forward stays hard.
    ``bvh``: a prebuilt BVH (``ops/bvh.prepare_bvh``), re-bound to each
    call's mesh verts; ``refit_bvh`` refits it to them first (a fit that
    moves the mesh)."""
    rcfg = resolve_mode(template, rcfg)

    def loss_fn(params: Dict[str, torch.Tensor]) -> torch.Tensor:
        tmpl, b = template, bvh
        if refit_bvh:
            b, tmpl = _refit(bvh, template, params)
        scene = set_params(tmpl, params)
        img = render(scene, cam, rcfg, bvh=_bind(b, scene))
        return ((img - target) ** 2).mean()

    return loss_fn


def _bind(bvh, scene):
    """Re-bind the BVH's epilogue triangles to the scene's current mesh
    verts (``ops/bvh.bind_verts``, the mesh-vertex gradient)."""
    if bvh is None:
        return None
    return bind_verts(bvh, scene)


class _Chunks(NamedTuple):
    """A batch's lanes in chunks of equal size ``[B, C, ...]``, the last
    one padded (``_chunks``), and the step's divisor."""
    o: torch.Tensor
    d: torch.Tensor
    target: torch.Tensor
    weights: torch.Tensor
    denom: torch.Tensor | float


def _chunks(rcfg: RenderConfig, o, d, target, chunk=None, weights=None,
            denom=None) -> _Chunks:
    """``make_chunked_value_and_grad``'s lanes in chunks of ``chunk``
    (default ``rcfg.ray_chunk``): the last chunk padded with dead lanes
    (origin 0, direction +z, target 0, weight 0), ``denom`` 3x the weight
    sum unless given."""
    n = o.shape[0]
    c = min(chunk or rcfg.ray_chunk or n, n)
    w = (torch.ones((n,), dtype=torch.float32, device=o.device)
         if weights is None else weights.to(torch.float32))
    if denom is None:
        denom = w.sum() * 3.0
    pad = (-n) % c
    if pad:
        z = torch.zeros((pad, 3), dtype=torch.float32, device=o.device)
        z[:, 2] = 1.0
        o, d = torch.cat([o, z]), torch.cat([d, z])
        target = torch.cat([target, torch.zeros_like(z)])
        w = torch.cat([w, w.new_zeros(pad)])
    return _Chunks(o.reshape(-1, c, 3), d.reshape(-1, c, 3),
                   target.reshape(-1, c, 3), w.reshape(-1, c), denom)


def _chunk_sums(template: Scene, rcfg: RenderConfig, ch: _Chunks, bvh,
                bg: torch.Tensor, leaves: Dict[str, torch.Tensor],
                loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                refit_bvh: bool = False,
                overflow: Optional[torch.Tensor] = None,
                stage: Optional[Callable] = None) -> None:
    """The chunked step's body, the eager step's and its graph's: the
    refit of ``bvh`` to the mesh of ``leaves`` (inside ``stage
    ('bvh.refit')`` where a stage is given), then per chunk the forward,
    ``autograd.grad`` of its weighted squared-error sum to ``leaves`` and
    the adds into ``loss`` and ``grads``. ``bg``: the background row
    (``mega.background_row``, built once by the caller); ``overflow``: the
    chain's stack-overflow counter, read by the caller
    (``trace_radiance``)."""
    tmpl, b = template, bvh
    if refit_bvh:
        b, tmpl = _refit(bvh, template, leaves, stage)
    names = list(leaves)
    for i in range(ch.o.shape[0]):
        with span("composed.chunk", i=i):
            with span("composed.forward"):
                scene = set_params(tmpl, leaves)
                rad = trace_radiance(scene, ch.o[i], ch.d[i], rcfg,
                                     bvh=_bind(b, scene), overflow=overflow,
                                     bg=bg)
                l_i = (((rad - ch.target[i]) ** 2)
                       * ch.weights[i][:, None]).sum()
            with span("composed.backward"):
                gs = torch.autograd.grad(l_i, [leaves[k] for k in names],
                                         allow_unused=True)
            loss.add_(l_i.detach())
            for k, g in zip(names, gs):
                if g is not None:
                    grads[k].add_(g)


def make_chunked_value_and_grad(template: Scene, rcfg: RenderConfig,
                                o: torch.Tensor, d: torch.Tensor,
                                target: torch.Tensor, bvh=None,
                                chunk: Optional[int] = None,
                                weights: Optional[torch.Tensor] = None,
                                denom: Optional[float] = None,
                                refit_bvh: bool = False) -> Callable:
    """Chunked gradient accumulation on the composed path: for each chunk
    of rays, the gradient of its summed squared error added into the same
    sums; the loss and gradients are divided once at the end by 3x the
    weight sum, so they equal the unchunked weighted-mean MSE's. Only one
    chunk's graph is alive at a time; ``rcfg.remat`` also recomputes each
    bounce segment in the backward.

    ``target``: radiance on the 0-255 scale, [N,3] aligned with
    ``(o, d)``. ``weights`` (optional [N]): per-lane loss weights, e.g. 0
    on the pad margin of block-ordered raygen. ``denom`` replaces the
    divisor: a rank's share of a loss over more rays than its own
    (``parallel/shard.make_sharded_train_step``). ``refit_bvh``: refit
    ``bvh`` to the mesh of ``params`` once per call, before the first
    chunk (a fit that moves the mesh). Each chunk installs the parameters
    anew, so that a chunk's graph (``positions[faces]``) is its own.
    Returns ``f(params) -> (loss, grads)``; ``GraphedComposedStep`` runs
    the same body as one CUDA graph replay."""
    rcfg = resolve_mode(template, rcfg)
    ch = _chunks(rcfg, o, d, target, chunk, weights, denom)
    bg = background_row(rcfg.background, o.device)

    def value_and_grad_fn(params):
        leaves = rp._leaves(params)
        loss = torch.zeros((), dtype=torch.float32, device=o.device)
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        _chunk_sums(template, rcfg, ch, bvh, bg, leaves, loss, grads,
                    refit_bvh)
        return loss / ch.denom, {k: g / ch.denom for k, g in grads.items()}

    return value_and_grad_fn


class GraphedComposedStep:
    """``make_chunked_value_and_grad`` with the whole step one CUDA graph
    replay (``ops/graphs.CapturedGraph`` named ``composed``): the refit of
    a mesh fit (its own stage, replayed inside a ``bvh.refit`` span), then
    for every chunk the forward, the (rematerialised) backward and the
    adds into the step's sums: ``_chunk_sums``, the eager step's body, with
    the chain's stack-overflow counter passed in, so every chain segment
    runs and nothing inside the step syncs. The same kernels on the same
    float32 inputs as the eager step; besides the order of the
    ``index_add_`` atomics, the one difference is the dead segments it
    runs, which add exactly 0.

    One object serves one ``fit.fit`` call (built there on the card, for
    the composed chunked scan chain). It owns what the graph reads and
    writes by address: the chunks of the rays, targets and weights
    (fixed for the call, padded as the eager step pads them), one
    ``requires_grad`` leaf per parameter, the loss and gradient sums and
    the overflow counter, all of which the graph zeroes first, and the
    background row, built here so that nothing is copied from the host
    inside the step.

    Per call: the values of ``params`` are copied into the leaves and the
    graph replayed (span ``composed.graph``, counter
    ``composed.graph.replays``). The first call captures instead (span
    ``composed.capture``, counter ``composed.graph.captures``;
    ``warm=True``: the step runs eagerly on the capture's side stream,
    which fills the sums, and the capture then records the same code
    without running it). Returns ``(loss, grads)`` divided as the eager
    step divides them, as new tensors; ``check`` reads the overflow
    counter (one sync, after the caller's read of the loss) and raises as
    ``check_overflow`` does."""

    def __init__(self, template: Scene, params: Dict[str, torch.Tensor],
                 rcfg: RenderConfig, o: torch.Tensor, d: torch.Tensor,
                 target: torch.Tensor, bvh=None,
                 weights: Optional[torch.Tensor] = None,
                 refit_bvh: bool = False):
        if refit_bvh:
            bvh = with_refit_tables(bvh, template)
        self.template, self.bvh, self.refit_bvh = template, bvh, refit_bvh
        self.rcfg = resolve_mode(template, rcfg)
        self.ch = _chunks(self.rcfg, o, d, target, weights=weights)
        self.device = o.device
        self.leaves = {k: torch.zeros_like(v).requires_grad_(True)
                       for k, v in params.items()}
        self.loss = torch.zeros((), dtype=torch.float32, device=o.device)
        self.grads = {k: torch.zeros_like(v) for k, v in params.items()}
        self.overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
        self.bg = background_row(self.rcfg.background, o.device)
        self.graph = None

    def _step(self, stage) -> None:
        """What the graph holds: the sums zeroed, then ``_chunk_sums``."""
        self.loss.zero_()
        for g in self.grads.values():
            g.zero_()
        self.overflow.zero_()
        _chunk_sums(self.template, self.rcfg, self.ch, self.bvh, self.bg,
                    self.leaves, self.loss, self.grads, self.refit_bvh,
                    overflow=self.overflow, stage=stage)

    def __call__(self, params: Dict[str, torch.Tensor]):
        first = self.graph is None
        with span("composed.capture" if first else "composed.graph"):
            with torch.no_grad():
                for k, v in params.items():
                    self.leaves[k].copy_(v)
            if first:
                self.graph = CapturedGraph("composed", self._step,
                                           self.device, warm=True)
            else:
                self.graph.replay()
        denom = self.ch.denom
        return self.loss / denom, {k: g / denom
                                   for k, g in self.grads.items()}

    def check(self) -> None:
        """Raise if the last step's walks dropped stack pushes."""
        check_overflow(self.overflow, "traversal")


def fit(template: Scene, cam: Camera, rcfg: RenderConfig,
        target: torch.Tensor, cfg: FitConfig,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        resume_from: Optional[str] = None,
        grad_transform: Optional[Callable] = None,
        bvh=None) -> FitResult:
    """Adam descent on the pixel MSE against ``target`` ([H,W,3], display
    scale): on the composed path (whole image, or chunked when
    ``rcfg.ray_chunk`` is set), or on the record-replay path with
    ``cfg.use_replay``.

    ``bvh``: the BVH from ``ops/bvh.prepare_bvh`` for ``use_bvh`` scenes
    (the replay needs the fused kernel's ``PackedBVH``). Parameters that
    move the mesh (``MESH_PARAMS``; the composed path only) refit it to
    each step's mesh before the step's rays (``ops/bvh.refit``; its index
    tables made once, here, on the host). ``grad_transform
    (grads, params) -> grads`` hooks in a gradient all-reduce for
    multi-device runs. ``resume_from``: a checkpoint written by this
    function (``cfg.checkpoint_every``); the fit continues from its step,
    parameters and Adam state.
    """
    rcfg = resolve_mode(template, rcfg).with_(
        diff=DiffConfig(soft_shadow_temp=cfg.soft_shadow_temp,
                        soft_hit_temp=cfg.soft_hit_temp,
                        straight_through=True))
    dev = template.aabb_min.device
    src = init_params or get_params(template, cfg.param_names)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in src.items()}
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    scale = 1.0 / (255.0 * 255.0)  # radiance-scale MSE -> image MSE
    live_prefix = measure_prefix = step_graph = None
    refit_bvh = bvh is not None and any(k in params for k in MESH_PARAMS)
    if refit_bvh:
        if cfg.use_replay:
            raise ValueError("a fit that moves the mesh runs on the "
                             "composed path, not FitConfig.use_replay")
        bvh = with_refit_tables(bvh, template)
    if cfg.use_replay:
        if rcfg.mode != "scan" or bvh is None \
                or getattr(bvh, "leafmeta", None) is None:
            raise ValueError("FitConfig.use_replay needs mode='scan' and "
                             "the fused kernel's PackedBVH "
                             "(ops/bvh.prepare_bvh)")
        rcfg_m = rcfg.with_(kernel="mega")
        o, d = generate_rays_blocks(cam, rcfg.block_size)
        tgt_rad = swizzle_image(target, rcfg.block_size) * 255.0
        lane_w = _lane_weights(cam, rcfg, dev)

        def measure_prefix(p):
            _, recs = rp.trace_records(set_params(template, p), o, d,
                                       rcfg_m, bvh, soft=True)
            return rp.live_depth(recs)

        # the live-segment prefix is measured on the scene being optimized
        # (template + init params), +1 for a chain that extends by one;
        # the guard below catches deeper extensions mid-fit
        live_prefix = min(rcfg_m.max_bounces + 1, measure_prefix(params) + 1)
        # the replay runs in chunks at frame scale (its [N,L] temporaries
        # would otherwise hold the whole frame's graph)
        chunk = rcfg.ray_chunk or ((1 << 18) if o.shape[0] > (1 << 18)
                                   else None)

        # on the card each chunk is one CUDA graph replay (captured in the
        # first step, again when the prefix guard widens the prefix)
        graphed = (rp.GraphedSoftReplay(template, params, o, d, tgt_rad,
                                        rcfg_m, bvh, weights=lane_w,
                                        chunk=chunk)
                   if dev.type == "cuda" else None)

        def value_and_grad(p):
            if graphed is not None:
                loss, grads = graphed(p, live_segments=live_prefix)
            else:
                loss, grads = rp.soft_replay_value_and_grad(
                    template, p, o, d, tgt_rad, rcfg_m, bvh, weights=lane_w,
                    live_segments=live_prefix, chunk=chunk)
            return loss * scale, {k: g * scale for k, g in grads.items()}

        # one-time check: warn when the fit starts inside the soft
        # replay's biased mesh-shadow regime
        diag = rp.soft_replay_bias_counts(set_params(template, params), o,
                                          d, rcfg_m, bvh,
                                          live_segments=live_prefix)
        if diag["mesh_occ_frozen"] or diag["proxy_mesh_risk"]:
            print(f"[fit] WARNING: soft-replay mesh-shadow bias regime "
                  f"active — {diag['mesh_occ_frozen']} lanes with frozen "
                  f"mesh-occluder shadow terms, {diag['proxy_mesh_risk']} "
                  f"proxy lanes with unqueried mesh-shadow risk; gradients "
                  f"for those lanes drop mesh silhouette terms (use the "
                  f"composed path for exactness)")
    elif rcfg.ray_chunk:
        o, d = generate_rays_blocks(cam, rcfg.block_size)
        tgt_rad = swizzle_image(target, rcfg.block_size) * 255.0
        kw = dict(bvh=bvh, weights=_lane_weights(cam, rcfg, dev),
                  refit_bvh=refit_bvh)
        # on the card the chain's whole step on the walk kernels is one
        # CUDA graph replay (captured in the first step); the tree and the
        # plain walk read the device on the host and stay eager
        if (dev.type == "cuda" and rcfg.mode == "scan"
                and kernel_walk(bvh, rcfg.kernel)):
            raw_vg = step_graph = GraphedComposedStep(
                template, params, rcfg, o, d, tgt_rad, **kw)
        else:
            raw_vg = make_chunked_value_and_grad(template, rcfg, o, d,
                                                 tgt_rad, **kw)

        def value_and_grad(p):
            loss, grads = raw_vg(p)
            return loss * scale, {k: g * scale for k, g in grads.items()}
    else:
        loss_fn = make_loss_fn(template, cam, rcfg, target, bvh=bvh,
                               refit_bvh=refit_bvh)

        def value_and_grad(p):
            leaves = rp._leaves(p)
            loss = loss_fn(leaves)
            loss.backward()
            return loss.detach(), rp._grads(leaves)

    start_step = 0
    if resume_from:
        start_step, p_np, adam = ckpt.load_checkpoint(resume_from)
        params = params_from_arrays(p_np, dev)
    optimizer = torch.optim.Adam(list(params.values()),
                                 lr=cfg.learning_rate)
    if resume_from and adam is not None:
        adam_state_from_arrays(*adam, optimizer, params)

    losses = []
    step = start_step - 1
    for step in range(start_step, cfg.steps):
        with span("fit.step", step=step):
            with span("fit.value_and_grad"):
                loss, grads = value_and_grad(params)
            if grad_transform is not None:
                with span("fit.grad_transform"):
                    grads = grad_transform(grads, params)
            with span("fit.adam"):
                for k, p in params.items():
                    p.grad = grads[k]
                optimizer.step()
            with span("fit.sync"):
                losses.append(float(loss))
                if step_graph is not None:
                    step_graph.check()
            if cfg.log_every and (step % cfg.log_every == 0
                                  or step == cfg.steps - 1):
                print(f"[fit] step {step:5d} loss {losses[-1]:.6e}")
            if (measure_prefix is not None and cfg.prefix_guard_every
                    and (step + 1) % cfg.prefix_guard_every == 0
                    and live_prefix < rcfg.max_bounces + 1):
                with span("fit.prefix_guard"):
                    depth_now = measure_prefix(params)
                if depth_now + 1 > live_prefix:
                    live_prefix = min(rcfg.max_bounces + 1, depth_now + 1)
                    print(f"[fit] live-prefix guard: bounce depth grew to "
                          f"{depth_now}; replay prefix now {live_prefix}")
            if (cfg.checkpoint_every and cfg.checkpoint_path
                    and (step + 1) % cfg.checkpoint_every == 0):
                with span("fit.checkpoint"):
                    ckpt.save_checkpoint(cfg.checkpoint_path, step + 1,
                                         params, optimizer)

    final = {k: v.detach() for k, v in params.items()}
    return FitResult(scene=set_params(template, final), params=final,
                     losses=np.asarray(losses), step=step + 1,
                     live_prefix=live_prefix)


def _lane_weights(cam: Camera, rcfg: RenderConfig, dev) -> torch.Tensor:
    """1 on the block-ordered lanes of image pixels, 0 on the pad margin."""
    return swizzle_image(torch.ones((cam.height, cam.width, 1),
                                    dtype=torch.float32, device=dev),
                         rcfg.block_size)[:, 0]
