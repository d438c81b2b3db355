"""PyTorch port: the composed chunked fit step as one CUDA graph replay
(``fit.GraphedComposedStep``) and the chain it runs.

On the CPU (tier 1):

* ``ops/render._trace_chain`` given a caller's stack-overflow counter runs
  every segment (no live test, no ``chain.sync``) and equals the chain
  that skips dead segments bit for bit: the radiance, the per-segment
  lane counts and the gradients, with and without ``remat``, on a scene
  where segment 1 is dead for every lane and on one where it is live;
* the graph's body (``GraphedComposedStep._step``, every segment run) run
  eagerly equals ``make_chunked_value_and_grad`` bit for bit, on spheres
  and on a mesh's shared vertices (the refit inside);
* a chunked composed fit on the CPU runs the eager step: no
  ``composed.graph*`` counter, no ``composed.graph`` or
  ``composed.capture`` span, the dead-segment test kept;
* the graph engages only on the walk kernels (``ops/bvh.kernel_walk``).

On the card (``gpu``; ``mesh10k`` at 64x64, 4,096 lanes in chunks of
1,500, so the last of 3 chunks is padded):

* the graphed step equals the eager ``make_chunked_value_and_grad`` over
  three calls with the parameters changed between them, on the spheres
  and on ``mesh_positions`` (the refit inside the graph): the loss within
  rtol 1e-6, each gradient within 1e-5 of its norm (``index_add_``'s
  atomics sum in another order on every run); the eager step keeps its
  live tests, the replay makes none;
* a 3-step ``fit.fit`` on the card matches the same fit on the CPU at
  ``tests/test_torch_fit.py``'s tolerances (losses rtol 1e-4, parameters
  rtol 1e-3, atol 1e-5);
* one capture per ``fit.fit`` call and one replay per later step, with
  the graph's spans;
* on a replayed step the refit's device activities are launched inside a
  ``bvh.refit`` span, as many as an eager refit makes;
* a stack overflow on the graphed route still raises, on every step;
* a fit on the plain per-lane walk captures nothing.

Nothing here imports JAX, so the ``gpu`` cases also run where only
PyTorch is installed (``pytest --noconftest -m gpu``).
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from torch_goldens import CFG, SOFT, TOY_FCFG, fit_inputs, fit_toy_inputs
from torch_parity import cuda  # noqa: F401
from unity_raytracer_tpu_torch import fit as t_fit
from unity_raytracer_tpu_torch.fit import get_params, set_params
from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import render as rd
from unity_raytracer_tpu_torch.utils import profiling as pf
from unity_raytracer_tpu_torch.utils.config import DiffConfig

torch.set_num_threads(1)

NAMES = ("sphere_centers", "sphere_diffuse")
MESH = ("mesh_positions",)
CHUNK = 1500            # 4,096 lanes: chunks of 1,500, 1,500 and 1,096 + pad
GRAPH_NAMES = ("composed.graph", "composed.capture")


# -- the chain with a caller's counter (CPU) ----------------------------------

@pytest.fixture(scope="module")
def chain_case():
    """The replay tests' scene at 16x16 on the CPU (a mirror sphere, so
    segment 1 is live), the same scene without mirrors (segment 1 dead for
    every lane), their BVH and the block-ordered rays."""
    scene, cam, packed, _, _ = fit_inputs()
    o, d = generate_rays_blocks(cam, CFG.block_size)
    sp = scene.spheres
    flat = dataclasses.replace(sp, materials=dataclasses.replace(
        sp.materials, is_mirror=torch.zeros_like(sp.materials.is_mirror)))
    return {"live": scene, "dead": dataclasses.replace(scene, spheres=flat),
            "bvh": packed, "o": o, "d": d}


def _chain(scene, case, cfg, with_stats, counter):
    """Radiance (and stats), the gradients of a weighted radiance sum to
    the sphere parameters, and the chain's spans."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in get_params(scene, NAMES).items()}
    overflow = torch.zeros(1, dtype=torch.int32) if counter else None
    with pf.recording() as rec:
        out = rd._trace_chain(set_params(scene, leaves), case["o"],
                              case["d"], cfg, bvh=case["bvh"],
                              with_stats=with_stats, overflow=overflow)
    rad, stats = out if with_stats else (out, None)
    w = torch.linspace(0.5, 1.5, rad.numel()).view_as(rad)
    grads = torch.autograd.grad((rad * w).sum(), list(leaves.values()))
    names = Counter(s["name"] for s in rec.spans)
    return rad.detach(), stats, grads, names


@pytest.mark.parametrize("which", ["dead", "live"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
def test_counter_chain_equals_skipping_chain(chain_case, which, remat,
                                             with_stats):
    """With a caller's counter every segment runs and nothing is tested
    on the host, and the radiance, lane counts and gradients are the
    skipping chain's, bit for bit."""
    cfg = CFG.with_(diff=SOFT, remat=remat)
    scene = chain_case[which]
    want, w_stats, w_grads, w_names = _chain(scene, chain_case, cfg,
                                             with_stats, False)
    got, g_stats, g_grads, g_names = _chain(scene, chain_case, cfg,
                                            with_stats, True)
    segments = cfg.max_bounces + 1
    assert g_names["chain.segment"] == segments
    assert g_names["chain.sync"] == 0
    assert w_names["chain.sync"] == segments       # one live test each
    # segment 1 is dead for every lane in one scene, live in the other
    assert (w_names["chain.segment"] == 1) == (which == "dead")
    assert torch.equal(got, want)
    for g, w in zip(g_grads, w_grads):
        assert torch.equal(g, w)
    if with_stats:
        assert (int(w_stats[0][1]) == 0) == (which == "dead")
        for g, w in zip(g_stats, w_stats):
            assert torch.equal(g, w)


def _body_case(mesh: bool):
    """The replay scene at 16x16 on the CPU, its spheres or its mesh's
    shared vertices (the refit inside the step) moved off the true ones:
    template, parameters, rays, target, weights, BVH."""
    scene, cam, bvh, _, params = fit_inputs()
    cfg = CFG.with_(diff=SOFT, remat=True)
    if mesh:
        bvh = t_bvh.with_refit_tables(bvh, scene)
        gen = torch.Generator().manual_seed(5)
        pos = scene.meshes.positions
        params = {"mesh_positions": pos + 0.02 * torch.rand(
            pos.shape, generator=gen) - 0.01}
    o, d = generate_rays_blocks(cam, cfg.block_size)
    target = rd.trace_radiance(scene, o, d, cfg.with_(diff=DiffConfig()),
                               bvh=bvh) * 0.9
    w = torch.ones(o.shape[0])
    w[::7] = 0.0
    return scene, cfg, params, o, d, target, w, bvh


@pytest.mark.parametrize("mesh", [False, True], ids=["spheres", "mesh"])
def test_graph_body_equals_eager_on_cpu(mesh):
    """What the graph holds, run eagerly on the CPU (every segment run,
    the counter passed, the sums zeroed first, the refit in a stage): its
    loss and gradient sums, divided as the graphed step divides them, are
    the eager chunked step's, bit for bit."""
    scene, cfg, params, o, d, target, w, bvh = _body_case(mesh)
    g = t_fit.GraphedComposedStep(scene, params, cfg.with_(ray_chunk=100),
                                  o, d, target, bvh=bvh, weights=w,
                                  refit_bvh=mesh)
    assert g.ch.o.shape[0] == -(-o.shape[0] // 100)
    with torch.no_grad():
        for k, v in params.items():
            g.leaves[k].copy_(v)
    for _ in range(2):           # the second run starts from zeroed sums
        g._step(pf.span)
    want_l, want_g = t_fit.make_chunked_value_and_grad(
        scene, cfg, o, d, target, bvh=bvh, chunk=100, weights=w,
        refit_bvh=mesh)(params)
    assert torch.equal(g.loss / g.ch.denom, want_l)
    for k in params:
        assert torch.equal(g.grads[k] / g.ch.denom, want_g[k]), k
        assert float(torch.linalg.vector_norm(want_g[k])) > 0, k
    assert all(p.grad is None for p in g.leaves.values())
    assert int(g.overflow) == 0


def test_cpu_composed_fit_runs_eager():
    """On the CPU the fit's chunked composed branch is the eager step: no
    graph counter and no graph span; each chunk keeps its forward and
    backward and each segment its live test."""
    scene, cam, cfg, target, init = fit_toy_inputs()
    init = {k: torch.from_numpy(v) for k, v in init.items()}
    fcfg = t_fit.FitConfig(steps=2, **TOY_FCFG)
    with pf.recording() as rec:
        res = t_fit.fit(scene, cam, cfg.with_(ray_chunk=96, remat=True),
                        target, fcfg, init_params=init)
    names = Counter(s["name"] for s in rec.spans)
    lanes = generate_rays_blocks(cam, cfg.block_size)[0].shape[0]
    n_chunks = -(-lanes // 96)
    assert names["composed.chunk"] == 2 * n_chunks
    assert names["composed.backward"] == 2 * n_chunks
    assert names["chain.sync"] >= 2 * n_chunks
    assert not [n for n in names if n in GRAPH_NAMES]
    assert not [c for c in rec.counts
                if c["name"].startswith("composed.graph")]
    assert len(res.losses) == 2


def test_graph_engages_on_the_walk_kernels_only(chain_case):
    """The graph needs the walks' kernels on a ``PackedBVH``: the plain
    per-lane walk (a bare tree, or ``kernel='xla'``) and a scene without
    a BVH stay eager."""
    packed = chain_case["bvh"]
    for kernel in ("auto", "pallas", "pallas3", "wide", "mega"):
        assert t_bvh.kernel_walk(packed, kernel), kernel
    assert not t_bvh.kernel_walk(packed, "xla")
    assert not t_bvh.kernel_walk(packed.bvh, "pallas")
    assert not t_bvh.kernel_walk(None, "pallas")


# -- on the card --------------------------------------------------------------

def _mesh10k(device, depth=None):
    scene, cam, cfg = get_preset("mesh10k", width=64, height=64,
                                 device=device)
    cfg = cfg.with_(kernel="pallas", mode="scan", remat=True,
                    diff=DiffConfig(soft_shadow_temp=1.0, soft_hit_temp=0.1,
                                    straight_through=True))
    if depth is not None:
        cfg = cfg.with_(max_bounces=depth)
    return scene, cam, cfg, t_bvh.prepare_bvh(scene, cfg)


@pytest.fixture(scope="module")
def card_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (marker gpu)")
    scene, cam, cfg, packed = _mesh10k("cuda")
    packed = t_bvh.with_refit_tables(packed, scene)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    target = rd.trace_radiance(scene, o, d, cfg.with_(diff=DiffConfig()),
                               bvh=packed) * 0.9
    w = torch.ones(o.shape[0], device="cuda")
    w[::5] = 0.0
    return scene, cfg, packed, o, d, target.detach(), w


def _moved(params, j):
    gen = torch.Generator().manual_seed(j)
    return {k: v + 0.01 * j * torch.rand(v.shape, generator=gen).to(v)
            for k, v in params.items()}


def _close(got, want, rtol_loss=1e-6, rtol_grad=1e-5):
    (lg, gg), (le, ge) = got, want
    np.testing.assert_allclose(float(lg), float(le), rtol=rtol_loss)
    for k in ge:
        err = float(torch.linalg.vector_norm(gg[k] - ge[k]))
        assert err <= rtol_grad * float(torch.linalg.vector_norm(ge[k])), k


@pytest.mark.gpu
@pytest.mark.parametrize("names", [NAMES, MESH], ids=["spheres", "mesh"])
def test_graphed_step_equals_eager(cuda, card_case, names):
    """Three calls, the parameters moved between them: the graph's loss
    and gradients are the eager step's; the returned tensors are new;
    the eager step tests each segment on the host, the replay nothing."""
    scene, cfg, packed, o, d, target, w = card_case
    cfg = cfg.with_(ray_chunk=CHUNK)
    mesh = names == MESH
    params = get_params(scene, names)
    g = t_fit.GraphedComposedStep(scene, params, cfg, o, d, target,
                                  bvh=packed, weights=w, refit_bvh=mesh)
    eager = t_fit.make_chunked_value_and_grad(
        scene, cfg, o, d, target, bvh=packed, weights=w, refit_bvh=mesh)
    assert g.ch.o.shape[0] == 3 and o.shape[0] % CHUNK
    kept = []
    for j in range(3):
        p = _moved(params, j)
        with pf.recording() as rec_g:
            got = g(p)
            g.check()
        with pf.recording() as rec_e:
            want = eager(p)
        _close(got, want)
        kept.append((got, {k: v.clone() for k, v in got[1].items()}))
        e_names = Counter(s["name"] for s in rec_e.spans)
        assert e_names["chain.sync"] >= 3 * 2     # live tests, overflow reads
        if j:
            g_names = Counter(s["name"] for s in rec_g.spans)
            assert g_names["composed.graph"] == 1
            assert g_names["chain.sync"] == 0
            assert g_names["bvh.refit"] == int(mesh)
    for got, copy in kept:   # later calls leave what was returned alone
        for k, v in copy.items():
            assert torch.equal(got[1][k], v), k
    assert not torch.equal(kept[0][1][names[0]], kept[2][1][names[0]])


def _fit(device, names=NAMES, record=False, steps=3):
    scene, cam, cfg, packed = _mesh10k("cpu", depth=1)
    target = rd.render(scene, cam, cfg.with_(diff=DiffConfig()), bvh=packed)
    if device != "cpu":
        scene, cam = scene.to(device), cam.to(device)
        packed = t_bvh.prepare_bvh(scene, cfg)
    true = get_params(scene, names)
    init = {k: v + 0.02 for k, v in true.items()} if names == MESH else {
        "sphere_centers": true["sphere_centers"] + 0.3,
        "sphere_diffuse": true["sphere_diffuse"] * 0.8}
    fcfg = t_fit.FitConfig(steps=steps, **dict(TOY_FCFG, param_names=names))
    cfg = cfg.with_(ray_chunk=CHUNK)
    run = lambda: t_fit.fit(scene, cam, cfg, target.to(device), fcfg,
                            init_params=init, bvh=packed)
    if not record:
        return run(), None
    with pf.recording() as rec:
        res = run()
    return res, rec


@pytest.mark.gpu
def test_plain_walk_fit_runs_eager(cuda):
    """A chunked fit on the card whose walk is the plain per-lane one
    (``kernel='xla'``: a bare tree) captures nothing."""
    scene, cam, cfg = get_preset("mesh10k", width=16, height=16,
                                 device="cuda")
    cfg = cfg.with_(kernel="xla", mode="scan", max_bounces=1, remat=True,
                    ray_chunk=100)
    bvh = t_bvh.prepare_bvh(scene, cfg)
    target = rd.render(scene, cam, cfg, bvh=bvh)
    true = get_params(scene, NAMES)
    fcfg = t_fit.FitConfig(steps=2, **TOY_FCFG)
    with pf.recording() as rec:
        res = t_fit.fit(scene, cam, cfg, target, fcfg, bvh=bvh,
                        init_params={k: v * 1.01 for k, v in true.items()})
    assert not [c for c in rec.counts
                if c["name"].startswith("composed.graph")]
    assert Counter(s["name"] for s in rec.spans)["chain.sync"] > 0
    assert np.isfinite(res.losses).all()


@pytest.mark.gpu
def test_fit_on_card_matches_cpu(cuda):
    """A 3-step chunked composed fit, graphed on the card and eager on the
    CPU."""
    card, _ = _fit("cuda")
    cpu, _ = _fit("cpu")
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)
    for k, v in cpu.params.items():
        np.testing.assert_allclose(card.params[k].cpu().numpy(), v.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("names", [NAMES, MESH], ids=["spheres", "mesh"])
def test_fit_counts_one_capture(cuda, names):
    """One capture per ``fit`` call and one replay per later step, under
    ``fit.value_and_grad``; the chunks' spans only inside the capture
    (the eager warm-up step and the recording)."""
    res, rec = _fit("cuda", names, record=True)
    n = Counter()
    for c in rec.counts:
        n[c["name"]] += c["value"]
    assert n["composed.graph.captures"] == 1
    assert n["composed.graph.replays"] == 3 - 1
    by_id = {s["id"]: s for s in rec.spans}

    def ancestors(s):
        while s["parent"] is not None:
            s = by_id[s["parent"]]
            yield s["name"]

    kids = Counter(s["name"] for s in rec.spans if s["name"] in GRAPH_NAMES
                   and by_id[s["parent"]]["name"] == "fit.value_and_grad")
    assert kids == {"composed.capture": 1, "composed.graph": 2}
    chunks = [s for s in rec.spans if s["name"] == "composed.chunk"]
    assert len(chunks) == 2 * 3           # warm-up and capture, 3 chunks
    assert all("composed.capture" in ancestors(s) for s in chunks)
    refits = [s for s in rec.spans if s["name"] == "bvh.refit"]
    if names == MESH:   # the replays' stage spans, under composed.graph
        assert sum(next(ancestors(s)) == "composed.graph"
                   for s in refits) == 2
    else:
        assert not refits
    assert np.isfinite(res.losses).all() and len(res.losses) == 3


def _refit_launches(work, steps=1):
    """Device activities a step launched inside ``bvh.refit*`` spans, and
    in all, over ``steps`` calls of ``work`` traced on the card."""
    from raybench import spans as rs
    stretch = rs.Stretch(True, torch.cuda.synchronize)
    stretch.start()
    for _ in range(steps):
        work()
    stretch.stop(steps)
    red = rs.reduce(stretch.events, stretch.base_ns, stretch.window_s,
                    stretch.recording.spans, steps)
    per = red["per_span"].values()
    inside = sum(s["launches"] for s in per
                 if s["name"].startswith("bvh.refit"))
    return inside / steps, sum(s["launches"] for s in per) / steps


@pytest.mark.gpu
def test_refit_replays_inside_its_span(cuda, card_case):
    """On a replayed step the refit's device activities are launched
    inside a ``bvh.refit`` span (its stage), as many as an eager refit of
    the same tree makes inside its spans."""
    scene, cfg, packed, o, d, target, w = card_case
    params = get_params(scene, MESH)
    g = t_fit.GraphedComposedStep(scene, params, cfg.with_(ray_chunk=CHUNK),
                                  o, d, target, bvh=packed, weights=w,
                                  refit_bvh=True)
    g(params)
    g(params)
    moved = set_params(scene, params)
    eager, _ = _refit_launches(lambda: t_bvh.refit(packed, moved), 2)
    replayed, every = _refit_launches(lambda: g(params), 2)
    assert 0 < eager <= 40
    assert replayed == eager
    assert every > replayed


@pytest.mark.gpu
def test_overflow_raises_on_the_graphed_route(cuda, card_case, monkeypatch):
    """A planted dropped push in each chunk's chain (added to the caller's
    counter, inside the graph) raises from ``check`` on every step, the
    capture step's included, and from ``fit.fit``."""
    trace = t_fit.trace_radiance

    def planted(*a, overflow=None, **kw):
        rad = trace(*a, overflow=overflow, **kw)
        if overflow is not None:   # as a kernel adds: no autograd version
            overflow.data.add_(1)
        return rad

    monkeypatch.setattr(t_fit, "trace_radiance", planted)
    scene, cfg, packed, o, d, target, w = card_case
    params = get_params(scene, NAMES)
    g = t_fit.GraphedComposedStep(scene, params, cfg.with_(ray_chunk=CHUNK),
                                  o, d, target, bvh=packed, weights=w)
    for _ in range(3):
        g(params)
        with pytest.raises(RuntimeError, match="dropped 3 stack pushes"):
            g.check()
    with pytest.raises(RuntimeError, match="stack pushes"):
        _fit("cuda", steps=2)
