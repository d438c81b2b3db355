"""PyTorch port: the soft replay step as one CUDA graph replay a chunk
(``ops/replay.GraphedSoftReplay``).

On the CPU (tier 1):

* ``fill`` writes exactly ``_chunk_records``' chunk ``i`` into the static
  inputs, the last chunk's pad lanes included, in any order of chunks;
* a replay fit on the CPU runs the eager step: no ``replay.graph*``
  counter, no ``replay.graph`` or ``replay.capture`` span.

On the card (``gpu``; ``mesh10k`` at 64x64, 4,096 lanes in chunks of
1,500, so the last of 3 chunks is padded):

* the graphed step equals the eager ``soft_replay_value_and_grad`` over
  three calls with the parameters changed between them: the loss within
  rtol 1e-6, each gradient within 1e-5 of its norm (``index_add_``'s
  atomics sum in another order on every run);
* a 3-step ``fit(use_replay=True)`` on the card matches the same fit on
  the CPU, at the tolerances of ``tests/test_torch_replay.py``'s
  ``test_value_and_grad_on_card_matches_cpu``;
* one capture per ``fit`` call, one replay per chunk after the eager
  warm-up chunk, and the graph path's spans;
* a changed ``live_segments`` captures again;
* the capture calls neither ``gc.collect`` nor ``torch.cuda.empty_cache``
  (``torch.cuda.graph``'s entry, which ``ops/graphs`` does without).

Nothing here imports JAX, so the ``gpu`` cases also run where only
PyTorch is installed (``pytest --noconftest -m gpu``).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from torch_goldens import CFG, FCFG, SOFT, fit_inputs
from torch_parity import cuda  # noqa: F401
from unity_raytracer_tpu_torch import fit as t_fit
from unity_raytracer_tpu_torch.fit import get_params, set_params
from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops import replay as rp
from unity_raytracer_tpu_torch.ops.render import render
from unity_raytracer_tpu_torch.utils import profiling as pf
from unity_raytracer_tpu_torch.utils.config import DiffConfig

torch.set_num_threads(1)

NAMES = ("sphere_centers", "sphere_diffuse", "light_intensities")
CHUNK = 1500            # 4,096 lanes: chunks of 1,500, 1,500 and 1,096 + pad
GRAPH_NAMES = ("replay.graph", "replay.capture")


@pytest.fixture(scope="module")
def small():
    """The replay tests' scene at 16x16 (256 lanes) on the CPU, its soft
    records, a target and weights with zeros."""
    scene, cam, packed, _, _ = fit_inputs()
    o, d = generate_rays_blocks(cam, CFG.block_size)
    cfg = CFG.with_(diff=SOFT)
    _, recs = rp.trace_records(scene, o, d, cfg, packed, soft=True)
    target = torch.rand((o.shape[0], 3), generator=torch.Generator()
                        .manual_seed(3)) * 255.0
    w = torch.ones(o.shape[0])
    w[::7] = 0.0
    return scene, packed, cfg, o, d, target, w, recs


@pytest.mark.parametrize("chunk", [100, 128])
def test_fill_equals_chunk_records(small, chunk):
    """Each chunk's static inputs equal ``_chunk_records``' chunk bit for
    bit (the dead-lane fills of the last chunk's pad too), whichever chunk
    was filled before."""
    scene, packed, cfg, o, d, target, w, recs = small
    params = get_params(scene, NAMES)
    g = rp.GraphedSoftReplay(scene, params, o, d, target, cfg, packed,
                             weights=w, chunk=chunk)
    oc, dc, tc, wc, rc, n_eff = rp._chunk_records(o, d, target, w, recs,
                                                  chunk)
    assert g.n_chunks == oc.shape[0] == -(-o.shape[0] // chunk)
    assert torch.equal(g.denom, n_eff * 3.0)
    order = list(range(g.n_chunks))
    for i in order[::-1] + order:
        g.fill(i, recs)
        for got, want in zip(g.lanes, (oc, dc, tc, wc)):
            assert torch.equal(got, want[i]), i
        assert len(g.recs) == len(rc) == 5
        for got, want in zip(g.recs, rc):
            assert torch.equal(got, want[i]), i
    last = o.shape[0] - (g.n_chunks - 1) * chunk
    if last < chunk:   # the pad lanes carry the dead-lane fills
        g.fill(g.n_chunks - 1, recs)
        for r, fill in zip(g.recs, (-1.0, 0.0, -1.0, 0.0, rp._BIG)):
            assert (r[:, last:] == fill).all()
        assert (g.lanes[3][last:] == 0.0).all()


def test_chunk_step_equals_eager_on_cpu(small):
    """What the graph holds, run eagerly chunk by chunk on the CPU: the
    loss and gradient sums over the ``fill``ed chunks, divided as the
    graphed step divides them, are the eager chunked step's, bit for bit
    (same operations in the same order)."""
    scene, packed, cfg, o, d, target, w, _ = small
    params = {k: v * 1.02 for k, v in get_params(scene, NAMES).items()}
    _, recs = rp.trace_records(set_params(scene, params), o, d, cfg, packed,
                               soft=True)
    g = rp.GraphedSoftReplay(scene, params, o, d, target, cfg, packed,
                             weights=w, chunk=100)
    with torch.no_grad():
        for k, v in params.items():
            g.leaves[k].copy_(v)
    for i in range(g.n_chunks):
        g.fill(i, recs)
        g._chunk_step(None)
    want_l, want_g = rp.soft_replay_value_and_grad(
        scene, params, o, d, target, cfg, packed, weights=w, chunk=100)
    assert torch.equal(g.loss / g.denom, want_l)
    for k in NAMES:
        assert torch.equal(g.grads[k] / g.denom, want_g[k]), k
    assert all(p.grad is None for p in g.leaves.values())


def test_cpu_replay_fit_runs_eager():
    """On the CPU the fit's replay branch is the eager step: no graph
    counter and no graph span; each chunk keeps its forward and backward."""
    scene, cam, bvh, target, init = fit_inputs()
    cfg = CFG.with_(ray_chunk=128)
    fcfg = t_fit.FitConfig(steps=2, **FCFG)
    with pf.recording() as rec:
        t_fit.fit(scene, cam, cfg, target, fcfg, init_params=init, bvh=bvh)
    names = Counter(s["name"] for s in rec.spans)
    assert names["replay.chunk"] == 4 and names["replay.forward"] == 4
    assert not [n for n in names if n in GRAPH_NAMES]
    assert not [c for c in rec.counts if c["name"].startswith("replay.graph")]


# -- on the card --------------------------------------------------------------

def _mesh10k(device):
    scene, cam, cfg = get_preset("mesh10k", width=64, height=64,
                                 device=device)
    cfg = cfg.with_(kernel="mega", mode="scan",
                    diff=DiffConfig(soft_shadow_temp=1.0, soft_hit_temp=0.1,
                                    straight_through=True))
    return scene, cam, cfg, t_bvh.prepare_bvh(scene, cfg)


@pytest.fixture(scope="module")
def card_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (marker gpu)")
    scene, cam, cfg, packed = _mesh10k("cuda")
    o, d = generate_rays_blocks(cam, cfg.block_size)
    target = rp.trace_radiance_replay_soft(scene, o, d, cfg, packed) * 0.9
    w = torch.ones(o.shape[0], device="cuda")
    w[::5] = 0.0
    return scene, cfg, packed, o, d, target.detach(), w


def _moved(params, j):
    return {k: v * (1.0 + 0.01 * (j + 1)) + 0.02 * j for k, v in
            params.items()}


def _close(got, want, rtol_loss=1e-6, rtol_grad=1e-5):
    (lg, gg), (le, ge) = got, want
    np.testing.assert_allclose(float(lg), float(le), rtol=rtol_loss)
    for k in ge:
        err = float(torch.linalg.vector_norm(gg[k] - ge[k]))
        assert err <= rtol_grad * float(torch.linalg.vector_norm(ge[k])), k


@pytest.mark.gpu
def test_graphed_step_equals_eager(cuda, card_case):
    """Three calls, the parameters moved between them: the graph's loss
    and gradients are the eager step's; the returned tensors are new."""
    scene, cfg, packed, o, d, target, w = card_case
    params = get_params(scene, NAMES)
    _, recs = rp.trace_records(scene, o, d, cfg, packed, soft=True)
    live = min(cfg.max_bounces + 1, rp.live_depth(recs) + 1)
    g = rp.GraphedSoftReplay(scene, params, o, d, target, cfg, packed,
                             weights=w, chunk=CHUNK)
    assert g.n_chunks == 3 and o.shape[0] % CHUNK
    kept = []
    for j in range(3):
        p = _moved(params, j)
        got = g(p, live_segments=live)
        want = rp.soft_replay_value_and_grad(
            scene, p, o, d, target, cfg, packed, weights=w,
            live_segments=live, chunk=CHUNK)
        _close(got, want)
        kept.append((got, {k: v.clone() for k, v in got[1].items()}))
    for got, copy in kept:   # later calls leave what was returned alone
        for k, v in copy.items():
            assert torch.equal(got[1][k], v), k
    assert not torch.equal(kept[0][1]["sphere_centers"],
                           kept[2][1]["sphere_centers"])


@pytest.mark.gpu
def test_live_segments_change_captures_again(cuda, card_case):
    scene, cfg, packed, o, d, target, w = card_case
    params = get_params(scene, NAMES)
    g = rp.GraphedSoftReplay(scene, params, o, d, target, cfg, packed,
                             weights=w, chunk=CHUNK)
    with pf.recording() as rec:
        for live in (2, 2, 3, 3):
            got = g(params, live_segments=live)
            want = rp.soft_replay_value_and_grad(
                scene, params, o, d, target, cfg, packed, weights=w,
                live_segments=live, chunk=CHUNK)
            _close(got, want)
    n = Counter()
    for c in rec.counts:
        n[c["name"]] += c["value"]
    assert n["replay.graph.captures"] == 2
    assert n["replay.graph.replays"] == 4 * 3 - 2


@pytest.mark.gpu
def test_capture_pays_no_graph_entry(cuda, card_case, monkeypatch):
    """A call that captures (one capture, a replay for every later chunk,
    the eager step's numbers) calls neither ``gc.collect`` nor
    ``torch.cuda.empty_cache``."""
    import gc
    calls = Counter()
    collect, empty = gc.collect, torch.cuda.empty_cache

    def counted_collect(*a):
        calls["gc.collect"] += 1
        return collect(*a)

    def counted_empty():
        calls["empty_cache"] += 1
        return empty()

    monkeypatch.setattr(gc, "collect", counted_collect)
    monkeypatch.setattr(torch.cuda, "empty_cache", counted_empty)
    scene, cfg, packed, o, d, target, w = card_case
    params = get_params(scene, NAMES)
    g = rp.GraphedSoftReplay(scene, params, o, d, target, cfg, packed,
                             weights=w, chunk=CHUNK)
    with pf.recording() as rec:
        got = g(params, live_segments=2)
    assert not calls, calls
    n = Counter()
    for c in rec.counts:
        n[c["name"]] += c["value"]
    assert n["replay.graph.captures"] == 1
    assert n["replay.graph.replays"] == g.n_chunks - 1
    _close(got, rp.soft_replay_value_and_grad(
        scene, params, o, d, target, cfg, packed, weights=w,
        live_segments=2, chunk=CHUNK))


def _fit(device, record=False):
    scene, cam, cfg, packed = _mesh10k("cpu")
    target = render(scene, cam, cfg, bvh=packed)
    if device != "cpu":
        scene, cam = scene.to(device), cam.to(device)
        packed = t_bvh.prepare_bvh(scene, cfg)
    true = get_params(scene, ("sphere_centers", "sphere_diffuse"))
    init = {"sphere_centers": true["sphere_centers"] + 0.3,
            "sphere_diffuse": (true["sphere_diffuse"] * 0.8)}
    fcfg = t_fit.FitConfig(steps=3, **FCFG)
    cfg = cfg.with_(ray_chunk=CHUNK)
    if not record:
        return t_fit.fit(scene, cam, cfg, target.to(device), fcfg,
                         init_params=init, bvh=packed), None
    with pf.recording() as rec:
        res = t_fit.fit(scene, cam, cfg, target.to(device), fcfg,
                        init_params=init, bvh=packed)
    return res, rec


@pytest.mark.gpu
def test_fit_on_card_matches_cpu(cuda):
    """A 3-step replay fit, graphed on the card and eager on the CPU."""
    card, _ = _fit("cuda")
    cpu, _ = _fit("cpu")
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)
    for k, v in cpu.params.items():
        want = v.numpy()
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(card.params[k].cpu().numpy(), want,
                                   rtol=5e-3, atol=5e-4 * scale, err_msg=k)


@pytest.mark.gpu
def test_fit_counts_one_capture(cuda):
    """One capture per ``fit`` call; every chunk after the eager warm-up
    chunk is one replay, under ``replay.chunk`` > ``replay.graph``; the
    capture under ``replay.chunk`` (0) > ``replay.capture``."""
    res, rec = _fit("cuda", record=True)
    n = Counter()
    for c in rec.counts:
        n[c["name"]] += c["value"]
    assert n["replay.graph.captures"] == 1
    assert n["replay.graph.replays"] == 3 * 3 - 1
    by_id = {s["id"]: s for s in rec.spans}
    kids = Counter()
    for s in rec.spans:
        if s["parent"] is not None and s["name"] in GRAPH_NAMES:
            parent = by_id[s["parent"]]
            assert parent["name"] == "replay.chunk"
            kids[(s["name"], parent["attrs"]["i"])] += 1
    assert kids == {("replay.capture", 0): 1, ("replay.graph", 0): 2,
                    ("replay.graph", 1): 3, ("replay.graph", 2): 3}
    assert not [s for s in rec.spans if s["name"] == "replay.forward"]
