"""PyTorch port: the multi-device layer (``parallel/``) on gloo ranks.

One module-scoped fixture starts a gloo group of 4 ranks (meshes (4,1)
and (2,2)) and one of 2 ranks (meshes (2,1) and (1,2)) with
``parallel/bootstrap.launch``; each rank runs every case of
``torch_parallel_cases.CASES`` and saves its outputs. The tests then hold
those outputs (which every rank must return alike) to the port's
single-process result and to the twin's ``shard_map`` functions on meshes
of the same shapes (``tests/goldens/torch/parallel.npz``, written by
``python tests/torch_goldens.py parallel``, refused when a file it was
computed from has changed since), at tests/test_parallel.py's
tolerances: images 1e-6 against the single-process frame, hits exactly
(t at rtol 1e-6), the train step's loss at rtol 1e-5 and parameters at
rtol 1e-4, atol 1e-5, the fit's trajectory at rtol 1e-4. Against JAX the
images hold the port's render tolerance (5e-4: XLA on the CPU fuses
multiply-adds, ROADMAP Queue C #7). ``build_shard_bvhs`` is held to the
twin's arrays exactly, live, and ``dryrun --device cpu --devices 4``
must exit 0. The ``gpu`` cases run a one-rank NCCL group on the card.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_goldens import load, parallel_source_hashes
from torch_parallel_cases import (CASES, FIT_LR, FIT_STEPS, SWAP_ROWS,
                                  TRAIN_LR, inputs, run_rank, shape_key,
                                  start_params)
from torch_parity import cuda  # noqa: F401  (fixture)
from unity_raytracer_tpu_torch.fit import set_params
from unity_raytracer_tpu_torch.models.camera import generate_rays
from unity_raytracer_tpu_torch.ops import intersect as isect
from unity_raytracer_tpu_torch.ops.render import render, trace_radiance
from unity_raytracer_tpu_torch.parallel import bootstrap
from unity_raytracer_tpu_torch.parallel import shard as shardmod

torch.set_num_threads(1)

IMG_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_IMG_TOL = dict(rtol=5e-4, atol=5e-4)
HITS = ("ssh", "ssh_bvh")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    for world in CASES:
        bootstrap.launch(run_rank, world, "cpu", args=(world, str(out)),
                         timeout_s=300)
    return out


@pytest.fixture(scope="module")
def golden():
    """The twin's frozen outputs, refused when a file they were computed
    from changed since (rerun ``python tests/torch_goldens.py
    parallel``)."""
    z = load("parallel")
    stale = [k for k, h in parallel_source_hashes().items()
             if k not in z or str(z[k]) != h]
    if stale:
        pytest.fail(f"tests/goldens/torch/parallel.npz is stale: {stale} "
                    f"changed; rerun python tests/torch_goldens.py parallel")
    return z


def got(ranks, world, shape, case) -> dict:
    """Rank 0's outputs of a case, after checking that every rank
    returned the same (the SPMD functions return global results)."""
    outs = []
    for r in range(world):
        with np.load(ranks / str(world) / shape_key(shape)
                     / f"{case}.rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    for r, o in enumerate(outs[1:], 1):
        for k, v in o.items():
            np.testing.assert_array_equal(v, outs[0][k],
                                          err_msg=f"rank {r} {case}/{k}")
    return outs[0]


def twin(golden, world, shape, case) -> dict:
    pre = f"{world}/{shape_key(shape)}/{case}/"
    return {k[len(pre):]: v for k, v in golden.items() if k.startswith(pre)}


def single_render(case):
    scene, cam, cfg, bvh = inputs("torch", case)
    return render(scene, cam, cfg, bvh=bvh).numpy()


@pytest.mark.parametrize("world,shape,case", [
    (4, (4, 1), "tiled"), (2, (2, 1), "tiled"), (4, (4, 1), "auto"),
    (4, (4, 1), "tiled_tiny")],
    ids=["4x1", "2x1", "auto-4x1", "padding-ranks-4x1"])
def test_render_tiled_matches_single(ranks, golden, world, shape, case):
    """Rays over dp (a 2-ray frame over 4 ranks: two ranks trace only
    filler rays and still reach every collective)."""
    img = got(ranks, world, shape, case)["img"]
    np.testing.assert_allclose(img, single_render(case), **IMG_TOL)
    np.testing.assert_allclose(img, twin(golden, world, shape, case)["img"],
                               **JAX_IMG_TOL)


def test_render_tiled_2d_mesh(ranks, golden):
    img = got(ranks, 4, (2, 2), "tiled")["img"]
    np.testing.assert_allclose(img, single_render("tiled"), **IMG_TOL)
    np.testing.assert_allclose(img, twin(golden, 4, (2, 2), "tiled")["img"],
                               **JAX_IMG_TOL)


@pytest.mark.parametrize("case", ["tiled_bvh", "tiled_pallas",
                                  "tiled_mega"])
def test_render_tiled_routes_match(ranks, golden, case):
    """The BVH routes under the tile-sharded renderer: the plain walk,
    the ordered binary walk ('pallas') and the fused segment ('mega'),
    each against its single-process frame and the twin's sharded frame
    (the Pallas interpreter's, for 'pallas' and 'mega')."""
    img = got(ranks, 4, (4, 1), case)["img"]
    np.testing.assert_allclose(img, single_render(case), **IMG_TOL)
    np.testing.assert_allclose(img, twin(golden, 4, (4, 1), case)["img"],
                               **JAX_IMG_TOL)
    assert img.std() > 0.01


def _check_hit(h, ref, normal_tol):
    """kind, index and mesh_index exactly, t at rtol 1e-6 on hits, the
    carried normal on mesh hits."""
    np.testing.assert_array_equal(h["kind"], ref["kind"])
    hit = ref["kind"] != isect.KIND_NONE
    assert hit.any()
    np.testing.assert_allclose(h["t"][hit], ref["t"][hit], rtol=1e-6)
    np.testing.assert_array_equal(h["index"][hit], ref["index"][hit])
    np.testing.assert_array_equal(h["mesh_index"], ref["mesh_index"])
    mesh_hit = ref["kind"] == isect.KIND_MESH
    assert mesh_hit.any()
    np.testing.assert_allclose(h["mesh_n"][mesh_hit],
                               ref["mesh_n"][mesh_hit], **normal_tol)


def single_hit(case):
    """The single-process nearest hit, its normal the stored one."""
    scene, cam, _, _ = inputs("torch", case)
    o, d = generate_rays(cam)
    ref = isect.nearest_hit(scene, o, d)
    out = {k: getattr(ref, k).numpy() for k in ("t", "kind", "index",
                                                "mesh_index")}
    out["mesh_n"] = scene.meshes.normals.numpy()[
        np.clip(out["index"], 0, scene.meshes.count - 1)]
    return out


@pytest.mark.parametrize("case", HITS)
@pytest.mark.parametrize("world,shape", [(4, (2, 2)), (2, (1, 2))],
                         ids=["2x2", "1x2"])
def test_scene_sharded_hit_matches(ranks, golden, world, shape, case):
    """Brute force over triangle shards (the nearest-triangle kernel's
    plain version) and per-shard BVH walks (the threaded walk's), against
    the single-process brute-force hit and the twin's sharded hit."""
    h = got(ranks, world, shape, case)
    normal_tol = (dict(rtol=1e-5, atol=1e-6) if case == "ssh"
                  else dict(rtol=1e-4, atol=1e-5))
    _check_hit(h, single_hit(case), normal_tol)
    _check_hit(h, twin(golden, world, shape, case), normal_tol)


def test_scene_sharded_hit_padding_rank(ranks, golden):
    """A tp rank whose triangles are all padding contributes the key
    INT32_MAX and loses every lane."""
    h = got(ranks, 2, (1, 2), "ssh_padded")
    tol = dict(rtol=1e-5, atol=1e-6)
    _check_hit(h, single_hit("ssh_padded"), tol)
    _check_hit(h, twin(golden, 2, (1, 2), "ssh_padded"), tol)
    assert h["index"][h["kind"] == isect.KIND_MESH].max() < \
        inputs("torch", "ssh_padded")[0].meshes.count // 2


def test_scene_sharded_normal_carry(ranks):
    """The winner's shard carries its stored shading normal across the
    combine: shading needs no global [M] normal table."""
    h = got(ranks, 4, (2, 2), "ssh")
    ref = single_hit("ssh")
    mesh_hit = ref["kind"] == isect.KIND_MESH
    assert mesh_hit.any()
    np.testing.assert_allclose(h["mesh_n"][mesh_hit],
                               ref["mesh_n"][mesh_hit], rtol=1e-5, atol=1e-6)


def test_scene_sharded_non_replication(ranks):
    """The TP regime's point: the [M]-row mesh arrays exist only as
    shards. The replicated part carries 1-row dummies and a rank's
    placed scene holds M/tp rows."""
    scene, _, _, _ = inputs("torch", "placed")
    m = scene.meshes.count
    rows = got(ranks, 4, (2, 2), "placed")["rows"]
    np.testing.assert_array_equal(rows, [m // 2, m // 2, 1, 1])


def test_scene_sharded_hit_bvh_two_meshes(ranks, golden):
    """A shard holding triangles of two meshes: the BVH route's mesh id is
    the single-process one. The twin reads its leaf-order
    ``prim_mesh_id`` at the walk's shard-local row and gives another id
    on some lanes (ROADMAP Queue C #13)."""
    h = got(ranks, 4, (2, 2), "ssh_bvh_meshes")
    ref = single_hit("ssh_bvh_meshes")
    _check_hit(h, ref, dict(rtol=1e-4, atol=1e-5))
    assert len(set(ref["mesh_index"][ref["mesh_index"] >= 0])) == 2
    jx = twin(golden, 4, (2, 2), "ssh_bvh_meshes")
    np.testing.assert_array_equal(jx["kind"], ref["kind"])
    assert (jx["mesh_index"] != ref["mesh_index"]).any()


def test_ring_hit_matches(ranks, golden):
    """Ring of triangle shards over dp = 4: (t, global index) against the
    single-process brute-force fold and the twin's ring."""
    scene, cam, _, _ = inputs("torch", "ring")
    o, d = generate_rays(cam)
    t_ref, i_ref = isect.ray_triangles(o, d, scene.meshes.verts,
                                       scene.meshes.valid).min(dim=1)
    t_ref, i_ref = t_ref.numpy(), i_ref.numpy()
    r = got(ranks, 4, (4, 1), "ring")
    hit = np.isfinite(t_ref)
    assert hit.any()
    np.testing.assert_allclose(r["t"][hit], t_ref[hit], rtol=1e-6)
    np.testing.assert_array_equal(r["i"][hit], i_ref[hit])
    assert (r["i"][~hit] == -1).all()
    jx = twin(golden, 4, (4, 1), "ring")
    np.testing.assert_allclose(r["t"][hit], jx["t"][hit], rtol=1e-6)
    np.testing.assert_array_equal(r["i"], jx["i"])


@pytest.mark.parametrize("world,shape", [(4, (4, 1)), (2, (2, 1))],
                         ids=["4x1", "2x1"])
def test_nearest_hit_ring_full_semantics(ranks, golden, world, shape):
    """The ring as a drop-in nearest_hit: kind, index, mesh_index, t and
    the carried normal."""
    h = got(ranks, world, shape, "ring_hit")
    tol = dict(rtol=1e-5, atol=1e-6)
    _check_hit(h, single_hit("ring_hit"), tol)
    _check_hit(h, twin(golden, world, shape, "ring_hit"), tol)


def test_swap_shard_axes_involution(ranks, golden):
    """Ulysses reshard: the declared block-interleave order (the twin's
    too), and an exact involution."""
    s = got(ranks, 4, (2, 2), "swap")
    x = np.arange(SWAP_ROWS * 3, dtype=np.float32).reshape(-1, 3)
    want = x.reshape(2, 2, -1, 3).swapaxes(0, 1).reshape(-1, 3)
    np.testing.assert_array_equal(s["y"], want)
    np.testing.assert_array_equal(s["y"], twin(golden, 4, (2, 2),
                                               "swap")["y"])
    np.testing.assert_array_equal(s["back"], x)


def test_min_hit_combine_tie_break(ranks):
    """Equal t on every rank: the smallest packed key (category order)
    wins."""
    c = got(ranks, 4, (4, 1), "combine")
    assert (c["key"] == 1).all() and (c["t"] == 1.0).all()


def test_make_mesh_refuses_wrong_shape(ranks):
    """A mesh whose dp x tp is not the world size raises the twin's
    ValueError."""
    e = got(ranks, 4, (4, 1), "mesh_error")
    assert e["raised"] == 1 and e["msg_ok"] == 1


def _single_steps(case, n_steps):
    """The single-process loop the sharded step must equal: the mean of
    the squared error of ``trace_radiance`` / 255 over every ray, Adam."""
    scene, cam, cfg, bvh = inputs("torch", case)
    o, d = generate_rays(cam)
    tgt = render(scene, cam, cfg, bvh=bvh).reshape(-1, 3)
    start = start_params("torch", case, scene)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    opt = torch.optim.Adam(list(leaves.values()),
                           lr=TRAIN_LR if case == "train" else FIT_LR)
    losses = []
    for _ in range(n_steps):
        rad = trace_radiance(set_params(scene, leaves), o, d, cfg,
                             bvh=bvh) / 255.0
        loss = ((rad - tgt) ** 2).sum() / tgt.numel()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return np.asarray(losses), {k: v.detach().numpy()
                                for k, v in leaves.items()}


@pytest.mark.parametrize("world,shape", [(4, (4, 1)), (2, (2, 1))],
                         ids=["4x1", "2x1"])
def test_sharded_train_step_matches_single_device(ranks, golden, world,
                                                  shape):
    """Loss and gradient all-reduce: one sharded Adam step equals one
    single-process step and the twin's sharded step."""
    s = got(ranks, world, shape, "train")
    losses, params = _single_steps("train", 1)
    jx = twin(golden, world, shape, "train")
    for ref_loss, ref_p in ((losses, params),
                            (jx["losses"], {k[2:]: v for k, v in jx.items()
                                            if k.startswith("p/")})):
        np.testing.assert_allclose(s["losses"], ref_loss, rtol=1e-5)
        np.testing.assert_allclose(s["p/sphere_centers"],
                                   ref_p["sphere_centers"], rtol=1e-4,
                                   atol=1e-5)


def test_sharded_fit_trajectory_matches_single(ranks, golden):
    """Config 5 in miniature: a tile-sharded fit through the BVH walk
    ('pallas'), 3 steps over dp = 4; the loss trajectory matches the
    single-process loop and the twin's, and it descends."""
    s = got(ranks, 4, (4, 1), "fit")
    losses, params = _single_steps("fit", FIT_STEPS)
    jx = twin(golden, 4, (4, 1), "fit")
    np.testing.assert_allclose(s["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(s["losses"], jx["losses"], rtol=1e-4)
    assert s["losses"][-1] < s["losses"][0]
    for k, v in params.items():
        np.testing.assert_allclose(s[f"p/{k}"], v, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(s[f"p/{k}"], jx[f"p/{k}"], rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_build_shard_bvhs_equal_twin(tp):
    """The per-shard BVHs are the twin's arrays exactly (the native
    build on both sides), and each shard's packed rows hold its tree."""
    from unity_raytracer_tpu.models import presets as j_presets
    from unity_raytracer_tpu.parallel import shard as j_shard

    j_scene, _, _ = j_presets.mesh_scene(100, width=8, height=8)
    want = j_shard.build_shard_bvhs(j_scene, tp=tp)
    scene, _, _, _ = inputs("torch", "ssh")
    sb = shardmod.build_shard_bvhs(scene, tp=tp)
    assert sb["leaf_size"] == want["leaf_size"]
    for k, v in want.items():
        if k != "leaf_size":
            np.testing.assert_array_equal(sb[k].numpy(), np.asarray(v),
                                          err_msg=k)
    assert len(sb["packed"]) == tp
    for s, packed in enumerate(sb["packed"]):
        assert packed.nodes.shape[0] == packed.bvh.n_nodes
        assert int((packed.leaf_prim >= 0).sum()) == int(sb["count"][s].sum())


def test_maybe_initialize_without_environment(monkeypatch):
    """No rendezvous configured: a no-op that returns False; ``world``
    reports one process with the twin's keys."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert bootstrap.maybe_initialize() is False
    assert bootstrap.world() == {"process_index": 0, "process_count": 1,
                                 "local_devices": 1, "global_devices": 1}


def test_dryrun_cli_on_cpu_ranks():
    """``python -m unity_raytracer_tpu_torch dryrun --device cpu
    --devices 4``: the twin's dry run on 4 gloo ranks, mesh (2, 2)."""
    proc = subprocess.run(
        [sys.executable, "-m", "unity_raytracer_tpu_torch", "dryrun",
         "--device", "cpu", "--devices", "4"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip ok: mesh=(2,2)" in proc.stdout


@pytest.fixture
def nccl_one_rank(cuda, tmp_path):  # noqa: F811
    """A one-rank NCCL group in this process, through a file store."""
    bootstrap.maybe_initialize(f"file://{tmp_path}/store", 1, 0,
                               device="cuda", timeout_s=120)
    yield cuda
    torch.distributed.destroy_process_group()


@pytest.mark.gpu
def test_sharded_paths_on_card_match_single(nccl_one_rank):
    """World size 1 on the card: the tiled render on the fused kernel,
    the scene-sharded hits (nearest-triangle kernel, threaded walk) and
    the ring against their single-process counterparts, on rays in
    row-major and in block order; the shard's kernels on those rays
    against their plain versions (the nearest triangle bit for bit, the
    walk's t on every lane and its triangle where t is not tied)."""
    from unity_raytracer_tpu_torch.models.camera import generate_rays_blocks
    from unity_raytracer_tpu_torch.models.presets import mesh_scene
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels import intersect_mk
    from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3 as m3
    from unity_raytracer_tpu_torch.ops.kernels.mega import _mt
    from unity_raytracer_tpu_torch.parallel.mesh import make_mesh

    dev = nccl_one_rank
    mesh = make_mesh(device="cuda")
    scene, cam, cfg = mesh_scene(10240, width=64, height=64, device=dev)
    cfg = cfg.with_(kernel="mega")
    bvh = bvhmod.prepare_bvh(scene, cfg)
    np.testing.assert_allclose(
        shardmod.render_tiled(scene, cam, cfg, mesh, bvh=bvh).cpu().numpy(),
        render(scene, cam, cfg, bvh=bvh).cpu().numpy(), **IMG_TOL)
    sb = shardmod.build_shard_bvhs(scene, 1)
    tris = (scene.meshes.verts, scene.meshes.valid)
    for o, d in (generate_rays(cam),
                 generate_rays_blocks(cam, cfg.block_size)):
        ref = isect.nearest_hit(scene, o, d, kernel="pallas")
        for h in (shardmod.scene_sharded_hit(scene, o, d, mesh),
                  shardmod.nearest_hit_ring(scene, o, d, mesh)):
            assert torch.equal(h.kind, ref.kind)
            assert torch.equal(h.mesh_index, ref.mesh_index)
        hb = shardmod.scene_sharded_hit_bvh(scene, o, d, mesh, sb)
        assert torch.equal(hb.kind, ref.kind)
        assert torch.equal(hb.mesh_index, ref.mesh_index)
        t_k, i_k = intersect_mk.nearest_triangle_pallas(o, d, *tris)
        t_p, i_p = intersect_mk.nearest_triangle_plain(o, d, *tris)
        assert torch.equal(i_k, i_p) and int((i_p >= 0).sum()) > 0
        assert torch.equal(t_k, t_p)
        tmax = torch.full((o.shape[0],), float("inf"), device=dev)
        got = m3.walk_raw("mk3", sb["packed"][0], o, d, tmax)
        want = m3.traverse_plain(sb["packed"][0], o, d, tmax)
        assert torch.equal(got[0], want[0])
        # a different triangle only where its own t ties the plain t
        pk = sb["packed"][0]
        rows = lambda w: pk.bvh.prim_index[pk.leaf_prim[
            w[2].clamp_min(0).long(), w[1].clamp_min(0).long()].long()]
        i = torch.nonzero((want[1] >= 0)
                          & (rows(got) != rows(want))).squeeze(1)
        if i.numel():
            v = pk.tris[got[2][i].long(), :126].reshape(-1, 14, 9)[
                torch.arange(i.numel(), device=dev), got[1][i].long()]
            ok, t_i = _mt(tuple(c[i] for c in o.unbind(-1)),
                          tuple(c[i] for c in d.unbind(-1)), v.T)
            assert bool((ok & (t_i == want[0][i])).all())
