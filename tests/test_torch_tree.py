"""PyTorch port: the dielectric tree, composed and fused, against the JAX package.

* The fused kernel's fork mode (c): ``trace_segment_plain(fork=True)``
  against the JAX ``trace_segment(fork=True)`` in the Pallas interpreter,
  on the inputs of the first three levels of the port's fused
  ``cornell_box`` tree (meshless: no walk) and on a mesh + glass scene on
  the Baldwin–Weber BVH4 route and the Möller–Trumbore BVH4 and binary
  routes — delta, both children's weights and liveness on every live
  lane, their origin and direction where the child is live, at rtol =
  atol = 5e-4 on the 0-255 scale (tests/test_mega.py:211's tolerance).
* The composed tree (``_trace_tree``) against JAX ``render`` on
  ``cornell_box`` at 24x24 (5e-4) and the scalar oracle's golden
  (tests/test_render_golden.py's criteria); tests/test_tree_compact.py's
  contracts (capped = uncapped at depth 6, the default cap changes
  nothing) and tests/test_render_golden.py's mirror-only tree = chain.
* The fused tree (``_trace_tree_mega``, plain versions) against the
  composed tree at depths 0, 1, 2 and 4 with tests/test_tree_mega.py's
  bounds (99th percentile < 0.02 and max < 1.0 of the per-pixel max error
  on the 0-255 scale; depth 0 at rtol 1e-3, atol 5e-3), and against the
  twin's fused tree where the twin's composed tree truncated nothing
  (ROADMAP Queue C #1); a mesh + glass scene on both routes; a glass
  mesh (refracted lanes walking the BVH from inside it), the port's
  composed tree and its fused tree on both BVH4 leaf tests against the
  JAX composed tree, live.
* The truncation count of a scene ``tree_cap`` is too small for: the
  composed count equals JAX's ``trace_radiance_tree_stats``, the fused
  route counts too; a mesh scene on the fused tree without a BVH raises
  (Queue C #2).
* Gradients of the mean 12x12 ``cornell_box`` image through the composed
  tree against eager ``jax.grad`` at tests/test_torch_grad.py's
  tolerance.

The JAX side of the tree-level checks is frozen in
``tests/goldens/torch/tree.npz`` (``python tests/torch_goldens.py
tree``); the segment checks run the interpreter live. The ``gpu`` cases
hold every fork instance to its plain version on the card and the card's
cornell frames to the CPU's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_goldens import (TREE_BLOCK, TREE_DEPTHS, TREE_GRAD_SIZE,
                           TREE_NAMES, TREE_SIZE, load, truncating_tree)
from torch_parity import (  # noqa: F401
    CAMERA, LAYOUTS, cuda, segment_rays, small_scene)
from unity_raytracer_tpu_torch import fit as t_fit
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.camera import (
    Camera, generate_rays_blocks)
from unity_raytracer_tpu_torch.models.convert import packed_from_arrays
from unity_raytracer_tpu_torch.models.presets import (
    cornell_box, three_spheres)
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.ops.render import (
    render, trace_radiance, trace_radiance_tree_stats)
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-4)
G_RTOL, G_ATOL = 5e-3, 5e-4  # tests/test_torch_grad.py's
GOLDENS = Path(__file__).parent / "goldens"
MESH_CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                        use_bvh=True, block_size=16, bvh_leaf=14)


@pytest.fixture(scope="module")
def gold():
    return load("tree")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _seg_kw(scene, max_bounces):
    return dict(n_lights=scene.lights.positions.shape[0],
                n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
                max_bounces=max_bounces)


def _check_fork(got, want, live):
    """Fork outputs on the live lanes: delta, and per child its weight and
    liveness, its origin and direction where it is live."""
    g, w = [_np(x) for x in got], [_np(x) for x in want]
    np.testing.assert_allclose(g[0][live], w[0][live], err_msg="delta",
                               **TOL)
    for base, name in ((1, "reflect"), (5, "refract")):
        np.testing.assert_array_equal(g[base + 3][live], w[base + 3][live],
                                      err_msg=f"{name} tmax")
        alive = live & (w[base + 3] >= 0)
        for k, what in enumerate(("origin", "direction")):
            np.testing.assert_allclose(g[base + k][alive],
                                       w[base + k][alive],
                                       err_msg=f"{name} {what}", **TOL)
        np.testing.assert_allclose(g[base + 2][live], w[base + 2][live],
                                   err_msg=f"{name} weight", **TOL)
    return g


def _cornell_rays(n, seed):
    """``n`` rays from the cornell_box camera toward seeded random points
    inside the box: unlike a pixel grid, none runs exactly along a wall
    edge or a floor diagonal, where XLA's fused multiply-adds and the
    port's separate roundings pick different triangles (ROADMAP Queue C
    #7)."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([0.0, 10.0, -13.0], np.float32), (n, 1))
    target = np.stack([rng.uniform(-9.5, 9.5, n), rng.uniform(0.5, 19.5, n),
                       rng.uniform(1.0, 19.5, n)], -1).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _fused_levels(monkeypatch, scene, o, d, cfg):
    """The inputs ``(o, d, thr, tmax)`` of every fork launch of the port's
    fused tree on these rays (plain versions, the CPU)."""
    levels = []
    seg = mega.trace_segment
    monkeypatch.setattr(mega, "trace_segment", lambda *a, **k: (
        levels.append(a[3:7]), seg(*a, **k))[1])
    trace_radiance(scene, o, d, cfg)
    monkeypatch.setattr(mega, "trace_segment", seg)
    return levels


@pytest.mark.parametrize("level", [0, 1, 2])
def test_fork_segment_meshless_matches_jax(monkeypatch, level):
    """Mode (c) without a mesh (has_mesh=False) on each level's lanes of
    the cornell_box tree of 256 seeded rays."""
    import jax.numpy as jnp
    from unity_raytracer_tpu.models.presets import cornell_box as j_cornell
    from unity_raytracer_tpu.ops.pallas import mega as j_mega
    from unity_raytracer_tpu.ops.render import _dummy_packed

    scene, cam, cfg = cornell_box(width=16, height=16, device="cpu")
    cfg = cfg.with_(kernel="mega")
    ins = _fused_levels(monkeypatch, scene, *_cornell_rays(256, 40),
                        cfg)[level]
    js, _, _ = j_cornell(width=16, height=16)
    kw = _seg_kw(scene, cfg.max_bounces)
    want = j_mega.trace_segment(
        _dummy_packed(4), j_mega.build_aux(js, cfg.background), level,
        *(jnp.asarray(_np(x)) for x in ins), interpret=True, tile_r=128,
        use_wide=True, tri_isect="mt", fork=True, has_mesh=False, **kw)
    got = mega.trace_segment_plain(None, mega.build_aux(scene, cfg.background),
                                   level, *ins, fork=True, has_mesh=False,
                                   tri_isect="mt", **kw)
    live = _np(ins[3]) >= 0
    g = _check_fork(got, want, live)
    assert live.sum() > 40 and (g[8] >= 0).sum() > 5  # refract children
    if level == 0:
        assert live.all() and (g[4] >= 0).sum() > 5  # reflect children


@pytest.mark.parametrize("layout", ["bw4", "mt4", "binary"])
def test_fork_segment_mesh_matches_jax(layout):
    """Mode (c) with a mesh walk, on a mesh + glass scene, on each route's
    layout and leaf test."""
    import jax
    import jax.numpy as jnp
    from unity_raytracer_tpu.models import meshgen, scene as j_scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.pallas import mega as j_mega

    lay = LAYOUTS[layout]
    js = small_scene(j_scene, meshgen, glass=True)
    jp = j_bvh.prepare_bvh(js, MESH_CFG.with_(kernel="mega", **lay))
    jaux = j_mega.build_aux(js, MESH_CFG.background)
    rays = segment_rays(256, seed=31)
    kw = _seg_kw(js, MESH_CFG.max_bounces)
    want = j_mega.trace_segment(
        jp, jaux, 0, *(jnp.asarray(x) for x in rays), interpret=True,
        tile_r=256, use_wide=lay["bvh_arity"] != 0,
        tri_isect=lay["tri_isect"], fuse_shadows=False, occ_mode="pack",
        stale_prune=False, fork=True, **kw)
    packed = packed_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    got = mega.trace_segment_plain(
        packed, torch.from_numpy(np.array(jaux)), 0,
        *(torch.from_numpy(x) for x in rays), fork=True,
        tri_isect=lay["tri_isect"], **kw)
    g = _check_fork(got, want, rays[3] >= 0)
    assert (g[4] >= 0).sum() > 5 and (g[8] >= 0).sum() > 5


def test_composed_tree_matches_jax(gold):
    scene, cam, cfg = cornell_box(width=TREE_SIZE, height=TREE_SIZE,
                                  device="cpu")
    got = render(scene, cam, cfg).numpy()
    np.testing.assert_allclose(got, gold["render"], **TOL)
    assert gold["render"].std() > 0.01


def test_composed_tree_oracle_golden():
    """tests/test_render_golden.py's _check against the scalar oracle."""
    scene, cam, cfg = cornell_box(width=24, height=24, device="cpu")
    img = render(scene, cam, cfg).numpy()
    ref = np.load(GOLDENS / "cornell_box_24x24.npy")
    assert img.shape == ref.shape == (24, 24, 3)
    err = np.abs(img - ref)
    assert np.quantile(err, 0.999) < 5e-3
    assert np.mean(err) < 2e-4 + 1e-3 * np.mean(np.abs(ref))
    assert img.max() > 0.05


def test_tree_cap_matches_uncapped_depth6():
    """tests/test_tree_compact.py: the capped tree drops only dead lanes
    on this scene, so it equals the uncapped 2^6-lane tree."""
    scene, cam, cfg = cornell_box(width=48, height=48, device="cpu")
    cfg = cfg.with_(max_bounces=6, mode="tree")
    uncapped = render(scene, cam, cfg.with_(tree_cap=0)).numpy()
    capped = render(scene, cam, cfg.with_(tree_cap=4)).numpy()
    assert np.isfinite(capped).all() and capped.std() > 0.01
    np.testing.assert_allclose(capped, uncapped, rtol=1e-5, atol=1e-5)


def test_tree_cap_default_changes_nothing():
    scene, cam, cfg = cornell_box(width=32, height=32, device="cpu")
    np.testing.assert_allclose(render(scene, cam, cfg).numpy(),
                               render(scene, cam,
                                      cfg.with_(tree_cap=0)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_mirror_only_tree_equals_scan():
    """tests/test_render_golden.py: without a dielectric the tree and the
    chain are the same function."""
    scene, cam, cfg = three_spheres(width=24, height=24, device="cpu")
    np.testing.assert_allclose(
        render(scene, cam, cfg.with_(mode="tree")).numpy(),
        render(scene, cam, cfg.with_(mode="scan")).numpy(), rtol=1e-5,
        atol=1e-5)


def _cornell_radiance(size, depth, kernel="auto"):
    scene, cam, cfg = cornell_box(width=size, height=size, device="cpu")
    cfg = cfg.with_(mode="tree", max_bounces=depth, kernel=kernel,
                    **TREE_BLOCK)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    return trace_radiance(scene, o, d, cfg).numpy()


def _assert_tree_bounds(fused, ref):
    """tests/test_tree_mega.py:29-33 on the 0-255 scale."""
    diff = np.abs(ref - fused).max(axis=-1)
    assert np.isfinite(fused).all()
    assert np.quantile(diff, 0.99) < 0.02, np.quantile(diff, 0.99)
    assert diff.max() < 1.0, diff.max()


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_fused_tree_matches_composed(depth):
    size = 16 if depth == 0 else 24
    ref = _cornell_radiance(size, depth)
    fused = _cornell_radiance(size, depth, "mega")
    if depth == 0:  # tests/test_tree_mega.py:36-43
        np.testing.assert_allclose(fused, ref, rtol=1e-3, atol=5e-3)
        return
    _assert_tree_bounds(fused, ref)
    assert ref.std() > 1.0  # the scene exercises the fork


@pytest.mark.parametrize("depth", TREE_DEPTHS)
def test_fused_tree_matches_jax_fused(gold, depth):
    """The twin's fused tree, held only where its composed tree truncated
    nothing (its fused tree would drop overflow tiles uncounted)."""
    assert int(gold[f"composed_truncated/{depth}"]) == 0
    _assert_tree_bounds(_cornell_radiance(TREE_SIZE, depth, "mega"),
                        gold[f"fused/{depth}"])


@pytest.mark.parametrize("layout", ["bw4", "mt4", "binary"])
def test_mesh_tree_fused_matches_composed(layout):
    """A mesh + glass scene on the tree: the fused fork kernel walking the
    mesh on each route against the composed tree (plain walk), at
    tests/test_tree_mega.py's bounds."""
    scene = small_scene(t_scene, t_meshgen, glass=True, device="cpu")
    cam = Camera.make(width=16, height=16, device="cpu", **CAMERA)
    cfg = MESH_CFG.with_(mode="tree", **LAYOUTS[layout])
    bvh = t_bvh.prepare_bvh(scene, cfg.with_(kernel="mega"))
    o, d = generate_rays_blocks(cam, cfg.block_size)
    ref = trace_radiance(scene, o, d, cfg.with_(kernel="xla"),
                         bvh=t_bvh.prepare_bvh(scene,
                                               cfg.with_(kernel="xla")))
    fused = trace_radiance(scene, o, d, cfg.with_(kernel="mega"), bvh=bvh)
    _assert_tree_bounds(fused.numpy(), ref.numpy())
    assert ref.std() > 1.0


@pytest.fixture(scope="module")
def glass_mesh_jax():
    """The glass-icosphere scene (``small_scene(glass_mesh=True)``) at
    16x16 through ``CAMERA``: its rays and the JAX composed tree's
    radiance and truncation count (``trace_radiance_tree_stats`` on the
    plain BVH walk), at the port's default cap and depth 4."""
    import jax
    from unity_raytracer_tpu.models import meshgen, scene as j_scene
    from unity_raytracer_tpu.models.camera import Camera as JCamera
    from unity_raytracer_tpu.models.camera import (
        generate_rays_blocks as j_rays)
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.render import (
        trace_radiance_tree_stats as j_tree_stats)

    cfg = MESH_CFG.with_(mode="tree", max_bounces=4)
    js = small_scene(j_scene, meshgen, glass_mesh=True)
    o, d = j_rays(JCamera.make(width=16, height=16, **CAMERA),
                  cfg.block_size)
    rad, trunc = j_tree_stats(js, o, d, cfg, bvh=j_bvh.prepare_bvh(js, cfg))
    return cfg, np.array(o), np.array(d), jax.device_get((rad, trunc))


@pytest.mark.parametrize("kernel", ["xla", "bw4", "mt4"])
def test_glass_mesh_tree_matches_jax(glass_mesh_jax, kernel):
    """A dielectric mesh, whose refracted lanes walk the BVH from inside
    it, on the JAX package's rays: the port's composed tree against the
    JAX composed tree at 5e-4, and the fused fork kernel (each BVH4 leaf
    test) at tests/test_tree_mega.py's bounds."""
    cfg, o, d, (want, trunc) = glass_mesh_jax
    assert int(trunc) == 0 and want.std() > 1.0
    scene = small_scene(t_scene, t_meshgen, glass_mesh=True, device="cpu")
    c = (cfg.with_(kernel="xla") if kernel == "xla"
         else cfg.with_(kernel="mega", **LAYOUTS[kernel]))
    got = trace_radiance(scene, torch.from_numpy(o), torch.from_numpy(d), c,
                         bvh=t_bvh.prepare_bvh(scene, c)).numpy()
    if kernel == "xla":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        _assert_tree_bounds(got, want)


def test_truncation_is_counted(gold):
    """tree_cap=1 on a scene whose live forks outnumber the rays: the
    composed count equals JAX's, and the fused route counts the lanes it
    drops too (the twin's drops whole tiles uncounted)."""
    scene, cam, cfg = truncating_tree("torch")
    o, d = generate_rays_blocks(cam, cfg.block_size)
    rad, count = trace_radiance_tree_stats(scene, o, d, cfg)
    assert int(count) == int(gold["trunc/count"]) > 0
    np.testing.assert_allclose(rad.numpy(), gold["trunc/rad"], **TOL)
    _, fused_count = trace_radiance_tree_stats(scene, o, d,
                                               cfg.with_(kernel="mega"))
    assert int(fused_count) > 0
    _, none = trace_radiance_tree_stats(scene, o, d, cfg.with_(tree_cap=0))
    assert int(none) == 0


def test_fused_tree_mesh_without_bvh_raises():
    """The twin's fused tree drops a mesh it has no BVH for (Queue C #2);
    the port refuses."""
    scene = small_scene(t_scene, t_meshgen, glass=True, device="cpu")
    cam = Camera.make(width=8, height=8, device="cpu", **CAMERA)
    with pytest.raises(ValueError, match="packed BVH"):
        render(scene, cam, MESH_CFG.with_(kernel="mega", use_bvh=False))


@pytest.mark.parametrize("name", TREE_NAMES)
def test_tree_grad_matches_jax(gold, name):
    """d mean(image) / d name through the composed tree (index_add,
    compaction gathers, Fresnel weights) against eager jax.grad."""
    scene, cam, cfg = cornell_box(width=TREE_GRAD_SIZE,
                                  height=TREE_GRAD_SIZE, device="cpu")
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in t_fit.get_params(scene, (name,)).items()}
    loss = render(t_fit.set_params(scene, params), cam, cfg).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), gold["grad/loss"],
                               rtol=1e-5)
    want = gold[f"grad/{name}"]
    scale = max(float(np.abs(want).max()), 1e-12)
    assert scale > 0
    np.testing.assert_allclose(params[name].grad.numpy(), want,
                               rtol=G_RTOL, atol=G_ATOL * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["bw/wide4", "bw/wide8", "mt/wide4",
                                   "mt/wide8", "mt/binary", "meshless"])
def test_fork_kernels_match_plain_on_card(cuda, route):
    scene = small_scene(t_scene, t_meshgen, glass=True, device=cuda)
    isect, layout = route.split("/") if "/" in route else ("mt", "")
    arity = {"wide4": 4, "wide8": 8, "binary": 0}.get(layout, 4)
    packed = t_bvh.prepare_bvh(scene, MESH_CFG.with_(kernel="mega",
                                                     bvh_arity=arity))
    aux = mega.build_aux(scene, MESH_CFG.background)
    rays = [torch.from_numpy(x).to(cuda) for x in segment_rays(4096, 33)]
    kw = dict(_seg_kw(scene, 2), fork=True, tri_isect=isect,
              has_mesh=route != "meshless")
    before = mega.route_launches["fork", route]
    got = mega.trace_segment(packed, aux, 0, *rays, **kw)
    torch.cuda.synchronize()
    assert mega.route_launches["fork", route] == before + 1
    want = mega.trace_segment_plain(packed, aux, 0, *rays, **kw)
    g, w = [_np(x) for x in got], [_np(x) for x in want]
    bad = ~np.isclose(g[0], w[0], **TOL).all(-1)
    for base in (1, 5):
        alive = w[base + 3] >= 0
        bad |= (g[base + 3] >= 0) != alive
        bad |= ~np.isclose(g[base + 2], w[base + 2], **TOL).all(-1)
        for k in (0, 1):
            bad |= alive & ~np.isclose(g[base + k], w[base + k],
                                       **TOL).all(-1)
    assert bad.sum() <= 1, np.nonzero(bad)  # the chip smoke's 0.01% gate


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["auto", "mega"])
def test_cornell_tree_on_card_matches_cpu(cuda, kernel):
    imgs = []
    for dev in (cuda, "cpu"):
        scene, cam, cfg = cornell_box(width=64, height=64, device=dev)
        imgs.append(render(scene, cam, cfg.with_(kernel=kernel)).cpu()
                    .numpy())
    bad = ~np.isclose(imgs[0], imgs[1], **TOL).all(-1)
    assert bad.sum() <= 2, np.nonzero(bad)
    assert imgs[1].std() > 0.01
