"""PyTorch port: one fused bounce segment against the JAX megakernel.

``trace_segment_plain`` (brute force over every leaf slot, no BVH walk)
is held against the JAX ``trace_segment`` run in the Pallas interpreter
on the same packed arrays, converted with ``packed_from_arrays``, on a
seeded numpy ray batch with dead lanes. Tolerance rtol = atol = 5e-4 on
the 0-255 outputs — the one tests/test_mega.py:211 holds the JAX 'bw'
kernel to. A continuing lane must continue on both sides; its ray state
is compared where it continues. Where a lane does not continue, the two
sides write different (unused) values by design.
"""

import numpy as np
import pytest
import torch

from torch_parity import cuda, segment_rays, small_scene
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.convert import packed_from_arrays
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops.kernels import mega
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-4)
MAX_BOUNCES = 2
CFG = RenderConfig(max_bounces=MAX_BOUNCES,
                   background=(0.04, 0.05, 0.07), use_bvh=True,
                   mode="scan", bvh_leaf=14, tri_isect="bw",
                   fuse_shadows=False)
N_RAYS = 256


def _kw(scene, light_cull):
    return dict(n_lights=scene.lights.positions.shape[0],
                n_spheres=scene.spheres.count, n_tris=scene.triangles.count,
                max_bounces=MAX_BOUNCES, light_cull=light_cull)


@pytest.fixture(scope="module")
def port_side():
    scene = small_scene(t_scene, t_meshgen)
    return scene, t_bvh.prepare_bvh(scene, CFG), mega.build_aux(
        scene, CFG.background)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(got, want, note=""):
    delta, o2, d2, thr2, tm2 = (_np(x) for x in want)
    g = [_np(x) for x in got]
    np.testing.assert_allclose(g[0], delta, err_msg="delta" + note, **TOL)
    np.testing.assert_array_equal(g[4] >= 0, tm2 >= 0,
                                  err_msg="continuation" + note)
    np.testing.assert_array_equal(g[4], tm2)
    cont = tm2 >= 0
    for k, (a, b) in enumerate(zip(g[1:4], (o2, d2, thr2))):
        np.testing.assert_allclose(a[cont], b[cont], err_msg=f"ray {k}" + note,
                                   **TOL)


@pytest.mark.parametrize("depth,light_cull", [(0, 0.0),
                                              (MAX_BOUNCES, 2.0)])
def test_plain_matches_jax_segment(depth, light_cull):
    import jax
    import jax.numpy as jnp
    from unity_raytracer_tpu.models import meshgen, scene as j_scene
    from unity_raytracer_tpu.ops import bvh as j_bvh
    from unity_raytracer_tpu.ops.pallas import mega as j_mega

    js = small_scene(j_scene, meshgen)
    jp = j_bvh.prepare_bvh(js, CFG.with_(kernel="mega"))
    jaux = j_mega.build_aux(js, CFG.background)
    o, d, thr, tmax = segment_rays(N_RAYS, seed=10 + depth)
    want = j_mega.trace_segment(
        jp, jaux, depth, jnp.asarray(o), jnp.asarray(d), jnp.asarray(thr),
        jnp.asarray(tmax), interpret=True, tile_r=N_RAYS, use_wide=True,
        fuse_shadows=False, tri_isect="bw", occ_mode="pack",
        stale_prune=False, **_kw(js, light_cull))

    packed = packed_from_arrays(jax.tree.map(np.asarray, jp))
    aux = torch.from_numpy(np.array(jaux))
    got = mega.trace_segment_plain(
        packed, aux, depth, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(thr), torch.from_numpy(tmax),
        **_kw(js, light_cull))
    _check(got, want)
    delta = got[0].numpy()
    # the batch must exercise hits, misses, shadows and dead lanes
    assert (delta[tmax < 0] == 0).all()
    assert delta[tmax >= 0].std() > 1.0
    if depth < MAX_BOUNCES:
        assert (got[4].numpy() >= 0).sum() > 5   # mirror continuations
    else:
        assert (got[4].numpy() < 0).all()        # depth cap: none


def test_wrapper_routes_cpu_to_plain(port_side):
    scene, packed, aux = port_side
    o, d, thr, tmax = (torch.from_numpy(x) for x in segment_rays(64, 5))
    before = mega.launches
    a = mega.trace_segment(packed, aux, 1, o, d, thr, tmax,
                           **_kw(scene, 0.0))
    b = mega.trace_segment_plain(packed, aux, 1, o, d, thr, tmax,
                                 **_kw(scene, 0.0))
    assert mega.launches == before  # CPU tensors launch nothing
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_dead_lanes_pass_through(port_side):
    scene, packed, aux = port_side
    o, d, thr, tmax = (torch.from_numpy(x)
                       for x in segment_rays(32, 6, dead_every=1))
    delta, o2, d2, thr2, tm2 = mega.trace_segment_plain(
        packed, aux, 0, o, d, thr, tmax, **_kw(scene, 0.0))
    assert (delta == 0).all() and (tm2 == -1).all()
    assert torch.equal(o2, o) and torch.equal(d2, d) \
        and torch.equal(thr2, thr)


@pytest.mark.gpu
@pytest.mark.parametrize("depth,light_cull", [(0, 0.0),
                                              (MAX_BOUNCES, 2.0)])
def test_kernel_matches_plain_on_card(cuda, port_side, depth, light_cull):
    scene, packed, aux = port_side
    packed, aux = packed.to(cuda), aux.to(cuda)
    rays = [torch.from_numpy(x).to(cuda)
            for x in segment_rays(4096, 20 + depth)]
    kw = _kw(scene, light_cull)
    before = mega.launches
    got = mega.trace_segment(packed, aux, depth, *rays, **kw)
    torch.cuda.synchronize()
    assert mega.launches == before + 1
    want = mega.trace_segment_plain(packed, aux, depth, *rays, **kw)
    # FMA contraction on the card can flip a silhouette-edge hit: allow
    # one lane of the 4096 (the chip smoke allows 0.01% of a frame)
    g, w = [_np(x) for x in got], [_np(x) for x in want]
    cont = w[4] >= 0
    bad = ~np.isclose(g[0], w[0], **TOL).all(-1) | ((g[4] >= 0) != cont)
    for a, b in zip(g[1:4], w[1:4]):
        bad |= cont & ~np.isclose(a, b, **TOL).all(-1)
    assert bad.sum() <= 1, np.nonzero(bad)
