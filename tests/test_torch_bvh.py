"""PyTorch port: host BVH build and packers against the JAX package.

Every array ``prepare_bvh`` returns (node rows, wide rows, MT and
Baldwin–Weber leaf rows, leaf slot map, leaf material ids) must equal the
JAX ``prepare_bvh(cfg.with_(kernel='mega'))`` exactly, and so must the aux
block — the fused segment kernel reads these bytes unchanged.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_same_arrays, cuda, leaves, small_scene
from unity_raytracer_tpu_torch.models import meshgen as t_meshgen
from unity_raytracer_tpu_torch.models import scene as t_scene
from unity_raytracer_tpu_torch.models.convert import (
    packed_from_arrays, scene_from_arrays)
from unity_raytracer_tpu_torch.models.presets import get_preset
from unity_raytracer_tpu_torch.ops import bvh as t_bvh
from unity_raytracer_tpu_torch.ops.kernels import (
    mega, traverse_mk3, traverse_wide)
from unity_raytracer_tpu_torch.utils import boxes
from unity_raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

ARRAYS = ("nodes", "wide", "tris", "tris_bw", "leaf_prim", "leafmeta")
CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", tri_isect="bw")


def _packed_arrays(p):
    return {k: (getattr(p, k).cpu().numpy()
                if isinstance(getattr(p, k), torch.Tensor)
                else np.asarray(getattr(p, k))) for k in ARRAYS}


def _jax_scene(name):
    from unity_raytracer_tpu.models import meshgen, presets, scene
    if name == "small":
        return small_scene(scene, meshgen), CFG
    js, _, cfg = presets.get_preset(name, width=8, height=8)
    return js, cfg


def _port_scene(name):
    if name == "small":
        return small_scene(t_scene, t_meshgen, device="cpu")
    return get_preset(name, width=8, height=8, device="cpu")[0]


@pytest.mark.parametrize("name,leaf,arity", [
    ("small", 14, 4), ("small", 28, 4), ("small", 14, 8),
    ("mesh10k", 98, 4), ("mesh100k", 98, 4)])
def test_prepare_bvh_equal(name, leaf, arity):
    from unity_raytracer_tpu.ops import bvh as j_bvh
    js, cfg = _jax_scene(name)
    cfg = cfg.with_(bvh_leaf=leaf, bvh_arity=arity)
    jp = j_bvh.prepare_bvh(js, cfg.with_(kernel="mega"))
    tp = t_bvh.prepare_bvh(_port_scene(name), cfg)
    assert_same_arrays(_packed_arrays(jp), _packed_arrays(tp))
    assert (tp.rows_per_leaf, tp.bw_rows_per_leaf) == (
        jp.rows_per_leaf, jp.bw_rows_per_leaf)
    for k in ("prim_index", "tri_verts", "first", "count", "miss_next",
              "node_min", "node_max", "flip"):
        np.testing.assert_array_equal(getattr(tp.bvh, k),
                                      np.asarray(getattr(jp.bvh, k)),
                                      err_msg=k)


@pytest.mark.parametrize("name", ["small", "mesh10k"])
def test_build_aux_equal(name):
    """The twin's aux block, but for its scene box (row 0, lanes 0-5),
    which the port widens as it widens every box a walk tests
    (``utils/boxes.pad_box``; ROADMAP Queue C #14)."""
    from unity_raytracer_tpu.ops.pallas import mega as j_mega
    js, cfg = _jax_scene(name)
    got = mega.build_aux(_port_scene(name), cfg.background).numpy()
    want = np.asarray(j_mega.build_aux(js, cfg.background)).copy()
    lo, hi = want[0, 0:3].copy(), want[0, 3:6].copy()
    want[0, 0:3], want[0, 3:6] = boxes.pad_box(lo, hi)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0:3] < lo).all() and (got[0, 3:6] > hi).all()


def test_packed_from_arrays_roundtrip():
    import jax
    from unity_raytracer_tpu.ops import bvh as j_bvh
    js, cfg = _jax_scene("small")
    jp = j_bvh.prepare_bvh(js, cfg.with_(kernel="mega"))
    conv = packed_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    mine = t_bvh.prepare_bvh(scene_from_arrays(
        jax.tree.map(np.asarray, js), "cpu"), cfg)
    assert_same_arrays(_packed_arrays(conv), _packed_arrays(mine))
    assert (conv.rows_per_leaf, conv.bw_rows_per_leaf) == (
        mine.rows_per_leaf, mine.bw_rows_per_leaf)
    assert conv.bvh.canonical and conv.bvh.leaf_size == 14


def test_widen_refuses_deep_tree():
    """A degenerate tree deeper than the kernel stack fails on the host."""
    n = 300  # a left-leaning chain of interior nodes, one leaf each side
    nodes = np.zeros((2 * n + 1, 16), np.float32)
    nodes[:, 6] = -1.0
    for i in range(n):
        nodes[2 * i, 9] = 2 * i + 2          # interior: right child
        nodes[2 * i + 1, 7] = 1.0            # left child: a leaf
        nodes[2 * i + 1, 6] = float(i)
    nodes[2 * n, 7] = 1.0
    packed = t_bvh.PackedBVH(nodes=torch.from_numpy(nodes),
                             tris=torch.zeros(1, 128),
                             leaf_prim=torch.zeros(1, 14, dtype=torch.int32),
                             bvh=None)
    with pytest.raises(ValueError, match="stack"):
        traverse_wide.widen(packed, arity=2)


def test_presplit_and_meshless_raise():
    """Neither raises any more: SBVH presplitting prepares a packed tree
    whose leaves hold duplicated triangles (``tests/test_torch_presplit.py``
    holds it to the twin), and a meshless build is the twin's single
    empty leaf."""
    from unity_raytracer_tpu.ops import bvh as j_bvh
    scene = small_scene(t_scene, t_meshgen, device="cpu")
    split = t_bvh.prepare_bvh(scene, CFG.with_(bvh_presplit=0.3))
    whole = t_bvh.prepare_bvh(scene, CFG)
    assert split.bvh.tri_verts.shape[0] > whole.bvh.tri_verts.shape[0]
    np.testing.assert_array_equal(np.unique(split.bvh.prim_index),
                                  np.unique(whole.bvh.prim_index))
    assert 0 < split.stack_binary <= traverse_mk3.STACK_BINARY
    assert 0 < split.stack_wide <= traverse_wide.STACK
    got = t_bvh.build(np.zeros((4, 3, 3), np.float32), np.zeros((4,), bool))
    want = j_bvh.build(np.zeros((4, 3, 3), np.float32), np.zeros((4,), bool))
    for k in ("node_min", "node_max", "first", "count", "miss_next",
              "tri_verts", "prim_index"):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


@pytest.mark.gpu
def test_prepare_bvh_on_card_equal(cuda):
    scene = small_scene(t_scene, t_meshgen, device="cpu")
    on_card = t_bvh.prepare_bvh(scene.to(cuda), CFG, cuda)
    assert on_card.wide.device.type == "cuda"
    assert_same_arrays(_packed_arrays(on_card),
                       _packed_arrays(t_bvh.prepare_bvh(scene, CFG)))
    assert_same_arrays(leaves(scene.to(cuda)), leaves(scene))
