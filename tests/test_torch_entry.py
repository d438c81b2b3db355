"""PyTorch port: the single-device entry (``graft_entry.entry``) and the
version against the twin's ``__graft_entry__.entry()`` and
``unity_raytracer_tpu.version``.

On the CPU the port's ``entry(device="cpu")`` builds the flagship
forward step from the same recipe as the twin's: the scene, the
row-major rays and the SAH tree equal the twin's bit for bit (the tree
is the packed rows' ``bvh``), and ``fn(*args)`` — the composed chain,
whose ``'auto'`` walk is the plain per-lane walk on the CPU — agrees with
the twin's ``fn(*args)`` (JAX on the CPU) at rtol = atol = 5e-4 on every
ray, as does the same step on the plain version of the card's walk
(``kernel='pallas'``, ``traverse_mk4``'s plain brute force over leaf
slots). On the card ``entry()`` returns tensors there, and ``fn``
launches the ordered binary walk (kernel #4, ``traverse_mk4``) and
agrees with ``entry("cpu")`` at the same tolerance.

JAX is imported inside the CPU tests only, so the ``gpu`` case also runs
where only PyTorch is installed (``pytest --noconftest -m gpu``).
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_same_arrays, cuda, leaves  # noqa: F401
from unity_raytracer_tpu_torch import __version__
from unity_raytracer_tpu_torch.graft_entry import dryrun_multichip, entry
from unity_raytracer_tpu_torch.ops.kernels import traverse_mk3
from unity_raytracer_tpu_torch.parallel.dryrun import dryrun

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def port():
    fn, args = entry("cpu")
    return fn, args, fn(*args).numpy()


@pytest.fixture(scope="module")
def twin():
    from __graft_entry__ import entry as j_entry
    fn, args = j_entry()
    return fn, args, np.asarray(fn(*args))


def test_inputs_equal_twin(port, twin):
    """Scene, rays and the tree of the twin's entry, bit for bit."""
    (_, (scene, o, d, bvh), _), (_, (js, jo, jd, jbvh), _) = port, twin
    assert_same_arrays(leaves(scene), leaves(js))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert isinstance(bvh, traverse_mk3.PackedBVH)
    assert_same_arrays(leaves(bvh.bvh), leaves(jbvh))
    assert (bvh.bvh.leaf_size, bvh.bvh.canonical) == (jbvh.leaf_size,
                                                      jbvh.canonical)


def test_fn_matches_twin(port, twin):
    got, want = port[2], twin[2]
    assert got.shape == want.shape == (64 * 64, 3)
    assert np.isfinite(got).all() and got.std() > 1.0
    off = ~np.isclose(got, want, **TOL).all(-1)
    assert int(off.sum()) == 0, (f"{int(off.sum())} rays off, max abs "
                                 f"{np.abs(got - want).max():.3g}")


def test_fn_on_the_card_walks_plain_version(port):
    """The step on the card's walk (``kernel='pallas'``), run by its plain
    version on the CPU, against ``'auto'``'s plain per-lane walk."""
    from unity_raytracer_tpu_torch.models.presets import mesh_scene
    from unity_raytracer_tpu_torch.ops.render import (
        resolve_mode, trace_radiance)
    _, (scene, o, d, bvh), want = port
    cfg = mesh_scene(100, width=64, height=64, device="cpu")[2]
    cfg = resolve_mode(scene, cfg).with_(kernel="pallas")
    got = trace_radiance(scene, o, d, cfg, bvh=bvh).numpy()
    assert int((~np.isclose(got, want, **TOL).all(-1)).sum()) == 0


def test_version_and_dryrun_equal_twin():
    from unity_raytracer_tpu import __version__ as j_version
    from unity_raytracer_tpu.version import __version__ as j_file_version
    from unity_raytracer_tpu_torch.version import __version__ as file_version
    assert __version__ == file_version == j_version == j_file_version
    assert dryrun_multichip is dryrun


@pytest.mark.gpu
def test_entry_on_card_launches_walk(cuda):
    fn, args = entry()
    scene, o, d, bvh = args
    assert o.is_cuda and d.is_cuda and scene.meshes.verts.is_cuda
    assert bvh.nodes_walk.is_cuda and scene.gate_min.is_cuda
    for k in traverse_mk3.launches:
        traverse_mk3.launches[k] = 0
    got = fn(*args)
    torch.cuda.synchronize()
    assert traverse_mk3.launches["mk4"] >= 1, traverse_mk3.launches
    fn_c, args_c = entry("cpu")
    want = fn_c(*args_c)
    assert got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, **TOL)
