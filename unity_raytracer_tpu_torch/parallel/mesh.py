"""Device-mesh construction.

Twin: ``unity_raytracer_tpu/parallel/mesh.py`` (``RAY_AXIS``,
``SCENE_AXIS``, ``make_mesh``, ``ray_sharding``, ``replicated``). A mesh
has two logical axes for a ray tracer:

* ``dp``: the ray/pixel axis (image tiles). Embarrassingly parallel; the
  primary scaling axis. It doubles as the "sequence parallel" axis: the
  wavefront's ray dimension is the sequence.
* ``tp``: the scene axis (mesh triangles sharded across devices) for
  scenes too large to replicate; partial nearest hits combine with a
  lexicographic (t, id) min (``collectives.py``).

The mesh is a ``torch.distributed`` ``DeviceMesh`` (``init_device_mesh``)
over the process group's ranks, one device per rank, laid out row-major
as the twin lays out its devices: rank ``i * tp + j`` sits at (dp ``i``,
tp ``j``). Where
the twin places arrays with a ``NamedSharding``, the port's SPMD code
asks for row ranges: ``ray_sharding`` gives this rank's rows along
``dp``, ``replicated`` the whole range.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

RAY_AXIS = "dp"
SCENE_AXIS = "tp"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device="cuda") -> DeviceMesh:
    """Mesh with axes (dp, tp) over every rank of the initialized process
    group (``bootstrap.maybe_initialize``). Default: all ranks on dp,
    tp = 1. ``device``: the device type of the ranks (``'cuda'`` with
    NCCL, ``'cpu'`` with gloo)."""
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    dp, tp = shape
    if dp * tp != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return init_device_mesh(torch.device(device).type, (dp, tp),
                            mesh_dim_names=(RAY_AXIS, SCENE_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis`` (the twin's ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that share this rank's other
    coordinate: the group a collective over ``axis`` runs in."""
    return mesh.get_group(axis)


def ray_sharding(mesh: DeviceMesh, n: int) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of ``n`` rays sharded over ``dp``
    (``n`` a multiple of the dp size: pad first)."""
    dp = axis_size(mesh, RAY_AXIS)
    if n % dp:
        raise ValueError(f"{n} rows do not split over dp = {dp}")
    rows = n // dp
    lo = axis_index(mesh, RAY_AXIS) * rows
    return lo, lo + rows


def replicated(mesh: DeviceMesh, n: int) -> Tuple[int, int]:
    """The whole row range: every rank holds all ``n`` rows."""
    return 0, n
