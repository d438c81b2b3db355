"""Multi-process bootstrap on ``torch.distributed``.

Twin: ``unity_raytracer_tpu/parallel/bootstrap.py`` (``maybe_initialize``,
``world``). The twin joins JAX's multi-host runtime; the port joins a
``torch.distributed`` process group, one process per device, following
torchrun's environment contract:

  MASTER_ADDR, MASTER_PORT   the rendezvous host and port of rank 0
  WORLD_SIZE                 the number of processes
  RANK                       this process's rank
  LOCAL_RANK                 this process's card on its host

Explicit arguments override the environment; without either
``maybe_initialize`` does nothing and returns False, so an entry point
can call it unconditionally. The backend is NCCL on the card; gloo runs
only when the caller asks for the CPU.

``launch`` starts ``n`` such processes on one host and runs a function in
each (the port's ``dryrun`` and its CPU tests): ranks meet through a file
store, so no port is opened for the rendezvous, and a group that hangs
fails at its deadline instead of hanging its caller.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", timeout_s: float = 600.0) -> bool:
    """Join the process group if one is configured; returns True if
    joined (also when this process already is).

    ``coordinator_address``: ``host:port`` of rank 0, or an ``init_method``
    URL (``tcp://...``, ``file://...``); default ``MASTER_ADDR`` and
    ``MASTER_PORT``. ``num_processes`` and ``process_id`` default to
    ``WORLD_SIZE`` and ``RANK``. On the card the process takes card
    ``LOCAL_RANK`` (default: its rank modulo the cards on the host) and
    NCCL; ``device='cpu'`` takes gloo. A collective that waits longer
    than ``timeout_s`` fails."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if not coordinator_address:
        return False
    world_size = int(num_processes if num_processes is not None
                     else os.environ.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", "0"))
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("maybe_initialize: no CUDA card; pass "
                               "device='cpu' for gloo on the CPU")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"maybe_initialize: unsupported device {device}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world() -> dict:
    """Process and device topology for logs (the twin's four keys): one
    device per process."""
    joined = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if joined else 1,
    }


def _run_rank(rank: int, fn: Callable, world_size: int, store: str,
              device: str, timeout_s: float, args: tuple):
    """One spawned process: join the group, run ``fn(rank, *args)``,
    leave the group."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # n processes share the host's cores
    maybe_initialize(store, world_size, rank, device=device,
                     timeout_s=timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, device="cuda", args: tuple = (),
           timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``n`` new processes (spawned: ``fn``
    must be importable), each a rank of one process group on ``device``
    (NCCL on the card, rank ``r`` on card ``r``; gloo on the CPU). Raises
    if a rank raises or if the group is not done within ``timeout_s``
    (then every rank is terminated)."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda":
        # one host: NCCL's bootstrap stays on the loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        ctx = mp.start_processes(
            _run_rank, args=(fn, n, store, str(device), timeout_s, args),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {n} ranks not done within "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(timeout=10.0)
