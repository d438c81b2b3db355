"""Timing, profiler traces and roofline accounting on the card.

Twin: ``unity_raytracer_tpu/utils/profiling.py`` — ``Timing``, ``timed``,
``trace``, ``device_hbm_gbps`` and ``roofline``, with the twin's
signatures, rewritten for PyTorch on an NVIDIA card:

* ``timed`` — best-of-N host clock, each run bracketed by
  ``torch.cuda.synchronize`` while CUDA is in use (on the CPU there is
  nothing to wait for);
* ``trace`` — ``torch.profiler`` over CPU and CUDA activities, written as
  a Chrome trace into a directory;
* ``device_hbm_gbps`` — the card's HBM bandwidth from NVIDIA's data
  sheets, by the name ``torch.cuda.get_device_name`` reports; a card not
  in the table (or no card) gets ``default``, which is None: no figure is
  assumed (the twin's default, 819 GB/s, is a TPU's);
* ``roofline`` — rays/s against the HBM-bandwidth bound; it raises where
  the bandwidth is unknown.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class Timing:
    wall_s: float
    runs: int

    @property
    def per_run_s(self) -> float:
        return self.wall_s / max(self.runs, 1)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, repeats: int = 3, warmup: int = 1,
          **kw) -> Timing:
    """Best-of-``repeats`` wall clock of ``fn(*args, **kw)`` after
    ``warmup`` runs, each run bracketed by a device sync."""
    for _ in range(warmup):
        fn(*args, **kw)
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return Timing(wall_s=best, runs=1)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and, where present, CUDA activities) and
    write its Chrome trace (``chrome://tracing``, Perfetto) into
    ``logdir`` as ``trace-<pid>-<ns>.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


# HBM bandwidth per card (GB/s), NVIDIA data sheets, matched in order on
# the lower-cased device name: H100 NVL (HBM3, 3.9 TB/s), H100 PCIe
# (HBM2e, 2.0 TB/s), H100 SXM ("NVIDIA H100 80GB HBM3", 3.35 TB/s)
_HBM_GBPS = (
    ("h100 nvl", 3900.0),
    ("h100 pcie", 2000.0),
    ("h100", 3350.0),
)


def _device_name() -> Optional[str]:
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else None


def device_hbm_gbps(default: Optional[float] = None) -> Optional[float]:
    """HBM GB/s of card 0 from ``_HBM_GBPS``, else ``default``."""
    name = (_device_name() or "").lower()
    for key, gbps in _HBM_GBPS:
        if name and key in name:
            return gbps
    return default


def roofline(rays_per_s: float, bytes_per_ray: float) -> dict:
    """How close a measured throughput comes to the HBM-bandwidth bound.

    ``bytes_per_ray``: the estimated HBM traffic per traced ray (scene
    reads amortize across the batch; per-ray state and the node and
    triangle reads of the walk dominate). Raises ``ValueError`` where
    the card's bandwidth is not known (``device_hbm_gbps``)."""
    gbps = device_hbm_gbps()
    if gbps is None:
        raise ValueError(
            f"no HBM bandwidth known for device {_device_name()!r}: "
            f"roofline needs a card listed in profiling._HBM_GBPS")
    bw = gbps * 1e9
    bound = bw / max(bytes_per_ray, 1e-9)
    return {
        "rays_per_s": rays_per_s,
        "hbm_gbps": gbps,
        "bytes_per_ray": bytes_per_ray,
        "hbm_bound_rays_per_s": bound,
        "fraction_of_roofline": rays_per_s / bound,
    }
