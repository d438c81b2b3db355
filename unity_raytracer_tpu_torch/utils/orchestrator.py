"""Tile-granular render orchestration with failure retry.

Twin: ``unity_raytracer_tpu/utils/orchestrator.py`` (``TileReport``,
``render_tiled_orchestrated``). Render jobs are stateless and idempotent,
so recovery is re-dispatch: the orchestrator traces the frame in row
bands, each on its own, and retries a band that fails. It also bounds
peak memory like ``RenderConfig.ray_chunk``, with progress that can be
restarted band by band.

The bands are rows of ``models/camera.generate_rays``, whose arithmetic
is ``render``'s, so a band equals the same rows of ``render``'s image
(the twin jits its raygen to get there; the port's raygen has one
arithmetic on every path).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from unity_raytracer_tpu_torch.models.camera import Camera, generate_rays
from unity_raytracer_tpu_torch.models.scene import Scene
from unity_raytracer_tpu_torch.ops.render import (
    check_supported, resolve_mode, trace_radiance)
from unity_raytracer_tpu_torch.utils.config import RenderConfig


@dataclass
class TileReport:
    tile: int
    rows: Tuple[int, int]
    attempts: int
    seconds: float
    ok: bool
    error: Optional[str] = None  # the last failed attempt's exception


def render_tiled_orchestrated(
        scene: Scene, cam: Camera, cfg: RenderConfig, bvh=None,
        rows_per_tile: int = 128, max_retries: int = 2,
        trace_fn: Optional[Callable] = None,
        progress: Optional[Callable[[TileReport], None]] = None
) -> Tuple[torch.Tensor, List[TileReport]]:
    """Render row bands independently; retry failed bands.

    ``trace_fn(scene, o, d, cfg, bvh)`` is injectable for tests (fault
    injection); by default ``trace_radiance``. Returns ``(image [H,W,3]
    on the display scale, on the camera's device; reports)``. A band that
    exhausts its retries stays zero and reports ``ok=False``; a report
    keeps the last failed attempt's exception (``error``). The time of a
    report is the host's, to the band's last host sync."""
    cfg = resolve_mode(scene, cfg)
    check_supported(cfg)
    trace = trace_fn or (lambda s, o, d, c, b: trace_radiance(s, o, d, c,
                                                              bvh=b))
    h, w = cam.height, cam.width
    o, d = generate_rays(cam)
    o = o.reshape(h, w, 3)
    d = d.reshape(h, w, 3)

    img = torch.zeros((h, w, 3), dtype=torch.float32, device=o.device)
    reports: List[TileReport] = []
    n_tiles = (h + rows_per_tile - 1) // rows_per_tile

    for tile in range(n_tiles):
        r0 = tile * rows_per_tile
        r1 = min(r0 + rows_per_tile, h)
        ot = o[r0:r1].reshape(-1, 3)
        dt = d[r0:r1].reshape(-1, 3)
        ok = False
        attempts = 0
        error = None
        t0 = time.perf_counter()
        while attempts <= max_retries and not ok:
            attempts += 1
            try:
                rad = trace(scene, ot, dt, cfg, bvh)
                img[r0:r1] = rad.reshape(r1 - r0, w, 3) / 255.0
                ok = True
            except Exception as e:  # a failed band is re-dispatched
                error = repr(e)
        rep = TileReport(tile=tile, rows=(r0, r1), attempts=attempts,
                         seconds=time.perf_counter() - t0, ok=ok,
                         error=error)
        reports.append(rep)
        if progress:
            progress(rep)
    return img, reports
