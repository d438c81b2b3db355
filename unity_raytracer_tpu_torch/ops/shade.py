"""Shading helpers shared by the fused segment and the record replay.

Twin: ``unity_raytracer_tpu/ops/shade.py`` — a partial port of what the
record-replay training path needs: ``SHADOW_EPS`` (``:22``),
``_soft_or_hard_vis`` (``:146-156``) and ``reflect_dir`` (``:258-262``).
Still to port under ROADMAP Queue A #10: ``surface_attributes``,
``shadow_min_t``, ``direct_lighting``, ``refract_dir`` and
``schlick_fresnel`` (the composed path). ``take_rows`` (``:32-48``) is a
TPU gather workaround and is not ported: the port indexes, and the
gradient of an index is the same scatter-add.
"""

from __future__ import annotations

import torch

from unity_raytracer_tpu_torch.ops.intersect import dot3

SHADOW_EPS = 1e-4  # ShadowRayEpsilon, RayTracingSetup.cs:42


def _soft_or_hard_vis(hard: torch.Tensor, margin: torch.Tensor, temp: float,
                      straight_through: bool) -> torch.Tensor:
    """Visibility in [0,1]. temp == 0: hard. Otherwise sigmoid(margin /
    temp); with ``straight_through`` the forward value is the hard one and
    only the gradient is soft (soft + detach(hard - soft))."""
    if temp <= 0.0:
        return hard.to(torch.float32)
    soft = torch.sigmoid(margin / temp)
    if straight_through:
        return soft + (hard.to(torch.float32) - soft).detach()
    return soft


def reflect_dir(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror direction ``d - 2 n (d.n)`` (Reflect, RayTracingSetup.cs:
    368-373, with v = -d). Unit length when d and n are."""
    return d - 2.0 * n * dot3(d, n)[..., None]
