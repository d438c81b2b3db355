"""The frozen yardstick: peaks of the card, issued rays and the bytes of a
frame. Copied here so that no change to the program moves it.

* ``HBM_BPS``, ``FP32_OPS``: the H100 SXM's HBM bandwidth and dense FP32
  rate outside the tensor cores (NVIDIA data sheet; the port's
  ``utils/profiling.HBM_BPS`` / ``FP32_OPS``).
* ``count_rays``: issued query slots of a frame, the port's
  ``bench.count_rays``: every pixel's ray and its shadow rays at every
  depth, whether or not the lane is still alive.
* ``frame_bytes``: the least a frame must move: the scene's arrays read
  once and the image written once (float32).
* A frame's FP32 operation count is a constant of its configuration
  (``yardstick.frame_fp32_ops`` in the configuration's file), measured
  once on the card (``raybench/tools/count_ops.py``) and frozen.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
FP32_OPS = 67e12


def count_rays(max_bounces: int, width: int, height: int,
               n_lights: int) -> int:
    return width * height * (max_bounces + 1) * (1 + n_lights)


def frame_bytes(arrays: dict, width: int, height: int) -> int:
    """Scene arrays (triangle corners, sphere centres and radii, light
    positions and intensities) read once, plus the float32 RGB image."""
    scene = (arrays["mesh_verts"].size + arrays["tri_verts"].size
             + arrays["sph_center"].size + arrays["sph_r2"].size
             + arrays["light_pos"].size + arrays["light_int"].size) * 4
    return scene + width * height * 3 * 4


def least_frame_s(ops: float, nbytes: float) -> float:
    """The frame's least time on the card: max of its bytes at the HBM
    rate and its FP32 operations at the FP32 rate."""
    return max(nbytes / HBM_BPS, ops / FP32_OPS)
