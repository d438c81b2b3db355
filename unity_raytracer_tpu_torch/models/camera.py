"""Pinhole camera + block-ordered primary-ray generation.

Twin: ``unity_raytracer_tpu/models/camera.py:20-127`` (``Camera`` with
``make`` and ``from_fov``, ``generate_rays_blocks``, ``generate_rays``). The reference model
is an explicit image plane (Data/Camera/ImagePlane.cs:11-45); primary
rays go through pixel centers,
``topLeft + (x+0.5)*hLen/resX * right - (y+0.5)*vLen/resY * up``
(Demo-RayTracing/RayTracingSetup.cs:291-298), pixel (0,0) top-left.

The float operations run in the order the JAX twin pins at ``:103-113``,
so on the CPU the rays equal the JAX rays bitwise
(``tests/test_torch_scene.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Camera:
    """Camera pose + image plane; ``width``/``height`` are plain ints."""

    position: torch.Tensor   # [3]
    forward: torch.Tensor    # [3] unit
    right: torch.Tensor      # [3] unit
    up: torch.Tensor         # [3] unit
    dist: torch.Tensor       # [] image-plane distance to camera
    half_h: torch.Tensor     # [] half horizontal extent
    half_v: torch.Tensor     # [] half vertical extent
    width: int = 0
    height: int = 0

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})

    @staticmethod
    def make(position=(0.0, 0.0, 0.0), forward=(0.0, 0.0, 1.0),
             up=(0.0, 1.0, 0.0), dist: float = 10.0, half_h: float = 20.0,
             half_v: float = 10.0, width: int = 50, height: int = 50,
             device="cuda") -> "Camera":
        f = np.asarray(forward, np.float32)
        f = f / np.linalg.norm(f)
        u = np.asarray(up, np.float32)
        r = np.cross(f, u)          # left-handed Unity basis: right = fwd x up
        r = r / np.linalg.norm(r)
        u = np.cross(r, f)
        u = u / np.linalg.norm(u)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device)
        return Camera(position=t(position), forward=t(f), right=t(r),
                      up=t(u), dist=t(dist), half_h=t(half_h),
                      half_v=t(half_v), width=int(width), height=int(height))

    @staticmethod
    def from_fov(position, look_at, up=(0.0, 1.0, 0.0),
                 fov_y_deg: float = 45.0, dist: float = 1.0,
                 width: int = 512, height: int = 512,
                 device="cuda") -> "Camera":
        """By vertical field of view (the twin's ``from_fov``, ``:60-69``;
        the reference has no FOV camera)."""
        p = np.asarray(position, np.float32)
        f = np.asarray(look_at, np.float32) - p
        half_v = dist * np.tan(np.deg2rad(fov_y_deg) * 0.5)
        half_h = half_v * (width / height)
        return Camera.make(position=p, forward=f, up=up, dist=dist,
                           half_h=float(half_h), half_v=float(half_v),
                           width=width, height=height, device=device)


def generate_rays_blocks(cam: Camera, bs: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays in bs x bs pixel-block lane order, on the camera's
    device. The image is padded up to whole blocks; pad lanes get valid
    rays through out-of-frame pixel centers and are cropped by
    ``utils/swizzle.unswizzle_image``. Returns ``(o [Np,3], d [Np,3])``
    with ``Np = Wp*Hp``."""
    w, h = cam.width, cam.height
    wp = -(-w // bs) * bs
    hp = -(-h // bs) * bs
    n = wp * hp
    lane = torch.arange(n, dtype=torch.int32, device=cam.position.device)
    wb = wp // bs
    blk = lane // (bs * bs)
    off = lane % (bs * bs)
    y = (blk // wb) * bs + off // bs
    x = (blk % wb) * bs + off % bs

    center = cam.position + cam.forward * cam.dist
    top_left = center - cam.right * cam.half_h + cam.up * cam.half_v
    xs = (x.to(torch.float32) + 0.5) * (2.0 * cam.half_h / w)
    ys = (y.to(torch.float32) + 0.5) * (2.0 * cam.half_v / h)
    # per-component math in the twin's order:
    # ((top_left + xs*r - ys*u) - pos), then sqrt and divide
    dx = (top_left[0] + xs * cam.right[0] - ys * cam.up[0]) - cam.position[0]
    dy = (top_left[1] + xs * cam.right[1] - ys * cam.up[1]) - cam.position[1]
    dz = (top_left[2] + xs * cam.right[2] - ys * cam.up[2]) - cam.position[2]
    # the float32 sqrt of PyTorch's CPU kernels is not always correctly
    # rounded; through float64 it is (one rounding of the exact root)
    nrm = torch.sqrt((dx * dx + dy * dy + dz * dz).double()).float()
    d = torch.stack([dx / nrm, dy / nrm, dz / nrm], dim=-1)
    o = cam.position.expand(n, 3).contiguous()
    return o, d


def generate_rays(cam: Camera) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays through every pixel center, row-major (``x + y*W``,
    the reference framebuffer index): ``generate_rays_blocks`` with
    1-pixel blocks, the same arithmetic, as in the twin (``:116-127``)."""
    return generate_rays_blocks(cam, 1)
