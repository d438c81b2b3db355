"""The plain reference of a mesh-geometry fit, in plain PyTorch, by brute force.

It decides ``correct`` for a fit that moves a mesh's shared vertices, and
imports nothing of the program. It builds on ``reference.py`` (the
Whitted tracer and the composed fit's soft equations, ``SoftFit``), which
it does not change: each step makes a ``reference.Reference`` of the
step's triangles for the hard search, and hands ``SoftFit`` mesh rows and
normals that are functions of the vertices, so that the gradient reaches
them through every term the composed path passes it through:

* nearest hits by brute force over the current triangles (``positions
  [faces]``), the search detached: it only picks the winner;
* a mesh hit's ``t`` re-derived by Möller–Trumbore from the winner's
  current corners (the search's ``t`` where that misses on rounding);
* a mesh hit's shading normal ``-normalize(cross(v2 - v0, v1 - v0))`` of
  the current corners;
* soft shadows ``sigmoid((t^2 - r^2) / shadow_temp)``, a mesh occluder's
  ``t`` re-derived from its current corners as above, and the soft hits of
  ``SoftFit`` (sphere silhouettes and proxies) at the traffic's
  temperatures; hits on the mesh weigh 1, as on the composed path;
* the loss, the pixel MSE on the display scale over every pixel, and its
  own Adam (``drivers/fit.adam``) on the positions.

Departures from the program, each known to move a few lanes at most:

* the winding: triangles are taken as the mesh gives them; the program
  swaps two corners where the derived normal opposes the stored one,
  once, when it builds the tree, which for a mesh whose stored normals
  are the bake's (``SceneBuilder.add_mesh``) swaps none;
* ties: of two triangles at the same ``t`` the lower index wins here, the
  first met in the walk's order in the program;
* precision: float32 throughout (TF32 off), where the program's kernels
  also run float32 but in their own order of operations.
"""

from __future__ import annotations

import numpy as np
import torch

from raybench import reference as ref_mod
from raybench.drivers.fit import adam

REF_BLOCK = 1 << 18      # rays per backward


def _rows(v: torch.Tensor, pad: int):
    """``(rows [M',9]: v0, e1, e2; shading normals [M',3])`` of triangles
    ``v [M,3,3]``, zero-padded to ``M' = M + pad`` rows."""
    v = torch.cat([v, v.new_zeros((pad, 3, 3))])
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    rows = torch.cat([v[:, 0], e1, e2], -1)
    nml = -ref_mod._normalize(ref_mod._cross(e2, e1))
    return rows, nml


class MeshFit:
    """The composed fit's loss and gradient with respect to a mesh's
    shared vertices ``positions [V,3]``, whose triangles are
    ``positions[faces]`` (``faces [M,3]``), for the deployment ``arrays``
    (``scene.arrays``; its ``mesh_verts`` are replaced by each step's),
    at ``depth`` bounces, in ``dtype``."""

    def __init__(self, arrays: dict, faces, depth: int, device,
                 hit_temp: float, shadow_temp: float, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.arrays, self.depth, self.device = arrays, depth, device
        self.dtype, self.ht, self.st = dtype, hit_temp, shadow_temp
        self.faces = torch.as_tensor(np.asarray(faces), dtype=torch.long,
                                     device=device)

    def _soft(self, pos: torch.Tensor) -> "ref_mod.SoftFit":
        """``SoftFit`` over a ``Reference`` of the triangles of ``pos``."""
        tri = pos.detach()[self.faces].float().cpu().numpy()
        arr = dict(self.arrays, mesh_verts=tri)
        ref = ref_mod.Reference(arr, self.depth, self.device, self.dtype)
        return ref_mod.SoftFit(ref, self.ht, self.st)

    def _bind(self, soft, pos: torch.Tensor) -> None:
        """The mesh rows and normals ``soft`` reads, as functions of
        ``pos`` (made anew for each backward)."""
        pad = soft.mesh_rows.shape[0] - self.faces.shape[0]
        rows, nml = _rows(pos.to(self.dtype)[self.faces], pad)
        soft.mesh_rows = rows
        soft.ref.mesh_n = nml

    def target(self, o, d) -> torch.Tensor:
        """The hard render (display scale) of rays ``o, d`` at the
        deployment's own mesh."""
        ref = ref_mod.Reference(self.arrays, self.depth, self.device,
                                self.dtype)
        with torch.no_grad():
            out = torch.cat([ref.trace(o[s:s + REF_BLOCK], d[s:s + REF_BLOCK])
                             for s in range(0, o.shape[0], REF_BLOCK)])
        return (out / 255.0).to(self.dtype)

    def value_and_grad(self, pos, o, d, target, chunk: int = REF_BLOCK):
        """Pixel MSE (display scale) of the rays ``o, d`` against
        ``target`` with the mesh at ``pos``, and its gradient w.r.t.
        ``pos``; one backward per ``chunk`` rays."""
        p = pos.detach().clone().requires_grad_(True)
        soft = self._soft(p)
        r = soft.ref
        centers, diffuse = r.sph_c, r.mat["diffuse"][r.sph_m]
        total = 0.0
        for s in range(0, o.shape[0], chunk):
            self._bind(soft, p)
            rad = soft.radiance(o[s:s + chunk], d[s:s + chunk], centers,
                                diffuse, self.depth)
            part = ((rad / 255.0 - target[s:s + chunk]) ** 2).sum()
            part.backward()
            total += float(part.detach())
        denom = 3.0 * o.shape[0]
        return total / denom, p.grad / denom

    def steps(self, pos, o, d, target, n: int, lr: float):
        """``n`` Adam steps from ``pos``: ``(losses, first gradient,
        positions after the steps)``."""
        p = {"mesh_positions": pos.to(self.device, self.dtype)}
        state, losses, first = {}, [], None
        for _ in range(n):
            loss, g = self.value_and_grad(p["mesh_positions"], o, d, target)
            first = g if first is None else first
            losses.append(loss)
            p = adam(p, {"mesh_positions": g}, state, lr)
        return np.asarray(losses), first, p["mesh_positions"]
