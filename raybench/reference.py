"""The plain reference: a Whitted ray tracer in plain PyTorch, by brute force.

It decides ``correct`` and imports nothing of the program. It takes the
benchmark's deployment arrays (``scene.arrays``) and camera numbers and
works out everything else itself: triangle normals, camera rays, nearest
hits, shadows, shading, mirror continuations and the dielectric tree.

Semantics (the baseline renderer's, RayTracingSetup.cs of the Unity
reference, with the dielectric extension):

* primary rays through pixel centres of an image plane ``dist`` ahead of
  the camera, ``half_h`` x ``half_v`` half extents, pixel (0, 0) top left;
* nearest hit over mesh triangles, then spheres, then loose triangles,
  a later category winning only when strictly nearer; Möller–Trumbore
  with the reference's rejects (|det| < 1e-5, u or v outside, t <= 1e-5),
  spheres by the half-b quadratic (the smallest root >= 0);
* shading normals: a sphere's from its centre, a loose triangle's
  ``cross(v2 - v0, v1 - v0)`` normalised, a mesh triangle's the negation
  of that (the reference's mesh bake); never flipped toward the viewer;
* local colour: ``ambient_m * ambient`` plus, per light facing the normal
  (``l.n >= 0``) and unshadowed, ``kd (l.n) I / r^2`` and Blinn-Phong
  ``ks (n.h)^phong I / r^2`` (0 where ``n.h <= 0``); a shadow ray leaves
  ``p + 1e-4 n`` toward the light, which it reaches unless an occluder is
  nearer (``t^2 < r^2``); a miss shows the background (x 255);
* a mirror hit spawns the reflected ray from ``p + 1e-4 n`` with weight
  ``mirror``; a dielectric hit spawns a reflected child (weight ``F T``)
  and, without total internal reflection, a refracted one (``(1 - F)
  T``, from ``p - 1e-4 n_eff``), ``F`` Schlick's; ``max_bounces`` levels
  after the primary one, the last shading only. No lane is dropped.

Radiance is on the 0-255 scale. ``dtype`` runs the whole computation in
another precision (the control runs it in bfloat16); the culling of mesh
chunks, which only skips triangles a ray cannot meet, stays float32.

Mesh triangles are tested in chunks of ``CHUNK`` consecutive triangles
(spatially compact on these meshes), each with a bounding sphere: a ray
tests a chunk's triangles only where it meets that sphere, grown by a
margin. That is exact: every hit lies on a triangle inside its sphere.
"""

from __future__ import annotations

import numpy as np
import torch

EPS_TRI = 1e-5
SHADOW_EPS = 1e-4
CHUNK = 256
PAIRS = 1 << 16       # (ray, chunk) pairs tested at once
CULL = 1 << 15        # rays whose chunk spheres are tested at once
INF = float("inf")
NONE, MESH, SPHERE, TRI = 0, 1, 2, 3
MAT_FIELDS = ("diffuse", "ambient", "mirror", "specular", "phong",
              "is_mirror", "transparency", "ior", "is_dielectric")


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normalize(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def _mt(o, d, v0, e1, e2):
    """Möller–Trumbore distances (+inf on a reject) of broadcast rays and
    triangles ``v0, e1 = v1 - v0, e2 = v2 - v0``."""
    h = _cross(d, e2)
    a = _dot(e1, h)
    parallel = a.abs() < EPS_TRI
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = o - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    miss = (parallel | (u < 0) | (u > 1) | (v < 0) | (u + v > 1)
            | (t <= EPS_TRI))
    return torch.where(miss, torch.full_like(t, INF), t)


def _first_min(t):
    """(min over the last axis, first index of it); -1 where all +inf."""
    tmin, idx = t.min(dim=-1)
    return tmin, torch.where(torch.isfinite(tmin), idx, -1)


class Reference:
    """The deployment on ``device`` in ``dtype``; ``trace`` renders rays."""

    def __init__(self, arrays: dict, max_bounces: int, device,
                 dtype=torch.float32):
        self.dtype, self.device, self.depth = dtype, device, max_bounces
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device).to(dtype)
        self.mat = {k: (torch.as_tensor(arrays["mat_" + k], device=device)
                        if k.startswith("is_") else f(arrays["mat_" + k]))
                    for k in MAT_FIELDS}
        self.bg = f(arrays["background"]) * 255.0
        self.ambient = f(arrays["ambient"])
        self.light_pos, self.light_int = (f(arrays["light_pos"]),
                                          f(arrays["light_int"]))
        self.sph_c, self.sph_r2 = f(arrays["sph_center"]), f(arrays["sph_r2"])
        lng = lambda a: torch.as_tensor(a, device=device, dtype=torch.long)
        self.sph_m, self.tri_m = lng(arrays["sph_mat"]), lng(arrays["tri_mat"])
        self.mesh_m = lng(arrays["mesh_mat"])
        tv = f(arrays["tri_verts"])
        self.tri = (tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        self.tri_n = _normalize(_cross(self.tri[2], self.tri[1]))
        mv = np.asarray(arrays["mesh_verts"], np.float32)
        self.n_mesh = mv.shape[0]
        pad = (-self.n_mesh) % CHUNK    # zero triangles: always rejected
        mvp = np.concatenate([mv, np.zeros((pad, 3, 3), np.float32)])
        v = f(mvp)
        self.mesh_n = -_normalize(_cross(v[:, 2] - v[:, 0],
                                         v[:, 1] - v[:, 0]))
        c = lambda x: x.reshape(-1, CHUNK, 3)
        self.mesh = (c(v[:, 0]), c(v[:, 1] - v[:, 0]), c(v[:, 2] - v[:, 0]))
        # chunk spheres, float64 on the host, grown so rounding never culls
        pts = mvp.reshape(-1, CHUNK * 3, 3).astype(np.float64)
        cen = (pts.min(axis=1) + pts.max(axis=1)) / 2
        rad = np.sqrt(((pts - cen[:, None]) ** 2).sum(-1).max(axis=1))
        rad = rad * (1 + 1e-4) + 1e-4 * (1 + np.abs(cen).max(axis=1))
        self.chunk_c = torch.as_tensor(cen, dtype=torch.float32, device=device)
        self.chunk_r2 = torch.as_tensor(rad ** 2, dtype=torch.float32,
                                        device=device)

    # -- intersection -----------------------------------------------------
    def _mesh_nearest(self, o, d):
        """Nearest mesh triangle ``(t, index)`` per ray (+inf, -1: none)."""
        n = o.shape[0]
        key = torch.full((n,), torch.iinfo(torch.int64).max,
                         dtype=torch.int64, device=self.device)
        if self.n_mesh == 0 or n == 0:
            return torch.full((n,), INF, dtype=self.dtype,
                              device=self.device), key.new_full((n,), -1)
        o32, d32 = o.float(), d.float()
        rays, chunks = [], []
        for s in range(0, n, CULL):   # which chunk spheres each ray meets
            dd = _dot(d32[s:s + CULL], d32[s:s + CULL])[:, None]
            oc = o32[s:s + CULL, None, :] - self.chunk_c[None]
            b = _dot(d32[s:s + CULL, None, :], oc) / dd
            c2 = _dot(oc, oc) - self.chunk_r2[None]
            closest = c2 - b * b * dd
            meet = (c2 <= 0) | ((b <= 0) & (closest <= 0))
            r, k = meet.nonzero(as_tuple=True)
            rays.append(r + s)
            chunks.append(k)
        rays, chunks = torch.cat(rays), torch.cat(chunks)
        v0, e1, e2 = self.mesh
        for s in range(0, rays.shape[0], PAIRS):
            r, k = rays[s:s + PAIRS], chunks[s:s + PAIRS]
            t = _mt(o[r][:, None], d[r][:, None], v0[k], e1[k], e2[k])
            tmin, j = _first_min(t)
            bits = tmin.float().view(torch.int32).to(torch.int64)
            packed = torch.where(torch.isfinite(tmin),
                                 (bits << 32) | (k * CHUNK + j),
                                 torch.iinfo(torch.int64).max)
            key.scatter_reduce_(0, r, packed, reduce="amin")
        hit = key != torch.iinfo(torch.int64).max
        t = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32),
                        INF)
        idx = torch.where(hit, key & 0xFFFFFFFF, -1)
        return t.to(self.dtype), idx

    def _spheres(self, o, d, centers=None):
        c = self.sph_c if centers is None else centers
        if c.shape[0] == 0:
            t = torch.full((o.shape[0], 1), INF, dtype=self.dtype,
                           device=self.device)
            return _first_min(t)
        oc = o[:, None] - c[None]
        uoc = _dot(d[:, None], oc)
        disc = uoc * uoc - (_dot(oc, oc) - self.sph_r2[None])
        sq = torch.sqrt(torch.clamp_min(disc, 0))
        big, small = -uoc + sq, -uoc - sq
        t = torch.where(small < 0, big, small)
        return _first_min(torch.where((disc < 0) | (big < 0),
                                      torch.full_like(t, INF), t))

    def _tris(self, o, d):
        if self.tri[0].shape[0] == 0:
            t = torch.full((o.shape[0], 1), INF, dtype=self.dtype,
                           device=self.device)
            return _first_min(t)
        v0, e1, e2 = self.tri
        return _first_min(_mt(o[:, None], d[:, None], v0[None], e1[None],
                              e2[None]))

    def nearest(self, o, d, centers=None):
        """``(t, kind, index)``: mesh, then spheres, then loose triangles,
        a later category winning only when strictly nearer (``centers``
        in place of the spheres' own)."""
        t, idx = self._mesh_nearest(o, d)
        kind = torch.where(torch.isfinite(t), MESH, NONE)
        for code, (tc, ic) in ((SPHERE, self._spheres(o, d, centers)),
                               (TRI, self._tris(o, d))):
            upd = t > tc
            t = torch.where(upd, tc, t)
            kind = torch.where(upd, code, kind)
            idx = torch.where(upd, ic, idx)
        return t, kind, idx

    def occluder(self, o, d):
        """Distance to the nearest primitive of any category (+inf)."""
        return torch.minimum(torch.minimum(self._mesh_nearest(o, d)[0],
                                           self._spheres(o, d)[0]),
                             self._tris(o, d)[0])

    # -- shading ----------------------------------------------------------
    def _local(self, o, d):
        """Hit, surface and local colour of each ray: ``(colour [N,3],
        hit, p, n, material dict)``; a miss shows the background."""
        t, kind, idx = self.nearest(o, d)
        hit = kind != NONE
        i = idx.clamp_min(0)
        p = o + d * torch.where(hit, t, torch.ones_like(t))[:, None]

        def pick(table):   # the hit primitive's row of a category's table
            if table.shape[0] == 0:
                return table.new_zeros((p.shape[0],) + table.shape[1:])
            return table[i.clamp_max(table.shape[0] - 1)]

        n = torch.where((kind == SPHERE)[:, None],
                        _normalize(p - pick(self.sph_c)),
                        torch.where((kind == MESH)[:, None],
                                    pick(self.mesh_n), pick(self.tri_n)))
        m_id = torch.where(kind == SPHERE, pick(self.sph_m),
                           torch.where(kind == MESH, pick(self.mesh_m),
                                       pick(self.tri_m)))
        mat = {k: v[m_id] for k, v in self.mat.items()}
        colour = mat["ambient"] * self.ambient[None]
        v = -d
        for li in range(self.light_pos.shape[0]):
            lvec = self.light_pos[li][None] - p
            r2 = _dot(lvec, lvec)
            ldir = lvec / torch.sqrt(r2)[:, None]
            ln = _dot(ldir, n)
            need = hit & (ln >= 0)
            vis = torch.zeros_like(ln, dtype=torch.bool)
            q = need.nonzero(as_tuple=True)[0]
            if q.numel():
                so = p[q] + n[q] * SHADOW_EPS
                st = self.occluder(so, ldir[q])
                vis[q] = ~(st * st < r2[q])
            irr = self.light_int[li][None] / r2[:, None]
            diff = mat["diffuse"] * torch.clamp_min(ln, 0)[:, None] * irr
            hv = ldir + v
            hv = hv / torch.clamp_min(torch.sqrt(_dot(hv, hv)),
                                      1e-30)[:, None]
            nh = torch.clamp_min(_dot(n, hv), 0)
            spec_t = torch.where(nh > 0, torch.where(nh > 0, nh, 1.0)
                                 ** mat["phong"], 0.0)
            spec = mat["specular"] * spec_t[:, None] * irr
            colour = colour + (diff + spec) * vis[:, None].to(self.dtype)
        colour = torch.where(hit[:, None], colour, self.bg[None])
        return colour, hit, p, n, mat

    def trace(self, o, d):
        """Radiance [N,3] (float32, 0-255 scale) of rays ``o, d``."""
        n0 = o.shape[0]
        acc = torch.zeros((n0, 3), dtype=self.dtype, device=self.device)
        parent = torch.arange(n0, device=self.device)
        w = torch.ones((n0, 3), dtype=self.dtype, device=self.device)
        for level in range(self.depth + 1):
            if o.shape[0] == 0:
                break
            colour, hit, p, n, mat = self._local(o, d)
            acc.index_add_(0, parent, w * colour)
            if level == self.depth:
                break
            dn = _dot(d, n)
            entering = dn < 0
            n_eff = torch.where(entering[:, None], n, -n)
            die, mir = mat["is_dielectric"] & hit, mat["is_mirror"] & hit
            n_refl = torch.where(die[:, None], n_eff, n)
            r_d = d - 2.0 * n_refl * _dot(d, n_refl)[:, None]
            ior = mat["ior"]
            n1 = torch.where(entering, torch.ones_like(ior), ior)
            n2 = torch.where(entering, ior, torch.ones_like(ior))
            eta = n1 / n2
            cos_i = -_dot(d, n_eff)
            k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
            tir = k < 0
            t_d = (eta[:, None] * d + (eta * cos_i - torch.sqrt(
                torch.clamp_min(k, 0)))[:, None] * n_eff)
            r0 = (n1 - n2) / (n1 + n2)
            r0 = r0 * r0
            c = 1.0 - dn.abs()
            fres = torch.where(tir, torch.ones_like(c),
                               r0 + (1.0 - r0) * (c * ((c * c) * (c * c))))
            tr = mat["transparency"]
            w_refl = w * (mir[:, None].to(self.dtype) * mat["mirror"]
                          + die[:, None].to(self.dtype) * fres[:, None] * tr)
            w_refr = w * (die[:, None].to(self.dtype)
                          * (1.0 - fres)[:, None] * tr)
            keep_r = (mir | die) & (w_refl != 0).any(-1)
            keep_t = die & ~tir & (w_refr != 0).any(-1)
            o = torch.cat([(p + n_refl * SHADOW_EPS)[keep_r],
                           (p - n_eff * SHADOW_EPS)[keep_t]])
            d = torch.cat([r_d[keep_r], t_d[keep_t]])
            w = torch.cat([w_refl[keep_r], w_refr[keep_t]])
            parent = torch.cat([parent[keep_r], parent[keep_t]])
        return acc.float()


def camera_rays(cam: dict, width: int, height: int, px, py, device,
                dtype=torch.float32):
    """Rays through the centres of pixels ``(px, py)`` (integer arrays):
    ``(o [P,3], d [P,3])``. The basis is the camera's: right = forward x
    up, then up again = right x forward, each normalised."""
    f = np.asarray(cam["forward"], np.float32)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(cam["up"], np.float32))
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    u = u / np.linalg.norm(u)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                  device=device).to(dtype)
    pos, f, r, u = t(cam["position"]), t(f), t(r), t(u)
    hh, hv, dist = (t(cam["half_h"]), t(cam["half_v"]), t(cam["dist"]))
    top_left = pos + f * dist - r * hh + u * hv
    xs = (t(px) + 0.5) * (2.0 * hh / width)
    ys = (t(py) + 0.5) * (2.0 * hv / height)
    d = top_left[None] + xs[:, None] * r[None] - ys[:, None] * u[None] \
        - pos[None]
    return pos.expand(d.shape).contiguous(), _normalize(d)


class SoftFit:
    """The composed fit's loss and gradients, in plain PyTorch autograd.

    The fitted quantity is the pixel MSE (display scale) of a render
    whose forward value is the hard one above and whose gradient is that
    of its soft relaxation (straight through), as the inverse-rendering
    fit of the baseline defines it:

    * a ray that misses everything adopts a proxy hit on the sphere in
      front of it with the largest silhouette margin ``disc / r^2``
      (first of equals), at its point of closest approach; a ray's
      sphere hit or proxy is weighted by ``sigmoid(margin / hit_temp)``
      (the argument clamped to +-30), other hits by 1, and blends from
      the background toward its shading by that weight;
    * a shadow ray's visibility is ``sigmoid((t^2 - r^2) / shadow_temp)``
      for its nearest occluder at ``t`` (mesh occluders beyond the light
      do not count; spheres and loose triangles at any distance do);
    * a hit's ``t`` is re-derived differentiably on the winning primitive
      (Möller–Trumbore for triangles, the quadratic for spheres), the
      search itself carries no gradient.

    ``value_and_grad`` takes the sphere centres and diffuse colours as
    the parameters.

    ``replay=True`` gives the soft record-replay's semantics (the port's
    ``fit --replay``), which freeze what its records hold: a mesh
    occluder's distance on a shadow ray keeps its value and carries no
    gradient, and the shadow rays of a proxy hit (which the hard render
    never casts) see no mesh occluder. The forward value is the same."""

    def __init__(self, ref: Reference, hit_temp: float, shadow_temp: float,
                 replay: bool = False):
        self.ref, self.ht, self.st = ref, hit_temp, shadow_temp
        self.replay = replay
        a = ref
        mv = torch.cat([a.mesh[0].reshape(-1, 3), a.mesh[1].reshape(-1, 3),
                        a.mesh[2].reshape(-1, 3)], -1)
        self.mesh_rows = mv                  # [M', 9]: v0, e1, e2

    def _sphere_t(self, o, d, c, r2):
        """Differentiable sphere distances [N,S] (+inf on a miss)."""
        oc = o[:, None] - c[None]
        uoc = _dot(d[:, None], oc)
        disc = uoc * uoc - (_dot(oc, oc) - r2[None])
        pos = disc > 0
        sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
        big, small = -uoc + sq, -uoc - sq
        t = torch.where(small < 0, big, small)
        return torch.where((disc < 0) | (big < 0), INF, t)

    def _tri_t(self, o, d, rows):
        """Differentiable t of each ray against its own triangle row."""
        return _mt(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])

    def _mesh_t(self, o, d, idx, t_hard):
        rows = self.mesh_rows[idx.clamp_min(0)]
        t = self._tri_t(o, d, rows)
        return torch.where(idx < 0, INF, torch.where(torch.isfinite(t), t,
                                                     t_hard))

    def _loose_t(self, o, d):
        r = self.ref
        if r.tri[0].shape[0] == 0:
            return torch.full((o.shape[0],), INF, dtype=o.dtype,
                              device=o.device)
        return _mt(o[:, None], d[:, None], r.tri[0][None], r.tri[1][None],
                   r.tri[2][None]).amin(-1)

    def _segment(self, o, d, centers, diffuse):
        """Contribution [N,3] of one segment and its continuation."""
        r = self.ref
        n_ray = o.shape[0]
        r2 = r.sph_r2
        with torch.no_grad():
            t_h, kind, idx = r.nearest(o.detach(), d.detach(),
                                       centers.detach())
        hit = kind != NONE
        i = idx.clamp_min(0)
        t_s_all = self._sphere_t(o, d, centers, r2)
        t = torch.where(kind == SPHERE, t_s_all.gather(
            1, i.clamp_max(max(r2.shape[0] - 1, 0))[:, None])[:, 0]
            if r2.shape[0] else t_h, t_h)
        t = torch.where(kind == MESH, self._mesh_t(o, d, torch.where(
            kind == MESH, idx, -1), t_h), t)
        if r.tri[0].shape[0]:
            rows = torch.cat([r.tri[0], r.tri[1], r.tri[2]], -1)
            t_tri = self._tri_t(o, d, rows[i.clamp_max(rows.shape[0] - 1)])
            t = torch.where(kind == TRI, torch.where(
                torch.isfinite(t_tri), t_tri, t_h), t)
        # soft silhouettes: margins, the best sphere in front of each ray
        oc = o[:, None] - centers[None]
        uoc = _dot(d[:, None], oc)
        disc = uoc * uoc - (_dot(oc, oc) - r2[None])
        marg = disc / torch.clamp_min(r2, 1e-12)[None]
        marg = torch.where(-uoc > 0, marg, -INF)
        m_best, j_best = marg.max(dim=1)       # the first maximum
        t_close = torch.clamp_min(-uoc.gather(1, j_best[:, None])[:, 0],
                                  1e-3)
        proxy = ~hit & torch.isfinite(m_best)
        t = torch.where(proxy, t_close, t)
        kind = torch.where(proxy, SPHERE, kind)
        i = torch.where(proxy, j_best, i)
        shade = hit | proxy
        win = hit & (kind == SPHERE)
        own = marg.gather(1, i.clamp_max(max(r2.shape[0] - 1, 0))[:, None])[:, 0]
        msel = torch.where(win | proxy, own, INF)
        w_soft = torch.sigmoid(torch.clamp(msel / self.ht, -30.0, 30.0))
        w = w_soft + (hit.to(o.dtype) - w_soft).detach()
        p = o + d * torch.where(shade, t, 1.0)[:, None]

        def pick(table):
            if table.shape[0] == 0:
                return table.new_zeros((n_ray,) + table.shape[1:])
            return table[i.clamp_max(table.shape[0] - 1)]

        sn = p - pick(centers)
        sn = sn * (1.0 / torch.sqrt(torch.clamp_min(_dot(sn, sn), 0)))[:, None]
        n = torch.where((kind == SPHERE)[:, None], sn,
                        torch.where((kind == MESH)[:, None], pick(r.mesh_n),
                                    pick(r.tri_n)))
        m_id = torch.where(kind == SPHERE, pick(r.sph_m),
                           torch.where(kind == MESH, pick(r.mesh_m),
                                       pick(r.tri_m)))
        diff_table = r.mat["diffuse"].index_put((r.sph_m,), diffuse)
        mat = {k: v[m_id] for k, v in r.mat.items()}
        mat["diffuse"] = diff_table[m_id]
        colour = mat["ambient"] * r.ambient[None]
        v = -d
        for li in range(r.light_pos.shape[0]):
            lvec = r.light_pos[li][None] - p
            l2 = _dot(lvec, lvec)
            ldist = torch.sqrt(l2)
            ldir = lvec / ldist[:, None]
            ln = _dot(ldir, n)
            need = shade & (ln >= 0)
            q = need.nonzero(as_tuple=True)[0]
            vis = torch.ones_like(ln)
            if q.numel():
                so, sd = p[q] + n[q] * SHADOW_EPS, ldir[q]
                with torch.no_grad():
                    tm_h, im = r._mesh_nearest(so.detach(), sd.detach())
                    beyond = tm_h >= ldist[q].detach()
                im = torch.where(beyond, -1, im)
                if self.replay:
                    im = torch.where(proxy[q], -1, im)
                    tm = torch.where(im < 0, INF, tm_h)
                else:
                    tm = self._mesh_t(so, sd, im, tm_h)
                st = torch.minimum(tm,
                                   self._sphere_t(so, sd, centers, r2).amin(-1)
                                   if r2.shape[0] else INF)
                st = torch.minimum(st, self._loose_t(so, sd))
                fin = torch.isfinite(st)
                st0 = torch.where(fin, st, 0.0)
                marg_s = torch.where(fin, st0 * st0 - l2[q], INF)
                soft = torch.sigmoid(marg_s / self.st)
                hard = (~(st * st < l2[q])).to(o.dtype)
                vis = vis.index_put((q,), soft + (hard - soft).detach())
            irr = r.light_int[li][None] / l2[:, None]
            dif = mat["diffuse"] * torch.clamp_min(ln, 0)[:, None] * irr
            hv = ldir + v
            hv = hv / torch.clamp_min(torch.sqrt(_dot(hv, hv)), 1e-30)[:, None]
            nh = torch.clamp_min(_dot(n, hv), 0)
            pos = nh > 0
            spec_t = torch.where(pos, torch.where(pos, nh, 1.0)
                                 ** mat["phong"], 0.0)
            spec = (mat["specular"] * spec_t[:, None] * irr
                    * (ln >= 0).to(o.dtype)[:, None])
            colour = colour + (dif + spec) * torch.where(need, vis, 0.0)[:, None]
        local = torch.where(shade[:, None], colour, r.bg[None])
        contrib = r.bg[None] + w[:, None] * (local - r.bg[None])
        cont = hit & mat["is_mirror"]
        o1 = p + n * SHADOW_EPS
        d1 = d - 2.0 * n * _dot(d, n)[:, None]
        return contrib, cont, mat["mirror"], o1, d1

    def radiance(self, o, d, centers, diffuse, depth: int):
        """Radiance [N,3] (0-255 scale, differentiable) of the mirror
        chain of rays ``o, d`` to ``depth`` bounces."""
        contrib, cont, mirror, o1, d1 = self._segment(o, d, centers, diffuse)
        acc, thr = contrib, torch.ones_like(contrib)
        live = torch.arange(o.shape[0], device=o.device)
        for _ in range(depth):
            q = cont.nonzero(as_tuple=True)[0]
            if q.numel() == 0:
                break
            thr, live = thr[q] * mirror[q], live[q]
            contrib, cont, mirror, o1, d1 = self._segment(
                o1[q], d1[q], centers, diffuse)
            acc = acc.index_add(0, live, thr * contrib)
        return acc

    def value_and_grad(self, centers, diffuse, o, d, target, depth: int,
                       chunk: int):
        """Pixel MSE (display scale) of the render of rays ``o, d`` against
        ``target`` [N,3], and its gradients w.r.t. ``centers`` and
        ``diffuse``; one backward per ``chunk`` rays."""
        c = centers.detach().clone().requires_grad_(True)
        k = diffuse.detach().clone().requires_grad_(True)
        total = 0.0
        for s in range(0, o.shape[0], chunk):
            rad = self.radiance(o[s:s + chunk], d[s:s + chunk], c, k, depth)
            part = ((rad / 255.0 - target[s:s + chunk]) ** 2).sum()
            part.backward()
            total += float(part.detach())
        denom = 3.0 * o.shape[0]
        return total / denom, c.grad / denom, k.grad / denom
