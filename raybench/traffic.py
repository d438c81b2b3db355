"""The general traffic generator: a mix's data file -> a seeded request stream.

A mix is ``raybench/traffic/<name>.json``. Its ``generator`` names one of
the kinds below, its ``driver`` the module under ``raybench/drivers``
that runs the cell, and the rest are the kind's parameters.

``orbit``: the camera orbits the configuration's ``orbit.center`` about
the vertical axis at the configuration camera's distance, height and
field of view. The mix fixes ``cameras`` yaws spaced evenly over
``+-orbit.yaw_deg``; every seed gets that same set of frames, in its own
order: a fresh seeded permutation for each pass over the set. So the
seed changes which frame follows which, and never the work of a pass.

``fit_start``: a fit's start, the true sphere centres moved by offsets
uniform in ``+-center_noise`` and the true diffuse colours by offsets
uniform in ``+-diffuse_noise`` (the driver clamps colours to [0, 1]).
"""

from __future__ import annotations

import math

import numpy as np

KINDS = ("orbit", "fit_start")


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use (``stream``) of ``seed``; any
    whole number, however large, is a seed."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def orbit_cameras(traffic: dict, config: dict, base: dict) -> list:
    """The mix's fixed set of camera parameter dicts (``base`` rotated by
    each yaw about ``config['orbit']['center']``)."""
    if traffic["generator"] != "orbit":
        raise ValueError(f"mix generator {traffic['generator']!r} is not "
                         f"orbit; the kinds are {KINDS}")
    n = int(traffic["cameras"])
    amp = float(config["orbit"]["yaw_deg"])
    c = np.asarray(config["orbit"]["center"], np.float64)
    p = np.asarray(base["position"], np.float64)
    f = np.asarray(base["forward"], np.float64)
    out = []
    for yaw in np.linspace(-amp, amp, n):
        a = math.radians(yaw)
        rot = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                        [-math.sin(a), 0.0, math.cos(a)]])
        out.append(dict(base, yaw_deg=float(yaw),
                        position=[float(x) for x in c + rot @ (p - c)],
                        forward=[float(x) for x in rot @ f]))
    return out


def fit_start(traffic: dict, n_spheres: int, seed: int) -> dict:
    """The seeded offsets of a fit's start: ``sphere_centers`` and
    ``sphere_diffuse``, [n_spheres, 3] float64 each."""
    if traffic["generator"] != "fit_start":
        raise ValueError(f"mix generator {traffic['generator']!r} is not "
                         f"fit_start")
    r = rng(seed, 4)
    shape = (int(n_spheres), 3)
    return {"sphere_centers": r.uniform(-traffic["center_noise"],
                                        traffic["center_noise"], shape),
            "sphere_diffuse": r.uniform(-traffic["diffuse_noise"],
                                        traffic["diffuse_noise"], shape)}


class Order:
    """Indices into the camera set, from ``seed``: one seeded permutation
    of the whole set per pass."""

    def __init__(self, n: int, seed: int):
        self.n, self._rng, self._perm, self._i = n, rng(seed, 1), None, n

    def __next__(self) -> int:
        if self._i == self.n:
            self._perm, self._i = self._rng.permutation(self.n), 0
        self._i += 1
        return int(self._perm[self._i - 1])

    def __iter__(self):
        return self


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from ``seed`` (Vitter's algorithm R): the frames whose output
    is checked once the window has closed."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen, self._rng = k, [], 0, rng(seed, 2)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self._rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
