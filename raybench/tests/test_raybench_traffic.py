"""The traffic generator: the same seed gives the same stream, other seeds
other orders of the same frames."""

import numpy as np

from raybench import run, scene as scn, traffic as trf

BIG = 2 ** 31 + 12345


def _cams(name):
    spec = run.cell_spec(name)
    return trf.orbit_cameras(spec["traffic"], spec["config"],
                             scn.camera(spec["config"]))


def _order(seed, n=64, k=200):
    o = trf.Order(n, seed)
    return [next(o) for _ in range(k)]


def test_same_seed_same_stream(cell_name):
    assert _cams(cell_name) == _cams(cell_name)
    assert _order(BIG) == _order(BIG)
    assert _order(7) == _order(7)


def test_other_seed_other_order_same_frames():
    a, b = _order(BIG), _order(BIG + 1)
    assert a != b
    # every pass over the 64 cameras holds each exactly once
    for s in (a, b):
        for p in range(len(s) // 64):
            assert sorted(s[64 * p:64 * (p + 1)]) == list(range(64))


def test_orbit_keeps_distance_height_and_range(cell_name):
    spec = run.cell_spec(cell_name)
    conf = spec["config"]
    cams = _cams(cell_name)
    c = np.asarray(conf["orbit"]["center"])
    base = np.asarray(conf["camera"]["position"], float)
    r0 = np.linalg.norm((base - c)[[0, 2]])
    yaws = [p["yaw_deg"] for p in cams]
    assert len(cams) == spec["traffic"]["cameras"]
    assert np.isclose(min(yaws), -conf["orbit"]["yaw_deg"])
    assert np.isclose(max(yaws), conf["orbit"]["yaw_deg"])
    for p in cams:
        pos = np.asarray(p["position"])
        assert np.isclose(np.linalg.norm((pos - c)[[0, 2]]), r0)
        assert np.isclose(pos[1], base[1])


def test_reservoir_is_seeded_and_uniform():
    def draw(seed):
        r = trf.Reservoir(3, seed)
        for i in range(1000):
            r.offer(i)
        return r.items
    assert draw(BIG) == draw(BIG)
    assert draw(BIG) != draw(BIG + 1)
    counts = np.zeros(10)
    for s in range(2000):
        for i in draw(s):
            counts[i // 100] += 1
    assert counts.min() > 0.8 * counts.mean()


def test_negative_and_huge_seeds():
    assert _order(-5) != _order(5)
    assert len(_order(2 ** 63 + 1)) == 200
