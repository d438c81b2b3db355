"""The metric arithmetic on synthetic profiler events and latencies."""

import numpy as np
import pytest

from raybench import run, trace as trc
from raybench.drivers.frames import Driver


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    return [
        _ev("cuda_runtime", "cudaEventRecord", 100.0, 20.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 105.0, 5.0),
        _ev("kernel", "k1", 110.0, 20.0),      # 110-130
        _ev("kernel", "k2", 120.0, 20.0),      # overlaps: union 110-140
        _ev("gpu_memcpy", "Memcpy DtoH", 150.0, 10.0),
        _ev("cuda_runtime", "cudaStreamSynchronize", 140.0, 15.0),
        _ev("kernel", "k1", 190.0, 30.0),      # clipped at 200
        _ev("kernel", "outside", 300.0, 5.0),  # after the stretch
    ]


def test_idle_union_launches_and_gaps():
    """The stretch is the 100 us from the first event (100-200 us)."""
    s = trc.summarize(_events(), 100e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert trc.summarize([], 1.0)["busy_s"] == 0.0
    # 110-140, 150-160, 190-200
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["device_ops"] == 4
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(30e-6)
    assert "outside" not in ops
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 100-110 under the event record (innermost at 100: the launch
    # starts at 105)
    assert gaps["cudaEventRecord"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(10e-6)  # 140-150
    assert gaps["host: between calls"] == pytest.approx(30e-6)  # 160-190


def test_readers_on_a_summary():
    ctx = dict(config={"width": 4, "height": 2,
                       "yardstick": {"frame_fp32_ops": 6.7e9}},
               arrays={k: np.zeros(3, np.float32) for k in
                       ("mesh_verts", "tri_verts", "sph_center", "sph_r2",
                        "light_pos", "light_int")},
               spans={"bvh_prepare_s": 0.25},
               trace={"busy_s": 0.5, "window_s": 2.0, "device_ops": 1080,
                      "units": 10})
    assert run.reader("device_idle_share.frame")(ctx) == pytest.approx(0.75)
    assert run.reader("launches_per_frame")(ctx) == pytest.approx(108)
    # 6.7e9 ops at 67e12 / s = 0.1 ms against 50 ms busy a frame
    assert run.reader("frame_roofline")(ctx) == pytest.approx(0.2)
    assert run.reader("bvh_prepare_s")(ctx) == 0.25
    quiet = dict(ctx, trace=None, spans={}, config={"width": 4,
                                                   "height": 2})
    for m in ("device_idle_share.frame", "launches_per_frame",
              "frame_roofline", "bvh_prepare_s"):
        assert run.reader(m)(quiet) is None


def test_p95_over_all_frames_and_rate():
    d = Driver.__new__(Driver)
    d.config = {"render": {"max_bounces": 4}}
    d.w, d.h = 10, 10
    d.dep = {"lights": [0, 0, 0]}
    lat = list(np.linspace(0.001, 0.1, 100))
    e = d.end_to_end({"done": 100, "window_s": 2.0, "latencies": lat})
    assert e["frame_ms_p95"] == pytest.approx(
        1e3 * np.percentile(lat, 95))
    assert e["rays_per_s"] == pytest.approx(100 * 5 * 4 * 100 / 2.0)
