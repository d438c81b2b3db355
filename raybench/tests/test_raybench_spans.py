"""The by-span reductions (``raybench/spans.py``) on a small synthetic trace,
and the span tool's run on the CPU.

The stretch is 100-200 us of trace time (``window_s`` 100 us from the
first event). Spans, recorded in ns after ``BASE``: ``render`` 103-199
over ``chain.segment`` 104-131, ``chain.sync`` 139.5-161,
``chain.segment`` 165-180 and ``tree.sync`` 181-185; ``late`` 195-260,
outermost, clipped to 200. Device activity: k1 110-130 (launched at
105), k2 135-140 (132), a copy 150-155 (140), a set 150-152 with no
runtime call, k3 190-230 (170, clipped), k4 300-310 (250, after the
stretch). A synchronize call 141-160."""

import numpy as np
import pytest

from raybench import spans

from conftest import tiny_spec

BASE = 10 ** 15


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("cuda_runtime", "cudaEventRecord", 100.0, 2.0),
    _x("cuda_runtime", "cudaLaunchKernel", 105.0, 5.0, 1),
    _x("kernel", "k1", 110.0, 20.0, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 132.0, 3.0, 2),
    _x("kernel", "k2", 135.0, 5.0, 2),
    _x("cuda_runtime", "cudaMemcpyAsync", 140.0, 1.0, 3),
    _x("gpu_memcpy", "Memcpy DtoH", 150.0, 5.0, 3),
    _x("gpu_memset", "Memset", 150.0, 2.0, 99),
    _x("cuda_runtime", "cudaStreamSynchronize", 141.0, 19.0),
    _x("cuda_runtime", "cudaLaunchKernel", 170.0, 4.0, 4),
    _x("kernel", "k3", 190.0, 40.0, 4),
    _x("cuda_runtime", "cudaLaunchKernel", 250.0, 4.0, 5),
    _x("kernel", "k4", 300.0, 10.0, 5),
]


def _span(i, name, a, z, parent=None):
    return {"name": name, "id": i, "parent": parent,
            "unit": 0 if parent is not None or i == 0 else i,
            "start_ns": BASE + int(a * 1e3), "end_ns": BASE + int(z * 1e3),
            "attrs": {}}


SPANS = [_span(1, "chain.segment", 104, 131, 0),
         _span(2, "chain.sync", 139.5, 161, 0),
         _span(3, "chain.segment", 165, 180, 0),
         _span(4, "tree.sync", 181, 185, 0),
         _span(0, "render", 103, 199),
         _span(5, "late", 195, 260)]


def _reduced():
    return spans.reduce(EVENTS, BASE, 100e-6, SPANS, 1)


def test_idle_gaps_by_span_partition_the_idle_time():
    red = _reduced()
    idle = dict(red["idle_gaps_by_span"])
    # gaps 100-110 (no span yet), 130-135 (inside the first segment),
    # 140-150 and 155-190 (both start inside chain.sync)
    assert idle == pytest.approx({spans.OUTSIDE: 10e-6,
                                  "chain.segment": 5e-6,
                                  "chain.sync": 45e-6})
    busy = 20 + 5 + 5 + 10           # 110-130, 135-140, 150-155, 190-200
    assert sum(idle.values()) == pytest.approx((100 - busy) * 1e-6,
                                               abs=1e-12)


def test_launches_match_through_correlation_within_the_stretch():
    red = _reduced()
    assert dict(red["launches_by_span"]) == {
        "chain.segment": 2, "render": 1, "chain.sync": 1,
        spans.OUTSIDE: 1}           # the set with no runtime call
    per = red["per_span"]
    assert per[1]["device_us"] == pytest.approx(20.0)
    assert per[3]["device_us"] == pytest.approx(10.0)   # clipped at 200
    halves = spans.reduce(EVENTS, BASE, 100e-6, SPANS, 2)
    assert dict(halves["launches_by_span"])["chain.segment"] == 1


def test_host_self_time_less_children_and_synchronize_calls():
    host = dict(_reduced()["host_self_s_by_span"])
    assert host == pytest.approx({
        "render": (96 - 27 - 21.5 - 15 - 4) * 1e-6,
        "chain.sync": (21.5 - 19) * 1e-6,
        "chain.segment": (27 + 15) * 1e-6,
        "tree.sync": 4e-6,
        "late": 5e-6})              # clipped at the stretch's end


def test_metrics_from_the_reduction():
    red = _reduced()
    # 82 us of host time over the 4 launches inside spans
    assert spans.host_us_per_launch(red) == pytest.approx(20.5)
    assert spans.host_us_per_launch(red, ("late",)) == pytest.approx(19.25)
    assert spans.host_us_per_launch(red, ("chain.sync",)) == \
        pytest.approx((82 - 2.5) / 3)
    assert spans.host_us_per_launch(None) is None
    config = {"width": 4, "height": 2,
              "yardstick": {"frame_fp32_ops": 6.7e8}}
    arrays = {k: np.zeros(3, np.float32) for k in
              ("mesh_verts", "tri_verts", "sph_center", "sph_r2",
               "light_pos", "light_int")}
    # 10 us least time over 30 us of segment launches a frame
    assert spans.segment_roofline(red, config, arrays, 1) == \
        pytest.approx(100 / 3)
    assert spans.segment_roofline(red, {"width": 4, "height": 2}, arrays,
                                  1) is None
    assert spans.segment_roofline(red, config, arrays, 1,
                                  name="tree.fork") is None


def test_sync_margins():
    got = spans.sync_margins(EVENTS, BASE, SPANS, 100.0, 200.0)
    # chain.sync encloses the copy (0.5 us in) and the synchronize call
    # (1 us from either edge); tree.sync encloses none
    assert got == {"n": 2, "missing": 1, "worst_us": pytest.approx(1.0)}


def test_tree_live_lane_share():
    def c(name, value, unit, t):
        return {"name": name, "value": value, "span": None, "unit": unit,
                "t_ns": t}

    counts = ([c("tree.live", 100, 1, 10)]
              + [c("tree.lanes", 100, 1, 11 + i) for i in range(3)]
              + [c("tree.live", v, 1, 20 + i) for i, v in enumerate((30,
                                                                     120))]
              + [c("tree.lanes", 7, 2, 30), c("tree.lanes", 7, 2, 31),
                 c("tree.live", 7, 2, 30)]        # a level that kept all
              + [c("tree.lanes", 9, 3, 500), c("tree.live", 9, 3, 500)])
    # unit 1: live 100, 30, min(120, 100) over 300 lanes; unit 2 unpaired,
    # unit 3 after the stretch
    assert spans.tree_live_lane_share(counts, 0, 100) == \
        pytest.approx(230 / 300)
    assert spans.tree_live_lane_share(counts, 400, 600) == 1.0
    assert spans.tree_live_lane_share([], 0, 100) is None


def test_span_tool_on_the_cpu():
    """The tool's traced run of a tiny frame cell: the run's result, the
    three by-span lists and the live-lane share; no device metric."""
    from raybench.tools import span_trace
    res = span_trace.traced(tiny_spec("cornell_box.tree"), 2 ** 31 + 7, 0.4,
                            "cpu")
    assert res["correct"] is True and list(res)[-1] == "checks"
    assert {"idle_gaps_by_span", "launches_by_span",
            "host_self_s_by_span"} <= set(res["breakdown"])
    names = {k for k, _ in res["breakdown"]["host_self_s_by_span"]}
    assert {"render", "tree", "tree.fork", "tree.compact"} <= names
    assert set(res["span_metrics"]) == {"tree_live_lane_share"}
    assert 0 < res["span_metrics"]["tree_live_lane_share"] < 1
    assert res["span_checks"]["spans_per_unit"] > 0
    assert "render" in res["setup_spans_s"]
