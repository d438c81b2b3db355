"""A run with the timed path broken underneath comes out not correct.

Each case skips the harness's look for a card and drives the rest of a
run (set-up, window, sample, reference, result) on the CPU at a tiny
size, with the program's output altered where it is produced: every
frame's colours scaled by 0.9, or half of each frame's rows left out
(black). A sound run of the same cell comes out correct."""

import time

import pytest
import torch

from raybench import run

from conftest import FITS, tiny_spec


def _scaled(img):
    return img * 0.9


def _half(img):
    out = img.clone()
    out[: img.shape[0] // 2] = 0.0
    return out


def _break(fault):
    def hook(drv):
        render = drv._render
        drv._render = lambda *a, **k: fault(render(*a, **k))
    return hook


@pytest.mark.parametrize("fault", [None, _scaled, _half],
                         ids=["sound", "scaled", "half_rows"])
def test_broken_path_is_not_correct(cell_name, fault):
    spec = tiny_spec(cell_name)
    res = run.execute(spec, 2 ** 31 + 99, 0.3, False, "cpu",
                      time.perf_counter(),
                      driver_hook=None if fault is None else _break(fault))
    assert list(res)[-1] == "checks"
    assert {k: c["limit"] for k, c in res["checks"].items()} == \
        spec["cell"]["check"]["limits"]
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] > 0


def test_trace_run_reports_per_layer_and_breakdown(cell_name):
    spec = tiny_spec(cell_name)
    res = run.execute(spec, 11, 0.4, True, "cpu", time.perf_counter())
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card: no device metric is read from a CPU run
    assert "device_idle_share.frame" not in res["metrics"]
    assert "launches_per_frame" not in res["metrics"]


class _NoStep(torch.optim.Adam):
    def step(self, closure=None):   # the state comes back unchanged
        return None


def _half_batch(drv):
    """The loss and gradient over the first half of the image's lanes
    only, the mean taken over that half: the lane weights of both the
    composed and the replay path zeroed on the second half."""
    fitmod = drv.fitmod
    weights = fitmod._lane_weights

    def half(cam, rcfg, dev):
        w = weights(cam, rcfg, dev).clone()
        w[w.shape[0] // 2:] = 0.0
        return w

    fitmod._lane_weights = half
    return weights


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
@pytest.mark.parametrize("name", FITS)
def test_broken_fit_is_not_correct(name, fault, monkeypatch):
    spec = tiny_spec(name, 40, 24)
    saved = {}

    def hook(drv):
        if fault == "unchanged":
            monkeypatch.setattr(drv.fitmod.torch.optim, "Adam", _NoStep)
        elif fault == "half_batch":
            saved["weights"] = _half_batch(drv)
            saved["mod"] = drv.fitmod

    try:
        res = run.execute(spec, 2 ** 31 + 7, 0.2, False, "cpu",
                          time.perf_counter(), driver_hook=hook)
    finally:
        if saved:
            saved["mod"]._lane_weights = saved["weights"]
    assert res["correct"] is (fault is None), res["checks"]
    assert "fit_step_s" in res["metrics"]
