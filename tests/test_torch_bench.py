"""The port's benchmark harness (``unity_raytracer_tpu_torch/bench.py``)
against the twin's (the repo-root ``bench.py``), on the CPU.

* ``count_rays`` equals the twin's on a grid of frames;
* ``run_once`` on ``mesh10k`` at 16x16, depth 1, with gradients, has the
  twin's record keys (the twin's ``run_once`` on the same arguments, run
  here on JAX's CPU backend) plus ``fp32_ops_per_s_measured``, none of
  the ``vs_baseline`` keys, and the twin's live-ray count;
* ``tree_truncated`` on a 16x16 ``cornell_box`` equals JAX
  ``trace_radiance_tree_stats``' count;
* ``run_sharded`` on 2 gloo processes gives a row for 1 and 2 devices;
* the ``bench`` CLI with ``--device cpu`` prints the JSON line with the
  twin's keys less ``vs_baseline*`` and plus the port's four, and without
  a card and without ``--device cpu`` it exits non-zero, as
  ``python -m unity_raytracer_tpu_torch.bench`` does.

On a card (``gpu``): ``run_once`` on a small ``mesh10k`` frame on the
fused kernel fills every field, the compute roofline included.
"""

import json
import math
import sys

import numpy as np
import pytest
import torch

from torch_parity import cuda  # noqa: F401  (fixture)
from unity_raytracer_tpu_torch import bench

# the twin's final line (bench.py:478-503), less vs_baseline*
TWIN_LINE = ("metric", "value", "unit", "rays_per_s_fwd",
             "rays_per_s_fwd_bwd", "rays_per_s_fwd_bwd_composed",
             "rays_per_s_fwd_bwd_soft", "rays_per_s_live", "frame_s",
             "grad_s", "grad_composed_s", "grad_soft_s",
             "fraction_of_hbm_roofline", "fraction_of_compute_roofline",
             "fraction_of_compute_roofline_fwd_bwd",
             "fraction_of_compute_roofline_fwd_bwd_soft", "kernel")
PORT_LINE = ("device", "rays_live", "compute_model_gflop_frame",
             "fp32_ops_per_s_measured")
SMALL = dict(width=16, height=16, max_bounces=1, repeats=1)


def _twin():
    """The repo-root harness (JAX, imported here only)."""
    import bench as twin_bench
    return twin_bench


@pytest.fixture(scope="module")
def twin_record():
    return _twin().run_once("mesh10k", grad=False, **SMALL)


@pytest.fixture(scope="module")
def port_record():
    return bench.run_once("mesh10k", grad=True, device="cpu", **SMALL)


@pytest.mark.parametrize("depth,width,height,lights", [
    (4, 1920, 1080, 3), (0, 16, 16, 0), (1, 16, 16, 3), (4, 512, 512, 2),
    (2, 33, 17, 1), (4, 1024, 1024, 3)])
def test_count_rays_equals_twin(depth, width, height, lights):
    assert bench.count_rays(depth, width, height, lights) == \
        _twin().count_rays(depth, width, height, lights)


def test_run_once_has_the_twin_keys(twin_record, port_record):
    assert set(port_record) == set(twin_record) | {"fp32_ops_per_s_measured"}
    assert not any(k.startswith("vs_baseline") for k in port_record)
    r = port_record
    assert r["device"] == "cpu" and r["kernel"] == "auto"
    assert r["rays_issued"] == twin_record["rays_issued"] == 16 * 16 * 2 * 4
    for k in ("frame_s", "grad_s", "grad_composed_s", "rays_per_s_fwd",
              "rays_per_s_fwd_bwd", "rays_per_s_fwd_bwd_composed"):
        assert math.isfinite(r[k]) and r[k] > 0, k
    # no fused kernel on the CPU: the composed step is the gradient number,
    # and no HBM or FP32 figure is assumed for the CPU
    assert r["grad_s"] == r["grad_composed_s"] and r["grad_soft_s"] is None
    assert all(r[k] is None for k in r if k.startswith("fraction_"))
    assert r["fp32_ops_per_s_measured"] is None


def test_run_once_live_rays_equal_twin(twin_record, port_record):
    assert isinstance(port_record["rays_live"], int)
    assert port_record["rays_live"] == twin_record["rays_live"] > 0


def test_tree_truncated_equals_jax():
    from unity_raytracer_tpu.models.camera import generate_rays_blocks
    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops.render import (
        resolve_mode, trace_radiance_tree_stats)
    scene, cam, cfg = get_preset("cornell_box", width=16, height=16)
    cfg = resolve_mode(scene, cfg.with_(use_bvh=True))
    o, d = generate_rays_blocks(cam, cfg.block_size)
    _, n_jax = trace_radiance_tree_stats(scene, o, d, cfg, bvh=None)
    r = bench.run_once("cornell_box", width=16, height=16, repeats=1,
                       grad=False, device="cpu")
    assert r["tree_truncated"] == int(np.asarray(n_jax))
    assert r["rays_live"] is None and r["lights"] == 2


def test_run_sharded_two_gloo_processes():
    out = bench.run_sharded("mesh10k", width=16, height=16, repeats=1,
                            device="cpu", world=2)
    rows = out["table"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["frame_s"] > 0 and r["rays_per_s"] > 0 for r in rows)
    assert out["value"] == rows[-1]["efficiency"]
    assert out["metric"] == "scaling_efficiency_mesh10k"
    assert "vs_baseline" not in out and out["device"] == "cpu"


def test_cli_bench_on_the_cpu(monkeypatch, capsys):
    from unity_raytracer_tpu_torch.__main__ import main
    monkeypatch.setattr(sys, "argv", [
        "unity_raytracer_tpu_torch", "bench", "--preset", "mesh10k",
        "--width", "16", "--height", "16", "--repeats", "1", "--no-grad",
        "--device", "cpu"])
    main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(TWIN_LINE) | set(PORT_LINE)
    assert line["metric"] == "rays_per_s_mesh10k" and line["value"] > 0
    assert line["device"] == "cpu" and line["rays_live"] > 0


@pytest.mark.parametrize("entry", ["cli", "module"])
def test_bench_without_a_card_exits_nonzero(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "cli":
        from unity_raytracer_tpu_torch.__main__ import main
        monkeypatch.setattr(sys, "argv", ["unity_raytracer_tpu_torch",
                                          "bench", "--preset", "mesh10k"])
        run = main
    else:
        run = lambda: bench.main(["--preset", "mesh10k"])
    with pytest.raises(SystemExit) as e:
        run()
    assert e.value.code not in (0, None)


@pytest.mark.gpu
def test_run_once_on_card_fills_every_field(cuda):
    r = bench.run_once("mesh10k", width=64, height=64, repeats=2,
                       device=cuda)
    assert r["kernel"] == "mega"
    for k, v in r.items():
        if k != "tree_truncated":
            assert v is not None, k
    assert 0 < r["fraction_of_hbm_roofline"] <= 1.05
    assert 0 < r["fraction_of_compute_roofline"] <= 1.05
    assert r["fp32_ops_per_s_measured"] > 1e12
