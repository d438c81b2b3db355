"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files plus entries in BENCHMARK.json, with no edit to a file that
is there; and the guard that keeps JAX out of a run."""

import json
import shutil
import sys

import pytest

from raybench import guard, run

from conftest import ROOT


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "raybench", tmp_path / "raybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "raybench"
    conf = json.loads((here / "configs" / "mesh100k.json").read_text())
    conf["name"], conf["width"], conf["height"] = "mesh100k_small", 64, 48
    (here / "configs" / "mesh100k_small.json").write_text(json.dumps(conf))
    mix = json.loads((here / "traffic" / "orbit.json").read_text())
    mix["cameras"] = 8
    (here / "traffic" / "orbit8.json").write_text(json.dumps(mix))
    (here / "cells" / "mesh100k_small.orbit8.json").write_text(
        (here / "cells" / "mesh100k.frame.json").read_text())
    (here / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return ctx['trace']['units']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="mesh100k_small",
                                 file="raybench/configs/mesh100k_small.json"))
    bench["workloads"].append({"name": "mesh100k_small.orbit8",
                               "config": "mesh100k_small",
                               "traffic": "orbit8", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "rays_per_s",
                               "workloads": ["mesh100k_small.orbit8"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("rays_per_s", "frame_ms_p95"):
            m["workloads"].append("mesh100k_small.orbit8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = run.cell_spec("mesh100k_small.orbit8", root=tmp_path)
    assert spec["config"]["width"] == 64
    assert spec["traffic"]["cameras"] == 8
    assert [m["name"] for m in spec["per_layer"]] == ["frames_traced"]
    assert [m["name"] for m in spec["end_to_end"]] == [
        "rays_per_s", "frame_ms_p95", "setup_s"]
    assert run.reader("frames_traced", root=tmp_path)(
        {"trace": {"units": 7}}) == 7
    # the cells already there are unchanged
    assert run.cell_spec("mesh100k.frame", root=tmp_path)["config"] == \
        run.cell_spec("mesh100k.frame")["config"]


def test_every_cell_and_metric_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        spec = run.cell_spec(w["name"])
        for m in spec["per_layer"]:
            assert callable(run.reader(m["name"]))
        assert spec["end_to_end"], w["name"]
        assert any(m["name"] == "setup_s" for m in spec["end_to_end"])


def test_a_missing_port_or_cell_is_refused(tmp_path):
    with pytest.raises(run.SpecError):
        run.check_port(tmp_path)
    with pytest.raises(run.SpecError):
        run.cell_spec("no.such.cell")


def test_no_card_no_result(capsys):
    # the sandbox has no CUDA card: the run refuses and prints no result
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", "mesh100k.frame", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert guard.forbidden_modules(
        ["unity_raytracer_tpu_torch.ops", "jaxtyping", "torch"]) == []
    assert guard.forbidden_modules(
        ["unity_raytracer_tpu.ops.render", "jax.numpy", "jaxlib",
         "flax.linen"]) == ["flax", "jax", "jaxlib", "unity_raytracer_tpu"]
    assert guard.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(guard.ForbiddenModules, match="jax"):
        guard.check()
