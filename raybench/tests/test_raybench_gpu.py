"""On the card: a short run of every cell, correct, with its metrics.
Skips where there is no CUDA card (decided inside the test)."""

import json

import pytest

from raybench import run


@pytest.mark.gpu
def test_cells_run_on_the_card(capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        for trace in ("0", "1"):
            assert run.main(["--workload", w["name"], "--seed", "5",
                             "--seconds", "3", "--trace", trace]) == 0
            res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert res["correct"] is True, res
            assert res["metrics"]
