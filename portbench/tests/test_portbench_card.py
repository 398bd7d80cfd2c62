"""On the card: one short run of each cell, correct, with its metrics.
Skips where there is no CUDA device (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from portbench.harness.main import ROOT, cell_metrics
from portbench.tests.test_portbench_cells import CELLS, SPEC


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed", "2147483747",
         "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell_metrics(SPEC, name, False)}
    assert result["device"]["platform"] == "gpu"


def test_run_refuses_without_enough_cards():
    """Without a CUDA device (or with too few) a run exits non-zero and
    prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
