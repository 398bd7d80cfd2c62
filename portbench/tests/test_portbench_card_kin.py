"""On the card: a short traced run of the omni and Ackermann cell,
correct, with every program span's metric, the sweep's roofline share
and the dead-sample share of its grid. Skips where there is no CUDA
device (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from portbench.harness.main import ROOT, cell_metrics
from portbench.tests.test_portbench_cells import SPEC

CELL = "omniack256.k8"


@pytest.mark.cuda
def test_the_omni_ackermann_cell_runs_correct_with_its_metrics():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "2147485125",
         "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    metrics = result["metrics"]
    spans = {m["name"] for m in cell_metrics(SPEC, CELL, True) if m["source"] == "program_span"}
    assert len(spans) == 7 and spans <= set(metrics)
    assert metrics["dead_sample_pct"]["value"] == pytest.approx(100 * 128 * 602 / (256 * 1978),
                                                                abs=1e-6)
    assert 0.0 < metrics["sweep_roofline_pct"]["value"] <= 105.0
