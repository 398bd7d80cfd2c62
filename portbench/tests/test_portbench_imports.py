"""Nothing the benchmark runs loads JAX or the JAX package; the reference
imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.harness.main import BENCH, ROOT, forbidden_modules

PROBE = """
import sys
sys.path.insert(0, {root!r})
import portbench.harness.main as M
import portbench.systems.fleet, portbench.systems.fleet_judge
import portbench.scenes.disc, portbench.scenes.peer
import portbench.harness.trace, portbench.control, portbench.roofline
import portbench.metrics.step_mfu
import kompass_core_tpu_torch.parallel.fleet_v2
print(M.forbidden_modules())
"""


def test_harness_and_port_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True, cwd=str(ROOT)).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kompass_core_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kompass_core_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert forbidden_modules() == ["jax", "kompass_core_tpu"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert set(imported_roots(path)) <= {"math", "numpy", "torch"}, path


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        roots = set(imported_roots(path))
        assert not roots & {"jax", "jaxlib", "flax", "kompass_core_tpu"}, path
