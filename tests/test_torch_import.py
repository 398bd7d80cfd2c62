"""The port imports torch and never jax (or triton), and nothing of the JAX
package: checked in a fresh interpreter, since this test process has both
loaded already, and by a scan of the port's sources."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = Path(REPO) / "kompass_core_tpu_torch"
EXAMPLES = Path(REPO) / "examples_torch"
# the workflows that run on a device; the vision and offline demos are
# host workflows and take none
DEVICE_DEMOS = ("full_stack_demo", "dynamic_world_demo", "fleet_demo",
                "rtt_amortized_serving_demo", "aot_artifact_demo",
                "serving_restart_demo", "serving_mesh_shard_demo")
HOST_DEMOS = ("vision_follow_demo", "offline_pipeline_demo")

# `import kompass_core_tpu`, `import kompass_core_tpu.x`, `from
# kompass_core_tpu import ...`, `from kompass_core_tpu.x import ...`, and
# the same through importlib or __import__; `kompass_core_tpu_torch` is
# not matched
_JAX_PACKAGE_IMPORT = re.compile(
    r"(^\s*(import|from)\s+kompass_core_tpu(\.|\s|$)"
    r"|(import_module|__import__)\(\s*['\"]kompass_core_tpu(\.|['\"]))",
    re.MULTILINE,
)


def test_port_import_loads_no_jax_and_no_triton():
    code = (
        "import sys, torch\n"
        "import kompass_core_tpu_torch, kompass_core_tpu_torch.control\n"
        "import kompass_core_tpu_torch.ops, kompass_core_tpu_torch.models\n"
        "import kompass_core_tpu_torch.datatypes\n"
        "import kompass_core_tpu_torch.native, kompass_core_tpu_torch.utils\n"
        "import kompass_core_tpu_torch.utils.geometry\n"
        "import kompass_core_tpu_torch.utils.common\n"
        "import kompass_core_tpu_torch.models.footprint\n"
        "import kompass_core_tpu_torch.parallel\n"
        "import kompass_core_tpu_torch.parallel.fleet\n"
        "import kompass_core_tpu_torch.ops.fleet_solver\n"
        "import kompass_core_tpu_torch.mapping, kompass_core_tpu_torch.ops.mapping\n"
        "import kompass_core_tpu_torch.vision, kompass_core_tpu_torch.algorithms\n"
        "import kompass_core_tpu_torch.planning\n"
        "import kompass_core_tpu_torch.planning.planners_trees\n"
        "import kompass_core_tpu_torch.serving, kompass_core_tpu_torch.utils.runtime\n"
        "import kompass_core_tpu_torch.utils.logger\n"
        "import kompass_core_tpu_torch.utils.visualization\n"
        "import kompass_core_tpu_torch.calibration, kompass_core_tpu_torch.motion_cost\n"
        "import kompass_core_tpu_torch.performance, kompass_core_tpu_torch.simulation\n"
        "import kompass_core_tpu_torch.py_path_tools\n"
        "import kompass_core_tpu_torch.datatypes.obstacles\n"
        "import kompass_core_tpu_torch.datatypes.path_sample\n"
        "import kompass_core_tpu_torch.datatypes.pcd\n"
        "import kompass_core_tpu_torch.benchmark\n"
        "from kompass_core_tpu_torch.benchmark import baseline, device_loop, kernel_bench\n"
        "from kompass_core_tpu_torch.benchmark import moving_bench, peer_bench\n"
        "from kompass_core_tpu_torch.benchmark import planner_bench, roofline, runner, scaling\n"
        "from kompass_core_tpu_torch.benchmark import batch_cliff, chunk_unroll_bench\n"
        "from kompass_core_tpu_torch.benchmark import fleet_fingerprint, mapper_split\n"
        "from kompass_core_tpu_torch.benchmark import scaling_proof\n"
        "import chip_smoke\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'triton',\n"
        "                                    'kompass_core_tpu', 'bench'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"port loaded: {proc.stdout.strip()}"


def test_serving_import_loads_no_tracing_module():
    """A serving process imports ``kompass_core_tpu_torch.serving`` and
    nothing that builds programs: no ``ops`` or ``control`` module (and no
    jax) until ``load_artifact`` registers the kernels' operators."""
    code = (
        "import sys\n"
        "import kompass_core_tpu_torch.serving as serving\n"
        "assert callable(serving.load_artifact)\n"
        "print(','.join(sorted(m for m in sys.modules\n"
        "    if m.startswith(('kompass_core_tpu_torch.ops',\n"
        "                     'kompass_core_tpu_torch.control', 'jax')))))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"serving loaded: {proc.stdout.strip()}"


def test_port_sources_never_import_the_jax_package():
    sources = (sorted(PORT.rglob("*.py")) + sorted(EXAMPLES.glob("*.py"))
               + [Path(REPO) / "chip_smoke.py"])
    assert len(sources) > 20
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if _JAX_PACKAGE_IMPORT.search(p.read_text())]
    assert offenders == []


# the root ``bench.py``, which imports the JAX package
_ROOT_BENCH_IMPORT = re.compile(r"^\s*(import\s+bench|from\s+bench\s+import)\b", re.MULTILINE)


def test_port_sources_never_import_the_root_bench():
    sources = sorted(PORT.rglob("*.py")) + [Path(REPO) / "chip_smoke.py"]
    assert any(p.parent.name == "benchmark" for p in sources)
    assert [str(p.relative_to(REPO)) for p in sources
            if _ROOT_BENCH_IMPORT.search(p.read_text())] == []
    assert _ROOT_BENCH_IMPORT.search("    from bench import build_scenario")
    assert not _ROOT_BENCH_IMPORT.search("from .baseline import build_scenario")


def test_source_scan_catches_each_import_form():
    for line in ("import kompass_core_tpu", "import kompass_core_tpu.ops",
                 "from kompass_core_tpu import native",
                 "    from kompass_core_tpu.datatypes.path import ReferencePath",
                 "importlib.import_module('kompass_core_tpu.native')",
                 '__import__("kompass_core_tpu")'):
        assert _JAX_PACKAGE_IMPORT.search(line), line
    for line in ("import kompass_core_tpu_torch",
                 "from kompass_core_tpu_torch.native import get_lib",
                 "# ported from kompass_core_tpu/ops/solver.py"):
        assert not _JAX_PACKAGE_IMPORT.search(line), line


def test_examples_are_the_nine_jax_demos():
    jax_demos = sorted(p.stem for p in (Path(REPO) / "examples").glob("*.py"))
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == jax_demos
    assert sorted(DEVICE_DEMOS + HOST_DEMOS) == jax_demos


def test_examples_import_loads_no_jax():
    """Every workflow module imports in a fresh interpreter without jax
    and without the JAX package."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import importlib\n"
        f"for name in {DEVICE_DEMOS + HOST_DEMOS!r}:\n"
        "    importlib.import_module('examples_torch.' + name)\n"
        "print(','.join(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'kompass_core_tpu', 'examples'))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"workflows loaded: {proc.stdout.strip()}"


def test_device_demos_exit_2_without_a_card_and_never_fall_back():
    """On a host without a card, ``main(["--device", "cuda"])`` of every
    device workflow exits 2 before any work, none calls the CPU-fallback
    helper ``require_backend_or_cpu``, and the host workflows take no
    ``--device``. Run in a fresh interpreter with CUDA reported absent."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "torch.cuda.is_available = lambda: False\n"
        "import importlib\n"
        "from kompass_core_tpu_torch.utils import runtime\n"
        "calls = []\n"
        "runtime.require_backend_or_cpu = lambda *a, **k: calls.append(a)\n"
        "codes = {}\n"
        f"for name in {DEVICE_DEMOS + HOST_DEMOS!r}:\n"
        "    mod = importlib.import_module('examples_torch.' + name)\n"
        "    try:\n"
        "        mod.main(['--device', 'cuda'])\n"
        "        codes[name] = 0\n"
        "    except SystemExit as e:\n"
        "        codes[name] = e.code\n"
        "print(codes, len(calls))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    codes = {**{n: 2 for n in DEVICE_DEMOS}, **{n: 2 for n in HOST_DEMOS}}
    assert proc.stdout.strip() == f"{codes} 0"
    assert proc.stderr.count("no CUDA device") == len(DEVICE_DEMOS)
    assert proc.stderr.count("unrecognized arguments: --device") == len(HOST_DEMOS)
    for name in DEVICE_DEMOS + HOST_DEMOS:
        assert "require_backend_or_cpu" not in (EXAMPLES / f"{name}.py").read_text()
