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
        "import chip_smoke\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'triton',\n"
        "                                    'kompass_core_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"port loaded: {proc.stdout.strip()}"


def test_port_sources_never_import_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [Path(REPO) / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if _JAX_PACKAGE_IMPORT.search(p.read_text())]
    assert offenders == []


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
