"""The port imports torch and never jax (or triton): checked in a fresh
interpreter, since this test process has jax loaded already."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_import_loads_no_jax_and_no_triton():
    code = (
        "import sys, torch\n"
        "import kompass_core_tpu_torch, kompass_core_tpu_torch.control\n"
        "import kompass_core_tpu_torch.ops, kompass_core_tpu_torch.models\n"
        "import kompass_core_tpu_torch.datatypes\n"
        "import kompass_core_tpu_torch.parallel\n"
        "import kompass_core_tpu_torch.ops.fleet_solver\n"
        "import kompass_core_tpu_torch.mapping, kompass_core_tpu_torch.ops.mapping\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'triton'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"port loaded: {proc.stdout.strip()}"
