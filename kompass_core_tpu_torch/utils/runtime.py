"""Runtime set-up helpers: the kernels' on-disk build cache and a probe of
the card.

The port's counterpart of ``kompass_core_tpu/utils/runtime.py``, with its
three names:

- ``enable_persistent_compilation_cache``: the JAX package points XLA's
  persistent compilation cache at a directory; the port's compiled
  artifact is the kernels' library, which ``ops/kernels.build_library``
  builds once per source hash into ``ops/kernels.BUILD_DIR`` and reuses
  after. Given a path, this points ``BUILD_DIR`` there, so a serving
  process outside the repository builds once into a writable place.
- ``probe_backend``: JAX's backend initialisation becomes CUDA's
  (``torch.cuda.init``), from a watchdog thread.
- ``require_backend_or_cpu``: the probe runs in a subprocess that builds
  the kernels and launches one; it returns the ``torch.device`` the
  caller should pass to the port's entry points, the CPU with a warning
  when the card is unusable. A demo and tool helper: nothing in the
  port calls it, and no entry point defaults its device through it.
"""

import logging
import os
import subprocess
import sys
import threading
from pathlib import Path

import torch

logger = logging.getLogger("kompass_core_tpu_torch")

_cache_enabled = False


def enable_persistent_compilation_cache(path: str = None) -> None:
    """Idempotently point the kernels' build cache at ``path`` (default:
    ``build/kompass_core_tpu_torch`` in the checkout).

    Disable with KOMPASS_TPU_NO_CACHE=1 (e.g. when measuring a cold
    build's time); call it before the first kernel launch, which builds
    or loads the library."""
    global _cache_enabled
    if _cache_enabled or os.environ.get("KOMPASS_TPU_NO_CACHE"):
        return
    from ..ops import kernels

    if path is not None:
        kernels.BUILD_DIR = Path(path).expanduser()
    _cache_enabled = True


def probe_backend(timeout_s: float = 240.0):
    """Initialise CUDA from a watchdog thread.

    Returns the cards as ``torch.device``s, or None when the
    initialisation raised, found no card or did not return within
    ``timeout_s`` (the reason in ``probe_backend.last_error``)."""
    result = {}

    def _probe():
        try:
            torch.cuda.init()
            result["devices"] = [torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count())]
        except Exception as e:  # noqa: BLE001 — report, don't hang
            result["error"] = repr(e)

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if result.get("devices"):
        return result["devices"]
    probe_backend.last_error = result.get(
        "error", f"CUDA init did not return within {timeout_s:.0f}s"
        if t.is_alive() else "no CUDA device"
    )
    return None


# the probe's subprocess: build the kernels, launch K1 once on one point
# against one row and read the result back
_PROBE = (
    "import torch\n"
    "from kompass_core_tpu_torch.ops import kernels\n"
    "d = torch.device('cuda')\n"
    "p = torch.zeros(1, 1, device=d)\n"
    "o = torch.ones(1, 2, device=d)\n"
    "s = torch.ones(1, device=d)\n"
    "a = torch.ones(1, dtype=torch.int32, device=d)\n"
    "d2, _ = kernels.fused_min_dist_sq(p, p, o, s, s, a)\n"
    "assert float(d2) == 2.0, float(d2)\n"
)


def require_backend_or_cpu(timeout_s: float = 240.0) -> torch.device:
    """Demo and tool helper: the device the caller should run the port on.

    Probes the card in a SUBPROCESS (a hung driver or a failing build
    must not take this process with it): it builds the kernels and
    launches one. Returns ``torch.device("cuda")`` when that worked, else
    ``torch.device("cpu")`` with a warning. KOMPASS_TPU_FORCE_CPU=1
    skips the probe and returns the CPU."""
    if os.environ.get("KOMPASS_TPU_FORCE_CPU"):
        return torch.device("cpu")
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                           timeout=timeout_s, capture_output=True, text=True)
        ok = r.returncode == 0
        err = "" if ok else (r.stderr or "")[-300:]
    except subprocess.TimeoutExpired:
        ok = False
        err = f"the kernel probe did not return within {timeout_s:.0f}s"
    if ok:
        return torch.device("cuda")
    logger.warning("no usable CUDA card (%s); running on CPU", err)
    return torch.device("cpu")
