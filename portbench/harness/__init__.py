"""The benchmark harness: cells resolved by name, the closed-loop window
and the trace reader. Systems and their output checks are under
``systems/``, traffic scenes under ``scenes/``."""

import os


def set_environment(root: str) -> None:
    """The run's process settings, before torch or numpy is imported:
    one host thread for the numeric libraries (the load comes from this
    process alone, and a steady one), and every build and kernel cache at
    a fixed path inside the checkout."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "portbench",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "portbench", "triton")
