"""kompass_core_tpu_torch: the DWA local planner of ``kompass_core_tpu``
ported to PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The JAX package stays the reference; this package keeps its file layout
and names (``ops/solver.py`` here is the counterpart of
``kompass_core_tpu/ops/solver.py``). It imports nothing of the JAX
package: the host modules it needs (path and scan datatypes, robot
models, the native host library, geometry and config helpers) are its
own copies, with the same code and numerics.

Every entry point takes its ``torch.device`` explicitly; nothing picks a
device for the caller.
"""

import torch

__version__ = "0.1.0"

# Float32 stays float32: a 10-bit TF32 mantissa puts the same class of
# error into squared distances as the TPU's bf16 matmul pass did.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import utils  # noqa: E402,F401
from .utils.logger import (  # noqa: E402,F401
    get_available_accelerators,
    set_log_file,
    set_log_level,
)

# reference-compatible alias (kompass_core.set_logging_level)
set_logging_level = set_log_level
