"""Package logging controls and accelerator enumeration.

The port's copy of ``kompass_core_tpu/utils/logger.py``: the role of the
reference's singleton Logger (``utils/logger.h:17-80``, exposed as
``set_log_level`` / ``set_log_file`` in ``bindings/bindings.cpp:37-46``)
and of ``get_available_accelerators`` (``gpu_check.cpp:7-22``), for the
port's logger ``"kompass_core_tpu_torch"`` and torch's CUDA devices.
"""

import logging
from typing import List, Optional

import torch

_logger = logging.getLogger("kompass_core_tpu_torch")
_file_handler: Optional[logging.FileHandler] = None


def set_log_level(level: str) -> None:
    _logger.setLevel(level.upper())


def set_log_file(file_path: str) -> None:
    """Attach (or move) a file sink for package logs."""
    global _file_handler
    if _file_handler is not None:
        _logger.removeHandler(_file_handler)
        _file_handler.close()
    _file_handler = logging.FileHandler(file_path)
    _file_handler.setFormatter(
        logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s")
    )
    _logger.addHandler(_file_handler)


def get_available_accelerators() -> List[str]:
    """Each CUDA card as ``"cuda:<i> <name>"``, then the CPU."""
    cards = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
             for i in range(torch.cuda.device_count())]
    return cards + ["cpu"]
