"""Shared config/logging helpers (reference ``utils/common.py``).

``set_params_from_yaml`` patches attributes of an arbitrary object from
a YAML file section; ``setup_logging`` configures root logging with a
``logs/`` file sink. Re-exports the attrs config base + validators like
the reference module does.
"""

import logging
import os
from typing import List, Optional, Sequence

from .config import BaseAttrs, base_validators  # noqa: F401 - re-exported

__all__ = [
    "BaseAttrs",
    "base_validators",
    "set_params_from_yaml",
    "setup_logging",
]


def set_params_from_yaml(
    used_class,
    path_to_file: str,
    param_names: Sequence,
    root_name: str,
    yaml_key_equal_attribute_name: bool = False,
    get_all_keys: bool = False,
) -> None:
    """Set attributes of ``used_class`` from the ``root_name`` section of
    a YAML file (reference ``utils/common.py:14-77``).

    ``param_names`` is a list of ``(yaml_key, attribute_name)`` pairs, or
    plain names when ``yaml_key_equal_attribute_name``. With
    ``get_all_keys`` every key under ``root_name`` is applied. Missing
    keys keep their defaults (logged at INFO); file/parse errors are
    logged, not raised, matching the reference's tolerant behavior.
    """
    import yaml

    try:
        with open(path_to_file, "r") as fh:
            data = yaml.safe_load(fh)
        if root_name not in data:
            logging.error(
                "Root name '%s' not found in provided file: %s",
                root_name,
                path_to_file,
            )
            return
        section = data[root_name]
        if get_all_keys:
            yaml_key_equal_attribute_name = True
            param_names = list(section)
        for entry in param_names:
            key, attr = (
                (entry, entry) if yaml_key_equal_attribute_name else entry
            )
            if key in section:
                setattr(used_class, attr, section[key])
            else:
                logging.info(
                    "Parameters: %s not found in file, will set to default "
                    "value %s",
                    key,
                    getattr(used_class, attr, None),
                )
    except Exception as exc:  # tolerant, like the reference
        logging.error("File Read Error: %s", exc)


def setup_logging(
    current_dir: str,
    log_file_name: str,
    logging_level: int,
    disable_module_debug: Optional[List[str]] = None,
) -> None:
    """Configure root logging with a file sink under
    ``<current_dir>/logs/<name>.log`` (reference
    ``utils/common.py:80-118``)."""
    log_dir = os.path.join(current_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)

    logging.basicConfig()
    logging.getLogger().setLevel(logging_level)
    for module_name in disable_module_debug or []:
        logging.getLogger(module_name).setLevel(logging.WARNING)

    # divergence from reference utils/common.py:110-115 (which appends a
    # new FileHandler every call): re-configuration replaces the previous
    # file sink instead of duplicating every record — same
    # remove-then-add pattern as utils/logger.set_log_file
    root = logging.getLogger()
    for h in [h for h in root.handlers if isinstance(h, logging.FileHandler)]:
        root.removeHandler(h)
        h.close()
    handler = logging.FileHandler(
        os.path.join(log_dir, f"{log_file_name}.log")
    )
    root.addHandler(handler)
