"""``set_params_from_yaml``: patches attributes of an object from a YAML
file section (reference ``utils/common.py``), for the robot models'
``set_from_yaml`` and the footprints. The port's logging set-up is the
host application's own, so ``setup_logging`` is not copied."""

import logging
from typing import Sequence


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
