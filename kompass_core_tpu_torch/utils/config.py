"""Typed configuration base built on ``attrs``.

Plays the role of the reference's two-level config system
(``utils/base_attrs.py`` BaseAttrs + C++ ``parameter.h`` Parameters): attrs
classes with range validators and dict/yaml/json/toml round-tripping. The
implementation here is original and minimal; serialization supports nested
configs and numpy arrays.
"""

import json
from typing import Optional

import numpy as np
from attrs import asdict, fields


class _Validators:
    """Factory namespace for common attrs validators."""

    @staticmethod
    def in_range(min_value, max_value):
        def _validator(_inst, attr, value):
            if value is None:
                return
            if not (min_value <= value <= max_value):
                raise ValueError(
                    f"'{attr.name}'={value} outside [{min_value}, {max_value}]"
                )

        return _validator

    @staticmethod
    def positive():
        return _Validators.in_range(np.finfo(float).tiny, np.inf)

    @staticmethod
    def in_(options):
        """Value must be one of ``options`` (enum-style params)."""
        opts = list(options)

        def _validator(_inst, attr, value):
            if value is None:
                return
            if value not in opts:
                raise ValueError(f"'{attr.name}'={value} not in {opts}")

        return _validator


base_validators = _Validators


class BaseAttrs:
    """Mixin for attrs-decorated config classes.

    Provides ``to_dict`` / ``update_from_dict`` and file loading from
    yaml/json/toml, including nested ``BaseAttrs`` members.
    """

    def to_dict(self) -> dict:
        def _serialize(_inst, _field, value):
            if isinstance(value, np.ndarray):
                return value.tolist()
            return value

        return asdict(self, value_serializer=_serialize)

    def update_from_dict(self, data: dict) -> None:
        field_names = {f.name: f for f in fields(type(self))}
        for key, value in data.items():
            if key not in field_names:
                continue
            current = getattr(self, key)
            if isinstance(current, BaseAttrs) and isinstance(value, dict):
                current.update_from_dict(value)
            elif isinstance(current, np.ndarray):
                setattr(self, key, np.asarray(value, dtype=current.dtype))
            else:
                setattr(self, key, value)

    def from_file(
        self, file_path: str, nested_root_name: Optional[str] = None
    ) -> None:
        """Load values from a yaml/json/toml file into this config."""
        if file_path.endswith((".yaml", ".yml")):
            import yaml

            with open(file_path) as f:
                data = yaml.safe_load(f)
        elif file_path.endswith(".toml"):
            import tomllib

            with open(file_path, "rb") as f:
                data = tomllib.load(f)
        else:
            with open(file_path) as f:
                data = json.load(f)
        if nested_root_name:
            for part in nested_root_name.split("."):
                data = data[part]
        self.update_from_dict(data)

    def to_json_file(self, file_path: str) -> None:
        with open(file_path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
