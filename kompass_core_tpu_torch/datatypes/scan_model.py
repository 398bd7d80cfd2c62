"""Probabilistic scan sensor-model configuration.

Mirrors the reference's ``ScanModelConfig`` (``datatypes/scan_model.py:7``):
parameters of the simplified inverse sensor model used for Bayesian
occupancy updates.
"""

import numpy as np
from attrs import define, field

from ..utils.config import BaseAttrs, base_validators


@define
class ScanModelConfig(BaseAttrs):
    p_prior: float = field(
        default=0.6, validator=base_validators.in_range(0.0, 1.0)
    )
    p_empty: float = field(init=False)
    p_occupied: float = field(
        default=0.9, validator=base_validators.in_range(0.0, 1.0)
    )
    range_sure: float = field(
        default=0.1, validator=base_validators.in_range(1e-4, 1e6)
    )
    range_max: float = field(
        default=20.0, validator=base_validators.in_range(1e-4, 1e6)
    )
    wall_size: float = field(
        default=0.1, validator=base_validators.in_range(1e-4, 1e6)
    )
    angle_step: float = field(
        default=0.01, validator=base_validators.in_range(1e-6, np.pi / 4)
    )
    max_height: float = field(
        default=10.0, validator=base_validators.in_range(-1e2, 1e2)
    )
    min_height: float = field(
        default=-10.0, validator=base_validators.in_range(-1e2, 1e2)
    )

    def __attrs_post_init__(self):
        self.p_empty = 1 - self.p_occupied
