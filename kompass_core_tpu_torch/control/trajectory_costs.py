"""Trajectory cost weights config.

Mirrors the reference's ``TrajectoryCostsWeights``
(``utils/cost_evaluator.h:22-50`` and ``control/_trajectory_.py``).
"""

from attrs import define, field

from kompass_core_tpu.utils.config import BaseAttrs, base_validators


@define
class TrajectoryCostsWeights(BaseAttrs):
    # defaults match the reference front-end (control/_trajectory_.py:46-64):
    # path 3.0, goal 3.0, obstacles 1.0, smoothness/jerk off
    reference_path_distance_weight: float = field(
        default=3.0, validator=base_validators.in_range(0.0, 1e3)
    )
    goal_distance_weight: float = field(
        default=3.0, validator=base_validators.in_range(0.0, 1e3)
    )
    obstacles_distance_weight: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1e3)
    )
    smoothness_weight: float = field(
        default=0.0, validator=base_validators.in_range(0.0, 1e3)
    )
    jerk_weight: float = field(
        default=0.0, validator=base_validators.in_range(0.0, 1e3)
    )
