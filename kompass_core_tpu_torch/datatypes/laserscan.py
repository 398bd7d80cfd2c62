"""Planar LiDAR scan container.

Functional equivalent of the reference's ``datatypes/laserscan.py:10-157``
(LaserScanData): angle bookkeeping, default ring generation, and angular-zone
queries used by the emergency stop tests.
"""

import math

import numpy as np
from attrs import define, field

from ..utils.angles import normalize_to_0_2pi
from ..utils.config import BaseAttrs, base_validators


@define
class LaserScanData(BaseAttrs):
    """Single scan from a planar laser range-finder.

    If ``angles``/``ranges`` are not given, a full ring at ``range_max`` is
    generated from angle_min/angle_max/angle_increment.
    """

    angle_min: float = field(
        default=0.0,
        validator=base_validators.in_range(-2 * math.pi, 2 * math.pi),
    )
    angle_max: float = field(
        default=2 * math.pi,
        validator=base_validators.in_range(-2 * math.pi, 2 * math.pi),
    )
    angle_increment: float = field(
        default=0.01 * math.pi,
        validator=base_validators.in_range(-math.pi, math.pi),
    )
    time_increment: float = field(
        default=1e-3, validator=base_validators.in_range(0.0, 1e3)
    )
    scan_time: float = field(
        default=1e-3, validator=base_validators.in_range(0.0, 1e3)
    )
    range_min: float = field(
        default=0.0, validator=base_validators.in_range(0.0, 1e3)
    )
    range_max: float = field(
        default=20.0, validator=base_validators.in_range(1e-3, 1e3)
    )
    ranges: np.ndarray = field(default=np.empty(0))
    angles: np.ndarray = field(default=np.empty(0))
    intensities: np.ndarray = field(default=np.empty(0))

    def __attrs_post_init__(self):
        if self.angles.size == 0:
            self.angles = np.arange(
                self.angle_min,
                self.angle_max + self.angle_increment,
                self.angle_increment,
            )
        if self.ranges.size == 0:
            self.ranges = np.full(self.angles.size, self.range_max)
        if self.angles.size != self.ranges.size:
            n = min(self.angles.size, self.ranges.size)
            self.angles = self.angles[:n]
            self.ranges = self.ranges[:n]

    def _zone_mask(self, right_angle: float, left_angle: float) -> np.ndarray:
        angles = normalize_to_0_2pi(self.angles)
        left = normalize_to_0_2pi(left_angle)
        right = normalize_to_0_2pi(right_angle)
        if right > left:
            return (angles <= left) | (angles >= right)
        return (angles <= left) & (angles >= right)

    def get_ranges(self, right_angle: float, left_angle: float) -> np.ndarray:
        """Range values inside the angular zone [right_angle, left_angle]."""
        return self.ranges[self._zone_mask(right_angle, left_angle)]

    def get_angles(self, right_angle: float, left_angle: float) -> np.ndarray:
        """Angle values inside the angular zone [right_angle, left_angle]."""
        return self.angles[self._zone_mask(right_angle, left_angle)]
