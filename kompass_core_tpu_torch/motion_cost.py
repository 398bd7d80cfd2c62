"""Offline motion-cost evaluation (Python-side cost library).

Role of the reference's ``motion_cost.py:19-438``: weighted cost terms for
offline trajectory evaluation — static collision, dynamic-obstacle collision
probability, and reference-tracking costs — over recorded/simulated paths.
Vectorized numpy.
"""

import logging
import math
from typing import Optional

import numpy as np
import attrs
from attrs import define, field

from .datatypes.path_sample import ObstaclesData, PathSample
from .utils.config import BaseAttrs, base_validators
from .utils.angles import normalize_to_minus_pi_pi
from .utils.geometry import (
    probability_of_collision,  # noqa: F401 — public, re-exported
    probability_of_collision_array,
)


class MotionCost:
    """Base weighted cost (reference ``motion_cost.py:19-57``)."""

    def __init__(self, weight: float, margin: float):
        self.weight = float(weight)
        self.margin = float(margin)
        self.cost = 0.0

    @property
    def value(self) -> float:
        """Reference attribute name for the accumulated raw cost
        (``motion_cost.py:33``)."""
        return self.cost

    @value.setter
    def value(self, v: float) -> None:
        self.cost = float(v)

    def set_params(self, weight: float, margin: float):
        self.weight = float(weight)
        self.margin = float(margin)

    def __call__(self) -> float:
        return self.weight * self.cost


class CollisionCost(MotionCost):
    """Collision cost base with a robot-footprint collision radius.
    Accepts either a footprint object (anything with ``get_radius()``,
    e.g. Circular/RectangleFootprint — the reference's ctor contract,
    ``motion_cost.py:64-80``) or a plain radius."""

    def __init__(self, weight: float, margin: float, robot_radius):
        super().__init__(weight, margin)
        if hasattr(robot_radius, "get_radius"):
            self.robot_footprint = robot_radius
            self.robot_radius = float(robot_radius.get_radius())
        else:
            self.robot_footprint = None
            self.robot_radius = float(robot_radius)

    @property
    def collision_limit_radius(self) -> float:
        return self.robot_radius + self.margin

    def _get_collision_limit_radius(self) -> float:
        """Reference method name (``motion_cost.py:82-89``)."""
        return self.collision_limit_radius

    def call(self) -> float:
        """Weighted accumulated cost (reference ``motion_cost.py:91-92``)."""
        return MotionCost.__call__(self)


class StaticCollisionCost(CollisionCost):
    """Min-clearance cost against static obstacles
    (reference ``motion_cost.py:95-155``): 1 at contact, linear decay to 0
    at margin distance beyond the footprint."""

    closest_distance: Optional[float] = None

    def __call__(
        self, path: PathSample, obstacles: ObstaclesData
    ) -> float:
        if len(obstacles) == 0 or len(path) == 0:
            self.cost = 0.0
            return 0.0
        obs_x = np.asarray(obstacles.x_global, float)
        obs_y = np.asarray(obstacles.y_global, float)
        zone = np.asarray(obstacles.occupied_zone, float)
        dx = path.x_points[:, None] - obs_x[None, :]
        dy = path.y_points[:, None] - obs_y[None, :]
        d = np.sqrt(dx * dx + dy * dy) - zone[None, :]
        min_d = float(np.min(d))
        clearance = min_d - self.robot_radius
        if clearance <= 0:
            self.cost = 1.0
        elif clearance >= self.margin:
            self.cost = 0.0
        else:
            self.cost = (self.margin - clearance) / self.margin
        return self.weight * self.cost

    def point_cost(
        self, point_x: float, point_y: float, local_map: ObstaclesData
    ) -> float:
        """Per-point static cost: count of obstacles within the collision
        radius (the reference's per-point ``__call__``,
        ``motion_cost.py:106-132``). ``closest_distance`` holds the
        minimum SQUARED distance — the reference stores ``min(dist_sqr)``
        without a sqrt (``motion_cost.py:126``), kept for parity."""
        if len(local_map) == 0:
            self.closest_distance = float("inf")
            return 0.0
        limit = self._get_collision_limit_radius()
        dist_sqr = (
            np.asarray(local_map.x_global, float) - point_x
        ) ** 2 + (np.asarray(local_map.y_global, float) - point_y) ** 2
        self.closest_distance = float(np.min(dist_sqr))
        return float(np.sum(np.where(dist_sqr <= limit**2, 1.0, 0.0)))

    def update(
        self, path_sample: PathSample, idx: int, local_map: ObstaclesData
    ) -> float:
        """Accumulate the static cost at a path index and return the
        weighted total (reference ``motion_cost.py:134-154``)."""
        self.value += self.point_cost(
            path_sample.x_points[idx], path_sample.y_points[idx], local_map
        )
        return self.call()


class DynamicCollisionProbabilityCost(CollisionCost):
    """Collision probability against moving obstacles with positional
    uncertainty (reference ``motion_cost.py:156-256``): per path point,
    propagate each obstacle by its velocity to the point's timestamp and
    integrate a Gaussian collision probability."""

    def __init__(
        self, weight: float, margin: float, robot_radius: float,
        position_sigma: float = 0.2,
    ):
        super().__init__(weight, margin, robot_radius)
        self.position_sigma = position_sigma

    def __call__(
        self,
        path: PathSample,
        obstacles: ObstaclesData,
        time_points: Optional[np.ndarray] = None,
    ) -> float:
        if len(obstacles) == 0 or len(path) == 0:
            self.cost = 0.0
            return 0.0
        t = (
            np.asarray(time_points)
            if time_points is not None
            else np.zeros(len(path))
        )
        obs_x = np.asarray(obstacles.x_global, float)
        obs_y = np.asarray(obstacles.y_global, float)
        obs_vx = np.asarray(obstacles.vx, float)
        obs_vy = np.asarray(obstacles.vy, float)
        ox = obs_x[None, :] + obs_vx[None, :] * t[:, None]
        oy = obs_y[None, :] + obs_vy[None, :] * t[:, None]
        d = np.sqrt(
            (path.x_points[:, None] - ox) ** 2
            + (path.y_points[:, None] - oy) ** 2
        )
        sigma_t = self.position_sigma * (1.0 + t[:, None])
        # one vectorized erf over the whole [points, obstacles] block —
        # the per-element Python loop was ~ms per call and grew linearly
        probs = probability_of_collision_array(
            d, np.broadcast_to(sigma_t, d.shape), self.collision_limit_radius
        )
        self.cost = float(1.0 - np.prod(1.0 - np.max(probs, axis=1)))
        return self.weight * self.cost

    _MAX_POINT_UNCERTAINTY = 1.0

    def point_cost(
        self,
        point_x: float,
        point_y: float,
        idx: int,
        future_map: ObstaclesData,
        time_step: float,
        prediction_horizon: float,
    ) -> float:
        """Per-point collision probability against one predicted map with
        time-growing inflation (the reference's per-point ``__call__``,
        ``motion_cost.py:166-256``; circle-overlap probability,
        ``utils/geometry.py:29-80``)."""
        from .utils.geometry import probability_of_collision_circles

        pose_uncertainty = self._MAX_POINT_UNCERTAINTY * (
            idx * time_step / prediction_horizon
        )
        robot_inflated = self._get_collision_limit_radius() * (
            1.0 + pose_uncertainty
        )
        prob = 0.0
        for i in range(len(future_map)):
            object_inflated = (
                float(future_map.occupied_zone[i]) + self.margin
            ) * (1.0 + pose_uncertainty)
            prob = max(
                prob,
                probability_of_collision_circles(
                    point_x,
                    point_y,
                    float(future_map.x_global[i]),
                    float(future_map.y_global[i]),
                    robot_inflated,
                    object_inflated,
                ),
            )
        return prob

    def update(
        self,
        path_sample: PathSample,
        idx: int,
        predicted_maps,
        time_step: float,
        prediction_horizon: float,
    ) -> float:
        """Track the max collision probability along the path and return
        the weighted value (reference ``motion_cost.py:221-255``)."""
        self.value = max(
            self.point_cost(
                path_sample.x_points[idx],
                path_sample.y_points[idx],
                idx,
                predicted_maps[idx],
                time_step,
                prediction_horizon,
            ),
            self.value,
        )
        return self.call()


class ReferenceCost(MotionCost):
    """Tracking error costs vs a reference path
    (reference ``motion_cost.py:258-360``): mean lateral distance, end-point
    distance, and mean heading error. Carries both the batch evaluation
    (``__call__(path, reference)``) and the reference's incremental
    per-index API (``update``/``point_cost`` over displacement +
    heading-error sub-costs)."""

    PATH_TRACKING_COST = 0
    GOAL_POINT_COST = 1

    def __init__(
        self,
        displacement_weight: float,
        heading_weight: Optional[float] = None,
        reference_type: int = PATH_TRACKING_COST,
        margin: float = 0.0,
    ):
        super().__init__(displacement_weight, margin)
        self.reference_type = reference_type
        self.displacement = MotionCost(displacement_weight, 0.0)
        self.heading_cost = MotionCost(
            heading_weight if heading_weight is not None else displacement_weight,
            0.0,
        )
        self.lateral_error = 0.0
        self.heading_error = 0.0
        self.end_error = 0.0

    def point_cost(
        self, point_x: float, point_y: float, point_heading: float, reference
    ):
        """(displacement, heading error) of one pose vs a reference path
        (list of PathPoint) or goal point (the reference's per-point
        ``__call__``, ``motion_cost.py:288-332``)."""
        from .py_path_tools.executor import PathExecutor
        from .utils.angles import normalize_to_0_2pi

        if self.reference_type == self.PATH_TRACKING_COST:
            path_point = PathExecutor.get_closest_point(
                reference, point_x, point_y
            )
            if path_point is None:
                # robustness divergence: get_closest_point returns None
                # for an empty reference path and the reference
                # (motion_cost.py:315-322) crashes dereferencing it —
                # report a zero cost with a logged error instead
                logging.error(
                    "ReferenceCost.point_cost called with an empty "
                    "reference path; returning zero cost"
                )
                return (0.0, 0.0)
        else:
            path_point = reference
        displacement = math.hypot(
            point_x - path_point.x, point_y - path_point.y
        )
        heading_error = normalize_to_minus_pi_pi(
            point_heading - normalize_to_0_2pi(path_point.heading)
        )
        return (displacement, float(heading_error))

    def update(self, path_sample: PathSample, idx: int, ref_path):
        """Per-index tracking cost: displacement ACCUMULATES (``+=``)
        while the heading term holds only the LAST index's error (``=``)
        — the reference's exact asymmetry (``motion_cost.py:357-359``).
        Returns the weighted (displacement, heading) pair."""
        displacement, heading_error = self.point_cost(
            path_sample.x_points[idx],
            path_sample.y_points[idx],
            path_sample.heading_points[idx],
            ref_path,
        )
        self.displacement.value += displacement / 2
        self.heading_cost.value = abs(heading_error) / 2
        return self.displacement(), self.heading_cost()

    def __call__(self, path: PathSample, reference: PathSample) -> float:
        if len(path) == 0 or len(reference) == 0:
            self.cost = 0.0
            return 0.0
        dx = path.x_points[:, None] - reference.x_points[None, :]
        dy = path.y_points[:, None] - reference.y_points[None, :]
        d = np.sqrt(dx * dx + dy * dy)
        nearest = np.argmin(d, axis=1)
        self.lateral_error = float(np.mean(np.min(d, axis=1)))
        dh = normalize_to_minus_pi_pi(
            path.heading_points - reference.heading_points[nearest]
        )
        self.heading_error = float(np.mean(np.abs(dh)))
        self.end_error = float(
            math.hypot(
                path.x_points[-1] - reference.x_points[-1],
                path.y_points[-1] - reference.y_points[-1],
            )
        )
        self.cost = self.lateral_error + self.end_error + self.heading_error
        return self.weight * self.cost


@define
class MotionCostsParams(BaseAttrs):
    """Weights/margins bundle (reference ``motion_cost.py:362-438``)."""

    static_collision_weight: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1e3)
    )
    dynamic_collision_weight: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1e3)
    )
    reference_weight: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1e3)
    )
    collision_margin: float = field(
        default=0.3, validator=base_validators.in_range(0.0, 1e2)
    )
    # reference field names (``motion_cost.py:362-382``); consumed by
    # build() — None means "fall back to the shared collision_margin";
    # explicit values validate like any margin (negatives still rejected)
    static_collision_margin: Optional[float] = field(
        default=None,
        validator=attrs.validators.optional(
            base_validators.in_range(0.0, 1e2)
        ),
    )
    dynamic_collision_margin: Optional[float] = field(
        default=None,
        validator=attrs.validators.optional(
            base_validators.in_range(0.0, 1e2)
        ),
    )
    goal_lat_err_weight: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1e3)
    )
    goal_heading_err_weight: float = field(
        default=0.1, validator=base_validators.in_range(0.0, 1e3)
    )

    def set(
        self,
        static_collision_margin: float,
        static_collision_weight: float,
        dynamic_collision_margin: float,
        dynamic_collision_weight: float,
        goal_lat_err_weight: float,
        goal_heading_err_weight: float,
    ):
        """Set all six reference parameters (reference
        ``motion_cost.py:383-413``)."""
        self.static_collision_margin = static_collision_margin
        self.static_collision_weight = static_collision_weight
        self.dynamic_collision_margin = dynamic_collision_margin
        self.dynamic_collision_weight = dynamic_collision_weight
        self.goal_lat_err_weight = goal_lat_err_weight
        self.goal_heading_err_weight = goal_heading_err_weight

    def set_from_yaml(self, path_to_file: str):
        """Load the parameters from a yaml file's 'motion_costs' section
        (reference ``motion_cost.py:415-438``)."""
        from .utils.common import set_params_from_yaml

        set_params_from_yaml(
            self,
            path_to_file,
            param_names=[
                "static_collision_margin",
                "static_collision_weight",
                "dynamic_collision_margin",
                "dynamic_collision_weight",
                "goal_lat_err_weight",
                "goal_heading_err_weight",
            ],
            root_name="motion_costs",
            yaml_key_equal_attribute_name=True,
        )

    def build(self, robot_radius: float):
        static_margin = (
            self.static_collision_margin
            if self.static_collision_margin is not None
            else self.collision_margin
        )
        dynamic_margin = (
            self.dynamic_collision_margin
            if self.dynamic_collision_margin is not None
            else self.collision_margin
        )
        return {
            "static_collision": StaticCollisionCost(
                self.static_collision_weight, static_margin, robot_radius
            ),
            "dynamic_collision": DynamicCollisionProbabilityCost(
                self.dynamic_collision_weight, dynamic_margin, robot_radius
            ),
            # reference_weight scales the whole tracking cost; the
            # reference's per-term weights multiply into displacement /
            # heading (both default 1.0 / 0.1 as upstream)
            "reference": ReferenceCost(
                self.reference_weight * self.goal_lat_err_weight,
                self.reference_weight * self.goal_heading_err_weight,
            ),
        }
