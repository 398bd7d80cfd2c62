"""Path-following base: target tracking on a segmented reference path.

Host-side (NumPy) equivalent of the reference ``Follower``
(``controllers/follower.cpp``): interpolated + segmented path ownership,
binary-search closest-segment lookup, closest-point-on-segment with signed
crosstrack error, sticky target determination with the 90%-of-segment
re-search rule, goal-reached / losing-goal detection, and the exponential
curvature/rotation speed regulation factor.

This logic runs per tick on host (a few hundred numpy ops on small arrays);
the expensive sampling/cost math runs on device. The fleet-scale variant
(``parallel/fleet.py``) re-expresses target determination in JAX so hundreds
of robots never touch the host.
"""

import logging
import math
import time as _time
from dataclasses import dataclass, field as dc_field
from typing import Optional

from attrs import define, field

from ..datatypes.path import InterpolationType, ReferencePath
from ..models import RobotState
from ..native import (
    closest_point_on_segment,
    find_closest_segment,
    speed_factor,
)
from ..utils.angles import (
    normalize_to_0_2pi,
    normalize_to_minus_pi_pi,
)
from ..utils.config import BaseAttrs, base_validators


@define
class FollowerConfig(BaseAttrs):
    """Follower parameters (defaults mirror reference ``follower.h:16-65`` /
    ``control/_base_.py:86-120``)."""

    max_point_interpolation_distance: float = field(
        default=0.01, validator=base_validators.in_range(1e-4, 1e2)
    )
    lookahead_distance: float = field(
        default=1.0, validator=base_validators.in_range(1e-4, 1e2)
    )
    goal_dist_tolerance: float = field(
        default=0.1, validator=base_validators.in_range(1e-4, 1e2)
    )
    goal_orientation_tolerance: float = field(
        default=0.1, validator=base_validators.in_range(1e-4, math.pi)
    )
    path_segment_length: float = field(
        default=1.0, validator=base_validators.in_range(1e-4, 1e2)
    )
    loosing_goal_distance: float = field(
        default=0.2, validator=base_validators.in_range(1e-4, 1e2)
    )
    speed_regulation_curvature: float = field(
        default=0.5, validator=base_validators.in_range(1e-3, 1.0)
    )
    speed_regulation_angular: float = field(
        default=0.5, validator=base_validators.in_range(1e-3, 1.0)
    )
    min_speed_regulation_factor: float = field(
        default=0.1, validator=base_validators.in_range(1e-3, 1.0)
    )
    curvature_horizon_tolerance: float = field(
        default=1.5, validator=base_validators.in_range(0.5, 1e2)
    )
    enable_reverse_driving: bool = field(default=False)
    # blocked-robot detection (reference controller.h:37-44 declares
    # these but never implements the logic; here they drive an actual
    # no-movement detector on the follower state — see
    # Follower.is_robot_blocked)
    enable_check_blocked: bool = field(default=False)
    max_blocked_duration: float = field(
        default=1.0, validator=base_validators.in_range(0.1, 360.0)
    )


@dataclass
class PathPosition:
    """Closest-point bookkeeping (reference ``Path::PathPosition``,
    ``datatypes/path.h:301-308``)."""

    index: int = 0
    segment_index: int = 0
    segment_length: float = -1.0  # normalized position in segment, [0, 1]
    normal_distance: float = 0.0
    parallel_distance: float = 0.0  # signed crosstrack
    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0


@dataclass
class FollowingTarget:
    """Tracked target handed to controllers (reference ``Follower::Target``,
    ``follower.h:71-79``)."""

    segment_index: int = 0
    position_in_segment: float = 0.0
    movement: RobotState = dc_field(default_factory=RobotState)
    lookahead: float = 0.0
    crosstrack_error: float = 0.0
    heading_error: float = 0.0
    reverse: bool = False


class Follower:
    """Stateful path follower base class."""

    def __init__(
        self,
        config: Optional[FollowerConfig] = None,
        is_ackermann: bool = False,
    ):
        self.config = config or FollowerConfig()
        self._path: Optional[ReferencePath] = None
        self._closest = PathPosition()
        self._target: Optional[FollowingTarget] = None
        self._interpolation_type = InterpolationType.LINEAR
        self.current_state = RobotState()
        self._current_segment_index = 0
        self._max_segment_index = 0
        self._path_processing = False
        self._reached_goal = True
        self._goal_distance = float("inf")
        # Ackermann bases cannot rotate in place (follower.cpp:41-46)
        self.rotate_in_place = not is_ackermann
        # blocked-robot detection state (controller.h:37-44 — the params
        # exist upstream but the detector does not; implemented here)
        self._blocked_ref: Optional[tuple] = None
        self._blocked_since: Optional[float] = None
        self._blocked_observed_s = 0.0  # non-movement span seen in updates
        self._blocked_reported = False
        self._clock = _time.monotonic  # injectable for deterministic tests

    # --- configuration ---

    @property
    def max_segment_size(self) -> int:
        """Max points per segment (reference ``follower.cpp:54-59``)."""
        return (
            int(
                self.config.path_segment_length
                / self.config.max_point_interpolation_distance
            )
            + 1
        )

    def set_interpolation_type(self, interpolation_type: InterpolationType):
        self._interpolation_type = interpolation_type

    @property
    def planner(self) -> "Follower":
        """The underlying path-tracking engine. The reference wrapper
        holds the C++ Follower as ``planner`` (``_base_.py:228-231``);
        here the wrapper and engine are one object."""
        return self

    def optimal_path(self):
        """Local plan, when the controller produces one — base default is
        None (reference template, ``control/_base_.py:300-303``);
        sampling controllers (DWA) override it."""
        return None

    # --- path management (follower.cpp:67-105) ---

    def clear_current_path(self):
        self._path = None
        self._reached_goal = True
        self._path_processing = False

    def set_current_path(self, path: ReferencePath, interpolate: bool = True):
        self._path = path
        if interpolate:
            self._path.interpolate(
                self.config.max_point_interpolation_distance,
                self._interpolation_type,
            )
        self._path.segment(self.config.path_segment_length, self.max_segment_size)
        self._max_segment_index = self._path.num_segments - 1
        self._path_processing = True
        self._current_segment_index = 0
        self._closest = PathPosition()
        self._goal_distance = float("inf")
        self._reached_goal = False

    def has_path(self) -> bool:
        return self._path is not None

    def get_current_path(self) -> Optional[ReferencePath]:
        return self._path

    # --- state ---

    def set_current_state(self, x, y, yaw, speed=0.0):
        self.current_state.x = float(x)
        self.current_state.y = float(y)
        self.current_state.yaw = float(yaw)
        self.current_state.speed = float(speed)
        self._update_blocked_check()

    def get_tracked_target(self) -> Optional[FollowingTarget]:
        return self._target

    # --- blocked-robot detection -------------------------------------
    # The reference declares enable_check_blocked / max_blocked_duration
    # (controller.h:37-44, "notify upper pipeline stages") but ships no
    # implementation. Here the detector is real: while a path is being
    # followed, if the pose has not moved by more than
    # _BLOCKED_MOVE_EPS_M / _BLOCKED_MOVE_EPS_RAD for longer than
    # max_blocked_duration seconds of wall time, is_robot_blocked()
    # turns True (and a warning is logged once per episode).

    _BLOCKED_MOVE_EPS_M = 1e-3
    _BLOCKED_MOVE_EPS_RAD = 1e-2

    def _update_blocked_check(self):
        if not self.config.enable_check_blocked or not self._path_processing:
            self._blocked_ref = None
            self._blocked_since = None
            self._blocked_observed_s = 0.0
            self._blocked_reported = False
            return
        s = self.current_state
        now = self._clock()
        if self._blocked_ref is not None:
            rx, ry, ryaw = self._blocked_ref
            moved = (
                math.hypot(s.x - rx, s.y - ry) > self._BLOCKED_MOVE_EPS_M
                or abs(normalize_to_minus_pi_pi(s.yaw - ryaw))
                > self._BLOCKED_MOVE_EPS_RAD
            )
        else:
            moved = True
        if moved:
            self._blocked_ref = (s.x, s.y, s.yaw)
            self._blocked_since = now
            self._blocked_observed_s = 0.0
            self._blocked_reported = False
            return
        # non-movement CONFIRMED by this pose observation: record the
        # observed span. The query below reports from this value, never
        # from wall time at call time — a stalled pose stream (upstream
        # localization hiccup) must not manufacture a 'blocked' report
        # for a robot that may well be driving.
        self._blocked_observed_s = now - self._blocked_since
        if (
            not self._blocked_reported
            and self._blocked_observed_s > self.config.max_blocked_duration
        ):
            self._blocked_reported = True
            logging.getLogger("kompass_core_tpu").warning(
                "robot blocked: no movement for %.2f s (max_blocked_duration"
                " %.2f s)",
                self._blocked_observed_s,
                self.config.max_blocked_duration,
            )

    def is_robot_blocked(self) -> bool:
        """True when blocked-robot checking is enabled and pose
        observations have confirmed no movement for more than
        ``max_blocked_duration`` seconds while a path is active."""
        if not self.config.enable_check_blocked or not self._path_processing:
            return False
        return self._blocked_observed_s > self.config.max_blocked_duration

    # --- goal detection (follower.cpp:109-142) ---

    def is_goal_reached(self) -> bool:
        if not self._path_processing:
            return True
        gx, gy = self._path.end
        current_goal_distance = math.hypot(
            self.current_state.x - gx, self.current_state.y - gy
        )
        end_reached = current_goal_distance <= self.config.goal_dist_tolerance
        loosing_goal = False
        if (self._current_segment_index + 1) >= self._max_segment_index:
            if current_goal_distance < self._goal_distance:
                self._goal_distance = current_goal_distance
            elif (
                abs(current_goal_distance - self._goal_distance)
                > self.config.loosing_goal_distance
            ):
                loosing_goal = True
        # reference quirk kept verbatim (follower.cpp:136-140): LOSING the
        # goal also sets reached_goal, so a diverging approach is reported
        # as GOAL_REACHED; FollowingStatus.LOOSING_GOAL exists but is
        # never emitted (upstream behavior)
        if end_reached or loosing_goal:
            self._path_processing = False
            self._reached_goal = True
        return self._reached_goal

    # --- closest point machinery (follower.cpp:149-264) ---

    def _dist_sq_to(self, px: float, py: float) -> float:
        dx = self.current_state.x - px
        dy = self.current_state.y - py
        return dx * dx + dy * dy

    def _find_closest_segment_index(self, left: int, right: int) -> int:
        """Binary-search-like descent over segment start points
        (follower.cpp:155-183). Delegates to the native host library when
        built (numpy fallback has identical semantics)."""
        # the only in-repo call uses the full range and takes the native
        # path below; the inline loop is the general-range fallback —
        # keep its quirks (the <= tie rule, mid==left/right early return)
        # in lockstep with native/__init__.py + kompass_host.cpp
        if left == 0 and right == self._max_segment_index:
            return find_closest_segment(
                self._path.xs,
                self._path.ys,
                self._path.segment_starts,
                self.current_state.x,
                self.current_state.y,
            )
        while left != right:
            mid = (left + right) // 2
            ls = self._path.segment_start_point(left)
            rs = self._path.segment_start_point(right)
            left_d = self._dist_sq_to(ls[0], ls[1])
            right_d = self._dist_sq_to(rs[0], rs[1])
            if mid == right or mid == left:
                return left if left_d <= right_d else right
            if left_d <= right_d:
                right = mid
            else:
                left = mid
        return left

    def _find_closest_point_on_segment(self, segment_index: int) -> PathPosition:
        """Linear scan over a segment's points; ties keep the later point
        (`<=` comparison in follower.cpp:225). Native-accelerated."""
        start_index = self._path.segment_start_index(segment_index)
        end_index = self._path.segment_end_index(segment_index)
        n = end_index - start_index + 1
        start = self._path.segment_start_point(segment_index)
        end = self._path.segment_end_point(segment_index)
        segment_heading = math.atan2(end[1] - start[1], end[0] - start[0])

        global_idx, min_val = closest_point_on_segment(
            self._path.xs,
            self._path.ys,
            start_index,
            end_index,
            self.current_state.x,
            self.current_state.y,
        )
        closest_idx = global_idx - start_index

        pos = PathPosition()
        pos.index = global_idx
        pos.segment_index = segment_index
        pos.segment_length = (closest_idx / (n - 1)) if n > 1 else 1.0
        pos.x = float(self._path.xs[global_idx])
        pos.y = float(self._path.ys[global_idx])
        pos.yaw = segment_heading
        pos.normal_distance = math.sqrt(float(min_val))
        # signed crosstrack via cross product (follower.cpp:247-261)
        vec_x = self.current_state.x - pos.x
        vec_y = self.current_state.y - pos.y
        cross = math.cos(pos.yaw) * vec_y - math.sin(pos.yaw) * vec_x
        pos.parallel_distance = (
            pos.normal_distance if cross > 0 else -pos.normal_distance
        )
        return pos

    def _find_closest_path_point(self) -> PathPosition:
        self._current_segment_index = self._find_closest_segment_index(
            0, self._max_segment_index
        )
        return self._find_closest_point_on_segment(self._current_segment_index)

    def determine_target(self) -> FollowingTarget:
        """Sticky target determination (follower.cpp:266-304): re-search
        globally only when entering a segment, passing its end, or passing
        90% of its length."""
        if (
            self._closest.segment_length <= 0.0
            or self._closest.index
            >= self._path.segment_end_index(self._current_segment_index)
            or self._closest.segment_length >= 0.9
        ):
            self._closest = self._find_closest_path_point()
        else:
            self._closest = self._find_closest_point_on_segment(
                self._closest.segment_index
            )

        target = FollowingTarget()
        target.segment_index = self._current_segment_index
        target.position_in_segment = self._closest.segment_length
        target.movement = RobotState(
            x=self._closest.x, y=self._closest.y, yaw=self._closest.yaw
        )
        target.lookahead = self.config.lookahead_distance
        target.heading_error = normalize_to_minus_pi_pi(
            self._closest.yaw - self.current_state.yaw
        )
        target.crosstrack_error = self._closest.parallel_distance
        target.reverse = False
        self._target = target
        return target

    @staticmethod
    def is_forward_segment(
        seg1_start, seg1_orientation, seg2_start, seg2_orientation
    ) -> bool:
        """Whether segment 2 continues forward from segment 1
        (follower.cpp:306-317). Faithful port INCLUDING the reference's
        quirky angle math: ``abs(normalizeTo02Pi(x))`` maps small negative
        differences to ~2*pi, so the test is asymmetric for clockwise
        bends and the right-hand side can go negative. Unexercised
        upstream (no callers in the reference either) — kept verbatim as
        parity surface, not as a recommended primitive."""
        angle_between = math.atan2(
            seg2_start[1] - seg1_start[1], seg2_start[0] - seg1_start[0]
        )
        return abs(
            normalize_to_0_2pi(seg2_orientation - angle_between)
        ) <= math.pi - abs(
            normalize_to_0_2pi(angle_between - seg1_orientation)
        )

    # --- speed regulation (follower.cpp:319-353) ---

    def exponential_speed_factor(self, current_angular_vel: float) -> float:
        """factor = max(exp(-(k_c * sum|kappa| + k_w * |omega|)), min_factor)
        integrating curvature over the lookahead distance ahead. Runs in
        the native host lib (kh_speed_factor; arithmetic-identical serial
        fallback) — this walk runs every tick for every follower."""
        if self._path is None or not self._path_processing:
            return 1.0
        return speed_factor(
            self._path.xs,
            self._path.ys,
            self._path.curvature,
            self._closest.index,
            self.config.lookahead_distance,
            self.config.speed_regulation_curvature,
            self.config.speed_regulation_angular,
            current_angular_vel,
            self.config.min_speed_regulation_factor,
        )
