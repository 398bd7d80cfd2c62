"""Stanley path-tracking controller.

Port of the reference Stanley law (``controllers/stanley.cpp:30-105``) and
its Python wrapper behavior (``control/stanley.py``): steering from
crosstrack + heading error, steering->omega via the bicycle model, both
accel-limited, with the wrapper's rotate-then-move command sequencing for
non-Ackermann robots.
"""

import logging
import math
from typing import List, Optional

import numpy as np
from attrs import define, field

from ..models import Robot, RobotCtrlLimits, RobotState, RobotType
from ..models.robot import restrict_velocity_to_limits
from ..utils.angles import normalize_to_minus_pi_pi
from ..utils.config import base_validators
from .follower import Follower, FollowerConfig
from .result import FollowingResult, FollowingStatus, VelocityCommand

logger = logging.getLogger("kompass_core_tpu_torch")


@define
class StanleyConfig(FollowerConfig):
    """Stanley parameters (defaults per reference ``control/stanley.py``)."""

    control_time_step: float = field(
        default=0.1, validator=base_validators.in_range(1e-6, 1e3)
    )
    wheel_base: float = field(
        default=0.266, validator=base_validators.in_range(1e-3, 1e3)
    )
    heading_gain: float = field(
        default=0.7, validator=base_validators.in_range(0.0, 1e2)
    )
    cross_track_min_linear_vel: float = field(
        default=0.05, validator=base_validators.in_range(1e-4, 1e2)
    )
    cross_track_gain: float = field(
        default=1.5, validator=base_validators.in_range(0.0, 1e2)
    )
    max_angle_error: float = field(
        default=np.pi / 16, validator=base_validators.in_range(1e-9, np.pi)
    )
    max_distance_error: float = field(
        default=0.1, validator=base_validators.in_range(1e-9, 1e9)
    )
    min_angular_vel: float = field(
        default=0.01, validator=base_validators.in_range(0.0, 1e9)
    )


class Stanley(Follower):
    """Stanley lateral controller over the follower machinery."""

    def __init__(
        self,
        robot: Robot,
        ctrl_limits: RobotCtrlLimits,
        config: Optional[StanleyConfig] = None,
        config_file: Optional[str] = None,
        config_root_name: Optional[str] = None,
        control_time_step: Optional[float] = None,
        generate_reference: bool = False,
        **_,
    ):
        config = config or StanleyConfig(wheel_base=robot.wheelbase)
        if config_file:
            config.from_file(config_file, config_root_name)
        if control_time_step:
            config.control_time_step = control_time_step
        is_ackermann = robot.robot_type == RobotType.ACKERMANN
        super().__init__(config=config, is_ackermann=is_ackermann)
        self._config = config
        self.robot = robot
        self.ctrl_limits = ctrl_limits
        self._generate_reference = generate_reference
        self._latest_cmd = VelocityCommand()
        self._result = FollowingResult()
        self._control_time_step = config.control_time_step
        logger.info("Stanley controller ready")

    # --- control law (stanley.cpp:30-105) ---

    def compute_velocity_commands(self, time_step: float) -> FollowingResult:
        if not self._path_processing:
            status = (
                FollowingStatus.GOAL_REACHED
                if self._reached_goal
                else FollowingStatus.NO_COMMAND_POSSIBLE
            )
            return FollowingResult(status=status)

        target = self.determine_target()
        limits = self.ctrl_limits
        target_speed = (
            -limits.vx_limits.max_vel if target.reverse else limits.vx_limits.max_vel
        )
        steering = -self._config.cross_track_gain * math.atan2(
            target.crosstrack_error,
            max(abs(target_speed), self._config.cross_track_min_linear_vel),
        ) + self._config.heading_gain * normalize_to_minus_pi_pi(
            target.heading_error
        )

        vx = restrict_velocity_to_limits(
            self._latest_cmd.vx,
            target_speed,
            limits.vx_limits.max_acc,
            limits.vx_limits.max_decel,
            limits.vx_limits.max_vel,
            time_step,
        )
        max_steer = self.ctrl_limits.omega_limits.max_steer
        steering = min(max(steering, -max_steer), max_steer)
        omega_target = math.tan(steering) * abs(vx) / self._config.wheel_base
        omega = restrict_velocity_to_limits(
            self._latest_cmd.omega,
            omega_target,
            limits.omega_limits.max_acc,
            limits.omega_limits.max_decel,
            limits.omega_limits.max_vel,
            time_step,
        )
        self._latest_cmd = VelocityCommand(vx=vx, omega=omega, steer_ang=steering)
        return FollowingResult(
            status=FollowingStatus.COMMAND_FOUND, velocity_command=self._latest_cmd
        )

    def execute(self, current_state, time_step: float) -> FollowingResult:
        self.set_current_state(
            current_state.x, current_state.y, current_state.yaw,
            getattr(current_state, "speed", 0.0),
        )
        return self.compute_velocity_commands(time_step)

    # --- wrapper API (control/stanley.py) ---

    def set_path(self, global_path, **_) -> None:
        from .dwa import DWA  # reuse the flexible parser

        DWA.set_path(self, global_path)

    @property
    def path(self) -> bool:
        return self.has_path()

    def interpolated_path(self):
        return self._path

    def reached_end(self) -> bool:
        return self.is_goal_reached()

    def loop_step(self, *, current_state: RobotState, **_) -> bool:
        self.set_current_state(
            current_state.x, current_state.y, current_state.yaw, current_state.speed
        )
        if self.reached_end():
            return True
        self._result = self.compute_velocity_commands(self._control_time_step)
        return self._result.status == FollowingStatus.COMMAND_FOUND

    def logging_info(self) -> str:
        return (
            f"Follower status: {self._result.status}, command: "
            f"{self._result.velocity_command}"
        )

    @property
    def tracked_state(self) -> Optional[RobotState]:
        return self._target.movement if self._target else None

    @property
    def distance_error(self) -> float:
        return self._target.crosstrack_error if self._target else 0.0

    @property
    def orientation_error(self) -> float:
        return self._target.heading_error if self._target else 0.0

    def in_place_rotation(self) -> float:
        max_w = self.ctrl_limits.omega_limits.max_vel
        val = (
            max_w
            * self.orientation_error
            / (self._control_time_step * 2 * np.pi)
        )
        return min(max(val, -max_w), max_w)

    def _rotate_then_move(self) -> bool:
        """Wrapper sequencing rule (reference ``control/stanley.py:200-263``):
        non-Ackermann robots with significant omega rotate before moving."""
        return (
            self.robot.robot_type != RobotType.ACKERMANN
            and abs(self._latest_cmd.omega) > self._config.min_angular_vel
        )

    def _needs_pure_rotation(self) -> bool:
        return (
            abs(self.orientation_error) > self._config.max_angle_error
            and abs(self.distance_error) < self._config.max_distance_error
        )

    # The reached_end() zero-guard exists only in the generate_reference
    # branch — the non-generate branches return the stale pre-goal command
    # after arrival, exactly like the reference getters
    # (control/stanley.py:199-257)
    @property
    def linear_x_control(self) -> List[float]:
        if self._generate_reference:
            return [self._latest_cmd.vx] if not self.reached_end() else [0.0]
        if self._rotate_then_move():
            if self._needs_pure_rotation():
                return [0.0]
            return [0.0, self._latest_cmd.vx]
        return [self._latest_cmd.vx]

    @property
    def linear_y_control(self) -> List[float]:
        if self._generate_reference:
            return [self._latest_cmd.vy] if not self.reached_end() else [0.0]
        if self._rotate_then_move():
            if self._needs_pure_rotation():
                return [0.0]
            return [0.0, self._latest_cmd.vy]
        return [self._latest_cmd.vy]

    @property
    def angular_control(self) -> List[float]:
        if self._generate_reference:
            return [self._latest_cmd.omega] if not self.reached_end() else [0.0]
        if self._rotate_then_move():
            if self._needs_pure_rotation():
                return [self.in_place_rotation()]
            return [self._latest_cmd.omega, 0.0]
        return [self._latest_cmd.omega]
