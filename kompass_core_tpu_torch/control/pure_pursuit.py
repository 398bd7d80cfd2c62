"""Pure Pursuit path-tracking controller with reactive obstacle avoidance.

Port of the reference (``controllers/pure_pursuit.cpp``): speed-scaled
lookahead ``L = max(L_min, k*v)``, circle-line-intersection lookahead point,
curvature law ``omega = v * 2 sin(alpha) / L``, omni vector-drive branch,
exponential curvature speed regulation, and the rollout collision gate with
omega/vy offset search (including reverse) from ``findSafeCommand``.

Collision checking uses the engine's point-robot model (circumscribed
radius + margin vs scan points in world frame) instead of FCL.
"""

import logging
import math
from typing import List, Optional

import numpy as np
from attrs import Factory, define, field

from ..models import Robot, RobotCtrlLimits, RobotState, RobotType
from ..native import find_lookahead
from ..ops.solver import COLLISION_MARGIN_FACTOR
from ..models.robot import restrict_velocity_to_limits
from ..utils.angles import normalize_to_minus_pi_pi
from ..utils.geometry import yaw_from_quaternion
from ..utils.config import base_validators
from .follower import Follower, FollowerConfig, FollowingTarget
from .result import FollowingResult, FollowingStatus, VelocityCommand

logger = logging.getLogger("kompass_core_tpu_torch")


@define
class PurePursuitConfig(FollowerConfig):
    """Pure Pursuit parameters (reference ``control/pure_pursuit.py``)."""

    control_time_step: float = field(
        default=0.1, validator=base_validators.in_range(1e-6, 1e3)
    )
    wheel_base: float = field(
        default=0.34, validator=base_validators.in_range(0.0, 100.0)
    )
    lookahead_gain_forward: float = field(
        default=0.8, validator=base_validators.in_range(0.1, 5.0)
    )
    prediction_horizon: int = field(
        default=10, validator=base_validators.in_range(0, 100)
    )
    path_search_step: float = field(
        default=0.2, validator=base_validators.in_range(0.001, 1000.0)
    )
    max_search_candidates: int = field(
        default=10, validator=base_validators.in_range(2, 1000)
    )
    octree_resolution: float = field(default=0.1)
    proximity_sensor_position_to_robot: np.ndarray = field(
        default=Factory(lambda: np.zeros(3, dtype=np.float32))
    )
    proximity_sensor_rotation_to_robot: np.ndarray = field(
        default=Factory(lambda: np.array([0, 0, 0, 1], dtype=np.float32))
    )


class PurePursuit(Follower):
    """Pure Pursuit controller."""

    def __init__(
        self,
        robot: Robot,
        ctrl_limits: RobotCtrlLimits,
        config: Optional[PurePursuitConfig] = None,
        config_file: Optional[str] = None,
        config_root_name: Optional[str] = None,
        control_time_step: Optional[float] = None,
        **_,
    ):
        config = config or PurePursuitConfig(wheel_base=robot.wheelbase)
        if config_file:
            config.from_file(config_file, config_root_name)
        if control_time_step:
            config.control_time_step = control_time_step
        is_ackermann = robot.robot_type == RobotType.ACKERMANN
        super().__init__(config=config, is_ackermann=is_ackermann)
        self._config = config
        # sensor-to-body 2D transform, honored like the reference wrapper
        # (control/pure_pursuit.py:143) and DWA's derivation
        self._sensor_yaw = yaw_from_quaternion(
            config.proximity_sensor_rotation_to_robot
        )
        self._sensor_pos = np.asarray(
            config.proximity_sensor_position_to_robot, dtype=np.float64
        )[:2]
        self.robot = robot
        self.ctrl_limits = ctrl_limits
        self._control_time_step = config.control_time_step
        self._is_omni = robot.robot_type == RobotType.OMNI
        self._last_found_index = 0
        self._current_vel = (0.0, 0.0, 0.0)
        self._obstacles_world: Optional[np.ndarray] = None
        self._result: Optional[FollowingResult] = None
        self._latest_cmd = VelocityCommand()
        # search offsets, reference quirk kept verbatim
        # (pure_pursuit.cpp:36-39): the loop strides i by 2 but scales by
        # (i+1), so the sequence is ODD multiples +-1,+-3,+-5,... * step,
        # not +-1,+-2,+-3,...
        n = config.max_search_candidates
        n += n % 2
        offs = []
        for i in range(0, n, 2):
            offs.append(config.path_search_step * (i + 1))
            offs.append(-config.path_search_step * (i + 1))
        self._search_offsets = offs
        logger.info("Pure Pursuit controller ready")

    # --- lookahead point (pure_pursuit.cpp:214-273) ---

    def find_lookahead_point(self, radius: float):
        # reference semantics kept (pure_pursuit.cpp:219-254): the loop
        # scans ALL remaining segments with no early break, so the LAST
        # circle intersection wins (on a switchback both legs intersect
        # and the far leg is chosen — upstream behavior). The scan runs in
        # the native host lib (kh_find_lookahead; arithmetic-identical
        # serial fallback) — the per-tick O(path) Python loop was the
        # host-side cost of this controller.
        path = self._path
        cx, cy = self.current_state.x, self.current_state.y
        found, tx, ty, idx = find_lookahead(
            path.xs, path.ys, self._last_found_index, cx, cy, radius
        )
        if found:
            target = np.array([tx, ty])
            self._last_found_index = idx
        else:
            xs, ys = path.xs, path.ys
            dist_to_end = math.hypot(float(xs[-1]) - cx, float(ys[-1]) - cy)
            if dist_to_end < radius:
                self._last_found_index = path.size() - 1
                return np.array([xs[-1], ys[-1]])
            return self.find_lookahead_point(1.1 * radius)
        # reference: currentTrackedTarget_->movement is set unconditionally
        # to the lookahead point (pure_pursuit.cpp:270) — PP's tracked state
        # is the lookahead target, not the closest path point
        if self._target is None:
            self._target = FollowingTarget()
        self._target.movement = RobotState(x=target[0], y=target[1], yaw=0.0)
        return target

    # --- collision gate (pure_pursuit.cpp:150-212) ---

    def _check_command_collisions(self, cmd: VelocityCommand, dt: float) -> bool:
        if self._obstacles_world is None or len(self._obstacles_world) == 0:
            return False
        r = self.robot.radius + self._config.octree_resolution * COLLISION_MARGIN_FACTOR
        x, y, yaw = (
            self.current_state.x,
            self.current_state.y,
            self.current_state.yaw,
        )
        obs = self._obstacles_world
        for _ in range(self._config.prediction_horizon):
            x += (cmd.vx * math.cos(yaw) - cmd.vy * math.sin(yaw)) * dt
            y += (cmd.vx * math.sin(yaw) + cmd.vy * math.cos(yaw)) * dt
            yaw += cmd.omega * dt
            d2 = (obs[:, 0] - x) ** 2 + (obs[:, 1] - y) ** 2
            if np.min(d2) < r * r:
                return True
        return False

    def _find_safe_command(self, nominal: VelocityCommand, dt: float):
        for reverse in (False, True):
            base_vx = -nominal.vx if reverse else nominal.vx
            # reference quirk kept verbatim (pure_pursuit.cpp:167-186):
            # ONE mutable candidate per phase — the omni lateral trial
            # sets candidate.vy = nominal.vy + off and the next offset's
            # "omega-only" trial inherits that stale vy, so omni omega
            # trials after the first are compound (vy_prev, omega_new)
            # candidates. Each phase (forward/reverse) resets the
            # candidate to nominal (pure_pursuit.cpp:189).
            vy = nominal.vy
            for off in self._search_offsets:
                cand = VelocityCommand(
                    vx=base_vx, vy=vy, omega=nominal.omega + off
                )
                if not self._check_command_collisions(cand, dt):
                    return cand
                if self._is_omni:
                    vy = nominal.vy + off
                    cand = VelocityCommand(
                        vx=base_vx, vy=vy, omega=nominal.omega
                    )
                    if not self._check_command_collisions(cand, dt):
                        return cand
        return VelocityCommand()

    # --- control law (pure_pursuit.cpp:43-141) ---

    def execute(self, time_step: float) -> FollowingResult:
        if not self._path_processing:
            status = (
                FollowingStatus.GOAL_REACHED
                if self._reached_goal
                else FollowingStatus.NO_COMMAND_POSSIBLE
            )
            return FollowingResult(status=status)

        # Reference quirk kept (pure_pursuit.cpp:43-141): execute() never
        # calls determineTarget(), so closestPosition stays at its
        # default-constructed index 0 (path.h:302) for the whole run and
        # calculateExponentialSpeedFactor (follower.cpp:329) always
        # integrates curvature from the PATH START, not from the robot's
        # current position. We mirror that by never advancing _closest here.
        vx0, vy0, w0 = self._current_vel
        lookahead = max(
            math.hypot(vx0, vy0) * self._config.lookahead_gain_forward,
            self.config.lookahead_distance,
        )
        target = self.find_lookahead_point(lookahead)
        dx = target[0] - self.current_state.x
        dy = target[1] - self.current_state.y
        alpha = normalize_to_minus_pi_pi(
            math.atan2(dy, dx) - self.current_state.yaw
        )
        dist = math.hypot(dx, dy)
        limits = self.ctrl_limits
        cmd_v = limits.vx_limits.max_vel * self.exponential_speed_factor(w0)

        if self._is_omni and abs(alpha) <= math.pi * 0.9:
            cmd = VelocityCommand(
                vx=cmd_v * math.cos(alpha),
                vy=cmd_v * math.sin(alpha),
                omega=2.0 * alpha,
            )
        else:
            curvature = 2.0 * math.sin(alpha) / max(dist, 0.001)
            cmd = VelocityCommand(vx=cmd_v, omega=cmd_v * curvature)

        v_safe = restrict_velocity_to_limits(
            vx0,
            cmd.vx,
            limits.vx_limits.max_acc,
            limits.vx_limits.max_decel,
            limits.vx_limits.max_vel,
            time_step,
        )
        if abs(cmd.vx) > 1e-4:
            cmd.omega *= v_safe / cmd.vx
        cmd.vx = v_safe
        self._latest_cmd = cmd

        gx, gy = self._path.end
        if (
            math.hypot(gx - self.current_state.x, gy - self.current_state.y)
            < self.config.goal_dist_tolerance
        ):
            self._reached_goal = True
            return FollowingResult(status=FollowingStatus.GOAL_REACHED)
        return FollowingResult(
            status=FollowingStatus.COMMAND_FOUND, velocity_command=cmd
        )

    def execute_with_sensor(self, time_step: float) -> FollowingResult:
        result = self.execute(time_step)
        if result.status != FollowingStatus.COMMAND_FOUND:
            return result
        if not self._check_command_collisions(result.velocity_command, time_step):
            return result
        safe = self._find_safe_command(result.velocity_command, time_step)
        return FollowingResult(
            status=FollowingStatus.COMMAND_FOUND, velocity_command=safe
        )

    # --- wrapper API ---

    def set_path(self, global_path, **_) -> None:
        from .dwa import DWA

        DWA.set_path(self, global_path)
        self._last_found_index = 0

    @property
    def path(self) -> bool:
        return self.has_path()

    def interpolated_path(self):
        return self._path

    def reached_end(self) -> bool:
        return self.is_goal_reached()

    def _update_obstacles(self, laser_scan=None, point_cloud=None):
        """Sensor data -> world obstacle points (same chain as DWA)."""
        if laser_scan is None and point_cloud is None:
            self._obstacles_world = None
            return
        from .dwa import DWA

        self._obstacles_world = DWA._obstacle_points_world(
            self, laser_scan, point_cloud
        )


    def loop_step(
        self,
        *,
        current_state: RobotState,
        laser_scan=None,
        point_cloud=None,
        local_map=None,
        **_,
    ) -> bool:
        """One controller iteration. ``local_map`` ([N, >=2] obstacle
        points already in the WORLD frame, e.g. occupied mapper cells)
        takes priority over the raw sensor inputs, mirroring the
        reference wrapper's overload dispatch
        (``control/pure_pursuit.py:175-190``) — silently dropping it
        would run the pursuit law with no collision gate at all."""
        self.set_current_state(
            current_state.x, current_state.y, current_state.yaw, current_state.speed
        )
        self._current_vel = (
            current_state.vx,
            current_state.vy,
            current_state.omega,
        )
        if local_map is not None:
            pts = np.atleast_2d(np.asarray(local_map, np.float32))[:, :2]
            # drop non-finite rows: one NaN defeats every collision
            # comparison (same rule as DWA._gather_obstacles)
            self._obstacles_world = pts[np.isfinite(pts).all(axis=1)]
            self._result = self.execute_with_sensor(self._control_time_step)
        elif laser_scan is not None or point_cloud is not None:
            self._update_obstacles(laser_scan, point_cloud)
            self._result = self.execute_with_sensor(self._control_time_step)
        else:
            self._result = self.execute(self._control_time_step)
        return self._result.status in (
            FollowingStatus.COMMAND_FOUND,
            FollowingStatus.GOAL_REACHED,
        )

    def logging_info(self) -> str:
        if self._result:
            v = self._result.velocity_command
            return (
                f"Follower status: {self._result.status}, cmd: vx={v.vx:.2f}, "
                f"vy={v.vy:.2f}, w={v.omega:.2f}"
            )
        return "Follower not started"

    @property
    def tracked_state(self) -> Optional[RobotState]:
        return self._target.movement if self._target else None

    @property
    def distance_error(self) -> float:
        return self._target.crosstrack_error if self._target else 0.0

    @property
    def orientation_error(self) -> float:
        return self._target.heading_error if self._target else 0.0

    @property
    def linear_x_control(self) -> List[float]:
        return [self._result.velocity_command.vx] if self._result else [0.0]

    @property
    def linear_y_control(self) -> List[float]:
        return [self._result.velocity_command.vy] if self._result else [0.0]

    @property
    def angular_control(self) -> List[float]:
        return [self._result.velocity_command.omega] if self._result else [0.0]
