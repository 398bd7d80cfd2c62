"""Vision-based target followers (RGB and RGB-D).

Ports of the reference's vision controllers:

* ``RGBFollower`` (``controllers/rgb_follower.cpp``): image-space visual
  servoing on a 2D box — size-ratio distance error and normalized center
  error drive a (v, omega) P-control — plus the target-lost recovery state
  machine (wait -> generated rotate/pause search sweep -> give up).
* ``RGBDFollower`` (``controllers/rgbd_follower.cpp``): DepthDetector lifts
  2D boxes to 3D, the feature tracker + Kalman filter smooths the target
  state, a tanh tracking law (with optional velocity feed-forward) builds a
  prediction-horizon reference trajectory by closed-loop simulation.

Python wrapper classes ``VisionRGBFollower`` / ``VisionRGBDFollower``
mirror the reference front-end (``control/rgb_follower.py`` /
``rgbd_follower.py``).
"""

import logging
import math
from collections import deque
from typing import List, Optional, Union

import numpy as np
from attrs import Factory, define, field

from ..datatypes.tracking import Bbox2D, Bbox3D, TrackedPose2D
from ..models import Robot, RobotCtrlLimits, RobotGeometry, RobotState, RobotType
from ..utils.angles import normalize_to_minus_pi_pi
from ..utils.config import BaseAttrs, base_validators
from ..vision.depth_detector import DepthDetector
from ..vision.tracker import FeatureBasedBboxTracker

logger = logging.getLogger("kompass_core_tpu_torch")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


# kw_only: the RGBD subclass re-defaults two inherited fields, which attrs
# relocates to the end of the generated __init__ — keyword-only
# construction makes that reordering unobservable
@define(kw_only=True)
class VisionRGBFollowerConfig(BaseAttrs):
    """(reference ``control/rgb_follower.py:13-90``)"""

    control_time_step: float = field(
        default=0.1, validator=base_validators.in_range(1e-6, 1e3)
    )
    control_horizon: int = field(
        default=2, validator=base_validators.in_range(1, 1000)
    )
    buffer_size: int = field(
        default=1, validator=base_validators.in_range(1, 100)
    )
    tolerance: float = field(
        default=0.1, validator=base_validators.in_range(0.0, 1.0)
    )
    target_distance: Optional[float] = field(default=None)
    target_wait_timeout: float = field(
        default=30.0, validator=base_validators.in_range(1e-3, 1e6)
    )
    target_search_timeout: float = field(
        default=30.0, validator=base_validators.in_range(1e-3, 1e6)
    )
    # search pause / gain defaults mirror the reference FRONT-END
    # (control/rgb_follower.py:56-66: pause 2.0, rotation 1.0, speed 0.7),
    # which overrides the C++ Parameter defaults (rgb_follower.h:32-35)
    target_search_pause: float = field(
        default=2.0, validator=base_validators.in_range(0.0, 1e6)
    )
    target_search_radius: float = field(
        default=0.5, validator=base_validators.in_range(1e-3, 1e3)
    )
    rotation_gain: float = field(
        default=1.0, validator=base_validators.in_range(1e-2, 10.0)
    )
    speed_gain: float = field(
        default=0.7, validator=base_validators.in_range(1e-2, 10.0)
    )
    min_vel: float = field(default=0.1)
    enable_search: bool = field(default=True)
    camera_position_to_robot: np.ndarray = field(
        default=Factory(lambda: np.zeros(3, np.float32))
    )
    camera_rotation_to_robot: np.ndarray = field(
        default=Factory(lambda: np.array([0, 0, 0, 1], np.float32))
    )


@define(kw_only=True)
class VisionRGBDFollowerConfig(VisionRGBFollowerConfig):
    """(reference ``control/rgbd_follower.py:22-258`` +
    ``rgbd_follower.h:23-88``)"""

    # >= 2: a 1-step horizon yields an empty velocity profile — the
    # follower would report success while never moving
    prediction_horizon: int = field(
        default=10, validator=base_validators.in_range(2, 1000)
    )
    # RGBD front-end re-defaults (control/rgbd_follower.py:170-258):
    # tighter distance tolerance, softer rotation gain, full speed gain
    distance_tolerance: float = field(default=0.05)
    angle_tolerance: float = field(default=0.1)
    rotation_gain: float = field(
        default=0.5, validator=base_validators.in_range(1e-2, 10.0)
    )
    speed_gain: float = field(
        default=1.0, validator=base_validators.in_range(1e-2, 10.0)
    )
    target_orientation: float = field(default=0.0)
    use_local_coordinates: bool = field(default=True)
    error_pose: float = field(default=0.05)
    error_vel: float = field(default=0.05)
    error_acc: float = field(default=0.05)
    depth_conversion_factor: float = field(default=1e-3)
    min_depth: float = field(default=0.0)
    max_depth: float = field(default=1e3)
    # metric following distance [m] (distinct from the RGB follower's
    # image-size-ratio target_distance)
    target_distance_m: float = field(default=1.0)


# ---------------------------------------------------------------------------
# RGB follower core
# ---------------------------------------------------------------------------


class RGBFollowerCore:
    """Image-space servoing + search state machine
    (``rgb_follower.cpp``)."""

    def __init__(
        self,
        robot_type: RobotType,
        ctrl_limits: RobotCtrlLimits,
        config: VisionRGBFollowerConfig,
    ):
        self.limits = ctrl_limits
        self.config = config
        self.rotate_in_place = robot_type in (
            RobotType.DIFFERENTIAL_DRIVE,
            RobotType.OMNI,
        )
        self._target_distance = config.target_distance
        self.dist_error = 0.0
        self.orientation_error = 0.0
        self._out_vel = (0.0, 0.0, 0.0)
        self._search_command = (0.0, 0.0, 0.0)
        self._search_queue: deque = deque()
        self._recorded_wait_time = 0.0
        self._recorded_search_time = 0.0
        self._last_tracking: Optional[Bbox2D] = None

    # --- target management (rgb_follower.cpp:22-35) ---

    def reset_target(self, target: Bbox2D):
        self._search_queue.clear()
        size = float(target.size[0] * target.size[1]) / float(
            target.img_size[0] * target.img_size[1]
        )
        self._target_distance = size

    # --- search command generation (rgb_follower.cpp:37-99) ---

    def _generate_search_commands(
        self, total_rotation, search_radius, max_rotation_time, enable_pause=False
    ):
        rotation_sign = -1.0 if total_rotation < 0.0 else 1.0
        dt = self.config.control_time_step
        rotation_time = max_rotation_time
        num_pause_steps = int(self.config.target_search_pause / dt)
        if enable_pause:
            # reference quirk kept verbatim (rgb_follower.cpp:46-49): the
            # formula divides steps by dt (dimensionally off, goes
            # negative for realistic configs); latent upstream too, since
            # getFindTargetCmds never passes enable_pause=true
            rotation_time = max_rotation_time * (1 - num_pause_steps / dt)
        omega_val = total_rotation / rotation_time
        # reference quirk kept verbatim (rgb_follower.cpp:53-56): the
        # SIGNED omega is floored by the positive min_vel, so negative
        # sweeps (the -2*pi return segment) run at min_vel magnitude
        omega_val = max(
            min(omega_val, self.limits.omega_limits.max_vel),
            self.config.min_vel,
        )
        t = 0.0
        while t <= max_rotation_time:
            if self.rotate_in_place:
                self._search_queue.append((0.0, 0.0, rotation_sign * omega_val))
            else:
                omega_ackermann = (
                    rotation_sign * self.limits.vx_limits.max_vel / search_radius
                )
                self._search_queue.append(
                    (self.limits.vx_limits.max_vel, 0.0, omega_ackermann)
                )
            if enable_pause:
                for _ in range(num_pause_steps + 1):
                    self._search_queue.append((0.0, 0.0, 0.0))
            t += dt

    def get_find_target_cmds(self, last_direction: int):
        """pi sweep, -2pi back, pi again (rgb_follower.cpp:82-99)."""
        self._search_queue.clear()
        part = self.config.target_search_timeout / 4
        r = self.config.target_search_radius
        self._generate_search_commands(last_direction * math.pi, r, part)
        self._generate_search_commands(
            -2.0 * last_direction * math.pi, r, 2.0 * part
        )
        self._generate_search_commands(last_direction * math.pi, r, part)

    # --- main entry (rgb_follower.cpp:101-149) ---

    def run(self, target: Optional[Bbox2D]) -> bool:
        if target is not None:
            # reference quirks kept verbatim (rgb_follower.cpp:101-117):
            # reacquiring a target resets the clocks but does NOT clear a
            # half-consumed search queue (a later loss resumes the stale
            # sweep), and after a give-up get_ctrl returns the last
            # tracking command (callers must treat run()==False as stop)
            self._recorded_wait_time = 0.0
            self._recorded_search_time = 0.0
            self._last_tracking = target
            self._track_target(target)
            return True
        if self.config.enable_search:
            if self._recorded_search_time < self.config.target_search_timeout:
                if not self._search_queue:
                    last_direction = 1
                    if self._last_tracking is not None:
                        c = self._last_tracking.get_center()
                        # reference quirk kept verbatim
                        # (rgb_follower.cpp:121-123): compares center.x
                        # against HALF CENTER.Y (not half image width)
                        last_direction = 1 if (c[0] - c[1] / 2.0) > 0.0 else -1
                        self._last_tracking = None
                    self.get_find_target_cmds(last_direction)
                self._search_command = self._search_queue.popleft()
                self._recorded_search_time += self.config.control_time_step
                return True
            self._recorded_search_time = 0.0
            return False
        if self._recorded_wait_time < self.config.target_wait_timeout:
            self._last_tracking = None
            self._recorded_wait_time += self.config.control_time_step
            return True
        self._recorded_wait_time = 0.0
        return False

    # --- servoing law (rgb_follower.cpp:151-222) ---

    def _track_target(self, target: Bbox2D):
        current_dist = float(target.size[0] * target.size[1]) / float(
            target.img_size[0] * target.img_size[1]
        )
        if self._target_distance is None:
            self._target_distance = current_dist
        # a degenerate (zero-area) reference box would divide by zero
        # below — C++ float division degrades to inf, Python raises;
        # floor the reference ratio instead
        self._target_distance = max(self._target_distance, 1e-6)
        self.dist_error = self._target_distance - current_dist
        distance_tolerance = self.config.tolerance * self._target_distance
        center = target.get_center()
        error_y = 2.0 * (float(center[1]) / float(target.img_size[1]) - 0.5)
        error_x = 2.0 * (float(center[0]) / float(target.img_size[0]) - 0.5)
        self.orientation_error = error_x

        if (
            abs(self.dist_error) < distance_tolerance
            and abs(error_y) < self.config.tolerance
            and abs(error_x) < self.config.tolerance
        ):
            self._out_vel = (0.0, 0.0, 0.0)
            return

        dist_speed = (
            (self.dist_error / self._target_distance)
            * self.limits.vx_limits.max_vel
            if abs(self.dist_error) > distance_tolerance
            else 0.0
        )
        omega = (
            -self.config.rotation_gain
            * error_x
            * self.limits.omega_limits.max_vel
        )
        v = self.config.speed_gain * dist_speed
        omega = omega if abs(omega) >= self.config.min_vel else 0.0
        w_lim = self.limits.omega_limits.max_vel
        omega = max(-w_lim, min(w_lim, omega))
        v = v if abs(v) >= self.config.min_vel else 0.0
        v_lim = self.limits.vx_limits.max_vel
        v = max(-v_lim, min(v_lim, v))
        self._out_vel = (v, 0.0, omega)

    def get_ctrl(self):
        """(rgb_follower.cpp:224-245)"""
        if self._recorded_search_time <= 0.0 and self._recorded_wait_time <= 0.0:
            return self._out_vel
        if self._recorded_search_time > 0.0:
            return self._search_command
        return (0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# RGBD follower core
# ---------------------------------------------------------------------------


class RGBDFollowerCore(RGBFollowerCore):
    """Depth-based following with tracker + reference-trajectory generation
    (``rgbd_follower.cpp``)."""

    def __init__(
        self,
        robot_type: RobotType,
        ctrl_limits: RobotCtrlLimits,
        robot_shape_type,
        robot_dimensions,
        config: VisionRGBDFollowerConfig,
    ):
        super().__init__(robot_type, ctrl_limits, config)
        self.config = config
        self.track_velocity = not config.use_local_coordinates
        self.tracker = FeatureBasedBboxTracker(
            config.control_time_step,
            config.error_pose,
            config.error_vel,
            config.error_acc,
        )
        self.detector: Optional[DepthDetector] = None
        self.robot_radius = RobotGeometry.get_radius(
            robot_shape_type, robot_dimensions
        )
        self.current_target_radius = 0.0
        self.current_state = RobotState()
        self._latest_cmd = (0.0, 0.0, 0.0)

    def set_camera_intrinsics(self, fx, fy, cx, cy):
        self.detector = DepthDetector(
            (self.config.min_depth, self.config.max_depth),
            self.config.camera_position_to_robot,
            self.config.camera_rotation_to_robot,
            (fx, fy),
            (cx, cy),
            self.config.depth_conversion_factor,
        )

    def set_current_state(self, x, y, yaw, speed=0.0):
        self.current_state = RobotState(x=x, y=y, yaw=yaw, speed=speed)

    # --- tracking law (rgbd_follower.cpp:77-146) ---

    def get_pure_tracking_ctrl(
        self, tracking_pose: TrackedPose2D, update_global_error=False
    ):
        if self.track_velocity:
            distance = (
                tracking_pose.distance(self.current_state.x, self.current_state.y)
                - self.robot_radius
                - self.current_target_radius
            )
            psi = normalize_to_minus_pi_pi(
                math.atan2(
                    tracking_pose.y - self.current_state.y,
                    tracking_pose.x - self.current_state.x,
                )
                - self.current_state.yaw
            )
            gamma = normalize_to_minus_pi_pi(
                tracking_pose.yaw - self.current_state.yaw
            )
        else:
            distance = (
                tracking_pose.distance(0.0, 0.0)
                - self.robot_radius
                - self.current_target_radius
            )
            psi = normalize_to_minus_pi_pi(
                math.atan2(tracking_pose.y, tracking_pose.x)
            )
            gamma = 0.0
        distance = max(distance, 0.001)
        distance_error = self.config.target_distance_m - distance
        angle_error = normalize_to_minus_pi_pi(
            self.config.target_orientation - psi
        )
        if update_global_error:
            self.dist_error = distance_error
            self.orientation_error = angle_error

        angle_diff = gamma - psi
        sin_diff = math.sin(angle_diff)
        cos_diff = math.cos(angle_diff)
        tv = 1.0 if self.track_velocity else 0.0

        v = omega = 0.0
        if (
            abs(distance_error) > self.config.distance_tolerance
            or abs(angle_error) > self.config.angle_tolerance
        ):
            v = tv * tracking_pose.v() * cos_diff - (
                self.config.speed_gain
                * self.limits.vx_limits.max_vel
                * math.tanh(distance_error)
            )
            v_lim = self.limits.vx_limits.max_vel
            v = max(-v_lim, min(v_lim, v))
            if abs(v) < self.config.min_vel:
                v = 0.0
            omega = (
                tv * tracking_pose.v() * sin_diff / distance
                + v * math.sin(psi) / distance
                - self.config.rotation_gain
                * self.limits.omega_limits.max_vel
                * math.tanh(angle_error)
            )
            w_lim = self.limits.omega_limits.max_vel
            omega = max(-w_lim, min(w_lim, omega))
            if abs(omega) < self.config.min_vel:
                omega = 0.0
        return (v, 0.0, omega)

    # --- initial tracking (rgbd_follower.cpp:148-208) ---

    def set_initial_tracking_boxes_3d(
        self, pose_x_img, pose_y_img, detected_boxes: List[Bbox3D], yaw=0.0
    ) -> bool:
        ok = self.tracker.set_initial_tracking_point(
            pose_x_img, pose_y_img, detected_boxes, yaw
        )
        if ok:
            self._refresh_target_geometry()
        return ok

    def set_initial_tracking_2d(
        self, aligned_depth_image, target_box_2d: Bbox2D, yaw=0.0
    ) -> bool:
        if self.detector is None:
            raise RuntimeError(
                "DepthDetector is not initialized with the camera intrinsics. "
                "Call set_camera_intrinsics first"
            )
        self.detector.update_boxes(
            aligned_depth_image,
            [target_box_2d],
            self.current_state if self.track_velocity else None,
        )
        boxes_3d = self.detector.get_3d_detections()
        if not boxes_3d:
            return False
        ok = self.tracker.set_initial_tracking_box(boxes_3d[0], yaw)
        if ok:
            self._refresh_target_geometry()
        return ok

    def _refresh_target_geometry(self):
        raw = self.tracker.get_raw_tracking()
        if raw is not None:
            sz = raw.box.size
            self.current_target_radius = 0.5 * max(float(sz[0]), float(sz[1]))

    # --- recovery stages (rgbd_follower.cpp:219-318) ---

    def _hold_result(self):
        n = self.config.control_horizon
        return [(0.0, 0.0, 0.0)] * max(n - 1, 1)

    def _pop_search_result(self):
        """Pop up to (control_horizon - 1) search commands. A PARTIAL
        batch is still returned when the queue drains mid-pop — returning
        None there would discard already-popped commands and spuriously
        give up before the search timeout, then restart a fresh search
        forever (the give-up path resets the search clock)."""
        cmds = []
        for _ in range(max(self.config.control_horizon - 1, 1)):
            if not self._search_queue:
                break
            cmds.append(self._search_queue.popleft())
            self._recorded_search_time += self.config.control_time_step
        return cmds or None

    def _try_wait(self):
        # reference quirk kept verbatim (rgbd_follower.cpp:258-269): the
        # wait clock advances by (control_horizon - 1) * dt per tick, so
        # control_horizon=1 never advances it (frozen wait upstream too)
        dt = self.config.control_time_step
        if self.config.enable_search:
            if self._recorded_wait_time >= dt:
                return None
            self._search_queue.clear()
            self._recorded_wait_time += (self.config.control_horizon - 1) * dt
            return self._hold_result()
        if self._recorded_wait_time >= self.config.target_wait_timeout:
            return None
        self._recorded_wait_time += (self.config.control_horizon - 1) * dt
        return self._hold_result()

    def _try_search(self):
        # reference quirk kept verbatim (rgbd_follower.cpp:219-241,
        # round-5 review confirmed the interplay): search resets the
        # wait clock and _try_wait clears the search queue, so with
        # search enabled the recovery OSCILLATES wait/search every other
        # tick — the queue regenerates each search tick and only its
        # first command ever executes (the robot rotates one way at half
        # cadence; the pi/-2pi/pi reversal never happens), and give-up
        # takes ~2x target_search_timeout. Also upstream: the sweep is
        # (re)generated BEFORE the timeout check, so the give-up tick
        # builds a queue it immediately discards.
        if not self.config.enable_search:
            return None
        self._recorded_wait_time = 0.0
        if not self._search_queue:
            last_direction = -1 if self._latest_cmd[2] < 0 else 1
            self.get_find_target_cmds(last_direction)
        if self._recorded_search_time >= self.config.target_search_timeout:
            return None
        return self._pop_search_result()

    def _give_up(self):
        self._recorded_wait_time = 0.0
        self._recorded_search_time = 0.0
        self._search_queue.clear()
        return None

    # --- reference trajectory (rgbd_follower.cpp:320-375) ---

    def _update_local_target(self, target: TrackedPose2D, cmd, dt):
        """Push the target back by the robot's own step
        (rgbd_follower.cpp:320-336)."""
        sx = cmd[0] * dt  # step in robot frame (vy=0 for these commands)
        sy = cmd[1] * dt
        syaw = cmd[2] * dt
        # robot step as a transform; apply its inverse to the target
        c, s = math.cos(syaw), math.sin(syaw)
        # inverse transform: R^T (p - t)
        px = c * (target.x - sx) + s * (target.y - sy)
        py = -s * (target.x - sx) + c * (target.y - sy)
        return TrackedPose2D(x=px, y=py, yaw=target.yaw)

    def get_tracking_reference_segment(self, tracking_pose: TrackedPose2D):
        """Closed-loop simulation of the tracking law over the prediction
        horizon (rgbd_follower.cpp:338-375). Returns (velocities, path)."""
        n = self.config.prediction_horizon
        dt = self.config.control_time_step
        initial = (
            RobotState(
                x=self.current_state.x,
                y=self.current_state.y,
                yaw=self.current_state.yaw,
            )
            if self.track_velocity
            else RobotState()
        )
        sim = RobotState(x=initial.x, y=initial.y, yaw=initial.yaw)
        sim_target = TrackedPose2D(
            x=tracking_pose.x,
            y=tracking_pose.y,
            yaw=tracking_pose.yaw,
            vx=tracking_pose.vx,
            vy=tracking_pose.vy,
            omega=tracking_pose.omega,
        )
        saved_state = self.current_state
        vels, path = [], []
        for step in range(n):
            path.append((sim.x, sim.y))
            self.current_state = sim
            cmd = self.get_pure_tracking_ctrl(sim_target, step == 0)
            c, s = math.cos(sim.yaw), math.sin(sim.yaw)
            sim = RobotState(
                x=sim.x + (cmd[0] * c - cmd[1] * s) * dt,
                y=sim.y + (cmd[0] * s + cmd[1] * c) * dt,
                yaw=sim.yaw + cmd[2] * dt,
            )
            if self.track_velocity:
                sim_target.update(dt)
            else:
                sim_target = self._update_local_target(sim_target, cmd, dt)
            if step < n - 1:
                vels.append(cmd)
        self.current_state = saved_state
        return vels, path

    # --- main dispatch (rgbd_follower.h:270-302) ---

    def get_tracking_ctrl_2d(
        self, aligned_depth_img, detected_boxes_2d: List[Bbox2D], current_vel
    ):
        if self.detector is None:
            raise RuntimeError("Camera intrinsics not set")
        if not self.tracker.tracker_initialized():
            raise RuntimeError("Tracker not initialized")
        tracked_pose = None
        if detected_boxes_2d:
            self.detector.update_boxes(
                aligned_depth_img,
                detected_boxes_2d,
                self.current_state if self.track_velocity else None,
            )
            boxes_3d = self.detector.get_3d_detections()
            if boxes_3d:
                if self.tracker.update_tracking(boxes_3d):
                    tracked_pose = self.tracker.get_filtered_tracked_pose_2d()
                    self._refresh_target_geometry()
        return self._dispatch(tracked_pose)

    def get_tracking_ctrl_3d(self, detected_boxes: List[Bbox3D], current_vel):
        # consistent with the 2D entry: a never-initialized follower must
        # raise rather than silently enter the wait/search state machine
        # on an empty detection list
        if not self.tracker.tracker_initialized():
            raise RuntimeError("Tracker not initialized")
        tracked_pose = None
        if detected_boxes:
            if self.tracker.update_tracking(detected_boxes):
                tracked_pose = self.tracker.get_filtered_tracked_pose_2d()
                self._refresh_target_geometry()
        return self._dispatch(tracked_pose)

    def _dispatch(self, tracked_pose: Optional[TrackedPose2D]):
        """Stage pipeline: follow -> wait -> search -> give up. Returns list
        of (vx, vy, omega) commands or None (no command possible)."""
        if tracked_pose is not None:
            self._recorded_wait_time = 0.0
            self._recorded_search_time = 0.0
            vels, _path = self.get_tracking_reference_segment(tracked_pose)
            if vels:
                self._latest_cmd = vels[0]
            return vels
        r = self._try_wait()
        if r is not None:
            return r
        r = self._try_search()
        if r is not None:
            return r
        return self._give_up()


# ---------------------------------------------------------------------------
# Python wrapper classes (reference control/rgb_follower.py /
# control/rgbd_follower.py API)
# ---------------------------------------------------------------------------


class VisionRGBFollower:
    """Wrapper exposing the ControllerTemplate surface."""

    def __init__(
        self,
        robot: Robot,
        ctrl_limits: RobotCtrlLimits,
        config: Optional[VisionRGBFollowerConfig] = None,
        config_file: Optional[str] = None,
        config_root_name: Optional[str] = None,
        **_,
    ):
        config = config or VisionRGBFollowerConfig()
        if config_file:
            config.from_file(config_file, config_root_name)
        self._config = config
        self._core = RGBFollowerCore(robot.robot_type, ctrl_limits, config)
        self._found = False

    def set_initial_tracking_2d_target(self, target_box: Bbox2D, **_) -> bool:
        self._core.reset_target(target_box)
        return True

    @property
    def dist_error(self) -> float:
        return self._core.dist_error

    @property
    def orientation_error(self) -> float:
        return self._core.orientation_error

    def loop_step(
        self, *, detections_2d: Optional[List[Bbox2D]] = None, **_
    ) -> bool:
        target = detections_2d[0] if detections_2d else None
        self._found = self._core.run(target)
        return self._found

    def logging_info(self) -> str:
        return f"RGB follower command: {self._core.get_ctrl()}"

    @property
    def linear_x_control(self) -> List[float]:
        return [self._core.get_ctrl()[0]]

    @property
    def linear_y_control(self) -> List[float]:
        return [self._core.get_ctrl()[1]]

    @property
    def angular_control(self) -> List[float]:
        return [self._core.get_ctrl()[2]]


class VisionRGBDFollower:
    """Wrapper exposing the FollowerTemplate-like surface."""

    def __init__(
        self,
        robot: Robot,
        ctrl_limits: RobotCtrlLimits,
        config: Optional[VisionRGBDFollowerConfig] = None,
        config_file: Optional[str] = None,
        config_root_name: Optional[str] = None,
        camera_focal_length=None,
        camera_principal_point=None,
        **_,
    ):
        config = config or VisionRGBDFollowerConfig()
        if config_file:
            config.from_file(config_file, config_root_name)
        if config.target_distance:
            config.target_distance_m = config.target_distance
        self._config = config
        self._core = RGBDFollowerCore(
            robot.robot_type,
            ctrl_limits,
            robot.geometry_type,
            robot.geometry_params,
            config,
        )
        if camera_focal_length is not None and camera_principal_point is not None:
            self.set_camera_intrinsics(
                camera_focal_length[0],
                camera_focal_length[1],
                camera_principal_point[0],
                camera_principal_point[1],
            )
        self._cmds: Optional[List] = None
        self._end_of_ctrl_horizon = max(config.control_horizon, 1)

    def set_camera_intrinsics(self, fx, fy, cx, cy) -> None:
        self._core.set_camera_intrinsics(fx, fy, cx, cy)

    def set_initial_tracking_2d_target(
        self,
        aligned_depth_image: np.ndarray,
        target_box: Bbox2D,
        yaw: float = 0.0,
        **_,
    ) -> bool:
        return self._core.set_initial_tracking_2d(
            aligned_depth_image, target_box, yaw
        )

    def set_initial_tracking_3d(
        self, pose_x_img, pose_y_img, detections_3d: List[Bbox3D], yaw=0.0
    ) -> bool:
        return self._core.set_initial_tracking_boxes_3d(
            pose_x_img, pose_y_img, detections_3d, yaw
        )

    @property
    def dist_error(self) -> float:
        return self._core.dist_error

    @property
    def orientation_error(self) -> float:
        return self._core.orientation_error

    def loop_step(
        self,
        *,
        current_state: Optional[RobotState] = None,
        aligned_depth_image: Optional[np.ndarray] = None,
        detections_2d: Optional[List[Bbox2D]] = None,
        detections_3d: Optional[List[Bbox3D]] = None,
        **_,
    ) -> bool:
        if current_state is not None:
            self._core.set_current_state(
                current_state.x, current_state.y, current_state.yaw
            )
        vel = (0.0, 0.0, 0.0)
        if detections_3d is not None:
            self._cmds = self._core.get_tracking_ctrl_3d(detections_3d, vel)
        elif detections_2d is not None and aligned_depth_image is not None:
            self._cmds = self._core.get_tracking_ctrl_2d(
                aligned_depth_image, detections_2d, vel
            )
        else:
            self._cmds = self._core._dispatch(None)
        return self._cmds is not None

    def has_result(self) -> bool:
        return self._cmds is not None

    def logging_info(self) -> str:
        return f"RGBD follower commands: {self._cmds}"

    @property
    def linear_x_control(self) -> Union[List[float], np.ndarray]:
        if self._cmds:
            return [c[0] for c in self._cmds[: self._end_of_ctrl_horizon]]
        return [0.0]

    @property
    def linear_y_control(self) -> Union[List[float], np.ndarray]:
        if self._cmds:
            return [c[1] for c in self._cmds[: self._end_of_ctrl_horizon]]
        return [0.0]

    @property
    def angular_control(self) -> Union[List[float], np.ndarray]:
        if self._cmds:
            return [c[2] for c in self._cmds[: self._end_of_ctrl_horizon]]
        return [0.0]
