"""DVZ controller: Stanley reference control + deformable-zone corrections.

Mirror of the reference ``control/dvz.py:53-308``: an internal Stanley
follower generates reference commands; the DVZ deformation modifies them
reactively based on the latest scan.
"""

import logging
from typing import List, Optional

import numpy as np
from attrs import define, field

from ..algorithms.dvz import DeformableVirtualZone, DeformableVirtualZoneParams
from ..datatypes.laserscan import LaserScanData
from ..models import Robot, RobotCtrlLimits, RobotState, RobotType
from ..utils.angles import normalize_to_0_2pi
from ..utils.config import base_validators
from .stanley import Stanley, StanleyConfig

logger = logging.getLogger("kompass_core_tpu_torch")


@define
class DVZConfig(DeformableVirtualZoneParams):
    """DVZ config + internal follower gains (reference ``control/dvz.py``)."""

    heading_gain: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1e2)
    )
    cross_track_gain: float = field(
        default=2.0, validator=base_validators.in_range(0.0, 1e2)
    )


class DVZ:
    """DVZ local planner."""

    def __init__(
        self,
        robot: Robot,
        ctrl_limits: RobotCtrlLimits,
        control_time_step: float = 0.1,
        config_file: Optional[str] = None,
        config: Optional[DVZConfig] = None,
        config_yaml_root_name: Optional[str] = None,
        **_,
    ):
        self._robot = robot
        self._control_time_step = control_time_step
        self._config = config = config or DVZConfig()
        self._path_controller = DeformableVirtualZone(
            robot=robot, ctrl_limits=ctrl_limits, config=config
        )
        if config_file:
            self._path_controller.set_from_yaml(config_file)
        self._dvz_linear = 0.0
        self._dvz_angular = 0.0
        # two reference quirks kept verbatim (control/dvz.py:99-110):
        # the generator StanleyConfig carries only the two gains, so
        # wheel_base stays the attrs default (NOT robot.wheelbase); and
        # `config_yaml_root_name=` does not match Stanley's
        # `config_root_name` parameter, so it lands in **_ and the YAML
        # root is ignored — both identical upstream
        self._ref = Stanley(
            robot=robot,
            ctrl_limits=ctrl_limits,
            config=StanleyConfig(
                heading_gain=config.heading_gain,
                cross_track_gain=config.cross_track_gain,
            ),
            config_file=config_file,
            config_yaml_root_name=config_yaml_root_name,
            generate_reference=True,
        )
        self.rotating_in_place = False
        logger.info("DVZ controller ready")

    # --- follower surface forwarded to the internal Stanley ---

    def reached_end(self) -> bool:
        return self._ref.reached_end()

    def interpolated_path(self):
        return self._ref.interpolated_path()

    def optimal_path(self):
        """No local plan is produced by DVZ (reference template default,
        ``control/_base_.py:300-303``)."""
        return None

    def set_interpolation_type(self, interpolation_type) -> None:
        return self._ref.set_interpolation_type(interpolation_type)

    @property
    def tracked_state(self) -> Optional[RobotState]:
        return self._ref.tracked_state

    @property
    def path(self) -> bool:
        return self._ref.path

    def set_path(self, global_path, **_) -> None:
        self._ref.set_path(global_path)

    @property
    def planner(self):
        return self._ref

    @property
    def distance_error(self) -> float:
        return self._ref.distance_error

    @property
    def orientation_error(self) -> float:
        return self._ref.orientation_error

    # --- control loop (reference control/dvz.py:151-221) ---

    def loop_step(
        self,
        *,
        laser_scan: LaserScanData,
        current_state: RobotState,
        initial_control_seq: Optional[np.ndarray] = None,
        debug: bool = False,
        **_,
    ) -> bool:
        if initial_control_seq is not None and len(initial_control_seq):
            ref_linear = initial_control_seq[0, 0]
            ref_angular = initial_control_seq[0, 2]
        else:
            ref_found = self._ref.loop_step(current_state=current_state)
            if not ref_found:
                ref_linear = 0.0
                ref_angular = 0.0
            else:
                ref_linear = self._ref.linear_x_control[0]
                ref_angular = self._ref.angular_control[0]

        self._get_dvz_deformation(laser_scan, debug)
        self._dvz_linear = self._path_controller.compute_linear_control(
            ref_linear, self._dvz_linear, self._control_time_step
        )
        self._dvz_angular = self._path_controller.compute_angular_control(
            ref_angular
        )
        return True

    def _get_dvz_deformation(self, laser_scan_data: LaserScanData, debug=False):
        if laser_scan_data.angles.any():
            angles = laser_scan_data.angles
        else:
            # build exactly len(ranges) angles: an arange from the scan
            # metadata can disagree with the ranges length and break the
            # elementwise deformation math downstream
            n = len(laser_scan_data.ranges)
            angles = normalize_to_0_2pi(
                laser_scan_data.angle_min
                + laser_scan_data.angle_increment * np.arange(n)
            )
        self._path_controller.update_zone_size(self._dvz_linear)
        self._path_controller.set_scan_values(
            scan_values=laser_scan_data.ranges, scan_angles=angles
        )
        self._path_controller.get_total_deformation(
            compute_deformation_plot=debug
        )

    def logging_info(self) -> str:
        return (
            f"Total DVZ deformation: {self._path_controller.total_deformation}"
        )

    # --- command sequencing (same rotate-then-move rule as Stanley) ---

    def _rotate_then_move(self) -> bool:
        return (
            self._robot.robot_type != RobotType.ACKERMANN
            and abs(self._dvz_angular) > self._ref._config.min_angular_vel
        )

    def _needs_pure_rotation(self) -> bool:
        return (
            abs(self.orientation_error) > self._ref._config.max_angle_error
            and abs(self.distance_error) < self._ref._config.max_distance_error
        )

    @property
    def linear_x_control(self) -> List[float]:
        if self._rotate_then_move():
            if self._needs_pure_rotation():
                return [0.0]
            return [0.0, self._dvz_linear]
        return [self._dvz_linear]

    @property
    def linear_y_control(self) -> List[float]:
        if self._rotate_then_move():
            if self._needs_pure_rotation():
                return [0.0]
            return [0.0, 0.0]
        return [0.0]

    @property
    def angular_control(self) -> List[float]:
        if self._rotate_then_move():
            if self._needs_pure_rotation():
                return [self._ref.in_place_rotation()]
            return [self._dvz_angular, 0.0]
        return [self._dvz_angular]
