"""Emergency stop checker (Python front-end).

Counterpart of ``kompass_core_tpu/utils/emergency_stop.py``, the API
mirror of the reference ``utils/emergency_stop.py:12-128``
(EmergencyChecker): lazy initialization on the first scan (LASERSCAN vs
POINTCLOUD mode), then per-tick slowdown-factor checks
(``ops/critical_zone.py``) on an explicit device.
"""

from typing import Optional, Union

import numpy as np

from ..datatypes import LaserScanData, PointCloudData
from ..datatypes.scan_model import ScanModelConfig
from ..models import Robot, RobotGeometry
from ..ops.critical_zone import (
    build_critical_zone,
    get_critical_zone_checker,
    get_critical_zone_checker_cloud,
)
from ..ops.mapping import pad_cloud_to_bucket


class EmergencyChecker:
    """Minimum-safety-distance emergency stop using a critical cone, on
    ``device``."""

    def __init__(
        self,
        robot: Robot,
        emergency_distance: float,
        slowdown_distance: float,
        emergency_angle: float,
        scan_model: Optional[ScanModelConfig] = None,
        sensor_position_robot: Optional[np.ndarray] = None,
        sensor_rotation_robot: Optional[np.ndarray] = None,
        use_gpu: bool = False,  # accepted for API parity; ``device`` decides
        *,
        device,
        **_,
    ) -> None:
        self._device = device
        self._scan_model = scan_model or ScanModelConfig()
        self._emergency_distance = float(emergency_distance)
        self._slowdown_distance = float(slowdown_distance)
        self._emergency_angle = float(emergency_angle)
        self._sensor_position = (
            np.asarray(sensor_position_robot, np.float64)
            if sensor_position_robot is not None
            else np.zeros(3)
        )
        # quaternion (x, y, z, w); identity default
        self._sensor_rotation = (
            np.asarray(sensor_rotation_robot, np.float64)
            if sensor_rotation_robot is not None
            else np.array([0.0, 0.0, 0.0, 1.0])
        )
        self._robot_shape = robot.geometry_type.value
        self._robot_dimensions = np.asarray(robot.geometry_params, np.float64)
        self._robot_height = RobotGeometry.get_height(
            robot.geometry_type, robot.geometry_params
        )
        self._spec = None
        self._is_pointcloud = False

    def _init_checker(self, scan: Union[LaserScanData, PointCloudData]):
        self._is_pointcloud = isinstance(scan, PointCloudData)
        if self._is_pointcloud:
            # EXACTLY uniform k*2pi/N grid (N from the configured step):
            # the cloud is binned onto 2pi/N-wide bins, and an
            # arange(0, 2pi, step) grid with a non-divisor step drifts by
            # up to a bin at the wrap, misaligning the cone masks
            n_bins = max(int(round(2 * np.pi / self._scan_model.angle_step)), 4)
            angles = np.arange(n_bins) * (2 * np.pi / n_bins)
        else:
            angles = scan.angles
        self._spec_angles = np.array(angles, np.float64, copy=True)
        self._spec = build_critical_zone(
            robot_shape_type=self._robot_shape,
            robot_dimensions=self._robot_dimensions,
            sensor_position_body=self._sensor_position,
            sensor_rotation_body=self._sensor_rotation,
            critical_angle_deg=self._emergency_angle,
            critical_distance=self._emergency_distance,
            slowdown_distance=self._slowdown_distance,
            angles=angles,
        )

    def run(
        self,
        *_,
        scan: Union[LaserScanData, PointCloudData],
        forward: bool = True,
    ) -> float:
        """Slowdown factor for the latest scan: 0.0 = stop, 1.0 = clear."""
        is_pc = isinstance(scan, PointCloudData)
        if (
            self._spec is None
            or self._is_pointcloud != is_pc
            or (
                not is_pc
                and not np.array_equal(scan.angles, self._spec_angles)
            )
        ):
            # re-init when the sensor modality OR the angle grid changes —
            # a stale spec would crash on a different ray count or
            # silently evaluate against the wrong per-beam cone masks
            self._init_checker(scan)
        if self._is_pointcloud:
            fn = get_critical_zone_checker_cloud(self._spec, self._device)
            return float(
                fn(
                    pad_cloud_to_bucket(scan.points),
                    forward,
                    np.float32(self._scan_model.range_max),
                    np.float32(-self._robot_height),
                    np.float32(self._robot_height),
                )
            )
        fn = get_critical_zone_checker(self._spec, self._device)
        return float(fn(np.asarray(scan.ranges, np.float32), forward))
