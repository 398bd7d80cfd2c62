"""Egocentric local occupancy mapper (Python front-end).

Port of ``kompass_core_tpu/mapping/local_mapper.py``, with the same API
plus an explicit ``device``: grid sizing and pose bookkeeping,
laserscan / pointcloud dispatch into ``ops/mapping.py``, Bayesian
temporal fusion with previous-grid re-projection, and thresholding of
the probability layer into occupancy codes.

The probability grid stays on the device across updates; the occupancy
layers come back to the host as numpy arrays, as the JAX mapper gives
them.
"""

import math
from typing import Optional, Union

import numpy as np
import torch
from attrs import define, field

from kompass_core_tpu.datatypes.laserscan import LaserScanData
from kompass_core_tpu.datatypes.pointcloud import PointCloudData
from kompass_core_tpu.datatypes.pose import (
    PoseData,
    get_relative_pose,
    transform_point_from_local_to_global,
)
from kompass_core_tpu.datatypes.scan_model import ScanModelConfig
from kompass_core_tpu.utils.config import BaseAttrs, base_validators

from ..ops.mapping import (
    EMPTY,
    OCCUPIED,
    UNEXPLORED,
    MapperSpec,
    get_pointcloud_to_scan,
    get_scan_to_grid,
    get_scan_to_grid_bayesian_warped,
    get_warp_previous_grid,
    resample_scan_uniform,
)


@define
class GridData(BaseAttrs):
    """Occupancy + probabilistic occupancy layers
    (reference ``mapping/local_mapper.py:19-59``)."""

    width: int = field()
    height: int = field()
    p_prior: float = field(default=0.5)
    occupancy: np.ndarray = field(init=False)
    occupancy_prob: np.ndarray = field(init=False)

    def __attrs_post_init__(self):
        self.occupancy = self.get_initial_grid_data()
        self.occupancy_prob = self.get_initial_grid_data()

    def get_initial_grid_data(self) -> np.ndarray:
        # [height, width], the orientation the kernels emit, so the shape
        # is the same before and after the first scan
        return np.full((self.height, self.width), UNEXPLORED, dtype=np.int32)


@define(kw_only=True)
class MapConfig(BaseAttrs):
    """Local mapper configuration (reference
    ``mapping/local_mapper.py:62-104``)."""

    width: float = field(
        default=3.0, validator=base_validators.in_range(0.1, 1e2)
    )
    height: float = field(
        default=3.0, validator=base_validators.in_range(0.1, 1e2)
    )
    resolution: float = field(
        default=0.1, validator=base_validators.in_range(1e-9, 1e2)
    )
    padding: float = field(
        default=0.0, validator=base_validators.in_range(0.0, 10.0)
    )
    baysian_update: bool = field(default=False)
    max_num_threads: int = field(default=1)  # API parity; unused
    filter_limit: float = field(
        validator=base_validators.in_range(0.1, 1e2)
    )
    max_points_per_line: int = field(
        validator=base_validators.in_range(1, 1e3)
    )

    @filter_limit.default
    def _set_filter_limit(self) -> float:
        return (
            self.width * math.sqrt(2)
            if self.width >= self.height
            else self.height * math.sqrt(2)
        )

    @max_points_per_line.default
    def _set_max_points_per_line(self) -> int:
        return round((self.filter_limit / self.resolution) * 1.5)


class LocalMapper:
    """Produces an egocentric occupancy grid from laserscan/pointcloud on
    ``device``."""

    def __init__(
        self,
        config: MapConfig,
        scan_model_config: ScanModelConfig,
        pose_laser_scanner_in_robot: Optional[PoseData] = None,
        *,
        device,
    ):
        self.device = torch.device(device)
        self.config = config
        self.grid_width = int(config.width / config.resolution)
        self.grid_height = int(config.height / config.resolution)
        self.scan_model = scan_model_config

        self._local_lower_right_corner_point = PoseData()
        self._local_lower_right_corner_point.set_position(
            x=-config.width / 2, y=-config.height / 2, z=0
        )
        self._pose_robot_in_world = PoseData()
        self.lower_right_corner_pose = PoseData()

        self.pose_laserscanner_in_robot = (
            pose_laser_scanner_in_robot or PoseData()
        )
        self.laserscan_orientation_in_robot = 2 * np.arctan2(
            self.pose_laserscanner_in_robot.qz, self.pose_laserscanner_in_robot.qw
        )

        self.grid_data = GridData(
            width=self.grid_width,
            height=self.grid_height,
            p_prior=self.scan_model.p_prior,
        )
        self._spec: Optional[MapperSpec] = None
        self._prev_prob: Optional[torch.Tensor] = None  # [H, W] f32, device
        self._warped: Optional[torch.Tensor] = None
        self.is_pointcloud = False
        self.processed = False

    # --- properties (reference :171-187) ---

    @property
    def occupancy(self) -> np.ndarray:
        return self.grid_data.occupancy

    @property
    def probabilistic_occupancy(self) -> np.ndarray:
        return self.grid_data.occupancy_prob

    @property
    def previous_grid_prob_transformed(self) -> Optional[np.ndarray]:
        """The previous probability grid re-projected into the last
        update's pose (Bayesian updates only)."""
        return None if self._warped is None else self._warped.cpu().numpy()

    @property
    def _model(self):
        m = self.scan_model
        return (m.p_prior, m.p_empty, m.p_occupied, m.range_sure, m.range_max,
                m.wall_size)

    # --- internals ---

    def _initialize(self, scan_size: int):
        pos = self.pose_laserscanner_in_robot
        self._spec = MapperSpec(
            grid_height=self.grid_height,
            grid_width=self.grid_width,
            num_bins=scan_size,
            resolution=self.config.resolution,
            laserscan_position_x=float(pos.x),
            laserscan_position_y=float(pos.y),
            laserscan_orientation=float(self.laserscan_orientation_in_robot),
        )
        self._prev_prob = torch.full(
            (self.grid_height, self.grid_width),
            float(np.float32(self.scan_model.p_prior)),
            dtype=torch.float32,
            device=self.device,
        )

    @staticmethod
    def fill_grid_around_point(
        grid_data: np.ndarray,
        grid_point,
        grid_padding: int,
        indicator: int,
    ) -> None:
        """Stamp a clipped square patch of ``indicator`` around a grid cell,
        in place (reference ``fillGridAroundPoint``,
        ``local_mapper.cpp:80-105``). A host-side numpy edit."""
        h, w = grid_data.shape
        i, j = int(grid_point[0]), int(grid_point[1])
        i0, i1 = max(0, i - grid_padding), min(h - 1, i + grid_padding)
        j0, j1 = max(0, j - grid_padding), min(w - 1, j + grid_padding)
        if i0 <= i1 and j0 <= j1:
            grid_data[i0 : i1 + 1, j0 : j1 + 1] = indicator
        if 0 <= i < h and 0 <= j < w:
            grid_data[i, j] = indicator

    def get_previous_grid_in_current_pose(
        self,
        current_position_in_previous_pose,
        current_orientation_in_previous_pose: float,
        unknown_value: Optional[float] = None,
    ) -> np.ndarray:
        """Public re-projection entry (reference binding
        ``get_previous_grid_in_current_pose``)."""
        if self._spec is None:
            raise RuntimeError("Mapper not initialized (no scan processed)")
        warped = get_warp_previous_grid(self._spec, self.device)(
            self._prev_prob,
            np.asarray(current_position_in_previous_pose[:2], np.float32),
            np.float32(current_orientation_in_previous_pose),
            unknown_value if unknown_value is not None
            else self.scan_model.p_prior,
        )
        return warped.cpu().numpy()

    def _uniform_ranges(self, scan: LaserScanData):
        """Clip (reference :296-306) + resample to the uniform bin grid."""
        filtered = np.minimum(
            self.config.filter_limit, np.maximum(0.0, scan.ranges)
        )
        return resample_scan_uniform(
            scan.angles,
            filtered,
            self._spec.num_bins,
            self.config.filter_limit,
        )

    # --- main update (reference :249-341) ---

    def update_from_scan(
        self,
        robot_pose: PoseData,
        scan: Union[LaserScanData, PointCloudData],
    ):
        if self.processed and self.is_pointcloud != isinstance(
            scan, PointCloudData
        ):
            # switching sensor type mid-run re-initializes, as in the JAX
            # mapper
            self.processed = False
        if not self.processed:
            self.is_pointcloud = isinstance(scan, PointCloudData)
            if self.is_pointcloud:
                self._initialize(
                    math.ceil(2 * np.pi / self.scan_model.angle_step)
                )
            else:
                self._initialize(scan.ranges.size)

        # the Bayesian grid shift is the relative motion previous ->
        # current; copy the pose, since a caller may mutate one PoseData
        previous_pose = self._pose_robot_in_world
        self._pose_robot_in_world = PoseData(
            x=robot_pose.x, y=robot_pose.y, z=robot_pose.z,
            qx=robot_pose.qx, qy=robot_pose.qy, qz=robot_pose.qz,
            qw=robot_pose.qw,
        )
        self.lower_right_corner_pose = transform_point_from_local_to_global(
            self._local_lower_right_corner_point, robot_pose
        )

        if self.is_pointcloud:
            # no bucket padding: eager PyTorch does not compile per shape
            points = torch.from_numpy(
                np.asarray(scan.points, np.float32).reshape(-1, 3)
            ).to(self.device)
            ranges = get_pointcloud_to_scan(self._spec.num_bins, self.device)(
                points,
                self.scan_model.range_max,
                self.scan_model.min_height,
                self.scan_model.max_height,
            )
        else:
            ranges = torch.from_numpy(self._uniform_ranges(scan)).to(self.device)

        if self.config.baysian_update:
            shift = np.zeros(3, np.float32)
            if self.processed:
                rel = get_relative_pose(
                    pose_1_in_ref=previous_pose, pose_2_in_ref=robot_pose
                )
                shift[:] = (rel.x, rel.y, rel.get_yaw())
            shift = torch.from_numpy(shift).to(self.device)
            # warp + Bayes on the device (reference :224-247 + :161)
            occ, prob, warped = get_scan_to_grid_bayesian_warped(
                self._spec, self.device
            )(ranges, self._prev_prob, shift[:2], shift[2], *self._model)
            self._prev_prob = prob
            self._warped = warped
            p_prior = torch.full((), float(np.float32(self.scan_model.p_prior)),
                                 device=self.device)
            thresholded = torch.where(
                prob > p_prior, OCCUPIED,
                torch.where(prob < p_prior, EMPTY, UNEXPLORED),
            ).to(torch.int32)
            occ, thresholded = torch.stack([occ, thresholded]).cpu().numpy()
            self.grid_data.occupancy = occ
            self.grid_data.occupancy_prob = thresholded
        else:
            occ = get_scan_to_grid(self._spec, self.device)(ranges)
            self.grid_data.occupancy = occ.cpu().numpy()

        self.processed = True
