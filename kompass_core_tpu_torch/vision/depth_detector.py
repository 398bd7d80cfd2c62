"""Depth-based 3D detection: 2D boxes + aligned depth image -> 3D boxes.

Port of the reference ``DepthDetector`` (``vision/depth_detector.cpp``):
MAD-filtered median depth inside each 2D box, pinhole back-projection from
the optical frame into a body-aligned camera frame (x fwd, y left, z up),
then registration in the world frame via the robot state. The per-box depth
statistics are vectorized numpy over the image crop.
"""

import math
from typing import List, Optional, Sequence

import numpy as np

from ..datatypes.tracking import Bbox2D, Bbox3D, PointsOfInterest


def _quat_to_matrix(q):
    """Rotation matrix from quaternion (x, y, z, w)."""
    x, y, z, w = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _state_to_tf(x, y, yaw):
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = np.array([x, y, 0.0])
    return R, t


class DepthDetector:
    def __init__(
        self,
        depth_range: Sequence[float],
        camera_in_body_translation: Sequence[float],
        camera_in_body_rotation: Sequence[float],  # quaternion (x, y, z, w)
        focal_length: Sequence[float],
        principal_point: Sequence[float],
        depth_conversion_factor: float = 1e-3,
    ):
        self.min_depth = float(depth_range[0])
        self.max_depth = float(depth_range[1])
        self.depth_conversion_factor = float(depth_conversion_factor)
        self.fx, self.fy = (float(v) for v in focal_length)
        self.cx, self.cy = (float(v) for v in principal_point)
        self._cam_R = _quat_to_matrix(camera_in_body_rotation)
        self._cam_t = np.asarray(camera_in_body_translation, dtype=np.float64)
        self._body_R = np.eye(3)
        self._body_t = np.zeros(3)
        self._boxes: Optional[List[Bbox3D]] = None

    def set_robot_state(self, x: float, y: float, yaw: float):
        self._body_R, self._body_t = _state_to_tf(x, y, yaw)

    def get_3d_detections(self) -> Optional[List[Bbox3D]]:
        return self._boxes

    def update_boxes(
        self,
        aligned_depth_img: np.ndarray,
        detections: List[Bbox2D],
        robot_state=None,
    ):
        """(``depth_detector.cpp:52-67``)"""
        if robot_state is not None:
            self.set_robot_state(robot_state.x, robot_state.y, robot_state.yaw)
        self._boxes = []
        for box2d in detections:
            box3d = self._convert(aligned_depth_img, box2d)
            if box3d is not None:
                self._boxes.append(box3d)

    def update_pois(
        self,
        aligned_depth_img: np.ndarray,
        poi: PointsOfInterest,
        robot_state=None,
    ):
        if robot_state is not None:
            self.set_robot_state(robot_state.x, robot_state.y, robot_state.yaw)
        self._boxes = []
        box2d = Bbox2D.from_points_of_interest(poi)
        box3d = self._convert(aligned_depth_img, box2d)
        if box3d is not None:
            self._boxes.append(box3d)

    def _convert(
        self, depth_img: np.ndarray, box2d: Bbox2D
    ) -> Optional[Bbox3D]:
        """2D box -> 3D box (``depth_detector.cpp:84-151``)."""
        xl = box2d.get_x_limits()
        yl = box2d.get_y_limits()
        if depth_img.ndim == 3 and depth_img.shape[-1] == 1:
            depth_img = depth_img[..., 0]  # (H, W, 1) from cv_bridge etc.
        h, w = depth_img.shape
        # clamp BOTH slice ends to >= 0: a box fully outside the frame
        # would otherwise produce a negative end index, which Python
        # reads as from-the-end and crops nearly the whole image
        y0, y1 = max(0, yl[0]), max(0, min(h, yl[1] + 1))
        x0, x1 = max(0, xl[0]), max(0, min(w, xl[1] + 1))
        if y1 <= y0 or x1 <= x0:
            return None
        crop = depth_img[y0:y1, x0:x1]
        depths = crop.astype(np.float64).ravel() * self.depth_conversion_factor
        # reference parity (depth_detector.cpp:95, inclusive >= with a
        # 0.0 min_depth default): zero-valued no-return pixels PASS the
        # range filter, so a hole-dominated crop medians toward the
        # camera origin — callers with realsense-style sensors should
        # set min_depth above 0 to exclude the zero sentinel
        depths = depths[(depths >= self.min_depth) & (depths <= self.max_depth)]
        if depths.size <= 1:
            return None
        median = float(np.median(depths))
        mad = float(np.median(np.abs(depths - median)))
        # min/max depth within 1.5 MAD of the median
        inliers_low = depths[depths >= median - 1.5 * mad]
        inliers_high = depths[depths <= median + 1.5 * mad]
        minimum_d = inliers_low.min() if inliers_low.size else self.max_depth
        maximum_d = inliers_high.max() if inliers_high.size else self.min_depth

        # pinhole back-projection, optical -> body-aligned camera frame
        x_opt = (
            (box2d.top_left_corner[0] + 0.5 * box2d.size[0] - self.cx)
            * median
            / self.fx
        )
        y_opt = (
            (box2d.top_left_corner[1] + 0.5 * box2d.size[1] - self.cy)
            * median
            / self.fy
        )
        center_cam = np.array([median, -x_opt, -y_opt])
        size_cam = np.array(
            [
                maximum_d - minimum_d,
                box2d.size[0] * median / self.fx,
                box2d.size[1] * median / self.fy,
            ]
        )

        # camera -> body -> world
        R_cw = self._body_R @ self._cam_R
        t_cw = self._body_R @ self._cam_t + self._body_t
        center_world = R_cw @ center_cam + t_cw
        size_world = np.abs(R_cw) @ size_cam

        box3d = Bbox3D.from_2d(box2d)
        box3d.center = center_world.astype(np.float32)
        box3d.size = size_world.astype(np.float32)
        return box3d

