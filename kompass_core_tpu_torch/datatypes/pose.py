"""2D/3D pose container with quaternion orientation.

Covers the role of the reference's ``datatypes/pose.py`` (PoseData) plus the
relative-pose helpers from ``utils/geometry.py`` that the mapper uses.
Planar math only (yaw about z) — the navigation stack is 2D.
"""

import math

import numpy as np
from attrs import define, field


@define
class PoseData:
    """Position + quaternion orientation (x, y, z, qx, qy, qz, qw)."""

    x: float = field(default=0.0)
    y: float = field(default=0.0)
    z: float = field(default=0.0)
    qx: float = field(default=0.0)
    qy: float = field(default=0.0)
    qz: float = field(default=0.0)
    qw: float = field(default=1.0)

    def set_position(self, x: float, y: float, z: float = 0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)

    def set_yaw(self, yaw: float):
        self.qx = self.qy = 0.0
        self.qz = math.sin(yaw / 2.0)
        self.qw = math.cos(yaw / 2.0)

    def set_orientation(self, qw: float, qx: float, qy: float, qz: float):
        """Set the quaternion components (reference
        ``datatypes/pose.py:72-88``)."""
        self.qw, self.qx, self.qy, self.qz = (
            float(qw),
            float(qx),
            float(qy),
            float(qz),
        )

    def set_pose(
        self,
        x: float,
        y: float,
        z: float,
        qw: float,
        qx: float,
        qy: float,
        qz: float,
    ):
        """Set position + orientation together (reference
        ``datatypes/pose.py:90-112``)."""
        self.set_position(x, y, z)
        self.set_orientation(qw, qx, qy, qz)

    def get_position(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z])

    def get_orientation(self) -> np.ndarray:
        """Quaternion as [qw, qx, qy, qz] (reference
        ``datatypes/pose.py:132-139``)."""
        return np.array([self.qw, self.qx, self.qy, self.qz])

    def check_approximate_equivalence(
        self, other: "PoseData", absolute_tolerance: float = 0.01
    ) -> bool:
        """Approximate position + orientation equality (reference
        ``datatypes/pose.py:176-201``); quaternions compare up to sign."""
        pos_ok = np.allclose(
            self.get_position(), other.get_position(), atol=absolute_tolerance
        )
        q1, q2 = self.get_orientation(), other.get_orientation()
        quat_ok = np.allclose(q1, q2, atol=absolute_tolerance) or np.allclose(
            q1, -q2, atol=absolute_tolerance
        )
        return bool(pos_ok and quat_ok)

    def get_yaw(self) -> float:
        return math.atan2(
            2.0 * (self.qw * self.qz + self.qx * self.qy),
            1.0 - 2.0 * (self.qy * self.qy + self.qz * self.qz),
        )


def get_relative_pose(pose_1_in_ref: PoseData, pose_2_in_ref: PoseData) -> PoseData:
    """Pose of frame 2 expressed in frame 1 (planar)."""
    yaw1 = pose_1_in_ref.get_yaw()
    dx = pose_2_in_ref.x - pose_1_in_ref.x
    dy = pose_2_in_ref.y - pose_1_in_ref.y
    c, s = math.cos(-yaw1), math.sin(-yaw1)
    rel = PoseData()
    rel.set_position(c * dx - s * dy, s * dx + c * dy, pose_2_in_ref.z - pose_1_in_ref.z)
    rel.set_yaw(pose_2_in_ref.get_yaw() - yaw1)
    return rel


def transform_point_from_local_to_global(
    point_local: PoseData, frame_in_global: PoseData
) -> PoseData:
    """Express a point given in a local frame in the global frame (planar)."""
    yaw = frame_in_global.get_yaw()
    c, s = math.cos(yaw), math.sin(yaw)
    out = PoseData()
    out.set_position(
        frame_in_global.x + c * point_local.x - s * point_local.y,
        frame_in_global.y + s * point_local.x + c * point_local.y,
        frame_in_global.z + point_local.z,
    )
    out.set_yaw(yaw + point_local.get_yaw())
    return out
