"""Geometry helpers: angle conversion, quaternions, frame transforms.

Role of the reference's ``utils/geometry.py:10-335``.
"""

import math
from typing import Tuple

import numpy as np

from .angles import normalize_to_0_2pi, normalize_to_minus_pi_pi

convert_to_0_2pi = normalize_to_0_2pi
convert_to_plus_minus_pi = normalize_to_minus_pi_pi


def add_angle(angle1: float, angle2: float) -> float:
    """Wrap-aware angle addition into (-pi, pi] (reference
    ``utils/geometry.py:335-352``)."""
    result = angle1 + angle2
    if result > math.pi:
        result -= 2 * math.pi
    if result <= -math.pi:
        result += 2 * math.pi
    return result


def quaternion_from_euler(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """(x, y, z, w) quaternion from intrinsic ZYX euler angles."""
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


def euler_from_quaternion(q) -> Tuple[float, float, float]:
    """(roll, pitch, yaw) from an (x, y, z, w) quaternion."""
    x, y, z, w = (float(v) for v in q)
    roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sinp = 2 * (w * y - z * x)
    pitch = math.copysign(math.pi / 2, sinp) if abs(sinp) >= 1 else math.asin(sinp)
    yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def yaw_from_quaternion(q) -> float:
    x, y, z, w = (float(v) for v in q)
    return math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def quaternion_multiply(q1, q2) -> np.ndarray:
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def quaternion_inverse(q) -> np.ndarray:
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    return np.array([-x, -y, -z, w]) / n


def rotation_matrix_2d(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, -s], [s, c]])


def transform_points_2d(points, yaw: float, translation) -> np.ndarray:
    """Rotate-then-translate a set of [N, 2] points."""
    return np.asarray(points) @ rotation_matrix_2d(yaw).T + np.asarray(translation)


def from_frame1_to_frame2_2d(
    x_in_1: float, y_in_1: float, frame1_x: float, frame1_y: float,
    frame1_yaw: float,
) -> Tuple[float, float]:
    """Express a point given in frame 1 in the frame that contains frame 1
    at (x, y, yaw)."""
    c, s = math.cos(frame1_yaw), math.sin(frame1_yaw)
    return frame1_x + c * x_in_1 - s * y_in_1, frame1_y + s * x_in_1 + c * y_in_1


def distance(x1: float, y1: float, x2: float, y2: float) -> float:
    return math.hypot(x2 - x1, y2 - y1)


def probability_of_collision(
    mean_distance: float, sigma: float, collision_radius: float
) -> float:
    """Gaussian collision probability within the collision radius (used by
    the dynamic-obstacle motion cost)."""
    if sigma <= 0:
        return 1.0 if mean_distance <= collision_radius else 0.0
    z = (collision_radius - mean_distance) / (sigma * math.sqrt(2.0))
    return 0.5 * (1.0 + math.erf(z))


def probability_of_collision_array(
    mean_distance: np.ndarray, sigma: np.ndarray, collision_radius: float
) -> np.ndarray:
    """Vectorized ``probability_of_collision`` over arrays (broadcasts)."""
    from scipy.special import erf

    mean_distance = np.asarray(mean_distance, np.float64)
    sigma = np.asarray(sigma, np.float64)
    z = (collision_radius - mean_distance) / (
        np.maximum(sigma, 1e-300) * math.sqrt(2.0)
    )
    soft = 0.5 * (1.0 + erf(z))
    hard = (mean_distance <= collision_radius).astype(np.float64)
    return np.where(sigma <= 0, hard, soft)


def probability_of_collision_circles(
    obj_1_x: float,
    obj_1_y: float,
    obj_2_x: float,
    obj_2_y: float,
    obj_1_radius: float,
    obj_2_radius: float,
) -> float:
    """Collision probability of two circles as intersection-area /
    object-1-area (the reference's ``probability_of_collision``,
    ``utils/geometry.py:29-80``; renamed — this module's Gaussian
    ``probability_of_collision`` predates it). Fixed quirk: the
    reference's containment check compares ``abs(r1 - r1)`` (always 0), so
    true containment falls into the acos branch with an out-of-domain
    argument and raises; the intended ``abs(r1 - r2)`` is used here."""
    dist = math.hypot(obj_2_x - obj_1_x, obj_2_y - obj_1_y)
    if dist >= obj_1_radius + obj_2_radius:
        return 0.0
    if dist <= abs(obj_1_radius - obj_2_radius):
        return 1.0
    area_1 = obj_1_radius**2 * math.acos(
        (dist**2 + obj_1_radius**2 - obj_2_radius**2)
        / (2 * dist * obj_1_radius)
    )
    area_2 = obj_2_radius**2 * math.acos(
        (dist**2 + obj_2_radius**2 - obj_1_radius**2)
        / (2 * dist * obj_2_radius)
    )
    area_3 = -0.5 * math.sqrt(
        (dist + obj_1_radius + obj_2_radius)
        * (dist - obj_1_radius + obj_2_radius)
        * (dist + obj_1_radius - obj_2_radius)
        * (-dist + obj_1_radius + obj_2_radius)
    )
    return (area_1 + area_2 + area_3) / (math.pi * obj_1_radius**2)


def from_euler_to_quaternion(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """ZYX euler angles -> quaternion in [w, x, y, z] order — the
    reference's convention and argument order
    (``utils/geometry.py:191-218``); :func:`quaternion_from_euler` above is
    the [x, y, z, w]-ordered variant."""
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    return np.array(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            sy * cp * sr + cy * sp * cr,
            sy * cp * cr - cy * sp * sr,
        ]
    )


def from_2d_to_PoseData(x: float, y: float, heading: float):
    """2D pose -> PoseData (reference ``utils/geometry.py:220-240``)."""
    from ..datatypes.pose import PoseData

    pose = PoseData()
    pose.set_position(x, y, 0.0)
    pose.set_yaw(heading)
    return pose


def get_polar_transformation_vector(
    translation_x: float, translation_y: float
) -> list:
    """Cartesian translation -> polar [radius, angle]
    (reference ``utils/geometry.py:354-371``). Kept quirk: the angle is
    recovered with arccos, so it lands in [0, pi] and the sign of
    ``translation_y`` is discarded — identical to the reference."""
    r_tr = np.sqrt(translation_x**2 + translation_y**2)
    if r_tr > 0:
        return [r_tr, np.arccos(translation_x / r_tr)]
    return [0.0, 0.0]


def get_transform_polar_coordinates(radius, angle, transf_vec, rotation_angle):
    """Transform polar coordinates by a polar translation vector and a
    rotation (law of cosines on the radius; reference
    ``utils/geometry.py:373-404``). Works on scalars and arrays."""
    radius_new = np.sqrt(
        radius**2
        + transf_vec[0] ** 2
        - 2 * radius * transf_vec[0] * np.cos(angle - transf_vec[1])
    )
    angle_new = convert_to_0_2pi(
        convert_to_0_2pi(angle) + convert_to_0_2pi(rotation_angle)
    )
    return (radius_new, angle_new)


def get_laserscan_transformed_polar_coordinates(
    angle_min: float,
    angle_max: float,
    angle_increment: float,
    laser_scan_ranges: np.ndarray,
    max_scan_range: float,
    translation,
    rotation,
):
    """Transform a laser scan into a translated+rotated sensor frame using
    the polar-coordinates shortcut (reference
    ``utils/geometry.py:406-484``). ``rotation`` is an [x, y, z, w]
    quaternion. Kept quirk: the rotation angle is recovered as
    ``2*atan2(q.z, q.w)`` exactly like the reference (``:473``) — correct
    ONLY for pure-yaw quaternions; a roll/pitch-mounted sensor needs
    :func:`yaw_from_quaternion` semantics the reference does not apply."""
    from ..datatypes.laserscan import LaserScanData

    angles = np.arange(angle_min, angle_max + angle_increment, angle_increment)
    if len(angles) < len(laser_scan_ranges):
        raise ValueError(
            f"Missing laser scan ranges for angles in [{angle_min},"
            f" {angle_max}], got length {len(laser_scan_ranges)} of ranges"
            f" for {len(angles)} angles"
        )
    angles = angles[: len(laser_scan_ranges)]

    ranges = np.where(
        laser_scan_ranges != np.inf,
        np.minimum(laser_scan_ranges, max_scan_range),
        max_scan_range,
    )
    trans_vec = get_polar_transformation_vector(
        translation_x=translation[0], translation_y=translation[1]
    )
    rotation_angle = 2 * math.atan2(rotation[2], rotation[3])
    ranges_transformed, angles_transformed = get_transform_polar_coordinates(
        radius=ranges,
        angle=angles,
        transf_vec=trans_vec,
        rotation_angle=rotation_angle,
    )
    order = np.argsort(angles_transformed)
    sorted_angles = angles_transformed[order]
    sorted_ranges = ranges_transformed[order]
    return LaserScanData(
        angle_min=float(np.min(sorted_angles)),
        angle_max=float(np.max(sorted_angles)),
        angle_increment=angle_increment,
        angles=sorted_angles,
        range_min=float(np.min(sorted_ranges)),
        range_max=float(np.max(sorted_ranges)),
        ranges=sorted_ranges,
    )


# the planar pose helpers live with PoseData; re-exported here to match the
# reference's utils/geometry surface (``utils/geometry.py:164-189``)
from ..datatypes.pose import (  # noqa: E402,F401
    get_relative_pose,
    transform_point_from_local_to_global,
)
