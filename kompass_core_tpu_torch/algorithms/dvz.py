"""Deformable Virtual Zone (DVZ) reactive obstacle avoidance.

Re-implementation of the reference's pure-Python DVZ
(``algorithms/dvz.py:77-560``; Lapierre, Zapata & Lepinay 2007,
"Simultaneous Path Following and Obstacle Avoidance Control of a
Unicycle-type Robot"): a speed-scaled elliptic protection zone deformed by
scan intrusions; the total deformation and its mean orientation drive
corrective linear/angular accelerations blended with a reference control.

The per-beam deformation math here is vectorized over the whole scan
(NumPy) instead of the reference's per-beam Python loop — identical
formulas, ~100x fewer interpreter iterations.
"""

import math

import numpy as np
from attrs import define, field

from ..models import Robot, RobotCtrlLimits, RobotState
from ..utils.angles import normalize_to_0_2pi, normalize_to_minus_pi_pi
from ..utils.config import BaseAttrs, base_validators

EPSILON_ANG = 0.01


@define
class DeformableVirtualZoneParams(BaseAttrs):
    """DVZ parameters (defaults per reference ``algorithms/dvz.py:17-77``)."""

    min_front_margin: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1e2)
    )
    K_linear: float = field(
        default=1.0, validator=base_validators.in_range(0.1, 10.0)
    )
    K_angular: float = field(
        default=1.0, validator=base_validators.in_range(0.1, 10.0)
    )
    K_I: float = field(default=5.0, validator=base_validators.in_range(0.1, 10.0))
    side_margin_width_ratio: float = field(
        default=1.0, validator=base_validators.in_range(1e-2, 1e2)
    )


class DeformableVirtualZone:
    """Speed-scaled elliptic protection zone with intrusion-driven control."""

    def __init__(
        self,
        robot: Robot,
        ctrl_limits: RobotCtrlLimits,
        config: DeformableVirtualZoneParams,
    ) -> None:
        self.robot = robot
        self.config = config
        self.ctrl_limits = ctrl_limits
        self._set_control_regularization()
        self.zone_ori_shift = 0.0  # gamma in the paper
        self.zone_center_shift_y = 0.0  # a_y in the paper
        self.update_zone_size(
            robot_speed=robot.state.speed if robot.state else 0.0
        )
        zone_side_margin = robot.radius / config.side_margin_width_ratio
        self.zone_minor_radius = robot.radius + zone_side_margin
        # speed-derivatives of the zone parameters for the deformation
        # gradients; the minor radius and lateral shift are
        # speed-independent (reference ``algorithms/dvz.py:145-165``)
        self.zone_minor_radius_diff = 0.0
        self.zone_shift_y_diff = 0.0
        self.scan_values = np.zeros(0)
        self.scan_angles = np.zeros(0)
        self.total_deformation = 0.0
        self.deformation_orientation = 0.0
        self.deformation_regulation = 1.0
        self.deformation_plot = []

    def set_from_yaml(self, path_to_file: str) -> None:
        self.config.from_file(path_to_file, nested_root_name="DVZ")
        self._set_control_regularization()

    def _set_control_regularization(self) -> None:
        """Coefficients keeping corrective accelerations within limits
        (reference ``:129-143``)."""
        deformation_max_at_angle = 0.25
        angle_max_angular = np.pi / 4
        self.angular_regulation = self.ctrl_limits.omega_limits.max_acc / (
            angle_max_angular * deformation_max_at_angle
        )
        self.linear_regulation = (
            self.ctrl_limits.vx_limits.max_acc / deformation_max_at_angle
        )

    def update_zone_size(self, robot_speed: float) -> None:
        """Zone major radius grows with speed; 2/3 of the zone sits ahead of
        the robot (reference ``:145-165``)."""
        self.zone_major_radius = (
            1 + abs(robot_speed) / self.ctrl_limits.vx_limits.max_vel
        ) * self.config.min_front_margin
        self.zone_major_radius_diff = (
            self.config.min_front_margin / self.ctrl_limits.vx_limits.max_vel
        )
        zone_shift_const = 2.0 / 3.0
        sign_speed = 1.0 if robot_speed == 0 else float(np.sign(robot_speed))
        self.zone_center_shift_x = (
            -zone_shift_const * sign_speed * self.zone_major_radius
        )
        self.zone_shift_x_diff = -zone_shift_const * self.zone_major_radius_diff

    def set_scan_values(self, scan_values: np.ndarray, scan_angles: np.ndarray):
        self.scan_values = np.asarray(scan_values, np.float64)
        self.scan_angles = np.asarray(scan_angles, np.float64)

    def set_control_params(self, linear_gain, angular_gain, deformation_gain):
        self.config.K_linear = linear_gain
        self.config.K_angular = angular_gain
        self.config.K_I = deformation_gain
        self._set_control_regularization()

    def _undeformed_radii(self, alphas: np.ndarray) -> np.ndarray:
        """Ellipse boundary radius at each scan angle (vectorized port of
        ``_get_undeformed_radius``, reference ``:179-206``)."""
        ang = alphas - self.zone_ori_shift
        c, s = np.cos(ang), np.sin(ang)
        b = self.zone_minor_radius
        a = self.zone_major_radius
        ax, ay = self.zone_center_shift_x, self.zone_center_shift_y
        A = (b * c) ** 2 + (a * s) ** 2
        B = 2 * (ax * c * b**2 + ay * s * a**2)
        C = (ax * b) ** 2 + (ay * a) ** 2 - (a * b) ** 2
        num = np.sqrt(np.maximum(B**2 - 4 * A * C, 0.0))
        return (-B + num) / (2 * A)

    def get_gradients(self, angle: float) -> None:
        """Deformation-formula gradients w.r.t. control and shift angle
        ("J_A/B/C" terms of Lapierre 2007; reference
        ``algorithms/dvz.py:226-333,359-370``)."""
        a, b = self.zone_major_radius, self.zone_minor_radius
        da, db = self.zone_major_radius_diff, self.zone_minor_radius_diff
        ax_, ay = self.zone_center_shift_x, self.zone_center_shift_y
        dax, day = self.zone_shift_x_diff, self.zone_shift_y_diff
        c, s = np.cos(angle), np.sin(angle)
        self.grad_A_u = 2 * (b * db * c**2 + a * da * s**2)
        self.grad_A_ang = 2 * c * s * (b**2 - a**2)
        self.grad_B_u = 2 * (
            c * (b**2 * dax + 2 * ax_ * b * db)
            + s * (a**2 * day + 2 * ay * a * da)
        )
        self.grad_B_ang = 2 * (ax_ * b**2 * s - ay * a**2 * c)
        self.grad_C_u = 2 * (
            ax_ * b * (b * dax + ax_ * db)
            + ay * a * (a * day + ay * da)
            - a * b * (a * db + b * da)
        )

    def plt_robot_zone(
        self, robot_state: RobotState, fig_ax=None, display_now: bool = False
    ) -> None:
        """Plot the robot footprint, the elliptic zone and the current
        scan deformation polygon (reference ``algorithms/dvz.py:500-575``)."""
        import matplotlib.pyplot as plt
        from matplotlib.patches import Ellipse, Polygon

        if not fig_ax:
            fig_ax = plt.gca()
        self.robot.footprint.plt_robot(
            x=robot_state.x, y=robot_state.y, heading=robot_state.yaw, ax=fig_ax
        )
        fig_ax.set(aspect=1)
        # divergence (corrected debug plot): the zone-center shift is a
        # body-frame offset, rotated here by the robot yaw; the reference
        # applies it in world axes and hands matplotlib radians where
        # Ellipse(angle=...) expects degrees (``algorithms/dvz.py:529-543``)
        zone_angle = robot_state.yaw + self.zone_ori_shift
        c, s = np.cos(robot_state.yaw), np.sin(robot_state.yaw)
        zone_x = robot_state.x - (
            c * self.zone_center_shift_x - s * self.zone_center_shift_y
        )
        zone_y = robot_state.y - (
            s * self.zone_center_shift_x + c * self.zone_center_shift_y
        )
        fig_ax.add_patch(
            Ellipse(
                xy=(zone_x, zone_y),
                width=self.zone_major_radius * 2,
                height=self.zone_minor_radius * 2,
                angle=float(np.degrees(zone_angle)),
                color="red",
                alpha=0.5,
                fill=True,
            )
        )
        fig_ax.plot(zone_x, zone_y, "r+")
        if self.deformation_plot:
            deformation_plot_xy = [
                (
                    point[1] * np.cos(point[0]) + robot_state.x,
                    point[1] * np.sin(point[0]) + robot_state.y,
                )
                for point in self.deformation_plot
            ]
            fig_ax.add_patch(Polygon(deformation_plot_xy, fill=False))
        fig_ax.autoscale()
        if display_now:
            plt.show()

    def get_total_deformation(self, compute_deformation_plot: bool = False):
        """Accumulate intrusion depth and its mean orientation over the scan
        (vectorized port of reference ``:372-405``)."""
        self.total_deformation = 0.0
        self.deformation_orientation = 0.0
        self.deformation_plot = []
        n = len(self.scan_angles)
        if n == 0:
            return
        undeformed = self._undeformed_radii(self.scan_angles)
        deformed = np.minimum(self.scan_values, undeformed)
        if compute_deformation_plot:
            self.deformation_plot = list(zip(self.scan_angles, deformed))
        intruding = deformed < undeformed
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.where(
                intruding, (undeformed - deformed) / np.maximum(deformed, 1e-9), 0.0
            )
        self.total_deformation = float(np.sum(depth))
        self.deformation_orientation = float(
            np.sum(depth * normalize_to_0_2pi(self.scan_angles))
        )
        if self.total_deformation > 0.0:
            self.deformation_orientation /= self.total_deformation
            self.total_deformation /= n  # regularization_coeff = scan size
            self.deformation_regulation = 1.0 / (
                1.0 + self.config.K_I * self.total_deformation
            )

    def compute_linear_control(
        self, ref_control_linear: float, old_control: float, time_step: float
    ) -> float:
        """Blend a corrective deceleration with the reference linear control
        (reference ``:425-466``)."""
        if self.total_deformation > 0.0:
            # reference quirk kept verbatim (algorithms/dvz.py:438-441):
            # the [0, 2pi) mean orientation is wrapped to [-pi, pi] before
            # dividing, so a right-side obstacle flips the sign of the
            # correction and a near-zero wrapped angle leaves only the
            # +EPSILON guard between this and a huge acceleration
            orientation_regulated = (
                normalize_to_minus_pi_pi(self.deformation_orientation) + EPSILON_ANG
            )
            dvz_acc = (
                -self.config.K_linear
                * self.total_deformation
                * self.linear_regulation
                / orientation_regulated
            )
            dvz_control = dvz_acc * time_step + old_control
            linear = (
                1 - self.deformation_regulation
            ) * dvz_control + self.deformation_regulation * ref_control_linear
        else:
            linear = ref_control_linear
        return min(linear, self.ctrl_limits.vx_limits.max_vel)

    def compute_angular_control(self, ref_control_angular: float) -> float:
        """Steer away from the deformation centroid (reference ``:468-497``)."""
        if self.total_deformation > 0.0:
            inv_angle = normalize_to_minus_pi_pi(
                math.pi - self.deformation_orientation
            )
            dvz_control = (
                -self.config.K_angular
                * inv_angle
                * self.total_deformation
                * self.angular_regulation
            )
            angular = (
                1 - self.deformation_regulation
            ) * dvz_control + self.deformation_regulation * ref_control_angular
        else:
            angular = ref_control_angular
        return min(angular, self.ctrl_limits.omega_limits.max_vel)
