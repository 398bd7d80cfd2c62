"""Motion-model calibration from recorded robot data.

Role of the reference's ``calibration.py:11-256``: least-squares fit of the
proportional ``MotionModel2D`` coefficients from a recorded ``MotionSample``
(state sequence + applied controls), plus a helper to replay the calibrated
model and compare.
"""

from typing import Optional, Tuple

import numpy as np

from .datatypes.path_sample import MotionSample, PathSample
from .models import MotionModel2D
from .simulation import RobotSim
from .utils.angles import normalize_to_minus_pi_pi


class ModelFitting:
    """Least-squares fit of the 2D proportional motion model."""

    def __init__(self, robot_data: Optional[MotionSample] = None):
        self._data = None
        if robot_data is not None:
            self.prep_data(robot_data)

    def prep_data(self, robot_data: MotionSample):
        """Build the regression matrices from finite differences of the
        recorded states (role of reference ``calibration.py:20-52``)."""
        x = robot_data.x_points
        y = robot_data.y_points
        yaw = robot_data.heading_points
        t = robot_data.time_points
        vx = robot_data.vx_points
        vy = robot_data.vy_points
        omega = robot_data.omega_points
        dt = np.diff(t)
        ok = dt > 1e-9
        dx = np.diff(x)[ok]
        dy = np.diff(y)[ok]
        # wrap yaw increments: recorded headings come wrapped to [-pi, pi]
        # (quaternion-derived), so a raw diff contains ~±2π jumps at the
        # wrap that poison the omega least-squares fit
        dyaw = normalize_to_minus_pi_pi(np.diff(yaw))[ok]
        dt = dt[ok]
        c = np.cos(yaw[:-1][ok])
        s = np.sin(yaw[:-1][ok])
        # controls applied over each interval are recorded at the interval's
        # end point
        vx_k = vx[1:][ok]
        vy_k = vy[1:][ok]
        w_k = omega[1:][ok]
        self._data = dict(
            dx_dt=dx / dt, dy_dt=dy / dt, dyaw_dt=dyaw / dt,
            c=c, s=s, vx=vx_k, vy=vy_k, omega=w_k,
        )

    def fit_data(self, log: bool = False) -> MotionModel2D:
        """Solve the three independent least-squares problems:
        dx/dt = a_xx vx cos(yaw) - a_xy vy sin(yaw)
        dy/dt = a_yx vx sin(yaw) + a_yy vy cos(yaw)
        dyaw/dt = a_w omega
        """
        if self._data is None:
            raise RuntimeError("Call prep_data first")
        d = self._data

        def solve(A, b, default):
            A = np.stack(A, axis=1)
            if A.size == 0 or np.allclose(A, 0):
                return np.asarray(default)
            sol, *_ = np.linalg.lstsq(A, b, rcond=None)
            return sol

        sx = solve([d["vx"] * d["c"], -d["vy"] * d["s"]], d["dx_dt"], [1.0, 1.0])
        sy = solve([d["vx"] * d["s"], d["vy"] * d["c"]], d["dy_dt"], [1.0, 1.0])
        denom = float(np.dot(d["omega"], d["omega"]))
        a_w = float(np.dot(d["omega"], d["dyaw_dt"]) / denom) if denom > 0 else 1.0

        # degenerate axes (e.g. vy always 0 for diff drive) fall back to 1.0
        def safe(v):
            return float(v) if np.isfinite(v) and abs(v) > 1e-9 else 1.0

        model = MotionModel2D(
            x_dot_prop_vx=safe(sx[0]),
            x_dot_prop_vy=safe(sx[1]),
            y_dot_prop_vx=safe(sy[0]),
            y_dot_prop_vy=safe(sy[1]),
            yaw_dot_prop_omega=safe(a_w),
        )
        return model


class Calibration:
    """End-to-end calibration helpers (reference ``calibration.py:110-256``)."""

    @classmethod
    def calibrate_data(cls, robot_data: MotionSample) -> MotionModel2D:
        fitting = ModelFitting(robot_data)
        return fitting.fit_data()

    @classmethod
    def simulate_calibrated_model_data(
        cls, robot_data: MotionSample, model: MotionModel2D
    ) -> Tuple[PathSample, float]:
        """Replay the recorded controls through the calibrated model and
        return (modeled path, RMS position error vs the recording)."""
        sim = RobotSim(model=model)
        sim.reset_state(
            x=robot_data.x_points[0],
            y=robot_data.y_points[0],
            yaw=robot_data.heading_points[0],
        )
        # replay with the RECORDED per-interval timing — a mean dt would
        # misalign variable-rate recordings and misreport model error
        dt = np.diff(robot_data.time_points)
        dt = np.where(dt > 0, dt, float(np.mean(dt[dt > 0])) if np.any(
            dt > 0
        ) else 0.1)
        modeled = sim.simulate_motion(
            robot_data.vx_points[1:],
            robot_data.omega_points[1:],
            dt,
            robot_data.vy_points[1:],
        )
        n = min(len(modeled.x_points), len(robot_data.x_points))
        err = np.hypot(
            modeled.x_points[:n] - robot_data.x_points[:n],
            modeled.y_points[:n] - robot_data.y_points[:n],
        )
        return modeled, float(np.sqrt(np.mean(err**2)))

    @classmethod
    def vis_calibration(
        cls, robot_data: MotionSample, modeled_path: PathSample
    ):
        """Plot real vs modeled motion per axis + the resulting paths
        (reference ``calibration.py:179-256``)."""
        import matplotlib.pyplot as plt

        fig, (ax0, ax1, ax2, ax3) = plt.subplots(
            nrows=4, ncols=1, figsize=(8, 8)
        )
        fig.suptitle("Calibration Results")
        fig.tight_layout(pad=3.0)
        n = min(len(modeled_path.x_points), len(robot_data.x_points))
        t = robot_data.time_points[:n]
        for ax, real, model, title in (
            (ax0, robot_data.x_points, modeled_path.x_points, "X-axis motion"),
            (ax1, robot_data.y_points, modeled_path.y_points, "Y-axis motion"),
            (
                ax2,
                robot_data.heading_points,
                modeled_path.heading_points,
                "Heading",
            ),
        ):
            ax.plot(t, real[:n], color="red", label="Real")
            ax.plot(t, model[:n], color="blue", label="Model")
            ax.legend()
            ax.set_title(title)
            ax.set_xlabel("time (s)")
        ax3.axis("equal")
        ax3.plot(
            robot_data.x_points, robot_data.y_points, color="red", label="Real"
        )
        ax3.plot(
            modeled_path.x_points,
            modeled_path.y_points,
            color="blue",
            label="Model",
        )
        ax3.legend()
        ax3.set_title("Path")
        return fig
