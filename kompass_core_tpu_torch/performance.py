"""Offline controller evaluation harness.

Role of the reference's ``performance.py:17-299``: run controllers against
canonical paths (via `RobotSim`), accumulate tracking metrics (lateral /
orientation errors, time-to-goal, success), and aggregate/export results.
"""

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

from .datatypes.path_sample import PathSample
from .motion_cost import ReferenceCost
from .simulation import RobotSim


class MotionResult:
    """Single-test result (reference ``performance.py:17-119``)."""

    def __init__(self) -> None:
        self.reached_end = False
        self.time_steps = 0
        self.time_to_goal = 0.0
        self.lateral_error_mean = 0.0
        self.orientation_error_mean = 0.0
        self.end_point_error = 0.0
        self.executed_path: Optional[PathSample] = None
        self.reference_path: Optional[PathSample] = None

    def compute_errors(self):
        if self.executed_path is None or self.reference_path is None:
            return
        cost = ReferenceCost(1.0)
        cost(self.executed_path, self.reference_path)
        self.lateral_error_mean = cost.lateral_error
        self.orientation_error_mean = cost.heading_error
        self.end_point_error = cost.end_error

    def to_dict(self) -> Dict:
        return {
            "reached_end": self.reached_end,
            "time_steps": self.time_steps,
            "time_to_goal": self.time_to_goal,
            "lateral_error_mean": self.lateral_error_mean,
            "orientation_error_mean": self.orientation_error_mean,
            "end_point_error": self.end_point_error,
        }

    def vis_result(
        self,
        test=None,
        robot_footprint=None,
        figure_title: str = "Figure 0",
    ):
        """Plot the test result: per-point tracking error + executed vs
        reference path, with the robot footprint at start/end (role of
        reference ``performance.py:29-118``; this engine records paths
        rather than raw command streams, so the error/path panels replace
        the reference's command panels)."""
        import matplotlib.pyplot as plt

        if self.executed_path is None:
            return None
        fig, (ax0, ax1) = plt.subplots(nrows=2, ncols=1, figsize=(8, 8))
        fig.suptitle(figure_title)
        fig.tight_layout(pad=3.0)

        if self.reference_path is not None and len(self.reference_path):
            dx = (
                self.executed_path.x_points[:, None]
                - self.reference_path.x_points[None, :]
            )
            dy = (
                self.executed_path.y_points[:, None]
                - self.reference_path.y_points[None, :]
            )
            lat_err = np.min(np.sqrt(dx * dx + dy * dy), axis=1)
            ax0.plot(lat_err)
            ax0.set_title("Lateral Distance Error (m)")
            ax0.set_xlabel("step")
            ax0.set_ylabel("Distance (m)")
            ax1.plot(
                self.reference_path.x_points,
                self.reference_path.y_points,
                color="red",
                label="reference",
            )
        ax1.axis("equal")
        ax1.plot(
            self.executed_path.x_points,
            self.executed_path.y_points,
            label="executed",
        )
        if robot_footprint is not None and len(self.executed_path):
            robot_footprint.plt_robot(
                self.executed_path.x_points[0],
                self.executed_path.y_points[0],
                self.executed_path.heading_points[0],
                ax=ax1,
                color="gray",
            )
            robot_footprint.plt_robot(
                self.executed_path.x_points[-1],
                self.executed_path.y_points[-1],
                self.executed_path.heading_points[-1],
                ax=ax1,
            )
        ax1.legend()
        ax1.set_title("Robot path")
        ax1.set_xlabel("X (m)")
        ax1.set_ylabel("Y (m)")
        return fig


class TestBase(RobotSim):
    """Robot-sim test fixture holding one reference path + result
    (reference ``performance.py:120-133``)."""

    def __init__(self, params_file: str) -> None:
        super().__init__(params_file=params_file)
        self.reset()

    def reset(self):
        """Reset test and result."""
        self.test: List = []
        self.result = MotionResult()


class TestAvgResults:
    """Aggregate over a batch of tests (reference ``performance.py:135-223``)."""

    def __init__(self) -> None:
        self.results: List[MotionResult] = []

    def add_test(self, result: MotionResult):
        self.results.append(result)

    @property
    def success_rate(self) -> float:
        if not self.results:
            return 0.0
        return float(np.mean([r.reached_end for r in self.results]))

    @property
    def avg_lateral_error(self) -> float:
        if not self.results:
            return 0.0
        return float(np.mean([r.lateral_error_mean for r in self.results]))

    @property
    def avg_time_to_goal(self) -> float:
        ok = [r.time_to_goal for r in self.results if r.reached_end]
        return float(np.mean(ok)) if ok else float("inf")

    def to_dict(self) -> Dict:
        return {
            "num_tests": len(self.results),
            "success_rate": self.success_rate,
            "avg_lateral_error": self.avg_lateral_error,
            "avg_time_to_goal": self.avg_time_to_goal,
            "tests": [r.to_dict() for r in self.results],
        }


class MotionEvaluation(RobotSim):
    """Closed-loop evaluation of a controller on a reference path
    (reference ``performance.py:224-299``)."""

    def __init__(self, robot=None, params_file: Optional[str] = None):
        super().__init__(robot=robot, params_file=params_file)
        self.avg_results = TestAvgResults()

    def run_test(
        self,
        controller,
        reference_path: PathSample,
        control_time_step: float = 0.1,
        max_steps: int = 1000,
        laser_scan=None,
    ) -> MotionResult:
        """Drive the controller in closed loop until the path end."""
        result = MotionResult()
        result.reference_path = reference_path
        path_pts = np.stack(
            [reference_path.x_points, reference_path.y_points], axis=1
        )
        controller.set_path(path_pts)
        self.reset_state(
            x=reference_path.x_points[0],
            y=reference_path.y_points[0],
            yaw=reference_path.heading_points[0],
        )
        xs, ys, hs = [], [], []
        steps = 0
        while steps < max_steps and not controller.reached_end():
            kwargs = {"current_state": self.robot.state}
            if laser_scan is not None:
                kwargs["laser_scan"] = laser_scan
            if not controller.loop_step(**kwargs):
                break
            for vx, vy, omega in zip(
                controller.linear_x_control,
                controller.linear_y_control,
                controller.angular_control,
            ):
                self.robot.set_control(
                    velocity_x=vx, velocity_y=vy, omega=omega
                )
                self.robot.get_state(dt=control_time_step)
                xs.append(self.robot.state.x)
                ys.append(self.robot.state.y)
                hs.append(self.robot.state.yaw)
                steps += 1
                if controller.reached_end():
                    break
        executed = PathSample(len(xs))
        executed.set_path(np.array(xs), np.array(ys), np.array(hs))
        result.executed_path = executed
        result.time_steps = steps
        result.time_to_goal = steps * control_time_step
        result.reached_end = controller.reached_end()
        result.compute_errors()
        self.avg_results.add_test(result)
        return result

    def compute_motion_cost(self, result: MotionResult, ref_path) -> float:
        """Accumulate the goal-tracking cost along an executed path
        (reference ``performance.py:248-257``). ``ref_path`` is a list of
        PathPoint; returns the weighted displacement cost total."""
        if result.executed_path is None:
            return 0.0
        self.end_goal_cost = ReferenceCost(1.0)
        weighted = 0.0
        for idx in range(len(result.executed_path.x_points)):
            weighted, _ = self.end_goal_cost.update(
                result.executed_path, idx, ref_path
            )
        return weighted

    def export(self, file_dir: str, name: str = "motion_evaluation"):
        os.makedirs(file_dir, exist_ok=True)
        path = os.path.join(file_dir, f"{name}.json")
        # avg_time_to_goal is +inf when no test reached its goal;
        # json.dump would emit the non-standard literal `Infinity`
        # (invalid strict JSON) — export null instead
        def _finite(v):
            if isinstance(v, float) and not math.isfinite(v):
                return None
            return v

        data = {k: _finite(v) for k, v in self.avg_results.to_dict().items()}
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
        return path
