"""Offline kinematic simulation and canonical test paths.

Role of the reference's ``simulation.py:11-327``: a parameter-driven robot
simulator (`RobotSim`) applying velocity sequences through the calibratable
motion model, and the canonical evaluation path generators
(circle / line / step / oval / u-turn) in `MotionPaths`.
"""

import math
from typing import Optional

import numpy as np

from .datatypes.path_sample import MotionSample, PathSample
from .models import MotionModel2D, Robot, RobotGeometry


class RobotSim:
    """Kinematic robot simulator for offline evaluation."""

    def __init__(
        self,
        robot: Optional[Robot] = None,
        params_file: Optional[str] = None,
        model: Optional[MotionModel2D] = None,
    ):
        self.robot = robot or Robot()
        if model is not None:
            self.robot.state.model = model
        if params_file:
            self.set_robot_params(params_file)

    def set_robot_params(self, path_to_file: str):
        """Load initial state / model parameters from a yaml/json file with
        a 'robot' root (role of reference ``simulation.py:19-69``)."""
        import json

        if path_to_file.endswith((".yaml", ".yml")):
            import yaml

            with open(path_to_file) as f:
                data = yaml.safe_load(f)
        else:
            with open(path_to_file) as f:
                data = json.load(f)
        robot = data.get("robot", data)
        st = self.robot.state
        st.x = robot.get("robot_initial_x", st.x)
        st.y = robot.get("robot_initial_y", st.y)
        st.yaw = robot.get("robot_initial_heading", st.yaw)
        st.speed = robot.get("robot_initial_speed", st.speed)
        for key in (
            "x_dot_prop_vx",
            "x_dot_prop_vy",
            "y_dot_prop_vx",
            "y_dot_prop_vy",
            "yaw_dot_prop_omega",
        ):
            if key in robot:
                setattr(st.model, key, robot[key])

    def init_robot(self, params_file: str):
        """Rebuild the testing robot (type, geometry, initial state) from a
        config file's 'robot' section (reference ``simulation.py:40-65``)."""
        import json

        if params_file.endswith((".yaml", ".yml")):
            import yaml

            with open(params_file) as f:
                data = yaml.safe_load(f)
        else:
            with open(params_file) as f:
                data = json.load(f)
        robot = data.get("robot", data)
        if "robot_model_type" in robot:
            # keep the attached motion model across the rebuild — a
            # calibrated model passed to the ctor (or via set_model) must
            # survive re-initialization from a geometry config
            model = self.robot.state.model
            self.robot = Robot(
                robot_type=robot["robot_model_type"],
                geometry_type=RobotGeometry.Type.from_str(
                    robot.get("robot_geometry_type", "CYLINDER")
                ),
                geometry_params=np.asarray(
                    robot.get("robot_geometry_params", [0.2, 0.5]), float
                ),
            )
            self.robot.state.model = model
        self.set_robot_params(params_file)

    def reset_state(self, x=0.0, y=0.0, yaw=0.0, speed=0.0):
        self.robot.state.x = x
        self.robot.state.y = y
        self.robot.state.yaw = yaw
        self.robot.state.speed = speed

    def simulate_motion(
        self,
        vx_sequence: np.ndarray,
        omega_sequence: np.ndarray,
        time_step: float,
        vy_sequence: Optional[np.ndarray] = None,
    ) -> MotionSample:
        """Apply a control sequence and record the resulting motion
        (role of reference ``simulation.py:71-123``)."""
        n = len(vx_sequence)
        if vy_sequence is None:
            vy_sequence = np.zeros(n)
        # scalar dt or one dt per step (variable-rate recordings replay
        # with their true timing)
        steps = np.broadcast_to(np.asarray(time_step, np.float64), (n,))
        times = np.concatenate([[0.0], np.cumsum(steps)])
        sample = MotionSample(n + 1)
        st = self.robot.state
        sample.set_sample_point(0, 0.0, st.x, st.y, st.yaw)
        for i in range(n):
            st.simulate(
                float(vx_sequence[i]),
                float(omega_sequence[i]),
                float(steps[i]),
                v_y=float(vy_sequence[i]),
            )
            sample.set_sample_point(
                i + 1,
                float(times[i + 1]),
                st.x,
                st.y,
                st.yaw,
                vx=float(vx_sequence[i]),
                vy=float(vy_sequence[i]),
                omega=float(omega_sequence[i]),
            )
            sample.speed_points[i + 1] = st.speed
        return sample


class MotionPaths:
    """Canonical evaluation path generators
    (reference ``simulation.py:124-327``)."""

    @staticmethod
    def generate_line_path(
        length: float = 5.0, num_points: int = 100, heading: float = 0.0
    ) -> PathSample:
        s = np.linspace(0.0, length, num_points)
        path = PathSample(num_points)
        path.set_path(
            s * math.cos(heading), s * math.sin(heading),
            np.full(num_points, heading),
        )
        return path

    @staticmethod
    def generate_circle_path(
        radius: float = 2.0, num_points: int = 200, arc: float = 2 * math.pi
    ) -> PathSample:
        theta = np.linspace(0.0, arc, num_points)
        path = PathSample(num_points)
        path.set_path(
            radius * np.sin(theta),
            radius * (1.0 - np.cos(theta)),
            theta,
        )
        return path

    @staticmethod
    def generate_step_path(
        length: float = 4.0, step_size: float = 1.0, num_points: int = 200
    ) -> PathSample:
        """Straight, lateral step, straight."""
        n1 = num_points // 3
        n2 = num_points // 3
        n3 = num_points - n1 - n2
        x1 = np.linspace(0, length / 2, n1)
        y1 = np.zeros(n1)
        y2 = np.linspace(0, step_size, n2)
        x2 = np.full(n2, length / 2)
        x3 = np.linspace(length / 2, length, n3)
        y3 = np.full(n3, step_size)
        path = PathSample(num_points)
        xs = np.concatenate([x1, x2, x3])
        ys = np.concatenate([y1, y2, y3])
        headings = np.concatenate(
            [np.zeros(n1), np.full(n2, math.pi / 2), np.zeros(n3)]
        )
        path.set_path(xs, ys, headings)
        return path

    @staticmethod
    def generate_oval_path(
        a: float = 3.0, b: float = 1.5, num_points: int = 300
    ) -> PathSample:
        theta = np.linspace(0.0, 2 * math.pi, num_points)
        xs = a * np.sin(theta)
        ys = b * (1 - np.cos(theta))
        headings = np.arctan2(np.gradient(ys), np.gradient(xs))
        path = PathSample(num_points)
        path.set_path(xs, ys, headings)
        return path

    @staticmethod
    def generate_u_turn_path(
        straight: float = 3.0, radius: float = 1.0, num_points: int = 300
    ) -> PathSample:
        n1 = num_points // 3
        n2 = num_points // 3
        n3 = num_points - n1 - n2
        x1 = np.linspace(0, straight, n1)
        y1 = np.zeros(n1)
        theta = np.linspace(-math.pi / 2, math.pi / 2, n2)
        x2 = straight + radius * np.cos(theta)
        y2 = radius + radius * np.sin(theta)
        x3 = np.linspace(straight, 0, n3)
        y3 = np.full(n3, 2 * radius)
        xs = np.concatenate([x1, x2, x3])
        ys = np.concatenate([y1, y2, y3])
        headings = np.arctan2(np.gradient(ys), np.gradient(xs))
        path = PathSample(num_points)
        path.set_path(xs, ys, headings)
        return path
