"""Recorded path / trajectory / motion sample containers.

Equivalents of the reference's ``datatypes/path.py`` (PathPoint, PathSample,
TrajectorySample, MotionSample) and ``datatypes/obstacles.py``
(ObstaclesData): SoA numpy containers used by the offline simulation,
evaluation and calibration tools.
"""

from typing import Union

import numpy as np


class PathPoint:
    """Single global path point."""

    def __init__(self, idx=0, x=0.0, y=0.0, heading=0.0, speed=0.0):
        self.idx = int(idx)
        self.x = float(x)
        self.y = float(y)
        self.heading = float(heading)
        self.speed = float(speed)

    def __sub__(self, other: "PathPoint") -> "PathPoint":
        return PathPoint(
            x=self.x - other.x,
            y=self.y - other.y,
            heading=self.heading - other.heading,
        )

    def __add__(self, other: "PathPoint") -> "PathPoint":
        return PathPoint(
            x=self.x + other.x,
            y=self.y + other.y,
            heading=self.heading + other.heading,
        )

    def __truediv__(self, value: Union[int, float]) -> "PathPoint":
        # reference quirk kept verbatim (datatypes/path.py:44-45): the
        # heading is NOT divided — (p1 + p2) / 2 yields the SUM of the
        # endpoint headings. Callers needing a true midpoint construct it
        # explicitly (see py_path_tools/executor._augment_path_points)
        return PathPoint(x=self.x / value, y=self.y / value, heading=self.heading)


class PathSample:
    """Fixed-length SoA path."""

    def __init__(self, length: int, frame_id: str = "map"):
        self.x_points = np.zeros(length, dtype=float)
        self.y_points = np.zeros(length, dtype=float)
        self.heading_points = np.zeros(length, dtype=float)
        self.frame_id = frame_id

    def set_path(self, x_points, y_points, heading_points):
        self.x_points = np.asarray(x_points, dtype=float)
        self.y_points = np.asarray(y_points, dtype=float)
        self.heading_points = np.asarray(heading_points, dtype=float)

    def set_point(self, idx: int, x: float, y: float, heading: float = 0.0):
        self.x_points[idx] = x
        self.y_points[idx] = y
        self.heading_points[idx] = heading

    def set_points(self, x, y, pitch, idx_start: int):
        """Sets a block of points from idx_start (reference
        ``datatypes/path.py:101-124``; the upstream bound check rejects
        blocks ending exactly at the sample end — `<` instead of `<=` —
        fixed here)."""
        idx_end = idx_start + len(x)
        if (
            idx_end > len(self.x_points)
            or idx_start < 0
            or not (len(x) == len(y) == len(pitch))
        ):
            import logging

            logging.error(
                "Cannot set points: block out of bounds or mismatched"
                " block lengths"
            )
            return
        self.x_points[idx_start:idx_end] = x
        self.y_points[idx_start:idx_end] = y
        self.heading_points[idx_start:idx_end] = pitch

    def __len__(self):
        return len(self.x_points)


class TrajectorySample(PathSample):
    """Path + applied control + timestamps."""

    def __init__(self, length: int, frame_id: str = "map"):
        super().__init__(length, frame_id)
        self.time_points = np.zeros(length, dtype=float)
        self.vx_points = np.zeros(length, dtype=float)
        self.vy_points = np.zeros(length, dtype=float)
        self.omega_points = np.zeros(length, dtype=float)

    def set_sample_point(
        self, idx, time, x, y, heading, vx=0.0, vy=0.0, omega=0.0
    ):
        self.set_point(idx, x, y, heading)
        self.time_points[idx] = time
        self.vx_points[idx] = vx
        self.vy_points[idx] = vy
        self.omega_points[idx] = omega

    @property
    def time(self) -> np.ndarray:
        """Reference field name for the timestamps array
        (``datatypes/path.py:126-180``)."""
        return self.time_points

    @time.setter
    def time(self, values) -> None:
        self.time_points = np.asarray(values, dtype=float)

    @property
    def path_sample(self) -> "PathSample":
        """The reference composes a PathSample member
        (``datatypes/path.py:139-143``); this SoA class IS its own path
        sample, so the member view is self."""
        return self

    def set_traj_length(self, length: int):
        """Re-init the sample arrays at a new length (reference
        ``datatypes/path.py:145-153``)."""
        TrajectorySample.__init__(self, length, self.frame_id)

    def set_traj(self, x_points, y_points, heading_points, time_points):
        """Set the whole trajectory at once (reference
        ``datatypes/path.py:155-176``); all blocks must share one length
        and every SoA array is re-sized to it so the sample stays
        internally consistent."""
        n = len(x_points)
        if not (len(y_points) == len(heading_points) == len(time_points) == n):
            import logging

            logging.error(
                "set_traj blocks must share one length; got "
                f"x={n}, y={len(y_points)}, heading={len(heading_points)},"
                f" time={len(time_points)}"
            )
            return
        self.set_path(x_points, y_points, heading_points)
        self.time_points = np.asarray(time_points, dtype=float)
        for name in ("vx_points", "vy_points", "omega_points"):
            if len(getattr(self, name)) != n:
                setattr(self, name, np.zeros(n, dtype=float))
        if hasattr(self, "speed_points") and len(self.speed_points) != n:
            self.speed_points = np.zeros(n, dtype=float)
        if hasattr(self, "length"):
            self.length = n

    def set_traj_from_path(self, path_sample: PathSample, time) -> None:
        """Adopt a path sample + time vector (reference
        ``datatypes/path.py:178-181``)."""
        self.set_traj(
            path_sample.x_points,
            path_sample.y_points,
            path_sample.heading_points,
            time,
        )
        self.frame_id = path_sample.frame_id

    def set_traj_point(
        self, x: float, y: float, heading: float, time: float, idx: int
    ):
        """Sets pose + timestamp at an index (reference
        ``datatypes/path.py:183-199``)."""
        self.set_point(idx, x, y, heading)
        self.time_points[idx] = time

    def set_traj_points(self, x, y, heading, time, idx_start: int):
        """Sets a block of trajectory points (reference
        ``datatypes/path.py:201-226``). Both blocks are bounds-checked
        BEFORE any write so poses and timestamps never update
        inconsistently."""
        idx_end = idx_start + len(time)
        if (
            idx_start < 0
            or idx_end > len(self.time_points)
            or idx_start + len(x) > len(self.x_points)
            or not (len(x) == len(y) == len(heading) == len(time))
        ):
            import logging

            logging.error(
                "Cannot set trajectory points: block out of bounds or"
                " mismatched block lengths"
            )
            return
        self.set_points(x, y, heading, idx_start)
        self.time_points[idx_start:idx_end] = time


class MotionSample(TrajectorySample):
    """Recorded robot motion (state sequence + control sequence), the input
    to motion-model calibration."""

    CSV_NAMES = [
        "time",
        "x",
        "y",
        "heading",
        "speed",
        "linear_control_x",
        "linear_control_y",
        "angular_control",
    ]

    def __init__(self, length: int, frame_id: str = "map"):
        super().__init__(length, frame_id)
        self.speed_points = np.zeros(length, dtype=float)
        self.length = length

    @property
    def control(self) -> np.ndarray:
        """The reference's [N, 3] control matrix view
        (``datatypes/path.py:248``): columns are the vx/vy/omega control
        SoA arrays. Read-only snapshot — write through set_control*."""
        return np.stack(
            [self.vx_points, self.vy_points, self.omega_points], axis=1
        )

    def set_length(self, length: int):
        """Re-init with a new length (reference
        ``datatypes/path.py:249-259``)."""
        self.set_traj_length(length)
        self.speed_points = np.zeros(length, dtype=float)
        self.length = length

    def set_control(
        self, linear_control_x, linear_control_y, angular_control
    ):
        """Set the whole control sequence (reference
        ``datatypes/path.py:261-280``)."""
        self.set_control_points(
            list(linear_control_x),
            list(linear_control_y),
            list(angular_control),
            idx_start=0,
        )

    def set_control_points(
        self,
        linear_control_x,
        linear_control_y,
        angular_control,
        idx_start: int,
    ):
        """Set a block of control commands (reference
        ``datatypes/path.py:281-306``)."""
        idx_end = idx_start + len(linear_control_x)
        if idx_start < 0 or idx_end > len(self.vx_points):
            import logging

            logging.error(
                f"Given control indices should be in [0, {self.length}]"
            )
            return
        self.vx_points[idx_start:idx_end] = linear_control_x
        self.vy_points[idx_start:idx_end] = linear_control_y
        self.omega_points[idx_start:idx_end] = angular_control

    def set_motion_point(
        self,
        x: float,
        y: float,
        heading: float,
        time: float,
        linear_control_x: float,
        linear_control_y: float,
        angular_control: float,
        idx: int,
    ):
        """Set pose + timestamp + control at one index (reference
        ``datatypes/path.py:334-360``)."""
        self.set_traj_point(x, y, heading, time, idx)
        self.set_control_point(
            linear_control_x, linear_control_y, angular_control, idx
        )

    def set_motion_points(
        self,
        x,
        y,
        heading,
        time,
        linear_control_x,
        linear_control_y,
        angular_control,
        idx_start: int,
    ):
        """Set a block of motion points (reference
        ``datatypes/path.py:362-399``)."""
        self.set_traj_points(x, y, heading, time, idx_start)
        self.set_control_points(
            linear_control_x, linear_control_y, angular_control, idx_start
        )

    def get_from_csv(self, file_location: str, file_name: str) -> bool:
        """Load a motion sample from a csv written by :meth:`save_to_csv`
        (role of reference ``datatypes/path.py:455-527``; this engine's
        csv schema is the one its own writer emits — time/x/y/heading/
        speed/linear_control_x/linear_control_y/angular_control — the
        reference's reader expects a frame_id column its writer also
        emits)."""
        import csv
        import logging
        import os

        if not os.path.exists(file_location):
            logging.error(f"No such folder {file_location}")
            return False
        _, extension = os.path.splitext(file_name)
        if extension == "":
            file_name += ".csv"
        elif extension.lower() != ".csv":
            logging.error("Given file must be a csv file")
            raise ValueError("Given file must be a csv file")
        with open(os.path.join(file_location, file_name), newline="") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
        if not rows or not all(
            name in rows[0] for name in self.CSV_NAMES
        ):
            logging.error(
                "Please provide a valid csv file containing MotionSample"
                " data"
            )
            raise AssertionError("invalid MotionSample csv")
        self.set_length(len(rows))
        for name, arr in zip(
            self.CSV_NAMES,
            (
                self.time_points,
                self.x_points,
                self.y_points,
                self.heading_points,
                self.speed_points,
                self.vx_points,
                self.vy_points,
                self.omega_points,
            ),
        ):
            arr[:] = [float(row[name]) for row in rows]
        return True

    def set_control_point(
        self,
        linear_control_x: float,
        linear_control_y: float,
        angular_control: float,
        idx: int,
    ):
        """Sets the commanded control at an index (reference
        ``datatypes/path.py:308-332``; the [N, 3] control matrix is the
        vx/vy/omega SoA columns here)."""
        self.vx_points[idx] = linear_control_x
        self.vy_points[idx] = linear_control_y
        self.omega_points[idx] = angular_control

    def save_to_csv(self, file_location: str, file_name: str) -> bool:
        """Saves the motion record to csv (reference
        ``datatypes/path.py:414-448``); stdlib csv writer, no pandas."""
        import csv
        import os

        if not os.path.exists(file_location):
            return False
        if not file_name.lower().endswith(".csv"):
            file_name += ".csv"
        columns = [
            self.time_points,
            self.x_points,
            self.y_points,
            self.heading_points,
            self.speed_points,
            self.vx_points,
            self.vy_points,
            self.omega_points,
        ]
        with open(os.path.join(file_location, file_name), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(self.CSV_NAMES)
            writer.writerows(zip(*columns))
        return True


class Point2D:
    """2D point (reference ``datatypes/path.py:561-568``)."""

    def __init__(self, x: float = 0.0, y: float = 0.0):
        self.x = float(x)
        self.y = float(y)


class Range2D:
    """2D range limits (reference ``datatypes/path.py:571-577``)."""

    def __init__(self, min_val: float = 0.0, max_val: float = 0.0):
        self.min_val = float(min_val)
        self.max_val = float(max_val)


class InterpolationPoint:
    """Interpolated path point: arc length + coordinates + pitch
    (reference ``datatypes/path.py:529-538``)."""

    def __init__(self, s, x, y, pitch):
        self.s = s
        self.x = x
        self.y = y
        self.pitch = pitch


class TrackedPoint:
    """Extended interpolated path point used for path following
    (reference ``datatypes/path.py:542-558``)."""

    def __init__(self):
        self.s = 0.0
        self.x = 0.0
        self.y = 0.0
        self.tangent_ori = 0.0
        self.lat_dist = 0.0
        self.curv = 0.0
        self.ori_err = 0.0
        self.s_dot = 0.0
        self.lat_vel = 0.0
        self.pitch = 0.0
        self.forward_dist = 0.0


class PathTrackingError:
    """Path tracking errors (reference ``datatypes/path.py:580-591``)."""

    def __init__(self):
        self.orientation_error = 0.0
        self.lateral_distance_error = 0.0

    def set(self, ori_error: float, lat_error: float):
        self.orientation_error = ori_error
        self.lateral_distance_error = lat_error


class Odom2D:
    """2D odometry (reference ``datatypes/path.py:594-608``)."""

    def __init__(self):
        self.x = 0.0
        self.y = 0.0
        self.ori = 0.0
        self.speed = 0.0

    def set(self, x, y, ori, speed):
        self.x = x
        self.y = y
        self.ori = ori
        self.speed = speed


# the canonical ObstaclesData lives in datatypes/obstacles.py (full
# reference API); re-exported here for backwards compatibility with the
# offline tools that grew up importing it from this module
from .obstacles import ObstaclesData  # noqa: E402,F401
