"""Path recording, save/load, spline interpolation and execution.

Full port of the reference's ``py_path_tools/executor.py``: the
``PathExecutor`` records path / trajectory / motion points, persists
paths to XML ("Points" schema with total length + frame id), interpolates
moving spline segments around the robot, and checks end-of-path with
tracking errors. ``PathRecorder``/``WaypointExecutor`` are simpler local
conveniences kept alongside (beyond-reference).
"""

import logging
import math
import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple
from xml.dom import minidom

import numpy as np
from attrs import define, field

from ..datatypes.path_sample import (
    InterpolationPoint,
    MotionSample,
    PathPoint,
    PathSample,
    TrackedPoint,
    TrajectorySample,
)
from ..utils.config import BaseAttrs, base_validators
from ..utils.geometry import convert_to_plus_minus_pi
from .interpolation import SplineInterpolatedPath

follower_types = {"STANLEY_FOLLOWER": 1}


@define
class PathExecutorParams(BaseAttrs):
    """Executor parameters (reference ``executor.py:25-62``)."""

    max_end_ori_error: float = field(
        default=1.0,
        validator=base_validators.in_range(0.0, 2 * math.pi),
    )
    max_end_dist_error: float = field(
        default=0.3, validator=base_validators.in_range(0.0, 1e6)
    )
    min_interpolation_dist: float = field(
        default=2.0, validator=base_validators.in_range(1e-3, 1e6)
    )
    follower_type: int = field(default=follower_types["STANLEY_FOLLOWER"])
    spline_segment_length: float = field(
        default=0.1, validator=base_validators.in_range(1e-6, 1e6)
    )
    min_segment_length: float = field(
        default=0.05, validator=base_validators.in_range(1e-6, 1e3)
    )
    frame_id: str = field(default="map")

    def __str__(self) -> str:
        return f"""
        Executor Params:
        min_interpolation_dist: {self.min_interpolation_dist}
        max_end_ori_error: {self.max_end_ori_error}
        spline_segment_length: {self.spline_segment_length}
        min_segment_length: {self.min_segment_length}"""


class PathExecutor:
    """Path executor: record, persist, interpolate and track reference
    paths (reference ``executor.py:64-683``)."""

    def __init__(self, params: Optional[PathExecutorParams] = None):
        self.params = params or PathExecutorParams()
        self.ref_path: List[PathPoint] = []
        self.closest_point = TrackedPoint()
        self.execution_index: int = 0
        self.execution_s: float = 0.0
        self.total_length: float = 0.0
        self.interpolation = SplineInterpolatedPath(
            seg_len_init=self.params.min_segment_length,
            seg_len_max=self.params.min_interpolation_dist,
        )
        self.interpolation_xpoints: List[float] = []
        self.interpolation_ypoints: List[float] = []
        self.ref_traj: Optional[TrajectorySample] = None
        self.traj_recording_idx: int = 0
        self.rec_motion: Optional[MotionSample] = None
        self.motion_recording_idx: int = 0

    def configure(
        self, config_file: str, nested_root_name: Optional[str] = None
    ):
        """Load parameters from a yaml/json/toml file (reference
        ``executor.py:104-114``)."""
        self.params.from_file(config_file, nested_root_name)

    # ----------------------------------------------------- recording

    def record_path_point(
        self, x: float, y: float, heading: float, vel: float
    ) -> bool:
        """Append a path point when it moved at least min_segment_length
        from the previous one (reference ``executor.py:115-155``)."""
        delta_x = delta_y = 0.0
        if self.ref_path:
            delta_x = x - self.ref_path[-1].x
            delta_y = y - self.ref_path[-1].y
        _delta_dist = math.sqrt(delta_x**2 + delta_y**2)
        if not self.ref_path or (
            _delta_dist > self.params.min_segment_length
        ):
            point = PathPoint(
                idx=len(self.ref_path), x=x, y=y, heading=heading, speed=vel
            )
            self.ref_path.append(point)
            self.total_length += _delta_dist
            return True
        return False

    def record_trajectory_point(
        self, x: float, y: float, heading: float, time: float
    ) -> bool:
        """Append to the active trajectory recording (reference
        ``executor.py:156-182``)."""
        if not self.ref_traj:
            return False
        if self.traj_recording_idx < len(self.ref_traj.time):
            self.ref_traj.set_traj_point(
                x=x,
                y=y,
                heading=heading,
                time=time,
                idx=self.traj_recording_idx,
            )
            self.traj_recording_idx += 1
            return True
        return False

    def record_motion_point(
        self,
        x: float,
        y: float,
        heading: float,
        time: float,
        linear_ctr_x: float,
        linear_ctr_y: float,
        angular_ctr: float,
    ) -> bool:
        """Append pose + control to the active motion recording (reference
        ``executor.py:184-228``)."""
        if not self.rec_motion:
            return False
        if self.motion_recording_idx < len(self.rec_motion.time):
            self.rec_motion.set_traj_point(
                x=x,
                y=y,
                heading=heading,
                time=time,
                idx=self.motion_recording_idx,
            )
            self.rec_motion.set_control_point(
                linear_control_x=linear_ctr_x,
                linear_control_y=linear_ctr_y,
                angular_control=angular_ctr,
                idx=self.motion_recording_idx,
            )
            self.motion_recording_idx += 1
            return True
        return False

    def start_path_recording(self) -> None:
        self.ref_path = []
        self.total_length = 0.0

    def start_trajectory_recording(
        self,
        recording_period: float,
        recording_step: float,
        frameid: str = "map",
    ) -> None:
        _traj_len = int(recording_period / recording_step) - 1
        self.ref_traj = TrajectorySample(length=_traj_len, frame_id=frameid)
        self.traj_recording_idx = 0

    def start_motion_recording(
        self,
        recording_period: float,
        recording_step: float,
        frameid: str = "map",
    ) -> None:
        _traj_len = int(recording_period / recording_step) - 1
        self.rec_motion = MotionSample(length=_traj_len, frame_id=frameid)
        self.motion_recording_idx = 0

    def save_motion_to_csv(self, file_location: str, file_name: str) -> bool:
        if not self.rec_motion:
            return False
        return self.rec_motion.save_to_csv(file_location, file_name)

    # --------------------------------------------------- persistence

    def save_path_to_xml(
        self, file_dir: str, file_name: str, frame_id: str
    ) -> bool:
        """Save the recorded path (reference 'Points' XML schema,
        ``executor.py:230-279``)."""
        if not self.ref_path:
            return False
        root = ET.Element("Points", length=str(self.total_length))
        frame_name = ET.SubElement(root, "Frame")
        frame_name.set("id", str(frame_id))
        for i, path_point in enumerate(self.ref_path):
            el = ET.SubElement(root, "Point")
            el.set("idx", str(i))
            el.set("x", str(path_point.x))
            el.set("y", str(path_point.y))
            el.set("heading", str(path_point.heading))
            el.set("speed", str(path_point.speed))
        xml_content = minidom.parseString(ET.tostring(root)).toprettyxml(
            indent="  "
        )
        if not os.path.exists(file_dir):
            os.makedirs(file_dir)
        try:
            with open(os.path.join(file_dir, file_name + ".xml"), "w") as f:
                f.write(xml_content)
                return True
        except (FileNotFoundError, OSError):
            logging.exception(
                f"Could not save to requested file {file_dir}/{file_name}"
            )
            return False

    def read_path_from_xml(self, file_dir: str, file_name: str) -> bool:
        """Load a path recorded by :meth:`save_path_to_xml` (reference
        ``executor.py:281-321``)."""
        self.ref_path = []
        self.total_length = 0.0
        file_path = os.path.join(file_dir, file_name + ".xml")
        if os.path.exists(file_path):
            try:
                root_element = ET.parse(file_path).getroot()
                if root_element.tag == "Points":
                    for el in root_element.findall("Point"):
                        self.ref_path.append(
                            PathPoint(
                                idx=int(el.get("idx")),
                                x=float(el.get("x")),
                                y=float(el.get("y")),
                                heading=float(el.get("heading", 0.0)),
                                speed=float(el.get("speed")),
                            )
                        )
                    self.total_length = float(root_element.get("length"))
                    self.params.frame_id = root_element.findall("Frame")[
                        0
                    ].get("id")
                    return True
                logging.error("File does not contain any points")
                return False
            except Exception as e:  # noqa: BLE001 — parity with reference
                logging.error(f"XML file parsing error: {str(e)}")
                return False
        logging.error(f"File not found at {file_dir}/{file_name}")
        return False

    # ------------------------------------------------- interpolation

    def _init_new_interpolation(self, x: float, y: float) -> None:
        """Reset the spline segment and re-anchor the execution index at
        the closest path point (reference ``executor.py:380-401``)."""
        self.interpolation = SplineInterpolatedPath(
            seg_len_init=self.params.min_segment_length,
            seg_len_max=self.params.min_interpolation_dist,
        )
        self.interpolation_xpoints = []
        self.interpolation_ypoints = []
        closest_idx = self.get_closest_point_index(self.ref_path, x, y)
        if not closest_idx:
            self.execution_index = 0
        else:
            self.execution_index = closest_idx - 1 if closest_idx > 0 else 0

    def _check_interpolation_distance(self) -> bool:
        """Clamp the interpolation distance to the path length (reference
        ``executor.py:403-416``)."""
        if self.params.min_interpolation_dist >= self.total_length:
            logging.info(
                "Path Executor: Interpolating the remaining path as one"
                f" segment with length {self.total_length}"
            )
            self.params.min_interpolation_dist = self.total_length
        return self.params.min_interpolation_dist < self.total_length

    def _get_interpolation_start_index(self) -> int:
        """Walk back until >=3 points are available for the spline,
        augmenting the path with midpoints when too sparse (reference
        ``executor.py:418-440``). Divergence: ``spline_start_index < 0``
        only happens at ``execution_index == 0``, where the reference
        recurses after augmenting without re-anchoring and so augments
        forever (RecursionError); exactly ONE densifying pass is
        performed here instead, and the anchor is the path start."""
        spline_start_index = self.execution_index - 1
        while (spline_start_index > 0) and (
            (self.execution_index - spline_start_index) <= 3
        ):
            spline_start_index -= 1
        if spline_start_index < 0:
            logging.debug("Augmenting path points to interpolate")
            if self._augment_path_points():
                return 0
        return spline_start_index

    def _augment_path_points(self) -> bool:
        """Insert midpoints between consecutive path points (reference
        ``executor.py:442-458``). The midpoint is built explicitly
        rather than via ``(p1 + p2) / 2``: PathPoint.__truediv__ keeps
        the reference's quirk of NOT dividing the heading, so the
        operator form would give the midpoint the SUM of the endpoint
        headings (never observable in the reference — its augmentation
        path cannot complete, see _get_interpolation_start_index)."""
        if len(self.ref_path) > 1:
            new_path = []
            for i in range(len(self.ref_path) - 1):
                a, b = self.ref_path[i], self.ref_path[i + 1]
                new_path.append(a)
                new_path.append(PathPoint(
                    x=(a.x + b.x) / 2.0,
                    y=(a.y + b.y) / 2.0,
                    heading=(a.heading + b.heading) / 2.0,
                ))
            new_path.append(self.ref_path[-1])
            self.ref_path = new_path
            return True
        return False

    def interpolate_path_spline(
        self, x: float, y: float, frame_id="map"
    ) -> bool:
        """Build/refresh the moving spline segment around the robot
        (reference ``executor.py:460-570``)."""
        # reference quirk kept verbatim (executor.py:475-481):
        # closest_point is only ever assigned in __init__ with s=0.0 and
        # never updated, so this early-return is dead and every call
        # rebuilds the spline; a caller may mutate executor.closest_point
        # to opt into the reuse, exactly as upstream
        if self.closest_point:
            if (
                self.closest_point.s <= self.params.min_interpolation_dist
                and self.closest_point.s > 0.0
            ):
                return True

        self._init_new_interpolation(x, y)
        self._check_interpolation_distance()

        interpolation_points = []
        spline_start_index = self._get_interpolation_start_index()
        if spline_start_index > len(self.ref_path) - 3:
            logging.warning(
                "Path Executor: Need more points to interpolate the path"
            )
            return False

        _arc_dist = 0.0
        _delta_dist = 0.0
        start_index = spline_start_index if spline_start_index > 0 else 0

        for i in range(len(self.ref_path)):
            if (_arc_dist < self.params.min_interpolation_dist) and (
                start_index + i < len(self.ref_path)
            ):
                _seg_length = 0.0
                if start_index + i > 0:
                    _seg_length = math.sqrt(
                        (
                            self.ref_path[start_index + i].x
                            - self.ref_path[start_index + i - 1].x
                        )
                        ** 2
                        + (
                            self.ref_path[start_index + i].y
                            - self.ref_path[start_index + i - 1].y
                        )
                        ** 2
                    )
                    _delta_dist += _seg_length
                _arc_dist += _seg_length
                # `i == start_index` is the reference's own comparison
                # (executor.py:533-535) of the loop OFFSET against the
                # ABSOLUTE start index: for start_index > 0 the segment's
                # first knot is not anchored at the segment start and the
                # unrelated offset i == start_index is appended
                # unconditionally — kept verbatim (quirk, not corrected)
                if (_delta_dist > self.params.spline_segment_length) or (
                    i == start_index
                ):
                    interpolation_points.append(
                        InterpolationPoint(
                            _arc_dist,
                            self.ref_path[start_index + i].x,
                            self.ref_path[start_index + i].y,
                            self.ref_path[start_index + i].heading,
                        )
                    )
                    _delta_dist = 0.0

        # spline parameterization must be strictly increasing in arc
        # length; the reference sorts by x (``executor.py:550-554``) which
        # only works for monotone-x paths — sorted by s here (divergence:
        # corrected; identical for the reference's own test paths)
        sorted_points = sorted(interpolation_points, key=lambda p: p.s)

        if len(sorted_points) > 3:
            self.interpolation.set_path_points(sorted_points, frame_id)
            s = 0.0
            while s <= _arc_dist:
                px, py = self.interpolation(s)
                self.interpolation_xpoints.append(px)
                self.interpolation_ypoints.append(py)
                s += self.params.spline_segment_length
            return True
        logging.warning(
            "Path Executor: Need more points to interpolate the path"
        )
        return False

    # --------------------------------------------------- tracking

    def reached_end(
        self, x: float, y: float, ori: float
    ) -> Tuple[bool, float, float]:
        """End-of-path check + tracking errors (reference
        ``executor.py:572-602``)."""
        if not self.ref_path:
            logging.error(
                "No path points are available -> End is already reached"
            )
            return True, 0.0, 0.0
        path_end = self.ref_path[-1]
        lat_dist = math.sqrt((x - path_end.x) ** 2 + (y - path_end.y) ** 2)
        ori_error = convert_to_plus_minus_pi(abs(path_end.heading - ori))
        reached = (
            abs(lat_dist) < self.params.max_end_dist_error
            and abs(ori_error) < self.params.max_end_ori_error
        )
        return reached, lat_dist, ori_error

    @classmethod
    def get_closest_point_index(
        cls, ref_path: List[PathPoint], x: float, y: float
    ) -> Optional[int]:
        """Index of the closest path point, or None on an empty path
        (reference ``executor.py:604-628``)."""
        if not ref_path:
            return None
        lat_dists = [
            math.sqrt((x - p.x) ** 2 + (y - p.y) ** 2) for p in ref_path
        ]
        return lat_dists.index(min(lat_dists))

    @classmethod
    def get_closest_point(
        cls, ref_path: List[PathPoint], x: float, y: float
    ) -> Optional[PathPoint]:
        """Closest path point, or None on an empty path. Divergence: the
        reference's falsy-int check returns None whenever the closest
        point is index 0 (``executor.py:630-653``); an explicit None check
        is used here."""
        idx = cls.get_closest_point_index(ref_path, x, y)
        if idx is None:
            return None
        return ref_path[idx]

    @classmethod
    def get_path_heading(cls, ref_path: List[PathPoint], idx: int) -> float:
        """Path heading at an index from the segment to the next point
        (previous point at the path end). Divergence: the reference's
        last-index branch is dead code and the call raises IndexError
        there (``executor.py:655-683``); the intended previous-segment
        heading is returned here."""
        if idx < 0 or idx >= len(ref_path):
            logging.error("Requested index is out of path points range")
            raise IndexError(
                f"Path point index {idx} out of range [0, {len(ref_path)})"
            )
        if idx == len(ref_path) - 1:
            return math.atan2(
                ref_path[idx].y - ref_path[idx - 1].y,
                ref_path[idx].x - ref_path[idx - 1].x,
            )
        return math.atan2(
            ref_path[idx + 1].y - ref_path[idx].y,
            ref_path[idx + 1].x - ref_path[idx].x,
        )


class PathRecorder:
    """Accumulates robot poses into a path, with distance-based pruning."""

    def __init__(self, min_point_distance: float = 0.05):
        self.min_point_distance = float(min_point_distance)
        self._xs = []
        self._ys = []
        self._hs = []

    def record(self, x: float, y: float, heading: float = 0.0) -> bool:
        if self._xs:
            d = np.hypot(x - self._xs[-1], y - self._ys[-1])
            if d < self.min_point_distance:
                return False
        self._xs.append(float(x))
        self._ys.append(float(y))
        self._hs.append(float(heading))
        return True

    def get_path(self) -> PathSample:
        path = PathSample(len(self._xs))
        path.set_path(
            np.asarray(self._xs), np.asarray(self._ys), np.asarray(self._hs)
        )
        return path

    def clear(self):
        self._xs, self._ys, self._hs = [], [], []

    # --- persistence (simple schema; PathExecutor carries the
    # reference-compatible "Points" XML schema) ---

    @staticmethod
    def save_xml(path: PathSample, file_path: str, name: str = "recorded"):
        root = ET.Element("path", attrib={"name": name})
        for i in range(len(path)):
            ET.SubElement(
                root,
                "point",
                attrib={
                    "idx": str(i),
                    "x": repr(float(path.x_points[i])),
                    "y": repr(float(path.y_points[i])),
                    "heading": repr(float(path.heading_points[i])),
                },
            )
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        ET.ElementTree(root).write(file_path)

    @staticmethod
    def load_xml(file_path: str) -> PathSample:
        root = ET.parse(file_path).getroot()
        points = root.findall("point")
        path = PathSample(len(points))
        for el in points:
            idx = int(el.get("idx"))
            path.set_point(
                idx,
                float(el.get("x")),
                float(el.get("y")),
                float(el.get("heading", 0.0)),
            )
        return path


class WaypointExecutor:
    """Steps through a recorded path, yielding the next target point when
    the previous one is reached (beyond-reference convenience)."""

    def __init__(self, path: PathSample, reach_tolerance: float = 0.1):
        self.path = path
        self.reach_tolerance = float(reach_tolerance)
        self._idx = 0

    @property
    def finished(self) -> bool:
        return self._idx >= len(self.path)

    def current_target(self) -> Optional[PathPoint]:
        if self.finished:
            return None
        return PathPoint(
            idx=self._idx,
            x=self.path.x_points[self._idx],
            y=self.path.y_points[self._idx],
            heading=self.path.heading_points[self._idx],
        )

    def update(self, x: float, y: float) -> Optional[PathPoint]:
        """Advance past reached points and return the active target."""
        while not self.finished:
            tx = self.path.x_points[self._idx]
            ty = self.path.y_points[self._idx]
            if np.hypot(x - tx, y - ty) > self.reach_tolerance:
                break
            self._idx += 1
        return self.current_target()
