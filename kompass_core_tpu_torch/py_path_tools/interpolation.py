"""Standalone path interpolation helpers.

Role of the reference's ``py_path_tools/interpolation.py``: thin wrappers
over the engine's spline machinery for offline use on PathSample data.
"""

import logging
import math
from typing import Optional, Tuple

import numpy as np

from ..datatypes.path import (
    InterpolationType,
    ReferencePath,
    _eval_natural_cubic,
    _natural_cubic_coeffs,
)
from ..datatypes.path_sample import (
    PathSample,
    Point2D,
    Range2D,
    TrackedPoint,
)
from ..utils import geometry


def interpolate_path(
    path: PathSample,
    max_point_distance: float = 0.01,
    interpolation_type: InterpolationType = InterpolationType.CUBIC_SPLINE,
) -> PathSample:
    """Resample a PathSample at uniform arc-length spacing."""
    ref = ReferencePath(np.stack([path.x_points, path.y_points], axis=1))
    ref.interpolate(max_point_distance, interpolation_type)
    out = PathSample(ref.size())
    headings = np.arctan2(np.gradient(ref.ys), np.gradient(ref.xs))
    out.set_path(ref.xs.astype(float), ref.ys.astype(float), headings)
    return out


def resample_path(path: PathSample, num_points: int) -> PathSample:
    """Resample to a fixed number of points by arc length."""
    seg = np.hypot(np.diff(path.x_points), np.diff(path.y_points))
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    s = np.linspace(0.0, arc[-1], num_points)
    out = PathSample(num_points)
    # unwrap before interpolating: a raw interp across the ±pi wrap would
    # yield bogus intermediate headings (e.g. ~0 between pi and -pi)
    heading = np.interp(s, arc, np.unwrap(path.heading_points))
    heading = np.mod(heading + np.pi, 2 * np.pi) - np.pi
    out.set_path(
        np.interp(s, arc, path.x_points),
        np.interp(s, arc, path.y_points),
        heading,
    )
    return out


class Spline:
    """1D cubic spline y(x) with limit checking.

    Role of the reference's scipy-backed ``Spline``
    (``py_path_tools/interpolation.py:10-88``); built on the engine's own
    natural-cubic solve (``datatypes/path._natural_cubic_coeffs``) instead
    of a scipy dependency — natural boundary conditions match the
    reference's native tk::spline default.
    """

    def __init__(self):
        self.x_points: np.ndarray = np.array([])
        self.y_points: np.ndarray = np.array([])
        self._ypp: Optional[np.ndarray] = None

    def set_points(self, x_points: np.ndarray, y_points: np.ndarray) -> None:
        order = np.argsort(x_points)
        self.x_points = np.asarray(x_points, dtype=float)[order]
        self.y_points = np.asarray(y_points, dtype=float)[order]
        self._ypp = _natural_cubic_coeffs(self.x_points, self.y_points)

    def __call__(self, x: float) -> float:
        if self._ypp is None:
            raise ValueError("No points are set for interpolation.")
        if self.x_points.size < 2:
            return float(self.y_points[0])
        return float(
            _eval_natural_cubic(self.x_points, self.y_points, self._ypp, x)
        )

    def get_points_len(self) -> int:
        return self.x_points.size

    def limit_check(self, x: float) -> bool:
        """True when x lies strictly inside the spline's point range
        (reference ``interpolation.py:76-88``). Divergence: emptiness is
        tested with ``.size`` — the reference's ``.any()`` reports an
        all-zero knot vector as 'no points'."""
        if self.x_points.size:
            return x > self.x_points.min() and x < self.x_points.max()
        return False


class SplineInterpolatedPath:
    """Spline-interpolated path parameterized by arc length.

    Port of the reference's ``SplineInterpolatedPath``
    (``py_path_tools/interpolation.py:91-396``): x(s)/y(s)/yaw(s) splines,
    coarse-to-fine closest-point search, tracking errors (lateral distance,
    orientation error, curvature, path-frame velocities), and end-of-path
    detection.
    """

    # Max path tracking error when checking if end is reached
    LAT_DIST_ERROR_MAX_TRACKING = 0.1

    def __init__(self, seg_len_init: float, seg_len_max: float):
        self.spline_x = Spline()
        self.spline_y = Spline()
        self.spline_yaw = Spline()
        self.length = 0.0
        self.range_x = Range2D(0, 0)
        self.range_y = Range2D(0, 0)
        self.end_point = Point2D(0, 0)
        self.frame_id = "map"
        self.seg_len_init = seg_len_init
        self.seg_len_max = seg_len_max

    def set_path_points(self, path_pts, frame_id) -> None:
        """Sets the x(s), y(s) splines from interpolation points."""
        s = np.array([p.s for p in path_pts])
        self.spline_x.set_points(s, np.array([p.x for p in path_pts]))
        self.spline_y.set_points(s, np.array([p.y for p in path_pts]))
        max_point = max(path_pts, key=lambda p: p.s)
        self.length = max_point.s
        self.frame_id = frame_id
        self.end_point.x = max_point.x
        self.end_point.y = max_point.y
        self.range_x.min_val = min(p.x for p in path_pts)
        self.range_x.max_val = max(p.x for p in path_pts)
        self.range_y.min_val = min(p.y for p in path_pts)
        self.range_y.max_val = max(p.y for p in path_pts)

    def set_path_points_yaw(self, path_pts, frame_id) -> None:
        """Sets x/y splines plus a yaw(s) spline. Accepts points carrying
        either a ``yaw`` or (InterpolationPoint-style) ``pitch`` heading
        attribute — the reference reads ``p.yaw`` from points whose class
        declares ``pitch`` (``interpolation.py:265-276``, upstream
        inconsistency resolved here by accepting both)."""
        self.set_path_points(path_pts, frame_id)
        s = np.array([p.s for p in path_pts])
        yaw = np.array(
            [getattr(p, "yaw", getattr(p, "pitch", 0.0)) for p in path_pts]
        )
        self.spline_yaw.set_points(s, yaw)

    def __call__(self, s: float) -> Tuple[float, float]:
        return self.spline_x(s), self.spline_y(s)

    def get_interpolated_pose(self, s: float) -> Tuple[float, float, float]:
        return self.spline_x(s), self.spline_y(s), self.spline_yaw(s)

    def get_path_segment(self, s_max: float) -> "SplineInterpolatedPath":
        """Returns the sub-path with arc length < s_max
        (reference ``interpolation.py:188-214``)."""
        sub_s = self.spline_x.x_points[self.spline_x.x_points < s_max]
        n = sub_s.shape[0]
        sub_path = SplineInterpolatedPath(
            seg_len_init=self.seg_len_init, seg_len_max=s_max
        )
        if n == 0:
            # no knots below s_max: return the empty segment instead of
            # crashing in the spline solve (upstream raises here)
            return sub_path
        sub_path.spline_x.set_points(sub_s, self.spline_x.y_points[:n])
        sub_path.spline_y.set_points(sub_s, self.spline_y.y_points[:n])
        sub_path.length = float(np.max(sub_s))
        return sub_path

    def get_closest_path_point(
        self, x: float, y: float, yaw: float, speed: float
    ):
        """Coarse-to-fine walk for the closest path point to (x, y), plus
        tracking errors at it. Port of the reference's descent: a forward
        sweep at ``seg_len_init`` steps that stops one step after the
        distance starts growing, then a backward sweep at half-step
        (``interpolation.py:216-375``). Returns a
        :class:`~..datatypes.path_sample.TrackedPoint`, or None when no
        interpolation is available around the query."""
        min_dist = 1e6
        dist = 1e6
        forward_dist = 0.0
        pp_x, pp_y, pp_s = None, None, None
        s = self.seg_len_init
        tracked_point = TrackedPoint()
        s_incr = self.seg_len_init

        while s_incr >= self.seg_len_init:
            while dist <= min_dist and s <= self.seg_len_max:
                if self.spline_x.limit_check(s) and self.spline_y.limit_check(
                    s
                ):
                    pp_x, pp_y = self.spline_x(s), self.spline_y(s)
                    pp_s = s
                    min_dist = dist
                    dist = np.sqrt((pp_x - x) ** 2 + (pp_y - y) ** 2)
                    forward_dist = abs(pp_x - x)
                s += s_incr
            # divergence: explicit None check — the reference's
            # `if pp_x and pp_y:` (interpolation.py:278,292) skips the
            # update whenever the closest point sits on a coordinate
            # axis (x or y exactly 0.0), corrupting the tracked point
            if pp_x is not None and pp_y is not None:
                tracked_point.x = pp_x
                tracked_point.y = pp_y
            s_incr /= 2.0
            while dist <= min_dist and s >= -self.seg_len_max:
                if self.spline_x.limit_check(s) and self.spline_y.limit_check(
                    s
                ):
                    pp_x, pp_y = self.spline_x(s), self.spline_y(s)
                    pp_s = s
                    min_dist = dist
                    dist = np.sqrt((pp_x - x) ** 2 + (pp_y - y) ** 2)
                    forward_dist = abs(pp_x - x)
                s -= s_incr
            if pp_x is not None and pp_y is not None:
                tracked_point.x = pp_x
                tracked_point.y = pp_y
            s_incr /= 2.0

        if pp_x is None or pp_y is None or pp_s is None:
            logging.error(
                "No interpolation is available around the requested point"
                " -> Close compute closest point"
            )
            return None

        tracked_point.s = pp_s
        minimum_distance = min_dist

        # 0.5 m tangent lookahead; five-point stencil around the LOOP EXIT
        # arc (the reference evaluates at s, not pp_s —
        # ``interpolation.py:300-320`` — kept for semantic parity)
        s_incr = 0.5
        xs = [self.spline_x(s + k * s_incr) for k in (-2, -1, 0, 1, 2)]
        ys = [self.spline_y(s + k * s_incr) for k in (-2, -1, 0, 1, 2)]
        alphas = [
            math.atan2(ys[i + 1] - ys[i], xs[i + 1] - xs[i]) for i in range(4)
        ]
        ori2 = geometry.add_angle(
            alphas[0], geometry.add_angle(alphas[1], -alphas[0]) / 2.0
        )
        ori4 = geometry.add_angle(
            alphas[2], geometry.add_angle(alphas[3], -alphas[2]) / 2.0
        )

        tracked_point.tangent_ori = geometry.convert_to_0_2pi(alphas[2])
        beta = math.atan2(y - tracked_point.y, x - tracked_point.x)
        gamma = tracked_point.tangent_ori - geometry.convert_to_0_2pi(beta)
        tracked_point.lat_dist = min_dist * np.sin(gamma)
        tracked_point.forward_dist = forward_dist
        tracked_point.curv = (ori4 - ori2) / (2.0 * s_incr)

        if speed < 0.0:
            tracked_point.ori_err = geometry.convert_to_0_2pi(
                tracked_point.tangent_ori - np.pi
            ) - geometry.convert_to_0_2pi(yaw)
            tracked_point.s_dot = (
                -speed
                * np.cos(tracked_point.ori_err)
                / (1 - tracked_point.curv * minimum_distance)
            )
            tracked_point.lat_vel = (
                -tracked_point.curv * speed * np.sin(tracked_point.ori_err)
            )
        else:
            tracked_point.ori_err = (
                tracked_point.tangent_ori - geometry.convert_to_0_2pi(yaw)
            )
            tracked_point.s_dot = (
                speed
                * np.cos(tracked_point.ori_err)
                / (1 - tracked_point.curv * minimum_distance)
            )
            tracked_point.lat_vel = (
                tracked_point.curv * speed * np.sin(tracked_point.ori_err)
            )
        tracked_point.ori_err = geometry.convert_to_plus_minus_pi(
            tracked_point.ori_err
        )
        return tracked_point

    def reached_end(self, x: float, y: float) -> bool:
        """True when (x, y) is within LAT_DIST_ERROR_MAX_TRACKING of the
        path end point (reference ``interpolation.py:377-396``)."""
        path_end = self.end_point
        lat_dist = math.sqrt((x - path_end.x) ** 2 + (y - path_end.y) ** 2)
        return abs(lat_dist) < self.LAT_DIST_ERROR_MAX_TRACKING
