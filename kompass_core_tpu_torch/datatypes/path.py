"""Reference-path machinery: interpolation, curvature, arc length, segments.

Host-side (NumPy) equivalent of the reference's ``datatypes/path.cpp:167-330``
and the embedded tk::spline (``utils/spline.h``): arc-length-parameterized
resampling with linear / natural-cubic / Hermite splines, finite-difference
curvature, prefix arc lengths, and length/point-count based segmentation.

This runs on host because it executes once per new global plan (rare),
while the per-tick hot path is the jitted device solver in ``ops/``.

Known intentional divergence from the reference: the final resampled point's
prefix arc length is always consistent (the reference leaves it
zero-initialized when the endpoint lands off the sampling comb,
``path.cpp:249-254``).
"""

from enum import Enum
from typing import Optional, Sequence

import numpy as np


class InterpolationType(Enum):
    LINEAR = "LINEAR"
    CUBIC_SPLINE = "CUBIC_SPLINE"
    HERMITE_SPLINE = "HERMITE_SPLINE"


def _natural_cubic_coeffs(s: np.ndarray, y: np.ndarray):
    """Second derivatives of a natural cubic spline through (s, y).

    Classic tridiagonal solve with zero second derivative at both ends
    (same boundary conditions as tk::spline's default cspline).
    """
    n = len(s)
    if n < 3:
        return np.zeros(n)
    h = np.diff(s)
    # tridiagonal system for interior second derivatives
    a = h[:-1]
    b = 2.0 * (h[:-1] + h[1:])
    c = h[1:]
    d = 6.0 * ((y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1])
    # Thomas algorithm
    m = len(b)
    cp = np.zeros(m)
    dp = np.zeros(m)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, m):
        denom = b[i] - a[i] * cp[i - 1]
        cp[i] = c[i] / denom if i < m - 1 else 0.0
        dp[i] = (d[i] - a[i] * dp[i - 1]) / denom
    ypp_int = np.zeros(m)
    ypp_int[-1] = dp[-1]
    for i in range(m - 2, -1, -1):
        ypp_int[i] = dp[i] - cp[i] * ypp_int[i + 1]
    ypp = np.zeros(n)
    ypp[1:-1] = ypp_int
    return ypp


def _eval_natural_cubic(s: np.ndarray, y: np.ndarray, ypp: np.ndarray, sq):
    idx = np.clip(np.searchsorted(s, sq, side="right") - 1, 0, len(s) - 2)
    h = s[idx + 1] - s[idx]
    t = (sq - s[idx]) / h
    a = ypp[idx] * h * h / 6.0
    b = ypp[idx + 1] * h * h / 6.0
    return (
        (1 - t) * y[idx]
        + t * y[idx + 1]
        + ((1 - t) ** 3 - (1 - t)) * a
        + (t**3 - t) * b
    )


def _eval_hermite(s: np.ndarray, y: np.ndarray, sq):
    """Cubic Hermite with 3-point finite-difference slopes (Catmull-Rom
    style), matching tk::spline's cspline_hermite behavior."""
    n = len(s)
    m = np.zeros(n)
    if n >= 3:
        m[1:-1] = (y[2:] - y[:-2]) / (s[2:] - s[:-2])
    m[0] = (y[1] - y[0]) / (s[1] - s[0])
    m[-1] = (y[-1] - y[-2]) / (s[-1] - s[-2])
    idx = np.clip(np.searchsorted(s, sq, side="right") - 1, 0, n - 2)
    h = s[idx + 1] - s[idx]
    t = (sq - s[idx]) / h
    h00 = 2 * t**3 - 3 * t**2 + 1
    h10 = t**3 - 2 * t**2 + t
    h01 = -2 * t**3 + 3 * t**2
    h11 = t**3 - t**2
    return h00 * y[idx] + h10 * h * m[idx] + h01 * y[idx + 1] + h11 * h * m[idx + 1]


class ReferencePath:
    """A 2D reference path with interpolation and segmentation.

    SoA storage (float32 arrays) mirrors the reference's ``Path::Path``
    (``datatypes/path.h:37-299``); the arrays are handed directly to the
    device solver after padding.
    """

    def __init__(self, points: Sequence):
        pts = np.asarray(points, dtype=np.float64)
        if pts.ndim != 2 or len(pts) < 2:
            raise ValueError("At least two points are required to create a path")
        self.xs = pts[:, 0].astype(np.float32)
        self.ys = pts[:, 1].astype(np.float32)
        self.zs = (
            pts[:, 2].astype(np.float32)
            if pts.shape[1] > 2
            else np.zeros(len(pts), dtype=np.float32)
        )
        self.curvature = np.zeros(len(pts), dtype=np.float32)
        self.arc_lengths = np.zeros(len(pts), dtype=np.float32)
        self.segment_starts: np.ndarray = np.array([0], dtype=np.int64)
        self.interpolated = False
        self._total_length: Optional[float] = None

    # --- basic accessors (kompass_cpp.types.Path-compatible surface) ---

    def size(self) -> int:
        return len(self.xs)

    def x(self) -> np.ndarray:
        return self.xs

    def y(self) -> np.ndarray:
        return self.ys

    def getIndex(self, i: int):
        return (float(self.xs[i]), float(self.ys[i]), float(self.zs[i]))

    @property
    def end(self):
        return (float(self.xs[-1]), float(self.ys[-1]))

    @property
    def start(self):
        return (float(self.xs[0]), float(self.ys[0]))

    def total_path_length(self) -> float:
        """Total arc length. After interpolation this is the spline length
        (reference ``path.cpp:148-165``)."""
        if self._total_length is not None:
            return self._total_length
        d = np.hypot(np.diff(self.xs), np.diff(self.ys))
        return float(d.sum())

    def get_orientation(self, index: int) -> float:
        i = min(index, self.size() - 2)
        return float(
            np.arctan2(self.ys[i + 1] - self.ys[i], self.xs[i + 1] - self.xs[i])
        )

    def end_orientation(self) -> float:
        return self.get_orientation(self.size() - 2)

    def start_orientation(self) -> float:
        return self.get_orientation(0)

    # --- interpolation ---

    def interpolate(
        self,
        max_interpolation_point_dist: float,
        interpolation_type: InterpolationType = InterpolationType.LINEAR,
    ) -> None:
        """Resample the path at uniform arc-length spacing.

        Semantics follow ``path.cpp:167-288``: chordal arc-length
        parameterization, spline fit per axis, resample at
        ``s = k * ds`` for ``k = 0 .. floor(L/ds)``, then finite-difference
        curvature.

        Endpoint note: when L is not a multiple of ds, the resampled
        path ends at ``floor(L/ds) * ds`` — up to one step short of the
        true endpoint. This matches the reference: its "add the last
        point" branch (``path.cpp:249-254``) requires ``idx < new_size``
        but the comb loop has already filled all ``new_size`` slots, so
        the branch fires only when FP accumulation of ``s += ds``
        overshoots L early (and then leaves that point's prefix arc
        length zero-initialized). Goal tolerance absorbs the gap in both
        implementations.
        """
        ds = float(max_interpolation_point_dist)
        x64 = self.xs.astype(np.float64)
        y64 = self.ys.astype(np.float64)
        seg = np.hypot(np.diff(x64), np.diff(y64))
        s_vals = np.concatenate([[0.0], np.cumsum(seg)])
        total = float(s_vals[-1])
        # collapse duplicate knots (zero-length path edges break splines)
        keep = np.concatenate([[True], np.diff(s_vals) > 1e-12])
        s_vals, x64, y64 = s_vals[keep], x64[keep], y64[keep]

        n_new = int(total / ds) + 1
        sq = ds * np.arange(n_new)

        if interpolation_type == InterpolationType.LINEAR or len(s_vals) < 3:
            xi = np.interp(sq, s_vals, x64)
            yi = np.interp(sq, s_vals, y64)
        elif interpolation_type == InterpolationType.CUBIC_SPLINE:
            # native O(n+m) spline when the host lib is built; its
            # fallback IS _natural_cubic_coeffs/_eval_natural_cubic, so
            # both deployments evaluate the same math
            from ..native import cubic_spline_eval

            xi = cubic_spline_eval(s_vals, x64, sq)
            yi = cubic_spline_eval(s_vals, y64, sq)
        elif interpolation_type == InterpolationType.HERMITE_SPLINE:
            xi = _eval_hermite(s_vals, x64, sq)
            yi = _eval_hermite(s_vals, y64, sq)
        else:
            raise ValueError(f"Unknown interpolation type {interpolation_type}")

        self.xs = xi.astype(np.float32)
        self.ys = yi.astype(np.float32)
        self.zs = np.zeros(n_new, dtype=np.float32)
        self.arc_lengths = sq.astype(np.float32)
        self._total_length = total
        self.interpolated = True
        # resampling invalidates any prior segmentation: stale
        # segment_starts would index the OLD point array (possibly past
        # the new end) — callers re-segment after interpolating, as the
        # follower does (set_current_path)
        self.segment_starts = np.array([0], dtype=np.int64)
        self._compute_curvature()

    def _compute_curvature(self) -> None:
        """Discrete curvature via first/second differences, matching
        ``path.cpp:260-288`` exactly (endpoints zero)."""
        x = self.xs.astype(np.float64)
        y = self.ys.astype(np.float64)
        k = np.zeros(len(x))
        if len(x) >= 3:
            dx = np.diff(x)  # dx[i] = x[i+1]-x[i]
            dy = np.diff(y)
            # at interior point i: uses dx_old = dx[i-1], dx = dx[i]
            ddx = dx[1:] - dx[:-1]
            ddy = dy[1:] - dy[:-1]
            val = dx[1:] ** 2 + dy[1:] ** 2
            denom = val * np.sqrt(val)
            num = dx[:-1] * ddy - ddx * dy[:-1]
            with np.errstate(divide="ignore", invalid="ignore"):
                k[1:-1] = np.where(denom > 1e-6, num / denom, 0.0)
        self.curvature = k.astype(np.float32)

    # --- segmentation ---

    def segment(self, path_segment_length: float, max_points_per_segment: int):
        """Split into segments by arc length / point count
        (reference ``path.cpp:290-330``)."""
        n = self.size()
        if n < 2:
            return
        if not self.interpolated:
            seg = np.hypot(np.diff(self.xs), np.diff(self.ys))
            self.arc_lengths = np.concatenate([[0.0], np.cumsum(seg)]).astype(
                np.float32
            )
        starts = [0]
        seg_start = 0
        seg_start_len = self.arc_lengths[0]
        for i in range(1, n):
            points_in_segment = i - seg_start + 1
            seg_len = self.arc_lengths[i] - seg_start_len
            if (path_segment_length > 0.0 and seg_len >= path_segment_length) or (
                max_points_per_segment > 0
                and points_in_segment > max_points_per_segment
            ):
                starts.append(i)
                seg_start = i
                seg_start_len = self.arc_lengths[i]
        self.segment_starts = np.asarray(starts, dtype=np.int64)

    @property
    def num_segments(self) -> int:
        return len(self.segment_starts)

    def segment_start_index(self, seg_idx: int) -> int:
        return int(self.segment_starts[seg_idx])

    def segment_end_index(self, seg_idx: int) -> int:
        if seg_idx + 1 < len(self.segment_starts):
            return int(self.segment_starts[seg_idx + 1] - 1)
        return self.size() - 1

    def segment_slice(self, seg_idx: int) -> slice:
        return slice(
            self.segment_start_index(seg_idx), self.segment_end_index(seg_idx) + 1
        )

    def segment_start_point(self, seg_idx: int):
        i = self.segment_start_index(seg_idx)
        return np.array([self.xs[i], self.ys[i]])

    def segment_end_point(self, seg_idx: int):
        i = self.segment_end_index(seg_idx)
        return np.array([self.xs[i], self.ys[i]])
