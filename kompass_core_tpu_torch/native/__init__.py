"""ctypes bindings for the native host runtime (``kompass_host.cpp``).

The port's own copy of the JAX package's host library: the same C++
source and the same NumPy fallbacks. At first use the source is compiled
with ``g++`` (the JAX package's Makefile flags) into
``build/kompass_core_tpu_torch/host/<hash of source and flags>/`` at the
repository root, never into the source tree. Every entry point has a
NumPy fallback that computes the same values, used when no compiler is
found or the build fails (``native_available()`` says which).
"""

import ctypes
import hashlib
import logging
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("kompass_core_tpu_torch")

_SOURCE = Path(__file__).resolve().with_name("kompass_host.cpp")
BUILD_DIR = _SOURCE.parents[2] / "build" / "kompass_core_tpu_torch" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall", "-std=c++17")
_lib: Optional[ctypes.CDLL] = None
_build_attempted = False
_lock = threading.Lock()

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the host library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libkompass_host.so"


def _build(lib: Path) -> bool:
    """Compile the source into ``lib``; False (logged) when there is no
    compiler or it fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        logger.debug("native host library: no C++ compiler found")
        return False
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        logger.debug(f"native host library build failed: {e}")
        return False
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_attempted
    with _lock:
        if _lib is not None or _build_attempted:
            return _lib
        _build_attempted = True
        lib_path = library_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        lib = ctypes.CDLL(str(lib_path))
        _bind_symbols(lib)
        _lib = lib
        return _lib


def _bind_symbols(lib: ctypes.CDLL) -> None:
    lib.kh_find_closest_segment.restype = ctypes.c_int
    lib.kh_find_closest_segment.argtypes = [
        _f32p, _f32p, _i64p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.kh_closest_point_on_segment.restype = None
    lib.kh_closest_point_on_segment.argtypes = [
        _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    lib.kh_cubic_spline.restype = None
    lib.kh_cubic_spline.argtypes = [
        _f64p, _f64p, ctypes.c_int64, _f64p, ctypes.c_int64, _f64p,
    ]
    lib.kh_scan_to_obstacle_block.restype = ctypes.c_int
    lib.kh_scan_to_obstacle_block.argtypes = [
        _f64p, _f64p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_float, ctypes.c_int64, _f32p,
    ]
    lib.kh_segment_block.restype = ctypes.c_double
    lib.kh_segment_block.argtypes = [
        _f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int64, _f32p, _f32p, _f32p,
    ]
    lib.kh_find_lookahead.restype = ctypes.c_int
    lib.kh_find_lookahead.argtypes = [
        _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.kh_speed_factor.restype = ctypes.c_double
    lib.kh_speed_factor.argtypes = [
        _f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
    ]


def native_available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# typed wrappers with numpy fallback
# ---------------------------------------------------------------------------


def find_closest_segment(xs, ys, seg_starts, px: float, py: float) -> int:
    lib = get_lib()
    if lib is None:
        # numpy fallback replicating the descent (see follower machinery)
        left, right = 0, len(seg_starts) - 1
        if right < 0:
            return 0

        def d(seg):
            i = seg_starts[seg]
            return (px - xs[i]) ** 2 + (py - ys[i]) ** 2

        while left != right:
            mid = (left + right) // 2
            ld, rd = d(left), d(right)
            if mid == right or mid == left:
                return left if ld <= rd else right
            if ld <= rd:
                right = mid
            else:
                left = mid
        return left
    return lib.kh_find_closest_segment(
        np.ascontiguousarray(xs, np.float32),
        np.ascontiguousarray(ys, np.float32),
        np.ascontiguousarray(seg_starts, np.int64),
        len(seg_starts),
        px,
        py,
    )


def closest_point_on_segment(xs, ys, start: int, end: int, px: float, py: float):
    lib = get_lib()
    if lib is None:
        if end < start:
            # match the native kernel's empty-segment sentinel (the numpy
            # reduction would raise on a zero-size array instead)
            return start, 1e300
        seg = np.arange(start, end + 1)
        # float64 like the native kernel — a float32 d2 could round
        # near-ties differently and pick a different `<=` winner index
        d2 = (px - xs[seg].astype(np.float64)) ** 2 + (
            py - ys[seg].astype(np.float64)
        ) ** 2
        min_val = d2.min()
        local = int(np.where(d2 == min_val)[0][-1])
        return start + local, float(min_val)
    idx = ctypes.c_int64()
    dist = ctypes.c_double()
    lib.kh_closest_point_on_segment(
        np.ascontiguousarray(xs, np.float32),
        np.ascontiguousarray(ys, np.float32),
        start,
        end,
        px,
        py,
        ctypes.byref(idx),
        ctypes.byref(dist),
    )
    return int(idx.value), float(dist.value)


def cubic_spline_eval(s, y, sq) -> np.ndarray:
    lib = get_lib()
    s = np.ascontiguousarray(s, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    sq = np.ascontiguousarray(sq, np.float64)
    if lib is None:
        if len(s) < 2:
            # kh_cubic_spline's degenerate-knot guard: constant y[0]
            # (or zero for an empty knot set) — the numpy fallback's
            # clip would otherwise index [-1] and emit NaN, breaking
            # the arithmetic-identical-fallback guarantee
            fill = float(y[0]) if len(s) == 1 else 0.0
            return np.full(len(sq), fill, np.float64)
        from ..datatypes.path import _eval_natural_cubic, _natural_cubic_coeffs

        return _eval_natural_cubic(s, y, _natural_cubic_coeffs(s, y), sq)
    out = np.empty(len(sq), np.float64)
    lib.kh_cubic_spline(s, y, len(s), sq, len(sq), out)
    return out


def scan_to_obstacle_block(
    ranges, angles, sensor_pose, robot_pose, pad_value: float, scan_cap: int
):
    """-> (block [2 * scan_cap] float32, n_real). sensor_pose/robot_pose:
    (x, y, yaw)."""
    lib = get_lib()
    ranges = np.ascontiguousarray(ranges, np.float64)
    angles = np.ascontiguousarray(angles, np.float64)
    if lib is None:
        r = np.where(np.isfinite(ranges), ranges, pad_value)
        pxs = r * np.cos(angles)
        pys = r * np.sin(angles)
        cs, ss = np.cos(sensor_pose[2]), np.sin(sensor_pose[2])
        bx = cs * pxs - ss * pys + sensor_pose[0]
        by = ss * pxs + cs * pys + sensor_pose[1]
        cy, sy = np.cos(robot_pose[2]), np.sin(robot_pose[2])
        wx = cy * bx - sy * by + robot_pose[0]
        wy = sy * bx + cy * by + robot_pose[1]
        out = np.full(2 * scan_cap, pad_value, np.float32)
        n = min(len(ranges), scan_cap)
        out[:n] = wx[:n]
        out[scan_cap : scan_cap + n] = wy[:n]
        return out, n
    out = np.empty(2 * scan_cap, np.float32)
    # n_rays bounded by BOTH arrays: ranges longer than angles would read
    # past the angles buffer in the C kernel (the fallback broadcasts and
    # raises instead)
    n = lib.kh_scan_to_obstacle_block(
        ranges, angles, min(len(ranges), len(angles)),
        sensor_pose[0], sensor_pose[1], sensor_pose[2],
        robot_pose[0], robot_pose[1], robot_pose[2],
        pad_value, scan_cap, out,
    )
    return out, n


def segment_block(xs, ys, arc, start: int, end: int, pad_value: float, seg_cap: int):
    """-> (seg_x, seg_y, seg_arc [seg_cap] each, total_len)."""
    lib = get_lib()
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    arc = np.ascontiguousarray(arc, np.float32)
    if lib is None:
        n = min(end - start + 1, seg_cap)
        seg_x = np.full(seg_cap, pad_value, np.float32)
        seg_y = np.full(seg_cap, pad_value, np.float32)
        seg_arc = np.zeros(seg_cap, np.float32)
        seg_x[:n] = xs[start : start + n]
        seg_y[:n] = ys[start : start + n]
        seg_arc[:n] = arc[start : start + n]
        total = float(
            np.hypot(np.diff(seg_x[:n]), np.diff(seg_y[:n])).sum()
        )
        return seg_x, seg_y, seg_arc, total
    seg_x = np.empty(seg_cap, np.float32)
    seg_y = np.empty(seg_cap, np.float32)
    seg_arc = np.empty(seg_cap, np.float32)
    total = lib.kh_segment_block(
        xs, ys, arc, start, end, pad_value, seg_cap, seg_x, seg_y, seg_arc
    )
    return seg_x, seg_y, seg_arc, float(total)


def find_lookahead(xs, ys, last_found_index: int, cx: float, cy: float,
                   radius: float):
    """PurePursuit circle-line lookahead scan (reference
    pure_pursuit.cpp:214-254 semantics: last intersection wins, t2
    preferred). Returns (found, x, y, index); on found == False the
    caller applies the end-of-path / radius-growth fallback.
    Serial numpy fallback is arithmetic-identical (f32 coords widened to
    f64 before the quadratic)."""
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    lib = get_lib()
    if lib is None:
        found, tx, ty, idx = False, 0.0, 0.0, last_found_index
        x64 = xs.astype(np.float64)
        y64 = ys.astype(np.float64)
        for i in range(last_found_index, len(x64) - 1):
            dx = x64[i + 1] - x64[i]
            dy = y64[i + 1] - y64[i]
            fx = x64[i] - cx
            fy = y64[i] - cy
            a = dx * dx + dy * dy
            b = 2.0 * (fx * dx + fy * dy)
            c = fx * fx + fy * fy - radius * radius
            disc = b * b - 4.0 * a * c
            if disc >= 0.0 and a > 0.0:
                sq = math.sqrt(disc)
                t1 = (-b - sq) / (2.0 * a)
                t2 = (-b + sq) / (2.0 * a)
                if 0.0 <= t2 <= 1.0:
                    tx, ty = x64[i] + t2 * dx, y64[i] + t2 * dy
                    idx, found = i, True
                elif 0.0 <= t1 <= 1.0:
                    tx, ty = x64[i] + t1 * dx, y64[i] + t1 * dy
                    idx, found = i, True
        return found, tx, ty, idx
    out_x = ctypes.c_double()
    out_y = ctypes.c_double()
    out_i = ctypes.c_int64()
    found = lib.kh_find_lookahead(
        xs, ys, len(xs), last_found_index, cx, cy, radius,
        ctypes.byref(out_x), ctypes.byref(out_y), ctypes.byref(out_i),
    )
    if not found:
        return False, 0.0, 0.0, last_found_index
    return True, float(out_x.value), float(out_y.value), int(out_i.value)


def speed_factor(xs, ys, curvature, start_idx: int, lookahead: float,
                 k_curv: float, k_rot: float, omega: float,
                 min_factor: float) -> float:
    """Exponential speed-regulation factor (reference follower.cpp:319-353):
    |curvature| integrated from start_idx over the lookahead distance.
    Serial fallback is arithmetic-identical (f32 chord subtraction)."""
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    curvature = np.ascontiguousarray(curvature, np.float32)
    lib = get_lib()
    if lib is None:
        curvature_sum = 0.0
        dist = 0.0
        idx = start_idx
        n = len(xs)
        while idx < n - 1:
            curvature_sum += abs(float(curvature[idx]))
            dist += math.hypot(
                float(xs[idx + 1] - xs[idx]), float(ys[idx + 1] - ys[idx])
            )
            if dist >= lookahead:
                break
            idx += 1
        exponent = k_curv * curvature_sum + k_rot * abs(omega)
        return max(math.exp(-exponent), min_factor)
    return float(
        lib.kh_speed_factor(
            xs, ys, curvature, len(xs), start_idx, lookahead,
            k_curv, k_rot, omega, min_factor,
        )
    )
