"""The port's own host modules against the JAX package's, on the CPU.

The port keeps copies of the JAX package's JAX-free host code (datatypes,
robot models, geometry helpers and the native host library) and imports
nothing of it. The code is the same, so every function here must give
the JAX package's values exactly, on the same numpy-seeded inputs, in
both forms of the native library: the compiled one and the NumPy
fallback.

``to_port`` turns a JAX package host object into the port's own object
with the same state; the other port test files build the port's side of
a comparison with it.
"""

import io
import math
import pickle

import numpy as np
import pytest

from kompass_core_tpu import native as jnative
from kompass_core_tpu.datatypes import LaserScanData as JaxLaserScanData
from kompass_core_tpu.datatypes import PoseData as JaxPoseData
from kompass_core_tpu.datatypes import ScanModelConfig as JaxScanModelConfig
from kompass_core_tpu.datatypes.path import ReferencePath as JaxReferencePath
from kompass_core_tpu.models import Robot as JaxRobot
from kompass_core_tpu.models import RobotGeometry as JaxRobotGeometry
from kompass_core_tpu.models import RobotType as JaxRobotType
from kompass_core_tpu.utils.geometry import yaw_from_quaternion as jax_yaw
from kompass_core_tpu_torch import native as tnative
from kompass_core_tpu_torch.datatypes import (
    LaserScanData,
    PoseData,
    ReferencePath,
    ScanModelConfig,
)
from kompass_core_tpu_torch.models import Robot, RobotGeometry, RobotType
from kompass_core_tpu_torch.utils.geometry import yaw_from_quaternion

_JAX, _PORT = "kompass_core_tpu", "kompass_core_tpu_torch"


class _ToPort(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _JAX or module.startswith(_JAX + "."):
            module = _PORT + module[len(_JAX):]
        return super().find_class(module, name)


def to_port(obj):
    """The port's object with ``obj``'s state: the same class path under
    ``kompass_core_tpu_torch`` (enums by value), every field copied."""
    return _ToPort(io.BytesIO(pickle.dumps(obj))).load()


# --- the native host library -------------------------------------------------


def _path(rng, n=60):
    t = np.cumsum(rng.uniform(0.05, 0.2, n))
    xs = (t + 0.1 * rng.standard_normal(n)).astype(np.float32)
    ys = np.sin(0.5 * t).astype(np.float32)
    return xs, ys


def _case_find_closest_segment(rng):
    xs, ys = _path(rng)
    starts = np.arange(0, 60, 7, dtype=np.int64)
    px, py = rng.uniform(0, 8), rng.uniform(-1, 1)
    return (xs, ys, starts, px, py)


def _case_closest_point_on_segment(rng):
    xs, ys = _path(rng)
    return (xs, ys, 10, 40, rng.uniform(0, 8), rng.uniform(-1, 1))


def _case_cubic_spline_eval(rng):
    s = np.cumsum(rng.uniform(0.1, 0.5, 25))
    return (s, np.sin(s), np.linspace(s[0], s[-1], 97))


def _case_scan_to_obstacle_block(rng):
    ranges = rng.uniform(0.2, 8.0, 90)
    ranges[[4, 17]] = [np.inf, np.nan]
    angles = np.linspace(-np.pi, np.pi, 90, endpoint=False)
    sensor, robot = (0.1, -0.05, 0.3), tuple(rng.uniform(-2, 2, 3))
    return (ranges, angles, sensor, robot, 1e8, 128)


def _case_segment_block(rng):
    xs, ys = _path(rng)
    arc = np.cumsum(np.hypot(np.diff(xs, prepend=xs[0]),
                             np.diff(ys, prepend=ys[0]))).astype(np.float32)
    return (xs, ys, arc, 5, 37, 1e8, 48)


def _case_find_lookahead(rng):
    xs, ys = _path(rng)
    return (xs, ys, 3, float(xs[10]), float(ys[10]) + 0.1, 0.8)


def _case_speed_factor(rng):
    xs, ys = _path(rng)
    curvature = rng.uniform(-2, 2, 60).astype(np.float32)
    return (xs, ys, curvature, 4, 1.5, 0.3, 0.2, 0.7, 0.1)


NATIVE_CASES = {
    "find_closest_segment": _case_find_closest_segment,
    "closest_point_on_segment": _case_closest_point_on_segment,
    "cubic_spline_eval": _case_cubic_spline_eval,
    "scan_to_obstacle_block": _case_scan_to_obstacle_block,
    "segment_block": _case_segment_block,
    "find_lookahead": _case_find_lookahead,
    "speed_factor": _case_speed_factor,
}


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("form", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(NATIVE_CASES))
def test_native_function_matches_jax(name, form, monkeypatch):
    if form == "numpy":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setenv("KOMPASS_TPU_NO_NATIVE", "1")
    else:
        assert tnative.native_available(), "the port's host library did not build"
        assert jnative.native_available()
    for seed in range(3):
        args = NATIVE_CASES[name](np.random.default_rng(seed))
        _assert_same(getattr(tnative, name)(*args), getattr(jnative, name)(*args))


def test_native_library_builds_outside_the_source_tree():
    lib = tnative.library_path()
    assert tnative.native_available() and lib.exists()
    assert lib.is_relative_to(tnative.BUILD_DIR)
    assert not any(tnative._SOURCE.parent.glob("*.so"))


# --- datatypes, models and geometry ------------------------------------------


INVALID = [
    (LaserScanData, JaxLaserScanData, dict(angle_min=7.0)),
    (LaserScanData, JaxLaserScanData, dict(angle_increment=-4.0)),
    (LaserScanData, JaxLaserScanData, dict(range_max=0.0)),
    (ScanModelConfig, JaxScanModelConfig, dict(p_prior=1.5)),
    (ScanModelConfig, JaxScanModelConfig, dict(range_sure=0.0)),
    (ScanModelConfig, JaxScanModelConfig, dict(angle_step=1.0)),
]


@pytest.mark.parametrize("port_cls, jax_cls, kwargs", INVALID)
def test_datatype_validators_reject_like_jax(port_cls, jax_cls, kwargs):
    with pytest.raises(ValueError) as jax_err:
        jax_cls(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port_cls(**kwargs)
    assert str(port_err.value) == str(jax_err.value)


def test_datatypes_build_like_jax():
    rng = np.random.default_rng(0)
    ranges = rng.uniform(0.1, 5.0, 40)
    angles = np.linspace(-1.0, 1.0, 45)
    got, want = (cls(ranges=ranges, angles=angles, range_max=6.0)
                 for cls in (LaserScanData, JaxLaserScanData))
    np.testing.assert_array_equal(got.ranges, want.ranges)
    np.testing.assert_array_equal(got.angles, want.angles)
    np.testing.assert_array_equal(got.get_ranges(-0.5, 0.5), want.get_ranges(-0.5, 0.5))
    assert ScanModelConfig(p_occupied=0.8).p_empty == JaxScanModelConfig(p_occupied=0.8).p_empty
    pts = np.stack([np.linspace(0, 4, 9), np.sin(np.linspace(0, 4, 9))], 1)
    paths = [cls(pts) for cls in (ReferencePath, JaxReferencePath)]
    for p in paths:
        p.interpolate(0.05)
        p.segment(0.5, 20)
    for attr in ("xs", "ys", "curvature", "arc_lengths", "segment_starts"):
        np.testing.assert_array_equal(getattr(paths[0], attr), getattr(paths[1], attr))
    assert paths[0].num_segments == paths[1].num_segments > 1


def test_yaw_from_quaternion_matches_jax():
    rng = np.random.default_rng(1)
    for q in rng.standard_normal((50, 4)):
        q = q / np.linalg.norm(q)
        assert yaw_from_quaternion(q) == jax_yaw(q)
    got, want = PoseData(), JaxPoseData()
    for p in (got, want):
        p.set_orientation(0.9, 0.1, -0.2, 0.37)
        p.set_position(1.0, -2.0, 0.5)
    assert got.get_yaw() == want.get_yaw()
    assert math.isfinite(got.get_yaw())
    np.testing.assert_array_equal(got.get_orientation(), want.get_orientation())


def test_to_port_builds_the_ports_own_objects():
    jrobot = JaxRobot(robot_type=JaxRobotType.OMNI,
                      geometry_type=JaxRobotGeometry.Type.BOX,
                      geometry_params=np.array([0.5, 0.3, 0.4]))
    jrobot.state.x, jrobot.state.yaw = 1.5, 0.25
    robot = to_port(jrobot)
    assert type(robot) is Robot and robot.robot_type is RobotType.OMNI
    assert robot.geometry_type is RobotGeometry.Type.BOX
    np.testing.assert_array_equal(robot.geometry_params, jrobot.geometry_params)
    assert (robot.state.x, robot.state.yaw) == (1.5, 0.25)
    assert type(robot.state).__module__.startswith("kompass_core_tpu_torch.")
