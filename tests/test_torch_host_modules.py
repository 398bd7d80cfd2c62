"""The port's own host modules against the JAX package's, on the CPU.

The port keeps copies of the JAX package's JAX-free host code (datatypes,
robot models, geometry helpers and the native host library) and imports
nothing of it. The code is the same, so every function here must give
the JAX package's values exactly, on the same numpy-seeded inputs, in
both forms of the native library: the compiled one and the NumPy
fallback.

``to_port`` turns a JAX package host object into the port's own object
with the same state; the other port test files build the port's side of
a comparison with it. ``port_twin`` loads a JAX package test module with
its imports pointed at the port, so the port's tests run the JAX
package's own assertions (``test_torch_controllers.py``,
``test_torch_twin_*.py``). All three live in the JAX-free
``torch_twin.py`` and are re-exported here.
"""

import math

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

from torch_twin import _JAX, _JAX_NAME, _PORT, _TESTS, port_twin, to_port, twin_tests  # noqa: F401


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


# --- the controllers' host modules ---------------------------------------------

CONTROLLER_COPIES = (
    "algorithms/__init__.py", "algorithms/dvz.py", "datatypes/tracking.py",
    "vision/__init__.py", "vision/kalman.py", "vision/tracker.py",
    "vision/depth_detector.py", "control/pid.py", "control/stanley.py",
    "control/dvz.py", "control/pure_pursuit.py", "control/vision_followers.py",
)


@pytest.mark.parametrize("rel", CONTROLLER_COPIES)
def test_controller_modules_are_copies(rel):
    """The copies keep the originals' code line for line: only the
    package's own name differs (the loggers')."""
    root = _TESTS.parent
    original = (root / _JAX / rel).read_text()
    copy = (root / _PORT / rel).read_text()
    assert _JAX_NAME.sub(_PORT, original) == copy


def _dvz_pair(pkg_models, pkg_dvz, scan):
    robot = pkg_models.Robot(robot_type=pkg_models.RobotType.DIFFERENTIAL_DRIVE,
                             geometry_type=pkg_models.RobotGeometry.Type.CYLINDER,
                             geometry_params=np.array([0.3, 0.4]))
    limits = pkg_models.RobotCtrlLimits(
        vx_limits=pkg_models.LinearCtrlLimits(max_vel=1.0, max_acc=2.0, max_decel=2.0),
        omega_limits=pkg_models.AngularCtrlLimits(max_vel=2.0, max_acc=3.0,
                                                  max_decel=3.0, max_steer=1.2))
    zone = pkg_dvz.DeformableVirtualZone(
        robot=robot, ctrl_limits=limits,
        config=pkg_dvz.DeformableVirtualZoneParams(min_front_margin=0.8, K_I=4.0))
    out = []
    for speed, (ranges, angles) in zip((0.0, 0.4, 0.9), scan):
        zone.update_zone_size(robot_speed=speed)
        zone.set_scan_values(ranges, angles)
        out.append((zone.get_total_deformation(),
                    zone.compute_linear_control(0.8, speed, 0.1),
                    zone.compute_angular_control(0.3)))
    return out


def test_dvz_algorithm_values_match_jax():
    import kompass_core_tpu.algorithms.dvz as jdvz
    import kompass_core_tpu.models as jmodels
    import kompass_core_tpu_torch.algorithms.dvz as tdvz
    import kompass_core_tpu_torch.models as tmodels

    rng = np.random.default_rng(5)
    angles = np.linspace(-np.pi, np.pi, 120, endpoint=False)
    scans = [(rng.uniform(0.3, 4.0, 120), angles) for _ in range(3)]
    assert _dvz_pair(tmodels, tdvz, scans) == _dvz_pair(jmodels, jdvz, scans)


def _track(tracking, vision, seed):
    rng = np.random.default_rng(seed)
    kf = vision.LinearSSKalmanFilter(4, 1)
    kf.setup(np.eye(4) + np.eye(4, k=2) * 0.1, np.zeros((4, 1)), np.eye(4) * 0.01,
             np.eye(4), np.eye(4) * 0.2)
    kf.set_initial_state([0.0, 0.0, 0.3, -0.1])
    states = []
    for k in range(12):
        kf.estimate(rng.normal(size=4), 1 + k % 3)
        states.append(kf.get_state().copy())
    tracker = vision.FeatureBasedBboxTracker(0.1, 2.0, 0.2, 0.5)
    box = tracking.Bbox3D(center=np.array([2.0, 0.5, 0.0], np.float32),
                          size=np.array([0.5, 0.4, 1.0], np.float32),
                          center_img_frame=np.array([320, 240]),
                          size_img_frame=np.array([40, 80]), timestamp=0.0)
    tracker.set_initial_tracking_box(box)
    for k in range(1, 15):
        moved = tracking.Bbox3D(
            center=box.center + np.float32(0.05 * k) + rng.normal(0, 0.01, 3).astype(np.float32),
            size=box.size, center_img_frame=box.center_img_frame,
            size_img_frame=box.size_img_frame, timestamp=0.1 * k)
        decoy = tracking.Bbox3D(center=np.array([0.0, -2.0, 0.0], np.float32),
                                size=box.size, center_img_frame=np.array([100, 200]),
                                size_img_frame=np.array([40, 80]), timestamp=0.1 * k)
        states.append(float(tracker.update_tracking([decoy, moved])))
        states.append(tracker.get_tracked_state().copy())
    return states


def test_vision_modules_values_match_jax():
    import kompass_core_tpu.datatypes.tracking as jtracking
    import kompass_core_tpu.vision as jvision
    import kompass_core_tpu_torch.datatypes.tracking as ttracking
    import kompass_core_tpu_torch.vision as tvision

    for seed in range(2):
        got, want = _track(ttracking, tvision, seed), _track(jtracking, jvision, seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
