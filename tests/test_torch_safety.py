"""The port's emergency stop against the JAX package's, on the CPU: the
critical-zone checker (``ops/critical_zone.py``), ``EmergencyChecker``
and the fleet's fused safety gate (``ops/fleet_solver.py``, item 5d).

Tolerances:

- Against JAX compiled without FMA (``test_torch_kernels.jax_without_fma``:
  XLA then rounds every operation on its own, as the port and the card
  do), bit for bit: the checker on 24 seeded scans and 20 seeded clouds
  (NaN and inf returns, translated and rotated sensors, both cone
  directions), the fleet's beam-form factor, and the world-form factor
  of robots with no point within ``EDGE_MARGIN`` of a cone edge.
  ``atan2`` differs by a few ulps between XLA and PyTorch, so a point
  that close to the edge may fall on either side; its count is reported.
- Against default JAX (XLA contracts multiply-adds into FMAs): the
  checker within rel 1e-6, the fleet's ``safety_factor`` column within
  ``SAFETY_ATOL`` (a few float32 ulps of a factor in [0, 1]) and the
  rest of each fleet row as ``tests/test_torch_fleet.py`` holds it:
  ``found``, ``reached``, ``active_points`` and ``num_admissible``
  equal, the cost within rel 1e-4, the command within 1e-4 or a tie.
- Against the reference's serial oracle (``tests/oracle/safety_impl``):
  rel 1e-5, as ``tests/test_critical_zone_oracle.py`` holds JAX.

The JAX fleets are built once per module.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.datatypes import LaserScanData as JaxScan
from kompass_core_tpu.datatypes import PointCloudData as JaxCloud
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.ops import critical_zone as jzone
from kompass_core_tpu.ops import fleet_solver as jfleet
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet as JaxDeviceFleet
from kompass_core_tpu.parallel.fleet_v2 import FleetSafetyConfig as JaxSafety
from kompass_core_tpu.utils.emergency_stop import EmergencyChecker as JaxChecker
from kompass_core_tpu_torch.datatypes import LaserScanData, PointCloudData
from kompass_core_tpu_torch.ops import critical_zone as tzone
from kompass_core_tpu_torch.ops import fleet_solver as tfleet
from kompass_core_tpu_torch.ops.mapping import pad_cloud_to_bucket
from kompass_core_tpu_torch.parallel import DeviceFleet
from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig
from kompass_core_tpu_torch.utils.emergency_stop import EmergencyChecker

from oracle.safety_impl import CriticalZoneOracle
from test_torch_host_modules import to_port
from test_torch_kernels import jax_without_fma

torch.set_num_threads(2)

RADIUS = 0.51
CHECKER_REL = 1e-6  # the checker against default JAX
ORACLE_REL = 1e-5  # against the serial oracle
SAFETY_ATOL = 1e-6  # the fleet's safety_factor against default JAX
EDGE_MARGIN = 1e-5  # rad: closer to a cone edge, atan2's ulps may decide
CMD_TOL = 1e-4
COST_REL = 1e-4
TIE_REL = 1e-6


# --- EmergencyChecker: tests/test_emergency_stop.py's cases, both packages --


def _robot(radius=RADIUS, height=1.0):
    return Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                 geometry_type=RobotGeometry.Type.CYLINDER,
                 geometry_params=np.array([radius, height]))


def _checker(pkg, **kw):
    args = dict(emergency_distance=0.3, slowdown_distance=0.6,
                emergency_angle=160.0)
    args.update(kw)
    if pkg == "jax":
        return JaxChecker(_robot(), **args)
    return EmergencyChecker(to_port(_robot()), **args, device="cpu")


def _scan(pkg, ranges):
    cls = JaxScan if pkg == "jax" else LaserScanData
    return cls(ranges=np.asarray(ranges, np.float64),
               angles=np.linspace(0, 2 * np.pi, len(ranges), endpoint=False))


def _front(front_range, n=72):
    ranges = np.full(n, 10.0)
    ranges[0] = front_range  # beam straight ahead
    return ranges


def _one_beam(index, value, n=72):
    ranges = np.full(n, 10.0)
    ranges[index] = value
    return ranges


def _ring_cloud(pkg):
    """A dense cloud ring at 5 m and one close point ahead."""
    theta = np.linspace(0, 2 * np.pi, 1000, endpoint=False)
    pts = np.stack([5 * np.cos(theta), 5 * np.sin(theta), np.zeros_like(theta)], 1)
    pts = np.vstack([pts, [[0.7, 0.0, 0.0]]]).astype(np.float32)
    return (JaxCloud if pkg == "jax" else PointCloudData)(points=pts)


# name -> (fn(pkg) -> the factors, the JAX test's expected factors)
CHECKER_CASES = {
    "clear_space_full_speed": (
        lambda p: [_checker(p).run(scan=_scan(p, _front(10.0)), forward=True)], [1.0]),
    # surface distance 0.7 - 0.51 = 0.19 < 0.3: stop
    "critical_stop": (
        lambda p: [_checker(p).run(scan=_scan(p, _front(0.7)), forward=True)], [0.0]),
    # surface distance 0.45: (0.45 - 0.3) / (0.6 - 0.3) = 0.5
    "slowdown_band_linear": (
        lambda p: [_checker(p).run(scan=_scan(p, _front(RADIUS + 0.45)),
                                   forward=True)], [0.5]),
    "backward_ignores_front_obstacle": (
        lambda p: [_checker(p).run(scan=_scan(p, _front(0.7)), forward=False)], [1.0]),
    "backward_sees_rear_obstacle": (
        lambda p: [_checker(p).run(scan=_scan(p, _one_beam(36, 0.7)), forward=f)
                   for f in (False, True)], [0.0, 1.0]),
    # 160-degree cone: half angle 80 deg; an obstacle at 90 deg is outside
    "cone_edge_exclusion": (
        lambda p: [_checker(p).run(scan=_scan(p, _one_beam(18, 0.6)), forward=True)],
        [1.0]),
    "pointcloud_variant": (
        lambda p: [_checker(p).run(scan=_ring_cloud(p), forward=f)
                   for f in (True, False)], [0.0, 1.0]),
}


@pytest.mark.parametrize("case", sorted(CHECKER_CASES))
def test_emergency_checker_cases(case):
    """Each case of ``test_emergency_stop.py``: the port's factors equal
    JAX's within CHECKER_REL and meet the JAX test's expectations."""
    fn, expected = CHECKER_CASES[case]
    got, want = fn("port"), fn("jax")
    np.testing.assert_allclose(got, want, rtol=CHECKER_REL, atol=0)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_emergency_checker_invalid_distances_raise():
    for pkg in ("jax", "port"):
        checker = _checker(pkg, emergency_distance=0.6, slowdown_distance=0.3)
        with pytest.raises(ValueError):
            checker.run(scan=_scan(pkg, _front(5.0)), forward=True)


def test_emergency_checker_reinitializes_on_a_new_grid_or_modality():
    """One checker fed a 72-ray scan, a 90-ray scan, a cloud and the first
    scan again re-initializes its zone each time, as JAX's does."""
    checkers = {p: _checker(p, sensor_position_robot=[0.05, -0.02, 0.1])
                for p in ("jax", "port")}
    inputs = [lambda p: _scan(p, _front(0.8)),
              lambda p: _scan(p, _front(0.7, n=90)),
              _ring_cloud,
              lambda p: _scan(p, _front(0.8))]
    got = {p: [c.run(scan=make(p), forward=True) for make in inputs]
           for p, c in checkers.items()}
    np.testing.assert_allclose(got["port"], got["jax"], rtol=CHECKER_REL, atol=0)
    assert got["port"][0] == got["port"][3] and 0.0 < got["port"][0] < 1.0
    assert got["port"][1] == 0.0 and got["port"][2] == 0.0


def test_emergency_checker_requires_a_device():
    with pytest.raises(TypeError):
        EmergencyChecker(to_port(_robot()), 0.3, 0.6, 160.0)


# --- the critical-zone checker against the oracle (test_critical_zone_oracle) --


def _random_zone(rng, n=None):
    """build_critical_zone's arguments for a random sensor pose, cone,
    radius and band (test_critical_zone_oracle.py's draws)."""
    n = int(rng.integers(180, 720)) if n is None else n
    angles = np.linspace(0.0, 2 * math.pi, n, endpoint=False)
    sensor_xy = rng.uniform(-0.1, 0.1, size=2)
    yaw = rng.uniform(-math.pi, math.pi)
    cone = float(rng.uniform(40.0, 200.0))
    radius = float(rng.uniform(0.2, 0.5))
    crit = float(rng.uniform(0.1, 0.4))
    slow = crit + float(rng.uniform(0.1, 0.6))
    return dict(robot_shape_type="CYLINDER", robot_dimensions=[radius, 0.3],
                sensor_position_body=[sensor_xy[0], sensor_xy[1], 0.0],
                sensor_rotation_body=[0.0, 0.0, math.sin(yaw / 2), math.cos(yaw / 2)],
                critical_angle_deg=cone, critical_distance=crit,
                slowdown_distance=slow, angles=angles)


def _oracle(zone):
    qz, qw = zone["sensor_rotation_body"][2:]
    return CriticalZoneOracle(
        robot_radius=zone["robot_dimensions"][0],
        sensor_x=float(zone["sensor_position_body"][0]),
        sensor_y=float(zone["sensor_position_body"][1]),
        sensor_yaw=math.atan2(2.0 * qw * qz, 1.0 - 2.0 * qz * qz),
        critical_angle_deg=zone["critical_angle_deg"],
        critical_distance=zone["critical_distance"],
        slowdown_distance=zone["slowdown_distance"],
        angles=zone["angles"],
    )


def _oracle_ranges(rng, zone, case):
    n = len(zone["angles"])
    crit, slow = zone["critical_distance"], zone["slowdown_distance"]
    ranges = rng.uniform(crit * 0.5, slow * 4.0, size=n)
    if case % 3 == 1:  # all clear
        ranges = rng.uniform(slow * 2.0, slow * 5.0, size=n)
    if case % 3 == 2:  # NaN/inf dropouts must be skipped, not fatal
        ranges = np.where(rng.random(n) < 0.1, np.nan, ranges)
        ranges[rng.integers(0, n)] = np.inf
    return ranges.astype(np.float32)


@pytest.mark.parametrize("seed", [1, 7, 13, 42])
def test_critical_zone_lockstep_with_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    zone = _random_zone(rng)
    jspec, tspec = jzone.build_critical_zone(**zone), tzone.build_critical_zone(**zone)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    oracle = _oracle(zone)
    n = len(zone["angles"])
    assert [bool(v) for v in tspec.forward_mask] == [
        i in set(oracle.indices_forward) for i in range(n)]
    assert [bool(v) for v in tspec.backward_mask] == [
        i in set(oracle.indices_backward) for i in range(n)]
    jcheck = jzone.get_critical_zone_checker(jspec)
    tcheck = tzone.get_critical_zone_checker(tspec, "cpu")
    for case in range(12):
        ranges = _oracle_ranges(rng, zone, case)
        for forward in (True, False):
            got = tcheck(ranges, forward)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), oracle.check(ranges, forward),
                                       rtol=ORACLE_REL, atol=1e-6,
                                       err_msg=f"case {case} forward={forward}")
            np.testing.assert_allclose(float(got), float(jcheck(ranges, forward)),
                                       rtol=CHECKER_REL, atol=0)


def test_degenerate_full_circle_cone_matches_reference_quirk():
    """A 360-degree critical angle wraps to -pi and empties both cones:
    the checker returns 1.0 everywhere, as upstream and as JAX."""
    zone = dict(robot_shape_type="CYLINDER", robot_dimensions=[0.3, 0.3],
                sensor_position_body=[0.0, 0.0, 0.0],
                sensor_rotation_body=[0.0, 0.0, 0.0, 1.0], critical_angle_deg=360.0,
                critical_distance=0.2, slowdown_distance=0.6,
                angles=np.linspace(0.0, 2 * math.pi, 90, endpoint=False))
    spec = tzone.build_critical_zone(**zone)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jzone.build_critical_zone(**zone))
    assert not any(spec.forward_mask) and not any(spec.backward_mask)
    ranges = np.full(90, 0.01, np.float32)  # everything touching the robot
    check = tzone.get_critical_zone_checker(spec, "cpu")
    assert float(check(ranges, True)) == 1.0 == float(check(ranges, False))
    assert _oracle(zone).check(ranges, True) == 1.0


def test_cloud_checker_requires_a_uniform_grid_from_zero():
    zone = _random_zone(np.random.default_rng(3), n=360)
    zone["angles"] = zone["angles"] - math.pi  # a [-pi, pi) grid
    with pytest.raises(ValueError, match="uniform"):
        tzone.get_critical_zone_checker_cloud(tzone.build_critical_zone(**zone), "cpu")


# --- bit for bit against JAX compiled without FMA -----------------------------

N_SCANS = 24
N_CLOUDS = 20
FLEET_ROWS = 8
WORLD_POINTS = 96  # per robot, in the slowdown band
EDGE_POINTS = 8  # per robot, on its cone edges


def _scan_case(i):
    """(zone, ranges [R] f32, forward) of seeded scan case i: 6 random
    zones (one compiled JAX checker each), 4 scans each, ranges from
    inside the critical band to clear (every fourth case beyond it), NaN
    and inf returns in every third case."""
    zone = _random_zone(np.random.default_rng(100 + i // 4))
    rng = np.random.default_rng(1000 + i)
    ranges = _oracle_ranges(rng, zone, i)
    if i % 4 == 3:  # every return beyond the critical band
        band = zone["robot_dimensions"][0] + zone["critical_distance"] + 0.01
        ranges = np.where(np.isfinite(ranges), np.maximum(ranges, band), ranges)
    return zone, ranges.astype(np.float32), bool(i % 2)


def _cloud_case(i):
    """(zone on the uniform grid from 0, cloud [4096, 3], forward,
    range_max, min_z, max_z) of seeded cloud case i: 5 zones, 4 clouds
    each, of 500 to 3000 points around the robot's band (padded with
    origin points, which the binning drops). Coordinates are multiples of
    1/64 m within 8 m, so x^2 + y^2 is exact in float32 with and without
    FMA (the port's binning mirrors XLA's fused one)."""
    zone = _random_zone(np.random.default_rng(200 + i // 4),
                        n=int(np.random.default_rng(i // 4).integers(90, 400)))
    rng = np.random.default_rng(2000 + i)
    n = int(rng.integers(500, 3000))
    radius = zone["robot_dimensions"][0]
    r = radius + rng.uniform(0.9 * zone["critical_distance"],
                             2.5 * zone["slowdown_distance"], n)
    r[rng.random(n) < 0.5] *= 4.0
    th = rng.uniform(-np.pi, np.pi, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th), rng.uniform(-0.6, 0.6, n)], 1)
    pts = (np.round(pts * 64.0) / 64.0).astype(np.float32)
    return (zone, pad_cloud_to_bucket(pts), bool(i % 2), np.float32(5.0),
            np.float32(-0.4), np.float32(0.4))


def _fleet_zones(rng):
    """Per-robot zone specs of one fleet row set (a shared 256-ray grid)."""
    angles = np.linspace(-np.pi, np.pi, 256, endpoint=False)
    zones = []
    for _ in range(FLEET_ROWS):
        z = _random_zone(rng, n=256)
        z["angles"] = angles
        zones.append(z)
    return zones


def _fleet_scan_case():
    """Inputs of the fleet's beam-form factor: zones, ranges [N, R] (NaN
    and inf among them), sensor_xy [N, 2], forward [N]."""
    rng = np.random.default_rng(300)
    zones = _fleet_zones(rng)
    ranges = rng.uniform(0.1, 2.5, (FLEET_ROWS, 256)).astype(np.float32)
    ranges[rng.random(ranges.shape) < 0.05] = np.nan
    ranges[:, 7] = np.inf
    sensor_xy = np.array([z["sensor_position_body"][:2] for z in zones], np.float32)
    forward = np.arange(FLEET_ROWS) % 3 != 0
    return zones, ranges, sensor_xy, forward


def _fleet_world_case():
    """Inputs of the fleet's world-form factor: zones, per robot a pose
    and WORLD_POINTS random points in its slowdown band plus EDGE_POINTS
    on the edges of its cones (float64 bearings, rounded to float32),
    forward [N]. Returns (zones, obs [N, P, 2], x, y, yaw, forward)."""
    rng = np.random.default_rng(400)
    zones = _fleet_zones(rng)
    x, y = rng.uniform(-5, 5, FLEET_ROWS), rng.uniform(-5, 5, FLEET_ROWS)
    yaw = rng.uniform(-np.pi, np.pi, FLEET_ROWS)
    obs = np.zeros((FLEET_ROWS, WORLD_POINTS + EDGE_POINTS, 2))
    for i, z in enumerate(zones):
        radius, crit = z["robot_dimensions"][0], z["critical_distance"]
        d = radius + rng.uniform(crit, z["slowdown_distance"], WORLD_POINTS + EDGE_POINTS)
        bearing = rng.uniform(-np.pi, np.pi, WORLD_POINTS + EDGE_POINTS)
        half = tzone.build_critical_zone(**z).half_cone
        edges = np.array([half, -half, np.pi - half, half - np.pi])
        bearing[WORLD_POINTS:] = edges[np.arange(EDGE_POINTS) % 4]
        obs[i, :, 0] = x[i] + d * np.cos(yaw[i] + bearing)
        obs[i, :, 1] = y[i] + d * np.sin(yaw[i] + bearing)
    f32 = np.float32
    return (zones, obs.astype(f32), x.astype(f32), y.astype(f32), yaw.astype(f32),
            np.arange(FLEET_ROWS) % 2 == 0)


PEER_CFG = dict(radii=np.array([0.3, 0.25, 0.31, 0.2, 0.0, 0.0], np.float32),
                n_real=4, ring=8, predict=True)


def _peer_states():
    rng = np.random.default_rng(500)
    states = rng.uniform(-3, 3, (6, 4)).astype(np.float32)
    vels = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    return states, vels


def _jax_safety(zones):
    return jfleet.build_fleet_safety([jzone.build_critical_zone(**z) for z in zones],
                                     FLEET_ROWS, 256)


def _port_safety(zones):
    return tfleet.build_fleet_safety([tzone.build_critical_zone(**z) for z in zones],
                                     FLEET_ROWS, 256, "cpu")


def _single_points(obs):
    """[N, P, 2] -> [N * P, 1, 2]: one point per row, so each point's cone
    decision shows in its own factor (every point lies in the band)."""
    return obs.reshape(-1, 1, 2)


def jax_fields_without_fma():
    """Every case's JAX result, for ``jax_without_fma``."""
    fields = {}
    for i in range(N_SCANS):
        zone, ranges, forward = _scan_case(i)
        check = jzone.get_critical_zone_checker(jzone.build_critical_zone(**zone))
        fields[f"scan/{i}"] = np.asarray(check(ranges, forward))
    for i in range(N_CLOUDS):
        zone, pts, forward, *limits = _cloud_case(i)
        spec = jzone.build_critical_zone(**zone)
        check = jzone.get_critical_zone_checker_cloud(spec)
        fields[f"cloud/{i}"] = np.asarray(check(pts, forward, *limits))
    zones, ranges, sensor_xy, forward = _fleet_scan_case()
    fields["fleet_scan"] = np.asarray(jax.jit(jax.vmap(jfleet._safety_factor_scan))(
        _jax_safety(zones), ranges, sensor_xy, forward))
    zones, obs, x, y, yaw, forward = _fleet_world_case()
    world = jax.jit(jax.vmap(jfleet._safety_factor_world))
    safety = _jax_safety(zones)
    fields["fleet_world"] = np.asarray(world(safety, obs, x, y, yaw, forward))
    P = obs.shape[1]
    per_point = [jnp.repeat(a, P, axis=0) for a in (x, y, yaw, forward)]
    rows = jax.tree_util.tree_map(lambda a: jnp.repeat(a, P, axis=0), safety)
    fields["fleet_world_points"] = np.asarray(world(rows, _single_points(obs),
                                                    *per_point))
    build, build_vel, _, _ = jfleet._peer_points_builder(PEER_CFG, 6)
    states, vels = _peer_states()
    fields["peer_pts"] = np.asarray(jax.jit(build)(states))
    fields["peer_vel"] = np.asarray(jax.jit(build_vel)(states, vels))
    return fields


@pytest.fixture(scope="module")
def no_fma(tmp_path_factory):
    return jax_without_fma("test_torch_safety",
                           tmp_path_factory.mktemp("no_fma") / "safety.npz")


def test_checker_bit_for_bit_without_fma(no_fma):
    for i in range(N_SCANS):
        zone, ranges, forward = _scan_case(i)
        check = tzone.get_critical_zone_checker(tzone.build_critical_zone(**zone), "cpu")
        assert np.array_equal(check(ranges, forward).numpy(), no_fma[f"scan/{i}"]), i
    assert np.isnan(_scan_case(2)[1]).any() and np.isinf(_scan_case(2)[1]).any()
    factors = [float(no_fma[f"scan/{i}"]) for i in range(N_SCANS)]
    assert 0.0 in factors and 1.0 in factors and any(0.0 < f < 1.0 for f in factors)


def test_cloud_checker_bit_for_bit_without_fma(no_fma):
    factors = []
    for i in range(N_CLOUDS):
        zone, pts, forward, *limits = _cloud_case(i)
        spec = tzone.build_critical_zone(**zone)
        got = tzone.get_critical_zone_checker_cloud(spec, "cpu")(pts, forward, *limits)
        assert np.array_equal(got.numpy(), no_fma[f"cloud/{i}"]), i
        factors.append(float(got))
    assert 0.0 in factors and any(0.0 < f < 1.0 for f in factors)


def test_fleet_beam_factor_bit_for_bit_without_fma(no_fma):
    zones, ranges, sensor_xy, forward = _fleet_scan_case()
    got = tfleet._safety_factor_scan(_port_safety(zones), torch.from_numpy(ranges),
                                     torch.from_numpy(sensor_xy),
                                     torch.from_numpy(forward))
    np.testing.assert_array_equal(got.numpy(), no_fma["fleet_scan"])
    assert (got < 1.0).sum() >= FLEET_ROWS // 2


def test_fleet_world_factor_without_fma_away_from_the_cone_edges(no_fma):
    """Per point (one point per row, every point in the slowdown band, so
    its factor is below 1 exactly when it is in the cone): the port's
    cone decisions equal JAX's for every point farther than EDGE_MARGIN
    from an edge, and so do the factors; the EDGE_POINTS placed on the
    edges of each robot's cones are the ones inside the margin, and the
    test reports how many of them each side decided differently. Each
    robot's min factor over its random points (the edge points left
    out) equals JAX's bit for bit."""
    zones, obs, x, y, yaw, forward = _fleet_world_case()
    safety = _port_safety(zones)
    P = obs.shape[1]
    t = [torch.from_numpy(a) for a in (obs, x, y, yaw, forward)]
    rows = tfleet.FleetSafety(*(a.repeat_interleave(P, 0) for a in safety))
    got = tfleet._safety_factor_world(
        rows, t[0].reshape(-1, 1, 2), *(a.repeat_interleave(P, 0) for a in t[1:]))
    want = no_fma["fleet_world_points"]
    bearing = np.arctan2(obs[..., 1] - y[:, None].astype(np.float64),
                         obs[..., 0] - x[:, None].astype(np.float64)) - yaw[:, None]
    bearing = np.abs(np.angle(np.exp(1j * bearing))).reshape(-1)
    half = safety.half_cone.numpy().repeat(P).astype(np.float64)
    near = ((np.abs(bearing - half) < EDGE_MARGIN)
            | (np.abs(bearing - (np.pi - half)) < EDGE_MARGIN))
    far = ~near
    np.testing.assert_array_equal(got.numpy()[far], want[far])
    inside = int(near.sum())
    flipped = (got.numpy() < 1.0) != (want < 1.0)
    print(f"world-form cone test: {inside} of {near.size} points within "
          f"{EDGE_MARGIN} rad of a cone edge, {int(flipped[near].sum())} of them "
          f"decided differently")
    assert inside == FLEET_ROWS * EDGE_POINTS and not flipped[far].any()
    assert (want[far] < 1.0).sum() > 100 and (want[far] == 1.0).sum() > 100
    # whole rows: the random points alone, then every robot whose edge
    # points were decided alike
    per_point = want.reshape(FLEET_ROWS, P)
    clear = tfleet._safety_factor_world(safety, t[0][:, :WORLD_POINTS], *t[1:])
    np.testing.assert_array_equal(clear.numpy(), per_point[:, :WORLD_POINTS].min(1))
    alike = ~flipped.reshape(FLEET_ROWS, P).any(1)
    full = tfleet._safety_factor_world(safety, *t).numpy()
    np.testing.assert_array_equal(full[alike], no_fma["fleet_world"][alike])


def test_peer_points_bit_for_bit_without_fma(no_fma):
    """The peer discs (positions, bit for bit) and their world velocities
    (prediction) of the fleet's 6 rows, 4 of them real."""
    build, build_vel, block, count = tfleet._peer_points_builder(PEER_CFG, 6, "cpu")
    assert (block, count) == (9, 27)
    states, vels = (torch.from_numpy(a) for a in _peer_states())
    np.testing.assert_array_equal(build(states).numpy(), no_fma["peer_pts"])
    # the velocities rotate by cos and sin of each heading, XLA's and
    # PyTorch's own: within 1e-7 m/s (an ulp of each rotated term)
    np.testing.assert_allclose(build_vel(states, vels).numpy(), no_fma["peer_vel"],
                               rtol=0, atol=1e-7)
    assert (no_fma["peer_pts"][4 * block:] == 1e8).all()
    assert (no_fma["peer_vel"][4 * block:] == 0.0).all()


# --- the fleet's safety gate (tests/test_fleet_safety.py), both packages -----

N_RAYS = 72
ANGLES = np.arange(N_RAYS) * (2 * np.pi / N_RAYS)
WALL_SAFETY = dict(critical_distance=0.5, slowdown_distance=1.2)
TIGHT = dict(critical_distance=0.05, slowdown_distance=0.1)
SENSOR_POSES = np.array([[0.08, -0.03, 0.3], [0.0, 0.0, np.pi]], np.float32)


def _robots(n):
    return [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.1, 0.4])) for _ in range(n)]


def _limits():
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=4.0, max_acc=3.0, max_decel=3.0,
                                       max_steer=np.pi),
    )


def _config():
    return DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            smoothness_weight=0.0, jerk_weight=0.0, obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=0.1,
    )


def _fleet(pkg, n, safety=None, **kw):
    """A fleet of ``pkg`` ("jax" or "port"); ``safety``: None, a dict of
    FleetSafetyConfig fields, or a list of them (one per robot)."""
    cfg_cls = JaxSafety if pkg == "jax" else FleetSafetyConfig
    if isinstance(safety, dict):
        safety = cfg_cls(**safety)
    elif isinstance(safety, list):
        safety = [cfg_cls(**s) for s in safety]
    args = dict(scan_rays=N_RAYS, path_capacity=512, max_segments=16,
                safety_config=safety, **kw)
    if pkg == "jax":
        return JaxDeviceFleet(_robots(n), _limits(), _config(), **args)
    return DeviceFleet(*to_port((_robots(n), _limits())), _config(), **args,
                       device="cpu")


FLEETS = {
    "safe": (1, {}, {}),
    "plain": (1, None, {}),
    "hetero": (2, [{}, TIGHT], {}),
    "sensors": (2, {}, dict(sensor_poses=SENSOR_POSES)),
    "wall": (1, WALL_SAFETY, {}),
}


@pytest.fixture(scope="module")
def jax_fleets():
    """The JAX fleets, built (and compiled) once for the module; every
    test sets their paths, which resets their carry."""
    return {name: _fleet("jax", n, s, **kw) for name, (n, s, kw) in FLEETS.items()}


def _pair(jax_fleets, name):
    n, s, kw = FLEETS[name]
    return jax_fleets[name], _fleet("port", n, s, **kw)


def assert_rows_close(jout, tout, where=""):
    """The module docstring's fleet-row tolerance against default JAX."""
    for key in ("found", "reached", "active_points", "num_admissible"):
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=f"{where} {key}")
    np.testing.assert_allclose(tout["safety_factor"], jout["safety_factor"],
                               rtol=0, atol=SAFETY_ATOL, err_msg=f"{where} safety")
    np.testing.assert_allclose(tout["cost"], jout["cost"], rtol=COST_REL, atol=1e-6,
                               err_msg=f"{where} cost")
    np.testing.assert_allclose(tout["heading_error"], jout["heading_error"],
                               atol=CMD_TOL, err_msg=f"{where} heading_error")
    cmd_t = np.stack([tout[k] for k in ("vx", "vy", "omega")], axis=-1)
    cmd_j = np.stack([jout[k] for k in ("vx", "vy", "omega")], axis=-1)
    for idx in np.argwhere(np.abs(cmd_t - cmd_j).max(axis=-1) > CMD_TOL):
        idx = tuple(idx)
        assert abs(tout["cost"][idx] - jout["cost"][idx]) <= TIE_REL * abs(jout["cost"][idx]), (
            f"{where} {idx}: command {cmd_t[idx]} vs JAX {cmd_j[idx]} is not a tie")
    if "final_states" in jout:
        np.testing.assert_allclose(tout["final_states"], jout["final_states"],
                                   rtol=1e-5, atol=1e-6, err_msg=f"{where} final")


def _ahead(dist):
    """Full-ring scan, one return straight ahead at ``dist``."""
    ranges = np.full(N_RAYS, 10.0, np.float32)
    ranges[0] = dist
    return ranges


def _tick_once(fleets, ranges, n=1, goal_x=3.0):
    """One tick of each fleet from the origin toward +x; the rows agree."""
    outs = []
    for f in fleets:
        f.set_paths([np.array([[0.0, 0.0], [goal_x, 0.0]])] * n)
        outs.append(f.tick(np.zeros((n, 4)), np.zeros((n, 3)),
                           np.tile(ranges, (n, 1)), ANGLES))
    if len(fleets) == 2:
        assert_rows_close(*outs)
    return outs[-1]


@pytest.mark.parametrize("dist", [0.45, 0.38, 0.65, 2.0])
def test_safety_factor_matches_emergency_checker(jax_fleets, dist):
    """The single tick's beam-form factor equals the standalone checker's
    on the same scan within 1e-5 (the JAX test's bound), and JAX's fleet
    factor within SAFETY_ATOL."""
    ranges = _ahead(dist)
    out = _tick_once(_pair(jax_fleets, "safe"), ranges)
    checker = EmergencyChecker(to_port(_robots(1)[0]), emergency_distance=0.3,
                               slowdown_distance=0.6, emergency_angle=160.0,
                               device="cpu")
    scan = LaserScanData(angles=ANGLES.copy(), ranges=ranges.astype(np.float64))
    got = float(out["safety_factor"][0])
    assert abs(got - checker.run(scan=scan, forward=True)) < 1e-5
    if 0.4 < dist < 0.7:
        assert 0.0 < got < 1.0


def test_safety_scales_linear_command(jax_fleets):
    """With safety the command is the plain fleet's times the factor (the
    gate scales the chosen command; it does not change the choice)."""
    ranges = _ahead(0.45)
    safe = _tick_once(_pair(jax_fleets, "safe"), ranges)
    plain = _tick_once(_pair(jax_fleets, "plain"), ranges)
    f = float(safe["safety_factor"][0])
    assert 0.0 < f < 1.0
    np.testing.assert_allclose(safe["vx"], plain["vx"] * f, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(safe["omega"], plain["omega"], rtol=1e-6, atol=1e-7)
    assert float(plain["safety_factor"][0]) == 1.0  # shape-stable column


def test_safety_critical_stop_zeroes_whole_twist(jax_fleets):
    """A full ring inside the critical band blocks both cones: the stop
    fires whichever direction the solver picks."""
    out = _tick_once(_pair(jax_fleets, "safe"), np.full(N_RAYS, 0.25, np.float32))
    assert float(out["safety_factor"][0]) == 0.0
    for key in ("vx", "vy", "omega"):
        assert float(out[key][0]) == 0.0


def test_safety_clear_scan_is_transparent(jax_fleets):
    ranges = np.full(N_RAYS, 10.0, np.float32)
    safe = _tick_once(_pair(jax_fleets, "safe"), ranges)
    plain = _tick_once(_pair(jax_fleets, "plain"), ranges)
    assert float(safe["safety_factor"][0]) == 1.0
    for key in ("vx", "vy", "omega", "cost"):
        np.testing.assert_array_equal(safe[key], plain[key])


def test_safety_per_robot_heterogeneous(jax_fleets):
    """Per-robot zone parameters: the same scan, different factors."""
    out = _tick_once(_pair(jax_fleets, "hetero"), _ahead(0.45), n=2)
    assert 0.0 < float(out["safety_factor"][0]) < 1.0
    assert float(out["safety_factor"][1]) == 1.0  # 0.45 - r > 0.1


def test_safety_with_sensor_poses_and_a_new_angle_grid(jax_fleets):
    """Translated and rotated sensors (the second faces backwards), over
    two angle grids: set_scan_angles rebuilds the zone presets, and the
    rows agree with JAX's for returns all around."""
    rng = np.random.default_rng(11)
    fleets = _pair(jax_fleets, "sensors")
    for f in fleets:
        f.set_paths([np.array([[0.0, 0.0], [3.0, 0.0]])] * 2)
    factors = []
    for grid in (ANGLES, np.linspace(-np.pi, np.pi, N_RAYS, endpoint=False)):
        for _ in range(4):
            ranges = rng.uniform(0.3, 1.5, (2, N_RAYS)).astype(np.float32)
            ranges[:, ::9] = np.nan
            states = np.array([[0.0, 0.0, 0.1, 0.0], [0.2, 0.1, -0.2, 0.0]])
            outs = [f.tick(states, np.zeros((2, 3)), ranges, grid) for f in fleets]
            assert_rows_close(*outs)
            factors += list(outs[1]["safety_factor"])
    assert min(factors) < 1.0


def test_safety_k_tick_loop_stops_before_wall(jax_fleets):
    """The k-tick loop is gated every tick: a robot integrating toward a
    wall hard-stops inside the call, against the world points from its
    current pose. The zone is far wider than the collision margin, so the
    stop is the gate's: the fleet without it drives measurably closer."""
    wall_x, k = 2.0, 40
    ranges = np.full(N_RAYS, 10.0, np.float32)
    hit = np.cos(ANGLES) > 0.5  # rays that hit the wall plane x = wall_x
    ranges[hit] = wall_x / np.cos(ANGLES[hit])

    def run(fleet):
        fleet.set_paths([np.array([[0.0, 0.0], [3.5, 0.0]])])
        return fleet.run_ticks_on_device(k, np.zeros((1, 4)), np.zeros((1, 3)),
                                         ranges[None, :], ANGLES)

    jout, out_safe = (run(f) for f in _pair(jax_fleets, "wall"))
    assert_rows_close(jout, out_safe)
    out_plain = run(_fleet("port", 1))
    x_safe = float(out_safe["final_states"][0, 0])
    x_plain = float(out_plain["final_states"][0, 0])
    # stop surface: wall - crit - radius = 2.0 - 0.5 - 0.1 = 1.4
    assert x_safe < 1.5, x_safe
    assert x_plain > x_safe + 0.2, (x_plain, x_safe)
    factors = out_safe["safety_factor"][0]
    # the gate scales vx by the factor each tick: the approach to the
    # stop surface is geometric
    assert factors[0] == 1.0 and factors[-1] < 0.1, factors
    assert np.all(np.diff(factors[8:]) <= 1e-6)
    assert abs(float(out_safe["vx"][0, -1])) < 0.05


def test_safety_tick_requires_arg():
    """A program built with safety=True refuses to run without its
    FleetSafety tables (a silent factor of 1 would be unsafe)."""
    fleet = _fleet("port", 1, {})
    fleet.set_paths([np.array([[0.0, 0.0], [1.0, 0.0]])])
    fleet.set_scan_angles(ANGLES)
    inputs = np.zeros((fleet._n, 7 + N_RAYS), np.float32)
    for fn in (tfleet.make_fleet_tick(fleet.spec, "cpu", safety=True),
               tfleet.make_fleet_ticks_on_device(fleet.spec, 2, "cpu", safety=True)):
        with pytest.raises(ValueError, match="FleetSafety"):
            fn(fleet._paths, fleet._cfg, fleet._carry, fleet._angles, inputs)
    with pytest.raises(ValueError, match="one per robot"):
        _fleet("port", 2, [{}])
