"""The port's DeviceFleet (parallel/fleet_v2.py over ops/fleet_solver.py)
against the JAX package's, on the CPU.

Both fleets are built from the same robots, limits and config (the
port's own host objects, ``to_port``, for the port's fleet): three
diff-drive cylinders with per-robot limits (the middle one slow) and
sensor poses (the last one's sensor faces backwards), 8 x 8 samples, a
20-step horizon and 64 rays; one plain, one with M = 2 tracked slots. The
JAX fleets are built once per module. Each scenario runs both in
lockstep: every tick both see the same inputs, and the states advance
with the JAX commands. Per tick and robot:

- ``found``, ``reached``, ``active_points`` and ``num_admissible`` equal;
- the heading error within 1e-4 and the cost within rel 1e-4 (the
  solver parity tolerances; sin/cos and sum order differ in the last
  bits between XLA and PyTorch on the CPU);
- the command within 1e-4, or a tie: two winners whose costs agree
  within rel 1e-6, as mirror-image samples of a robot aligned with its
  lane are (the carry does not depend on the command, so a tie changes
  nothing after its tick).

The scenarios are those of ``tests/test_fleet_moving.py`` and the
``tests/test_fleet_v2.py`` ones whose features are ported, plus a
snapshot taken in one package and resumed in the other.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet as JaxDeviceFleet
from kompass_core_tpu_torch.ops.fleet_solver import (
    OUT_FIELDS,
    fleet_spec_from_jax,
    make_fleet_tick,
    make_fleet_ticks_on_device,
)
from kompass_core_tpu_torch.parallel import DeviceFleet
from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig

from test_torch_host_modules import to_port

torch.set_num_threads(2)

N_ROBOTS = 3
N_RAYS = 64
ANGLES = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
DT = 0.1
CMD_TOL = 1e-4
COST_REL = 1e-4
TIE_REL = 1e-6
EXACT = ("found", "reached", "active_points", "num_admissible", "safety_factor")
COMMAND = ("vx", "vy", "omega")


def _robots(n=N_ROBOTS, geometry=RobotGeometry.Type.CYLINDER, params=(0.2, 0.4)):
    return [
        Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE, geometry_type=geometry,
              geometry_params=np.array(params))
        for _ in range(n)
    ]


def _limits(vx):
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=vx, max_acc=10.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
        ),
    )


LIMITS = [_limits(1.0), _limits(0.27), _limits(1.0)]
SENSOR_POSES = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, np.pi]],
                        np.float32)


def _config():
    return DWAConfig(
        max_linear_samples=8, max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5, smoothness_weight=0.0,
            jerk_weight=0.0,
        ),
        prediction_horizon=20, control_horizon=2, control_time_step=DT,
    )


def _host(cls, objs):
    """The robots and limits for a fleet of ``cls``: the port's own host
    objects (built from the same values) for the port's fleet."""
    return to_port(objs) if cls is DeviceFleet else objs


def _fleet(cls, tracked=0, **kw):
    args = dict(path_capacity=1024, max_segments=16, sensor_poses=SENSOR_POSES,
                tracked_obstacles=tracked)
    args.update(kw)
    return cls(*_host(cls, (_robots(), LIMITS)), _config(), N_RAYS, **args)


def _port(tracked=0, **kw):
    return _fleet(DeviceFleet, tracked, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_fleets():
    """The JAX fleets, built (and compiled) once for the module; every
    test sets their paths, which resets their carry."""
    return {0: _fleet(JaxDeviceFleet), 2: _fleet(JaxDeviceFleet, 2)}


def _truncate_config():
    config = _config()
    config.drop_samples = False
    config.costs_weights.smoothness_weight = 0.1
    config.costs_weights.jerk_weight = 0.05
    return config


def _lanes(length=6.0):
    return [np.array([[0.0, 2.0 * i], [length, 2.0 * i]]) for i in range(N_ROBOTS)]


def _start(yaw=0.0, vx=0.0):
    """Each robot at its lane's start, a few mm off the interpolated path's
    1 cm grid: a rollout end point exactly midway between two path points
    is a tie of the goal cost, which the last bit of a position decides
    (the two packages' rollouts differ there, see test_torch_solver.py)."""
    states = np.zeros((N_ROBOTS, 4), np.float32)
    states[:, 0] = 0.0137
    states[:, 1] = 2.0 * np.arange(N_ROBOTS)
    states[:, 2] = yaw
    vels = np.zeros((N_ROBOTS, 3), np.float32)
    vels[:, 0] = vx
    return states, vels


def _free_ranges():
    return np.full((N_ROBOTS, N_RAYS), 10.0, np.float32)


def assert_rows_match(jout, tout, where=""):
    for key in EXACT:
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=f"{where} {key}")
    np.testing.assert_allclose(tout["heading_error"], jout["heading_error"],
                               atol=CMD_TOL, err_msg=f"{where} heading_error")
    np.testing.assert_allclose(tout["cost"], jout["cost"], rtol=COST_REL,
                               atol=1e-6, err_msg=f"{where} cost")
    cmd_t = np.stack([tout[k] for k in COMMAND], axis=1)
    cmd_j = np.stack([jout[k] for k in COMMAND], axis=1)
    for r in np.flatnonzero(np.abs(cmd_t - cmd_j).max(axis=1) > CMD_TOL):
        assert abs(tout["cost"][r] - jout["cost"][r]) <= TIE_REL * abs(jout["cost"][r]), (
            f"{where} robot {r}: command {cmd_t[r]} vs JAX {cmd_j[r]} is not "
            f"a tie (costs {tout['cost'][r]} vs {jout['cost'][r]})"
        )


def _advance(states, out):
    """Integrate every robot's command for one step (position from the
    pre-update heading), as the JAX package's k-tick loop does."""
    s = states.copy()
    vx, vy, om = out["vx"], out["vy"], out["omega"]
    c, sn = np.cos(s[:, 2]), np.sin(s[:, 2])
    s[:, 0] += DT * (vx * c - vy * sn)
    s[:, 1] += DT * (vx * sn + vy * c)
    s[:, 2] += DT * om
    s[:, 3] = np.hypot(vx, vy)
    return s, np.stack([vx, vy, om], axis=1).astype(np.float32)


def lockstep(jf, tf, states, vels, ticks, ranges=None, tracked=None,
             until_reached=False):
    """Tick both fleets on the same inputs; advance with the JAX command.
    ``tracked(tick)`` gives the tick's tracked rows. Returns the final
    states and the per-tick port outputs."""
    outs = []
    for tick in range(ticks):
        trk = tracked(tick) if tracked else None
        r = _free_ranges() if ranges is None else ranges
        jout = jf.tick(states, vels, r, ANGLES, tracked=trk)
        tout = tf.tick(states, vels, r, ANGLES, tracked=trk)
        assert_rows_match(jout, tout, f"tick {tick}")
        outs.append(tout)
        if until_reached and jout["reached"].all():
            break
        states, vels = _advance(states, jout)
    return states, outs


def _pair(jax_fleets, tracked=0, length=6.0):
    jf, tf = jax_fleets[tracked], _port(tracked)
    for f in (jf, tf):
        f.set_paths(_lanes(length))
    return jf, tf


# --- construction ----------------------------------------------------------


@pytest.mark.parametrize("tracked", [0, 2])
def test_fleet_spec_and_config_match_jax(jax_fleets, tracked):
    jf, tf = jax_fleets[tracked], _port(tracked)
    assert fleet_spec_from_jax(jf.spec) == tf.spec
    assert tf.spec.solver.device_window
    assert tf.spec.solver.moving_obstacles == bool(tracked)
    for jv, tv in zip(jf._cfg, tf._cfg):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n", [3, 64, 65, 130])
def test_robot_count_padding_matches_jax(n):
    """Snapshots carry the padded robot count, so both packages pad the
    same way: to whole 64-row chunks above 64 robots."""
    robots, config = _robots(n), _config()
    jf = JaxDeviceFleet(robots, _limits(1.0), config, 8, path_capacity=64,
                        max_segments=4)
    tf = DeviceFleet(*to_port((robots, _limits(1.0))), config, 8,
                     path_capacity=64, max_segments=4, device="cpu")
    assert tf._n == jf._n and tf._inputs.shape == jf._inputs.shape


def test_device_is_required_and_explicit():
    with pytest.raises(TypeError):
        DeviceFleet(*to_port((_robots(), LIMITS)), _config(), N_RAYS)
    assert _port().device == torch.device("cpu")


@pytest.mark.parametrize(
    "kw,item",
    [(dict(mesh=object()), "5g"), (dict(peer_avoidance=True), "5c"),
     (dict(peer_avoidance=True, peer_prediction=True), "5c"),
     (dict(safety_config=FleetSafetyConfig()), "5d"),
     (dict(split_mover_sweep=True), "5e")],
)
def test_unported_options_raise_naming_their_roadmap_item(kw, item):
    """The mesh (5g) raises naming its item; peers (5c), the safety gate
    (5d) and the split mover sweep (5e) are ported: the fleet builds and
    ticks (``test_torch_peers.py``, ``test_torch_safety.py``,
    ``test_torch_fleet_moving.py``), the split fleet as the JAX one."""
    if item == "5g":
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            _port(**kw)
        return
    tracked = 2 if item == "5e" else 0
    fleet = _port(tracked, **kw)
    fleet.set_paths(_lanes())
    trk = _crossing_movers(0) if tracked else None
    out = fleet.tick(*_start(), _free_ranges(), ANGLES, tracked=trk)
    assert out["found"].all()
    if item == "5e":
        jf = _fleet(JaxDeviceFleet, tracked, **kw)
        jf.set_paths(_lanes())
        assert fleet_spec_from_jax(jf.spec) == fleet.spec
        assert_rows_match(jf.tick(*_start(), _free_ranges(), ANGLES, tracked=trk), out)


def test_unported_box_robots_and_k_tick_loop_raise():
    """BOX fleets are ported (item 5f): a fleet with a BOX robot builds,
    ticks and runs its k-tick loop as the JAX one does
    (``test_torch_box_fleet.py``); the k-tick loop runs with its peer and
    safety forms, and its mesh form raises naming item 5g."""
    robots = _robots()
    robots[1] = _robots(1, RobotGeometry.Type.BOX, (0.5, 0.3, 0.4))[0]
    jf = JaxDeviceFleet(robots, LIMITS, _config(), N_RAYS, path_capacity=1024,
                        max_segments=16)
    box = DeviceFleet(*to_port((robots, LIMITS)), _config(), N_RAYS,
                      path_capacity=1024, max_segments=16, device="cpu")
    assert fleet_spec_from_jax(jf.spec) == box.spec and box.spec.solver.dynamic_box
    for f in (jf, box):
        f.set_paths(_lanes())
    assert_rows_match(jf.tick(*_start(), _free_ranges(), ANGLES),
                      box.tick(*_start(), _free_ranges(), ANGLES))
    fleet = _port()
    fleet.set_paths(_lanes())
    states, vels = _start()
    for f in (fleet, box):
        out = f.run_ticks_on_device(3, states, vels, _free_ranges(), ANGLES)
        assert out["vx"].shape == (N_ROBOTS, 3)
    for kw in (dict(peer_cfg={"ring": 8, "n_real": 3, "radii": [0.2] * 3}),
               dict(safety=True)):
        make_fleet_ticks_on_device(fleet.spec, 3, "cpu", **kw)
    with pytest.raises(NotImplementedError, match="item 5g"):
        make_fleet_ticks_on_device(fleet.spec, 3, "cpu", mesh=object())


def test_tracked_spec_requires_the_moving_sweep():
    """Direct composers: tracked slots without the moving sweep would
    silently drop the velocities."""
    spec = _port(tracked=1).spec
    bad = dataclasses.replace(
        spec, solver=dataclasses.replace(spec.solver, moving_obstacles=False)
    )
    with pytest.raises(ValueError, match="moving_obstacles"):
        make_fleet_tick(bad, "cpu")


# --- lockstep against JAX ----------------------------------------------------


def test_static_fleet_lockstep_with_scans(jax_fleets):
    """Random scans around every robot, 15 closed-loop ticks."""
    jf, tf = _pair(jax_fleets)
    rng = np.random.default_rng(0)
    ranges = rng.uniform(0.8, 10.0, (N_ROBOTS, N_RAYS)).astype(np.float32)
    ranges[:, 5] = np.inf
    ranges[1, 9] = np.nan
    states, vels = _start(vx=0.5)
    _, outs = lockstep(jf, tf, states, vels, 15, ranges=ranges)
    assert outs[-1]["found"].any()


def _crossing_movers(tick, v=-0.45):
    """Per robot: one mover crossing its lane ahead (moving -y from 1.5 m
    left of it), one NaN row (an empty slot)."""
    trk = np.full((N_ROBOTS, 2, 4), np.nan, np.float32)
    trk[:, 0] = (3.0, 1.5 + v * DT * tick, 0.0, v)
    trk[:, 0, 1] += 2.0 * np.arange(N_ROBOTS)
    return trk


def test_tracked_fleet_lockstep_with_crossing_movers(jax_fleets):
    jf, tf = _pair(jax_fleets, tracked=2)
    states, vels = _start(vx=0.5)
    lockstep(jf, tf, states, vels, 20, tracked=_crossing_movers)


def test_crossing_mover_is_avoided(jax_fleets):
    """test_fleet_moving.py's crossing mover, in lockstep until robot 0
    reaches its goal: with the mover's velocity the robot keeps clearance
    (robot radius 0.2 + margin 0.07 at the checked poses); with it zeroed
    (a static model of a moving world, port only) it runs closer."""

    def run(fleet_pair, v_seen, ticks):
        states, vels = _start(vx=0.5)
        mover = np.array([3.0, 1.5])
        min_d = np.inf
        for tick in range(ticks):
            trk = [np.array([[mover[0], mover[1], 0.0, v_seen]], np.float32),
                   np.zeros((0, 4)), np.zeros((0, 4))]
            outs = [f.tick(states, vels, _free_ranges(), ANGLES, tracked=trk)
                    for f in fleet_pair]
            if len(outs) == 2:
                assert_rows_match(*outs, f"tick {tick}")
            if outs[0]["reached"][0]:
                return True, min_d
            states, vels = _advance(states, outs[0])
            mover = mover + np.array([0.0, -0.45]) * DT
            min_d = min(min_d, float(np.hypot(*(states[0, :2] - mover))))
        return False, min_d

    reached, d_pred = run(_pair(jax_fleets, tracked=2), -0.45, 200)
    assert reached
    assert d_pred > 0.25, f"predictive fleet came within {d_pred:.3f} m"
    static = _port(tracked=2)
    static.set_paths(_lanes())
    _, d_static = run((static,), 0.0, 80)
    assert d_pred > d_static


def test_static_tracked_object_blocks_like_a_wall(jax_fleets):
    jf, tf = _pair(jax_fleets, tracked=2)
    states, vels = _start(vx=0.5)
    (_, (free,)) = lockstep(jf, tf, states, vels, 1)
    wall = [np.array([[0.6, 0.0, 0.0, 0.0]])]
    (_, (blocked,)) = lockstep(jf, tf, states, vels, 1, tracked=lambda t: wall)
    assert free["found"][0] and free["vx"][0] > 0.1
    assert blocked["num_admissible"][0] < free["num_admissible"][0]
    np.testing.assert_array_equal(blocked["num_admissible"][1:],
                                  free["num_admissible"][1:])


def test_goals_reached_with_per_robot_limits(jax_fleets):
    """Every robot reaches the end of its 2.5 m lane; the slow robot never
    exceeds its own 0.27 m/s while the others drive faster."""
    jf, tf = _pair(jax_fleets, length=2.5)
    states, vels = _start()
    states, outs = lockstep(jf, tf, states, vels, 150, until_reached=True)
    assert outs[-1]["reached"].all()
    vx = np.array([o["vx"] for o in outs])
    assert vx[:, 1].max() <= 0.27 + 1e-5
    assert vx[:, 0].max() > 0.3
    np.testing.assert_allclose(states[:, 0], 2.5, atol=0.3)


def test_rotate_in_place_first(jax_fleets):
    """Robots facing away from their lanes turn on the spot first."""
    jf, tf = _pair(jax_fleets, length=2.5)
    states, vels = _start(yaw=np.pi)
    _, outs = lockstep(jf, tf, states, vels, 12)
    first = outs[0]
    assert first["found"].all()
    np.testing.assert_allclose(first["vx"], 0.0, atol=1e-6)
    assert np.all(np.abs(first["omega"]) > 0.1)
    np.testing.assert_array_equal(first["cost"], 0.0)


def test_sensor_pose_per_robot(jax_fleets):
    """A wall 0.35 m ahead in the sensor frame: robot 0 (sensor forward)
    is blocked or crawls, robot 2 (sensor backward) sees it behind and
    drives on."""
    jf, tf = _pair(jax_fleets)
    ranges = _free_ranges()
    wrapped = np.angle(np.exp(1j * ANGLES))
    ranges[:, np.abs(wrapped) < np.radians(40)] = 0.35
    states, vels = _start()
    (_, (out,)) = lockstep(jf, tf, states, vels, 1, ranges=ranges)
    assert out["found"][2] and out["vx"][2] > 0.15
    assert (not out["found"][0]) or out["vx"][0] < out["vx"][2] - 0.1


def test_update_path_reroutes_one_robot_only(jax_fleets):
    jf, tf = _pair(jax_fleets, length=2.5)
    states, vels = _start()
    states, _ = lockstep(jf, tf, states, vels, 10)
    before = [t.clone() for t in tf._carry]
    new_goal = (float(states[1, 0]) + 1.0, float(states[1, 1]) + 0.8)
    new_path = np.array([states[1, :2], new_goal])
    for f in (jf, tf):
        f.update_path(1, new_path)
    for b, a in zip(before, tf._carry):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert int(tf._carry.closest_idx[1]) == 0 and not bool(tf._carry.reached[1])
    states, outs = lockstep(jf, tf, states, vels, 80, until_reached=True)
    assert outs[-1]["reached"].all()
    assert np.hypot(states[1, 0] - new_goal[0], states[1, 1] - new_goal[1]) < 0.4
    with pytest.raises(IndexError):
        tf.update_path(7, new_path)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_resumes_in_the_other_package(jax_fleets, direction):
    """Five tracked ticks in lockstep, a snapshot of one package loaded
    into a fresh fleet of the other, then ten more ticks in lockstep."""
    jf, tf = _pair(jax_fleets, tracked=2)
    states, vels = _start(vx=0.5)
    states, _ = lockstep(jf, tf, states, vels, 5, tracked=_crossing_movers)
    if direction == "jax_to_port":
        sd = jf.state_dict()
        tf = _port(tracked=2)
        tf.load_state_dict(sd)
    else:
        sd = tf.state_dict()
        jf.load_state_dict(sd)
    for key, value in tf.state_dict().items():
        np.testing.assert_array_equal(value, sd[key], err_msg=key)
        assert np.asarray(value).dtype == np.asarray(sd[key]).dtype, key
    lockstep(jf, tf, states, vels, 10, tracked=lambda t: _crossing_movers(t + 5))


def test_truncate_mode_tracked_lockstep():
    """Truncate mode with crossing movers and a wall of scan points ahead:
    truncated samples sweep the movers a second time from their frozen
    points (two moving-sweep launches per tick), and smoothness and jerk
    count."""
    fleets = [cls(*_host(cls, (_robots(), LIMITS)), _truncate_config(), N_RAYS,
                  path_capacity=1024, max_segments=16, tracked_obstacles=2,
                  **kw)
              for cls, kw in ((JaxDeviceFleet, {}), (DeviceFleet, dict(device="cpu")))]
    for f in fleets:
        f.set_paths(_lanes())
    ranges = _free_ranges()
    wrapped = np.angle(np.exp(1j * ANGLES))
    ranges[:, np.abs(wrapped) < np.radians(30)] = 1.6
    states, vels = _start(vx=0.8)
    _, outs = lockstep(*fleets, states, vels, 12, ranges=ranges,
                       tracked=_crossing_movers)
    assert all(o["found"].any() for o in outs)
    drop = _port(2)  # the same first tick in drop mode admits fewer samples
    drop.set_paths(_lanes())
    first = drop.tick(states, vels, ranges, ANGLES, tracked=_crossing_movers(0))
    assert (outs[0]["num_admissible"] > first["num_admissible"]).any()


def test_mixed_kinematics_fleet_lockstep():
    """An omni robot among diff-drive ones makes the grid omni-shaped;
    the others keep diff-drive sampling through zeroed vy limits."""
    robots = _robots()
    robots[1] = Robot(robot_type=RobotType.OMNI,
                      geometry_type=RobotGeometry.Type.CYLINDER,
                      geometry_params=np.array([0.2, 0.4]))
    omni_limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0, max_decel=10.0),
        vy_limits=LinearCtrlLimits(max_vel=0.5, max_acc=5.0, max_decel=5.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
        ),
    )
    limits = [LIMITS[0], omni_limits, LIMITS[2]]
    fleets = [cls(*_host(cls, (robots, limits)), _config(), N_RAYS, path_capacity=1024,
                  max_segments=16, **kw)
              for cls, kw in ((JaxDeviceFleet, {}), (DeviceFleet, dict(device="cpu")))]
    assert fleets[1].spec.solver.is_omni
    paths = _lanes(2.5)
    paths[1] = np.array([[0.0, 2.0], [1.5, 3.5]])  # diagonal: the omni robot slides
    for f in fleets:
        f.set_paths(paths)
    states, vels = _start()
    lockstep(*fleets, states, vels, 15)


# --- port-only contracts (test_fleet_moving.py, test_fleet_v2.py) -----------


def test_empty_tracked_slots_match_the_plain_fleet_exactly():
    """M pad slots (sentinel position, zero velocity, or NaN rows) change
    no output value against a fleet built without the feature."""
    base, trk = _port(0), _port(2)
    for f in (base, trk):
        f.set_paths(_lanes())
    states, vels = _start(vx=0.5)
    want = base.tick(states, vels, _free_ranges(), ANGLES)
    nan_rows = np.full((N_ROBOTS, 2, 4), np.nan, np.float32)
    for tracked in (None, nan_rows):
        trk.set_paths(_lanes())
        got = trk.tick(states, vels, _free_ranges(), ANGLES, tracked=tracked)
        for key in OUT_FIELDS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_stale_tracked_rows_are_cleared_between_ticks():
    fleet = _port(1)
    fleet.set_paths(_lanes())
    states, vels = _start(vx=0.5)
    free = fleet.tick(states, vels, _free_ranges(), ANGLES)
    blocked = fleet.tick(states, vels, _free_ranges(), ANGLES,
                         tracked=[np.array([[0.6, 0.0, 0.0, 0.0]])])
    assert blocked["num_admissible"][0] < free["num_admissible"][0]
    again = fleet.tick(states, vels, _free_ranges(), ANGLES)
    np.testing.assert_array_equal(again["num_admissible"], free["num_admissible"])


def test_tracked_input_validation():
    plain = _port(0)
    plain.set_paths(_lanes())
    states, vels = _start()
    r = _free_ranges()
    with pytest.raises(ValueError, match="tracked_obstacles=0"):
        plain.tick(states, vels, r, ANGLES, tracked=[np.zeros((1, 4), np.float32)])
    fleet = _port(1)
    fleet.set_paths(_lanes())
    with pytest.raises(ValueError, match="capacity"):
        fleet.tick(states, vels, r, ANGLES, tracked=[np.zeros((2, 4), np.float32)])
    with pytest.raises(ValueError, match=r"\[m, 4\]"):
        fleet.tick(states, vels, r, ANGLES, tracked=[np.zeros((1, 3), np.float32)])
    with pytest.raises(ValueError, match="ambiguous"):
        fleet.tick(states, vels, r, ANGLES, tracked=np.zeros((2, 4), np.float32))


def test_tick_before_set_paths_raises_clearly():
    fleet = _port()
    states, vels = _start()
    with pytest.raises(RuntimeError, match="set_paths"):
        fleet.tick(states, vels, _free_ranges(), ANGLES)
    with pytest.raises(RuntimeError, match="set_paths"):
        fleet.state_dict()
    with pytest.raises(ValueError, match="3-robot"):
        fleet.set_paths(_lanes()[:2])


def test_snapshot_rejects_a_different_fleet():
    fleet = _port()
    fleet.set_paths(_lanes())
    sd = fleet.state_dict()
    sd["num_robots"] = np.int32(2)
    with pytest.raises(ValueError, match="shape mismatch"):
        _port().load_state_dict(sd)


@pytest.mark.parametrize("reached", [False, True])
def test_goal_reached_at_a_misrounded_square_root(reached):
    """The goal test d <= tol, at a distance whose square (5.55078125 =
    (14^2 + 35^2) / 256) is one where a float32 sqrt that is not correctly
    rounded (PyTorch's on an AVX-512 CPU) comes out one ulp low. The
    tolerance sits at the correctly rounded root, or one ulp below it; the
    port must decide "reached" as the JAX fleet does in both cases."""
    d2 = (14.0**2 + 35.0**2) / 256.0
    root = np.float32(np.sqrt(d2))
    config = _config()
    config.goal_dist_tolerance = float(root if reached else
                                       np.nextafter(root, np.float32(0.0)))
    fleets = [cls(*_host(cls, (_robots(), LIMITS)), config, N_RAYS,
                  path_capacity=1024, max_segments=16,
                  sensor_poses=SENSOR_POSES, **kw)
              for cls, kw in ((JaxDeviceFleet, {}), (DeviceFleet, dict(device="cpu")))]
    for f in fleets:
        f.set_paths(_lanes(4.0))
    states, vels = _start()
    states[:, 0] = 4.0 - 14.0 / 16.0
    states[:, 1] -= 35.0 / 16.0
    _, (out,) = lockstep(*fleets, states, vels, 1)
    np.testing.assert_array_equal(out["reached"], reached)
