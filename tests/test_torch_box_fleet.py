"""BOX fleets (``SolverSpec.dynamic_box``) and K9, the oriented-box field,
against the JAX package, on the CPU.

Mirrors ``tests/test_fleet_v2.py``'s box cases: a fleet with a BOX robot
decides every robot's admissibility on its oriented box, a circle robot
as a (0, 0) box with its radius in its margin, so a mixed fleet's rows
equal the homogeneous fleets' (``test_mixed_shapes_match_homogeneous_
fleets``), and head-on BOX robots with peer avoidance keep clear
(``test_peer_avoidance_box_fleet``). The port's BOX fleets run in
lockstep with the JAX package's under the fleet tests' parity rule
(``test_torch_fleet.assert_rows_match``): alone, with tracked movers in
both forms, with peers, prediction and the safety gate, and in the
k-tick loop.

K9's plain version (``kernels.box_min_dist_sq_reference``) given the
JAX package's headings equals its ``_min_box_dist_sq`` compiled without
FMA bit for bit (``test_torch_kernels.jax_without_fma``); with the
port's own headings (torch's cos and sin, an ulp from XLA's) the field
agrees within rel 1e-5.
"""

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
from kompass_core_tpu.parallel.fleet_v2 import FleetSafetyConfig as JaxSafetyConfig
from kompass_core_tpu_torch.ops import kernels
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.ops.fleet_solver import fleet_spec_from_jax
from kompass_core_tpu_torch.parallel import DeviceFleet
from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig

from test_torch_fleet import assert_rows_match
from test_torch_host_modules import to_port
from test_torch_kernels import jax_without_fma

torch.set_num_threads(2)

N_RAYS = 72
DT = 0.1
ANGLES = np.linspace(-np.pi, np.pi, N_RAYS, endpoint=False)


def _config(obstacles=0.0, drop=True):
    return DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            smoothness_weight=0.0 if drop else 0.1, jerk_weight=0.0,
            obstacles_distance_weight=obstacles,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=DT,
        drop_samples=drop,
    )


def _limits():
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=4.0, max_acc=3.0, max_decel=3.0,
                                       max_steer=np.pi),
    )


def _robot(box, robot_type=RobotType.ACKERMANN, params=None):
    if box:
        return Robot(robot_type=robot_type, geometry_type=RobotGeometry.Type.BOX,
                     geometry_params=np.array(params or [1.2, 0.2, 0.3]))
    return Robot(robot_type=robot_type, geometry_type=RobotGeometry.Type.CYLINDER,
                 geometry_params=np.array(params or [0.1, 0.4]))


def _pair(robots, config, safety=False, **kw):
    args = dict(scan_rays=N_RAYS, path_capacity=512, max_segments=16, **kw)
    jf = JaxDeviceFleet(robots, _limits(), config, **args,
                        safety_config=JaxSafetyConfig() if safety else None)
    tf = DeviceFleet(*to_port((robots, _limits())), config, device="cpu", **args,
                     safety_config=FleetSafetyConfig() if safety else None)
    assert fleet_spec_from_jax(jf.spec) == tf.spec
    for jv, tv in zip(jf._cfg, tf._cfg):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    return jf, tf


def _wall_ranges():
    """A wall 0.5 m ahead in the body frame: the 1.2 m box (half length
    0.6) is into it, the r = 0.1 circle is not."""
    ranges = np.full(N_RAYS, 10.0)
    for lat in np.arange(-1.0, 1.0, 0.02):
        ang, r = np.arctan2(lat, 0.5), np.hypot(0.5, lat)
        k = int(np.argmin(np.abs(np.angle(np.exp(1j * (ANGLES - ang))))))
        ranges[k] = min(ranges[k], r)
    return ranges


def _first_tick(fleet, n):
    fleet.set_paths([np.array([[0.0, 0.0], [0.3, 2.5]])] * n)
    states = np.tile([0.1, 0.05, np.pi / 2, 0.0], (n, 1))
    return fleet.tick(states, np.zeros((n, 3)), np.tile(_wall_ranges(), (n, 1)),
                      ANGLES)


def test_mixed_shapes_match_homogeneous_fleets():
    """A circle and a BOX in one fleet give the homogeneous fleets' rows
    (the (0, 0) box is the circle model; the dynamic box is the static
    one), and each row is the JAX mixed fleet's."""
    config = _config(obstacles=1.0)
    jm, mixed = _pair([_robot(False), _robot(True)], config)
    _, circle = _pair([_robot(False)], config)
    _, box = _pair([_robot(True)], config)
    out_m, out_c, out_b = (_first_tick(f, n) for f, n in
                           ((mixed, 2), (circle, 1), (box, 1)))
    assert_rows_match(_first_tick(jm, 2), out_m)
    assert out_m["found"][0] == out_c["found"][0]
    assert out_m["found"][1] == out_b["found"][0]
    for key in ("vx", "omega"):
        np.testing.assert_allclose(out_m[key][0], out_c[key][0], atol=1e-5)
        np.testing.assert_allclose(out_m[key][1], out_b[key][0], atol=1e-5)
    # the two shapes behave differently here: the box is wedged
    assert out_m["found"][0] and not out_m["found"][1]


def test_peer_avoidance_box_fleet():
    """Head-on BOX robots with peer avoidance keep clear for 60 ticks; the
    port's rows agree with the JAX fleet's every tick (both see the
    port-driven states)."""
    robots = [_robot(True, RobotType.DIFFERENTIAL_DRIVE, [0.5, 0.4, 0.3])
              for _ in range(2)]
    jf, tf = _pair(robots, _config(), peer_avoidance=True)
    assert tf.spec.solver.dynamic_box
    paths = [np.array([[0.0, 0.0], [4.0, 0.0]]), np.array([[4.0, 0.0], [0.0, 0.0]])]
    for f in (jf, tf):
        f.set_paths(paths)
    state = [to_port(r) for r in robots]
    state[0].state.x, state[0].state.yaw = 0.0, 0.0
    state[1].state.x, state[1].state.yaw = 4.0, np.pi
    ranges = np.full((2, N_RAYS), 10.0)
    min_d = np.inf
    for tick in range(60):
        states = np.array([[r.state.x, r.state.y, r.state.yaw, r.state.speed]
                           for r in state])
        vels = np.array([[r.state.vx, r.state.vy, r.state.omega] for r in state])
        out = tf.tick(states, vels, ranges, ANGLES)
        assert_rows_match(jf.tick(states, vels, ranges, ANGLES), out, f"tick {tick}")
        for r, vx, vy, om, found in zip(state, out["vx"], out["vy"],
                                        out["omega"], out["found"]):
            if found:
                r.set_control(velocity_x=vx, velocity_y=vy, omega=om)
                r.get_state(dt=DT)
        min_d = min(min_d, np.hypot(state[0].state.x - state[1].state.x,
                                    state[0].state.y - state[1].state.y))
    assert min_d > 0.45, f"box peers collided: min distance {min_d}"


def _lanes(n):
    return [np.array([[0.0, 3.0 * i], [5.0, 3.0 * i]]) for i in range(n)]


def _movers(tick, n, v=-0.4):
    trk = np.full((n, 2, 4), np.nan, np.float32)
    trk[:, 0] = (2.5, 1.2 + v * DT * tick, 0.0, v)
    trk[:, 0, 1] += 3.0 * np.arange(n)
    return trk


@pytest.mark.parametrize("form", ["tail", "split", "peers_safety"])
def test_box_fleet_lockstep_with_jax(form):
    """A circle, a BOX and a diff-drive BOX with movers crossing their
    lanes and random scans: 10 closed-loop ticks in lockstep with the JAX
    fleet, then 5 ticks of the k-tick loop. ``peers_safety``: peers with
    prediction and the safety gate too (truncate mode)."""
    robots = [_robot(False, RobotType.DIFFERENTIAL_DRIVE),
              _robot(True, RobotType.DIFFERENTIAL_DRIVE, [0.5, 0.3, 0.4]),
              _robot(True, RobotType.ACKERMANN, [0.6, 0.35, 0.4])]
    kw = dict(tracked_obstacles=2, split_mover_sweep=form == "split")
    if form == "peers_safety":
        kw.update(peer_avoidance=True, peer_prediction=True, safety=True)
    jf, tf = _pair(robots, _config(0.5, drop=form != "peers_safety"), **kw)
    for f in (jf, tf):
        f.set_paths(_lanes(3))
    rng = np.random.default_rng(4)
    ranges = rng.uniform(1.0, 10.0, (3, N_RAYS)).astype(np.float32)
    states = np.zeros((3, 4), np.float32)
    states[:, 0] = 0.0137
    states[:, 1] = 3.0 * np.arange(3)
    vels = np.zeros((3, 3), np.float32)
    found = 0
    for tick in range(10):
        jout = jf.tick(states, vels, ranges, ANGLES, tracked=_movers(tick, 3))
        tout = tf.tick(states, vels, ranges, ANGLES, tracked=_movers(tick, 3))
        assert_rows_match(jout, tout, f"tick {tick}")
        found += int(tout["found"].sum())
        c, s = np.cos(states[:, 2]), np.sin(states[:, 2])
        states = states.copy()
        states[:, 0] += DT * jout["vx"] * c
        states[:, 1] += DT * jout["vx"] * s
        states[:, 2] += DT * jout["omega"]
        vels = np.stack([jout["vx"], jout["vy"], jout["omega"]], 1).astype(np.float32)
    assert found > 15
    jout = jf.run_ticks_on_device(5, states, vels, ranges, ANGLES, tracked=_movers(10, 3))
    tout = tf.run_ticks_on_device(5, states, vels, ranges, ANGLES, tracked=_movers(10, 3))
    for key in ("found", "num_admissible", "safety_factor"):
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
    np.testing.assert_allclose(tout["final_states"], jout["final_states"],
                               rtol=1e-4, atol=1e-4)


def test_dynamic_box_needs_its_extents():
    """A dynamic_box tick given a config without ``collision_box2`` raises,
    as the JAX package does: the circle model would count the radius
    twice."""
    _, tf = _pair([_robot(False), _robot(True)], _config())
    tf.set_paths(_lanes(2))
    tf._cfg = tf._cfg._replace(collision_box2=None)
    with pytest.raises(ValueError, match="collision_box2"):
        tf.tick(np.zeros((2, 4)), np.zeros((2, 3)), np.full((2, N_RAYS), 10.0),
                ANGLES)


# --- K9's plain version against the JAX package ---------------------------------

K9_CASES = [(0, 12, False), (1, 7, True), (2, 1, True)]  # (seed, active, moving)


def _k9_case(seed, moving):
    rng = np.random.default_rng(seed)
    S, T, O = 24, 12, 150
    px = rng.uniform(-8.0, 8.0, (S, T)).astype(np.float32)
    py = rng.uniform(-8.0, 8.0, (S, T)).astype(np.float32)
    obs = rng.uniform(-8.0, 8.0, (O, 2)).astype(np.float32)
    obs[:4] = px[:4, 3:4].repeat(2, 1)  # inside the footprint of some poses
    obs[:4, 1] = py[:4, 3]
    obs[-3:] = 1e8  # pad rows
    vel = rng.uniform(-1.5, 1.5, (O, 2)).astype(np.float32) if moving else None
    if moving:
        vel[-3:] = 0.0
    state = np.array([0.3, -0.2, rng.uniform(-3, 3)], np.float32)
    omega = rng.uniform(-2.0, 2.0, S).astype(np.float32)
    half = np.array([0.3 + 0.1 * seed, 0.2], np.float32)
    return px, py, obs, vel, state, omega, half, np.float32(0.1)


def jax_fields_without_fma():
    """Each K9 case's JAX box field, its yaw's cos and sin as XLA computes
    them there, for ``jax_without_fma``."""
    import jax
    import jax.numpy as jnp
    from kompass_core_tpu.ops import solver as jsolver

    fields = {}
    for seed, active, moving in K9_CASES:
        px, py, obs, vel, state, omega, half, dt = _k9_case(seed, moving)
        T = px.shape[1]
        mask = jnp.arange(T) < active
        vels = np.zeros((px.shape[0], 3), np.float32)
        vels[:, 2] = omega

        @jax.jit
        def field(px, py, obs, vel, state, vels, hl, hw, dt):
            params = jsolver.SolverParams(*([dt] + [jnp.float32(0.0)] * 11))
            d2 = jsolver._min_box_dist_sq(None, params, state, vels, px, py, obs,
                                          mask, box_hl=hl, box_hw=hw, obs_vel=vel)
            yaw = state[2] + vels[:, 2:3] * jnp.arange(T, dtype=jnp.float32)[None, :] * dt
            return d2, jnp.cos(yaw), jnp.sin(yaw)

        d2, c, s = field(px, py, obs, vel, state, vels, half[0], half[1], dt)
        for key, a in (("d2", d2), ("cos", c), ("sin", s)):
            fields[f"{seed}/{key}"] = np.asarray(a)
    return fields


@pytest.fixture(scope="module")
def k9_without_fma(tmp_path_factory):
    return jax_without_fma("test_torch_box_fleet",
                           tmp_path_factory.mktemp("no_fma") / "k9.npz")


def _k9_port(case, active, cos=None, sin=None):
    px, py, obs, vel, state, omega, half, dt = case
    t = {k: torch.from_numpy(v) for k, v in
         dict(px=px, py=py, obs=obs, half=half).items()}
    if cos is None:
        # the solver's headings: torch's cos and sin of the same yaw
        yaw = (torch.tensor(state[2]) + torch.from_numpy(omega)[:, None]
               * torch.arange(px.shape[1], dtype=torch.float32) * torch.tensor(dt))
        cos, sin = torch.cos(yaw), torch.sin(yaw)
    else:
        cos, sin = torch.from_numpy(cos), torch.from_numpy(sin)
    return kernels.box_min_dist_sq(
        t["px"][None], t["py"][None], cos[None].contiguous(), sin[None].contiguous(),
        t["obs"][None], None if vel is None else torch.from_numpy(vel)[None],
        torch.tensor([dt]), t["half"][None], torch.tensor([active], dtype=torch.int32),
    )[0].numpy()


@pytest.mark.parametrize("seed,active,moving", K9_CASES)
def test_k9_plain_version_equals_jax_without_fma(k9_without_fma, seed, active,
                                                 moving):
    """Given XLA's headings, every operation rounded on its own: bit for
    bit, 0 inside the footprint, +inf at inactive steps; with torch's
    headings within rel 1e-5 (the headings differ by an ulp)."""
    case = _k9_case(seed, moving)
    want = k9_without_fma[f"{seed}/d2"]
    got = _k9_port(case, active, k9_without_fma[f"{seed}/cos"],
                   k9_without_fma[f"{seed}/sin"])
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:, active:]).all()
    own = _k9_port(case, active)
    np.testing.assert_allclose(own[:, :active], want[:, :active], rtol=1e-5,
                               atol=1e-6)


def test_k9_field_inside_pads_nan_batch_and_slabs(monkeypatch):
    """A row inside the footprint gives 0; pad rows change nothing; a NaN
    row makes the field NaN (as ``torch.amin``); three robots in one call
    give each robot's own values; slabs of any size give one broadcast's."""
    rng = np.random.default_rng(11)
    B, S, T, O = 3, 30, 8, 40
    px, py = (torch.from_numpy(rng.uniform(-4, 4, (B, S, T)).astype(np.float32))
              for _ in range(2))
    yaw = torch.from_numpy(rng.uniform(-3, 3, (B, S, T)).astype(np.float32))
    c, s = torch.cos(yaw), torch.sin(yaw)
    rows = torch.from_numpy(rng.uniform(-4, 4, (B, O, 2)).astype(np.float32))
    rows[0, 0] = torch.stack([px[0, 5, 2], py[0, 5, 2]])
    vel = torch.from_numpy(rng.uniform(-1, 1, (B, O, 2)).astype(np.float32))
    dt = torch.tensor([0.1, 0.2, 0.05])
    half = torch.tensor([[0.3, 0.2], [0.0, 0.0], [0.5, 0.1]])
    ap = torch.tensor([8, 5, 1], dtype=torch.int32)
    got = kernels.box_min_dist_sq(px, py, c, s, rows, vel, dt, half, ap)
    assert got[0, 5, 2] == 0.0
    assert torch.isinf(got[1, :, 5:]).all() and torch.isinf(got[2, :, 1:]).all()
    for b in range(B):
        one = kernels.box_min_dist_sq(px[b:b + 1], py[b:b + 1], c[b:b + 1],
                                      s[b:b + 1], rows[b:b + 1], vel[b:b + 1],
                                      dt[b:b + 1], half[b:b + 1], ap[b:b + 1])
        assert torch.equal(one[0], got[b])
    padded_rows = torch.cat([rows, torch.full((B, 5, 2), 1e8)], 1)
    padded_vel = torch.cat([vel, torch.zeros(B, 5, 2)], 1)
    assert torch.equal(kernels.box_min_dist_sq(px, py, c, s, padded_rows, padded_vel,
                                               dt, half, ap), got)
    monkeypatch.setattr(kernels, "_SLAB_ELEMS", 7 * T * O * B)
    assert torch.equal(kernels.box_min_dist_sq(px, py, c, s, rows, vel, dt, half, ap),
                       got)
    rows[1, 3, 0] = float("nan")
    nan = kernels.box_min_dist_sq(px, py, c, s, rows, vel, dt, half, ap)
    assert torch.isnan(nan[1, :, :5]).all() and torch.equal(nan[0], got[0])


def test_box_solver_runs_k9_once_per_box_field(monkeypatch):
    """The BOX solve calls K9 once, and once more for split movers."""
    calls = []
    real = tsolver.box_min_dist_sq
    monkeypatch.setattr(tsolver, "box_min_dist_sq",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    robots = [_robot(False), _robot(True, RobotType.DIFFERENTIAL_DRIVE, [0.5, 0.3, 0.4])]
    for split, expected in ((False, 1), (True, 2)):
        _, tf = _pair(robots, _config(), tracked_obstacles=1, split_mover_sweep=split)
        tf.set_paths(_lanes(2))
        calls.clear()
        tf.tick(np.zeros((2, 4)), np.zeros((2, 3)), np.full((2, N_RAYS), 10.0),
                ANGLES, tracked=_movers(0, 2)[:, :1])
        assert len(calls) == expected
