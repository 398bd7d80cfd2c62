"""The split mover sweep (``FleetSpec.split_mover_sweep``, K3s) against
the tail-slot form and against the JAX package, on the CPU.

Mirrors ``tests/test_fleet_moving.py``'s split cases: the split form is a
program-shape change (a min over the same rows; a zero-velocity row is
static bit for bit), so the port's split fleet gives the port's tail-slot
fleet's outputs bit for bit, in the single tick and the k-tick loop; its
scan bucket stays at the rays. Against the JAX package's split fleet the
port runs in lockstep under the fleet tests' parity rule
(``test_torch_fleet.assert_rows_match``), in drop and truncate mode, with
peers and prediction, and on random configurations.

K3s's plain version (``kernels.min_dist_sq_moving_reference``) equals the
JAX package's ``_min_obstacle_dist_sq_moving`` compiled without FMA bit
for bit (``test_torch_kernels.jax_without_fma``).
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
from kompass_core_tpu_torch.ops import kernels
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.ops.fleet_solver import fleet_spec_from_jax, make_fleet_tick
from kompass_core_tpu_torch.parallel import DeviceFleet

from test_torch_fleet import assert_rows_match
from test_torch_host_modules import to_port
from test_torch_kernels import jax_without_fma

torch.set_num_threads(2)

N_RAYS = 64
DT = 0.1
ANGLES = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)


def _parts(n_robots=1, horizon=20, n_lin=8, n_ang=8, drop=True):
    robots = [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                    geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.2, 0.4]))
              for _ in range(n_robots)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0, max_decel=6.0,
                                       max_steer=np.pi),
    )
    config = DWAConfig(
        max_linear_samples=n_lin, max_angular_samples=n_ang,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
            smoothness_weight=0.0 if drop else 0.1,
            jerk_weight=0.0 if drop else 0.05,
        ),
        prediction_horizon=horizon, control_horizon=2, control_time_step=DT,
        drop_samples=drop,
    )
    return robots, limits, config


def _make(split, jax=False, n_robots=1, tracked=2, rays=N_RAYS, parts=None, **kw):
    """The fleet of ``test_fleet_moving.py::_make_split`` (the JAX
    package's with ``jax``, else the port's on the CPU)."""
    robots, limits, config = parts or _parts(n_robots)
    args = dict(scan_rays=rays, path_capacity=1024, max_segments=16,
                tracked_obstacles=tracked, split_mover_sweep=split, **kw)
    if jax:
        fleet = JaxDeviceFleet(robots, limits, config, **args)
    else:
        fleet = DeviceFleet(*to_port((robots, limits)), config, device="cpu", **args)
    fleet.set_paths([np.array([[0.0, 2.0 * i], [6.0, 2.0 * i]])
                     for i in range(len(robots))])
    return fleet


def _free_inputs(n_robots=1):
    states = np.zeros((n_robots, 4), np.float32)
    states[:, 0] = 0.0137
    states[:, 1] = 2.0 * np.arange(n_robots)
    vels = np.zeros((n_robots, 3), np.float32)
    vels[:, 0] = 0.5
    ranges = np.full((n_robots, N_RAYS), 10.0, np.float32)
    return states, vels, ranges, ANGLES


TRACKED_CASES = [
    None,
    [np.array([[1.2, 0.0, 0.0, 0.0]], np.float32)],  # a static wall
    [np.array([[3.0, 2.0, 0.0, -0.8], [1.5, -1.0, 0.3, 0.4]], np.float32)],
    np.array([[[2.0, 1.0, -0.5, 0.0], [np.nan] * 4]], np.float32),  # NaN pad
]


@pytest.mark.parametrize("case", range(len(TRACKED_CASES)))
def test_split_mover_sweep_bit_identical_to_tail_slot(case):
    """Crossing movers, a static wall, empty slots and NaN pads: the split
    fleet's outputs equal the tail-slot fleet's bit for bit."""
    inputs = _free_inputs()
    out_t = _make(False).tick(*inputs, tracked=TRACKED_CASES[case])
    out_s = _make(True).tick(*inputs, tracked=TRACKED_CASES[case])
    for key in out_t:
        np.testing.assert_array_equal(out_s[key], out_t[key], err_msg=key)


def test_split_mover_sweep_k_ticks_bit_identical():
    """The k-tick loop advects split movers as it advects tail-slot movers:
    k = 12 ticks equal bit for bit."""
    trk = [np.array([[3.0, 2.0, 0.0, -0.8]], np.float32)]
    out_t = _make(False, tracked=1).run_ticks_on_device(12, *_free_inputs(), tracked=trk)
    out_s = _make(True, tracked=1).run_ticks_on_device(12, *_free_inputs(), tracked=trk)
    for key in out_t:
        np.testing.assert_array_equal(out_s[key], out_t[key], err_msg=key)


@pytest.mark.parametrize("rays,tail_size", [(64, 256), (256, 512)])
def test_split_mover_scan_bucket_stays_at_rays(rays, tail_size):
    """The split form keeps the scan bucket at the rays; the tail-slot
    form grows it by the slots (past a full bucket, to the next 256), and
    only the tail-slot form needs the main sweep's velocities."""
    tail, split = _make(False, tracked=8, rays=rays), _make(True, tracked=8, rays=rays)
    assert tail.spec.solver.scan_size == tail_size
    assert split.spec.solver.scan_size == 256
    assert tail.spec.solver.moving_obstacles
    assert not split.spec.solver.moving_obstacles
    jax_split = _make(True, jax=True, tracked=8, rays=rays)
    assert fleet_spec_from_jax(jax_split.spec) == split.spec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tail_parity_random_configs(seed):
    """Random grids, horizons, rays, slots, fleet sizes and drop or
    truncate: split == tail-slot bit for bit in the port, and the port's
    split fleet agrees with the JAX package's."""
    rng = np.random.default_rng(seed)
    n_robots = int(rng.integers(1, 4))
    tracked = int(rng.integers(1, 4))
    rays = int(rng.choice([32, 64, 96]))
    horizon = int(rng.integers(8, 25))
    n_lin, n_ang = int(rng.integers(3, 9)), int(rng.integers(3, 9))
    drop = bool(rng.integers(0, 2))
    parts = _parts(n_robots, horizon, n_lin, n_ang, drop)
    states = np.zeros((n_robots, 4), np.float32)
    states[:, 0] = 0.0137
    states[:, 1] = 2.0 * np.arange(n_robots)
    vels = np.zeros((n_robots, 3), np.float32)
    vels[:, 0] = 0.5
    ranges = rng.uniform(1.5, 10.0, (n_robots, rays)).astype(np.float32)
    angles = np.linspace(0, 2 * np.pi, rays, endpoint=False)
    trk = rng.uniform(-1.0, 5.0, (n_robots, tracked, 4)).astype(np.float32)
    trk[:, :, 2:4] = rng.uniform(-0.8, 0.8, (n_robots, tracked, 2))
    for i in range(n_robots):
        if rng.integers(0, 2):
            trk[i, rng.integers(0, tracked)] = np.nan
    fleets = {form: _make(form != "tail", jax=form == "jax", tracked=tracked,
                          rays=rays, parts=parts)
              for form in ("tail", "split", "jax")}
    out = {form: f.tick(states, vels, ranges, angles, tracked=trk)
           for form, f in fleets.items()}
    for key in out["tail"]:
        np.testing.assert_array_equal(out["split"][key], out["tail"][key],
                                      err_msg=f"seed {seed} {key}")
    assert_rows_match(out["jax"], out["split"], f"seed {seed}")


def _crossing(tick, n_robots=3, v=-0.45):
    trk = np.full((n_robots, 2, 4), np.nan, np.float32)
    trk[:, 0] = (3.0, 1.5 + v * DT * tick, 0.0, v)
    trk[:, 0, 1] += 2.0 * np.arange(n_robots)
    return trk


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "truncate"])
@pytest.mark.parametrize("peers", [False, True], ids=["alone", "peers"])
def test_split_fleet_lockstep_with_jax(drop, peers):
    """Three robots, a mover crossing each lane, 12 closed-loop ticks in
    lockstep with the JAX split fleet (with peers: avoidance and
    prediction, the main sweep then moving); then 6 ticks of the k-tick
    loop."""
    parts = _parts(3, drop=drop)
    kw = dict(peer_avoidance=True, peer_prediction=True) if peers else {}
    jf = _make(True, jax=True, n_robots=3, parts=parts, **kw)
    tf = _make(True, n_robots=3, parts=parts, **kw)
    assert fleet_spec_from_jax(jf.spec) == tf.spec
    assert tf.spec.solver.moving_obstacles == peers
    states, vels, ranges, angles = _free_inputs(3)
    for tick in range(12):
        jout = jf.tick(states, vels, ranges, angles, tracked=_crossing(tick))
        tout = tf.tick(states, vels, ranges, angles, tracked=_crossing(tick))
        assert_rows_match(jout, tout, f"tick {tick}")
        c, s = np.cos(states[:, 2]), np.sin(states[:, 2])
        states = states.copy()
        states[:, 0] += DT * jout["vx"] * c
        states[:, 1] += DT * jout["vx"] * s
        states[:, 2] += DT * jout["omega"]
        vels = np.stack([jout["vx"], jout["vy"], jout["omega"]], 1).astype(np.float32)
    jout = jf.run_ticks_on_device(6, states, vels, ranges, angles, tracked=_crossing(12))
    tout = tf.run_ticks_on_device(6, states, vels, ranges, angles, tracked=_crossing(12))
    np.testing.assert_array_equal(tout["found"], jout["found"])
    np.testing.assert_array_equal(tout["num_admissible"], jout["num_admissible"])
    np.testing.assert_allclose(tout["final_states"], jout["final_states"],
                               rtol=1e-4, atol=1e-4)


def test_mover_sweep_runs_k3s_whatever_the_backend(monkeypatch):
    """``dwa_solve``'s ``mover4`` goes through K3s for every backend (K3's
    direct form, as the JAX package sweeps it), once in drop mode and
    again from the truncated positions in truncate mode."""
    calls = []
    real = tsolver.min_dist_sq_moving
    monkeypatch.setattr(tsolver, "min_dist_sq_moving",
                        lambda *a: calls.append(1) or real(*a))
    for backend in tsolver.BACKENDS:
        for drop in (True, False):
            fleet = _make(True, parts=_parts(1, drop=drop))
            fleet.spec = dataclasses.replace(fleet.spec, solver=dataclasses.replace(
                fleet.spec.solver, backend=backend))
            fleet._tick_fn = make_fleet_tick(fleet.spec, "cpu")
            calls.clear()
            fleet.tick(*_free_inputs(), tracked=TRACKED_CASES[2])
            assert len(calls) == (1 if drop else 2), (backend, drop)


# --- K3s's plain version against the JAX package --------------------------------

K3S_CASES = [(0, 12, 8), (1, 7, 3), (2, 1, 1)]  # (seed, active steps, rows)


def _k3s_case(seed, rows):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-12.0, 12.0, (40, 12)).astype(np.float32)
    py = rng.uniform(-12.0, 12.0, (40, 12)).astype(np.float32)
    obs = rng.uniform(-12.0, 12.0, (rows, 2)).astype(np.float32)
    vel = rng.uniform(-1.5, 1.5, (rows, 2)).astype(np.float32)
    if rows > 2:
        obs[-1], vel[-1] = 1e8, 0.0  # a pad row
    return px, py, obs, vel, np.float32(0.1 + 0.05 * seed)


def jax_fields_without_fma():
    """Each K3s case's field of the JAX package's moving sweep, for
    ``jax_without_fma``."""
    import jax
    import jax.numpy as jnp
    from kompass_core_tpu.ops import solver as jsolver

    fields = {}
    for seed, active, rows in K3S_CASES:
        px, py, obs, vel, dt = _k3s_case(seed, rows)
        mask = jnp.arange(px.shape[1]) < active
        fn = jax.jit(lambda *a: jsolver._min_obstacle_dist_sq_moving(*a, mask))
        fields[f"{seed}"] = np.asarray(fn(px, py, obs, vel, dt))
    return fields


@pytest.fixture(scope="module")
def k3s_without_fma(tmp_path_factory):
    return jax_without_fma("test_torch_fleet_moving",
                           tmp_path_factory.mktemp("no_fma") / "k3s.npz")


@pytest.mark.parametrize("seed,active,rows", K3S_CASES)
def test_k3s_plain_version_equals_jax_without_fma(k3s_without_fma, seed, active,
                                                  rows):
    """Every operation of the direct moving form rounded on its own, as
    JAX compiles it without FMA: bit for bit, +inf at inactive steps."""
    px, py, obs, vel, dt = (torch.from_numpy(np.asarray(a)) for a in _k3s_case(seed, rows))
    ap = torch.tensor(active, dtype=torch.int32)
    got = kernels.min_dist_sq_moving(px, py, obs, vel, dt.reshape(()), ap).numpy()
    np.testing.assert_array_equal(got, k3s_without_fma[f"{seed}"])
    assert np.isinf(got[:, active:]).all()


def test_k3s_is_k3s_obstacle_field():
    """K3s's plain version is K3's obstacle field over the same rows,
    batched and per robot."""
    rng = np.random.default_rng(9)
    B, S, T, M = 3, 20, 9, 5
    px, py = (torch.from_numpy(rng.uniform(-5, 5, (B, S, T)).astype(np.float32))
              for _ in range(2))
    rows = torch.from_numpy(rng.uniform(-5, 5, (B, M, 2)).astype(np.float32))
    vel = torch.from_numpy(rng.uniform(-1, 1, (B, M, 2)).astype(np.float32))
    dt = torch.tensor([0.1, 0.2, 0.05])
    ap = torch.tensor([9, 4, 1], dtype=torch.int32)
    seg = torch.full((B, 4), 1e8)
    got = kernels.min_dist_sq_moving(px, py, rows, vel, dt, ap)
    d2_obs, _ = kernels.fused_min_dist_sq_moving(px, py, rows, vel, dt, seg, seg, ap)
    assert torch.equal(got, d2_obs)
    for b in range(B):
        one = kernels.min_dist_sq_moving(px[b], py[b], rows[b], vel[b], dt[b], ap[b])
        assert torch.equal(one, got[b])
