"""What ``ops/solver.py`` offers around the packed solve, against the JAX
package on the CPU: BOX robots, custom costs, the debug sampler and the
standalone cost evaluator.

Tolerances are those of ``tests/test_torch_solver.py`` (the same
``found``, ``num_admissible`` and inf pattern; costs within rel 1e-4;
the winner equal or a tie), and the controllers' commands within 1e-4
per tick as in ``tests/test_torch_dwa.py``. The BOX surface distance is
plain torch on both sides; its cosines and sines come from different
libraries, an ulp apart, and the costs absorb that like the rollout's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kompass_core_tpu.control import DWA as JaxDWA
from kompass_core_tpu.control import DWAConfig as JaxDWAConfig
from kompass_core_tpu.datatypes.laserscan import LaserScanData
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotState,
    RobotType,
)
from kompass_core_tpu.ops import solver as jsolver
from kompass_core_tpu.ops.window import sample_velocity_window
from kompass_core_tpu_torch.control import DWA, DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu_torch.ops import solver as tsolver

from test_cost_evaluator_standalone import _heavy_samples
from test_oracle_parity import _scenario_inputs
from test_torch_host_modules import to_port
from test_torch_solver import _jax_spec, _pack, assert_tick_parity

torch.set_num_threads(2)
CPU = torch.device("cpu")
CMD_TOL = 1e-4

# --- BOX robots: the narrow box through the corridor ---------------------------

HALF = (0.4, 0.15)  # 0.8 m long, 0.3 m wide: circumscribed radius 0.427


def _corridor_spec(**kw):
    return jsolver.SolverSpec(**{
        **dict(is_omni=False, n_vx=3, n_vy=1, n_omega=3, max_points=10,
               num_ctrl_points=2, scan_size=256, seg_size=64,
               drop_samples=True, collision_box=HALF),
        **kw,
    })


def _corridor_buffer(jspec, obs_vel=None):
    """``tests/test_solver_modes.py``'s corridor: walls at y = +-0.25,
    wider than the box, narrower than its circle."""
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=0.5, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=0.1, max_acc=3.0, max_decel=3.0),
    ).to_array()
    limits[3:6] = 0.0
    xs = np.linspace(-0.5, 2.0, 60)
    wall = np.concatenate([np.stack([xs, np.full_like(xs, 0.25)], 1),
                           np.stack([xs, np.full_like(xs, -0.25)], 1)])
    obs = np.full((256, 2), 1e8, np.float32)
    obs[: len(wall)] = wall
    n_seg = 40
    s = np.linspace(0, 2.0, n_seg).astype(np.float32)
    seg_x = np.full(64, 1e8, np.float32)
    seg_y = np.full(64, 1e8, np.float32)
    seg_arc = np.zeros(64, np.float32)
    seg_x[:n_seg], seg_y[:n_seg], seg_arc[:n_seg] = s, 0.0, s
    window = sample_velocity_window((0.4, 0.0, 0.0), limits, 0.1, 3, 1, 3, False)
    params = np.array([0.1, float(np.hypot(*HALF)), 0.05, 2.0, 1.0, 0.5, 0.0,
                       0.0, 5.0, 0.0, 3.0, 10 / 3], np.float32)
    buf = np.zeros(jsolver.packed_input_size(jspec), np.float32)
    kw = {}
    if obs_vel is not None:
        vel = np.zeros((256, 2), np.float32)
        vel[: len(wall)] = obs_vel
        kw["obs_vel_xy"] = vel
    jsolver.pack_solver_input(
        jspec, buf, params, (0.0, 0.0, 0.0), window, obs, len(wall), seg_x,
        seg_y, seg_arc, n_seg, float(s[-1]), 2.0, jspec.max_points, **kw,
    )
    return buf


def _out(res):
    """The packed output vector of a (JAX or port) one-robot result."""
    head = [float(res.found), float(res.cost), float(res.best_index),
            float(res.num_admissible)]
    return np.concatenate([head, np.asarray(res.velocities).T.ravel(),
                           np.asarray(res.path).T.ravel()]).astype(np.float32)


def _both(jspec, buf, box_dyn=None, custom=((), ())):
    """(JAX result, its output vector, port result, its output vector)
    for one packed buffer; ``custom`` holds the JAX and the torch custom
    costs. The port's packed solver gives its output vector exactly."""
    jbox = None if box_dyn is None else jnp.asarray(box_dyn, jnp.float32)
    tbox = None if box_dyn is None else torch.tensor(box_dyn)[None]

    def jsolve(b):
        u = jsolver._unpack_inputs(jspec, b)
        return jsolver.dwa_solve(jspec, *u[:12], obs_vel=u[12],
                                 collision_box_dyn=jbox, custom_costs=custom[0])

    jres = jax.jit(jsolve)(jnp.asarray(buf))
    tspec = tsolver.spec_from_jax(jspec)
    tres = tsolver.dwa_solve(
        tspec, *tsolver._unpack_inputs(tspec, torch.from_numpy(buf[None].copy())),
        collision_box_dyn=tbox, custom_costs=custom[1],
    )
    tres = tsolver.SolveResult(*(f[0] for f in tres))
    if box_dyn is None:
        packed = tsolver.make_packed_dwa_solver(tspec, CPU, custom[1])(buf)
        np.testing.assert_array_equal(packed.numpy(), _out(tres))
    return jres, _out(jres), tres, _out(tres)


def test_box_robot_passes_the_corridor_the_circle_blocks():
    """The static box admits the straight samples; the same spec with
    the circumscribed circle admits none. Both as in JAX."""
    jspec = _corridor_spec()
    buf = _corridor_buffer(jspec)
    jres, jout, tres, tout = _both(jspec, buf)
    assert_tick_parity(jres, jout, tres, tout)
    assert bool(tres.found) and int(tres.num_admissible) > 0
    circle = dataclasses.replace(jspec, collision_box=None)
    cres = _both(circle, buf)
    assert_tick_parity(*cres)
    assert not bool(cres[2].found)


@pytest.mark.parametrize("half,expect_found", [(HALF, True), ((0.0, 0.0), True),
                                               ((0.4, 0.3), False)])
def test_dynamic_box_matches_jax(half, expect_found):
    """``dynamic_box`` with the half-extents as a tensor argument: the
    corridor box passes, a zero box is the point robot (its radius would
    go into the margin), a box wider than the corridor is blocked."""
    jspec = dataclasses.replace(_corridor_spec(), collision_box=None,
                                dynamic_box=True)
    jres, jout, tres, tout = _both(jspec, _corridor_buffer(jspec), box_dyn=half)
    assert_tick_parity(jres, jout, tres, tout)
    assert bool(tres.found) == expect_found


@pytest.mark.parametrize("drop", [True, False])
def test_moving_box_matches_jax(drop):
    """The box against walls that drift toward the robot's lane at
    0.1-0.3 m/s, drop and truncate mode (the truncate re-sweep)."""
    jspec = _corridor_spec(moving_obstacles=True, drop_samples=drop)
    rng = np.random.default_rng(17 + drop)
    vel = np.zeros((120, 2), np.float32)
    vel[:60, 1] = -rng.uniform(0.1, 0.3, 60)  # upper wall moves down
    vel[60:, 1] = rng.uniform(0.1, 0.3, 60)
    vel[:, 0] = rng.uniform(-0.2, 0.2, 120)
    moving = _both(jspec, _corridor_buffer(jspec, vel))
    assert_tick_parity(*moving)
    still = _both(jspec, _corridor_buffer(jspec, 0.0 * vel))
    assert_tick_parity(*still)
    assert int(moving[2].num_admissible) < int(still[2].num_admissible)


def test_packed_interfaces_reject_dynamic_box():
    spec = tsolver.spec_from_jax(dataclasses.replace(
        _corridor_spec(), collision_box=None, dynamic_box=True))
    for build in (lambda: tsolver.make_packed_dwa_solver(spec, CPU),
                  lambda: tsolver.get_debug_dwa_solver(spec, CPU)):
        with pytest.raises(ValueError, match="dynamic_box"):
            build()


# --- custom costs: one cost written in JAX and in torch ---------------------------


def _jax_cost(vel, px, py, ap):
    return jnp.mean(vel[..., 2] ** 2, axis=-1) + 0.5 * jnp.abs(py[..., -1] - px[..., 0])


def _torch_cost(vel, px, py, ap):
    return (vel[..., 2] ** 2).mean(-1) + 0.5 * torch.abs(py[..., -1] - px[..., 0])


@pytest.mark.parametrize("drop", [True, False])
def test_custom_cost_through_the_packed_solver(drop):
    """The cost moves the ranking, and both packages agree on it, on the
    randomized scenarios of ``tests/test_torch_solver.py``."""
    jspec = _jax_spec(False, drop)
    rng = np.random.default_rng(31 + drop)
    custom = (((3.0, _jax_cost),), ((3.0, _torch_cost),))
    moved = []
    for i in range(3):
        buf = _pack(jspec, _scenario_inputs(rng, False, int(rng.integers(4, 13))))
        plain = _both(jspec, buf)[2].costs.numpy()
        weighted = _both(jspec, buf, custom=custom)
        assert_tick_parity(*weighted)
        fin = np.isfinite(plain)
        moved.append(bool((weighted[2].costs.numpy()[fin] != plain[fin]).any()))
    assert any(moved)
    jout = np.asarray(jax.jit(jsolver.make_packed_dwa_solver(jspec, custom[0]))(buf))
    tout = tsolver.make_packed_dwa_solver(
        tsolver.spec_from_jax(jspec), CPU, custom[1])(buf).numpy()
    np.testing.assert_allclose(tout[:4], jout[:4], rtol=1e-4)


def test_make_dwa_solver_matches_jax():
    """``make_dwa_solver`` binds the spec and the custom costs and takes
    ``dwa_solve``'s dynamic arguments as numpy arrays, moved to its
    device; ``return_all_paths`` passes through."""
    jspec = _jax_spec(False, False)
    buf = _pack(jspec, _scenario_inputs(np.random.default_rng(61), False, 8))
    u = jsolver._unpack_inputs(jspec, jnp.asarray(buf))
    jres = jsolver.make_dwa_solver(jspec, ((3.0, _jax_cost),))(*u[:12])
    params = tsolver.SolverParams(*(np.asarray(f) for f in u[0]))
    window = tuple(np.asarray(f) for f in u[2])
    args = (params, np.asarray(u[1]), window, *(np.asarray(a) for a in u[3:12]))
    solve = tsolver.make_dwa_solver(tsolver.spec_from_jax(jspec), CPU,
                                    ((3.0, _torch_cost),))
    tres = solve(*args)
    assert tres.costs.device == CPU and tres.costs.dtype == torch.float32
    assert_tick_parity(jres, _out(jres), tres, _out(tres))
    res, (px, py) = solve(*args, return_all_paths=True)
    assert torch.equal(res.costs, tres.costs) and px.shape == (jspec.num_samples, 12)


def _dwa_pair(robot, samples=4):
    kw = dict(
        max_linear_samples=samples, max_angular_samples=samples,
        octree_resolution=0.1, prediction_horizon=10, control_horizon=2,
        control_time_step=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0, goal_distance_weight=1.0,
            obstacles_distance_weight=1.0, smoothness_weight=0.0,
            jerk_weight=0.0,
        ),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0),
    )
    jdwa = JaxDWA(robot=robot, ctrl_limits=limits, config=JaxDWAConfig(**kw))
    tdwa = DWA(robot=to_port(robot), ctrl_limits=to_port(limits),
               config=DWAConfig(**kw), device="cpu")
    for d in (jdwa, tdwa):
        d.set_path(np.array([[0.0, 0.0], [0.0, 3.0]]))
    return jdwa, tdwa


def _commands(dwa):
    return np.array([dwa.linear_x_control, dwa.linear_y_control,
                     dwa.angular_control], np.float64)


def _lockstep(robot, jdwa, tdwa, scan, ticks):
    robot.state.x, robot.state.y, robot.state.yaw = 0.0, 0.0, np.pi / 2
    for i in range(ticks):
        ok = jdwa.loop_step(current_state=robot.state, laser_scan=scan)
        assert tdwa.loop_step(current_state=to_port(robot.state),
                              laser_scan=to_port(scan)) == ok
        assert tdwa.has_result() == jdwa.has_result()
        np.testing.assert_allclose(_commands(tdwa), _commands(jdwa),
                                   atol=CMD_TOL, err_msg=f"tick {i}")
        robot.set_control(velocity_x=float(jdwa.linear_x_control[0]),
                          velocity_y=0.0, omega=float(jdwa.angular_control[0]))
        robot.get_state(dt=0.1)
    return robot.state.y


def _side_scan():
    angles = np.linspace(np.pi * 0.55, np.pi * 0.8, 15)
    return LaserScanData(ranges=np.full(15, 1.0), angles=angles)


def test_box_robot_dwa_in_lockstep_with_jax():
    robot = Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.BOX,
                  geometry_params=np.array([0.6, 0.3, 0.4]))
    jdwa, tdwa = _dwa_pair(robot)
    assert tdwa._spec_proto["collision_box"] == (0.3, 0.15)
    assert _lockstep(robot, jdwa, tdwa, _side_scan(), 12) > 0.3


def test_custom_cost_dwa_in_lockstep_with_jax():
    """``add_custom_cost`` on both controllers (a heading-rate penalty),
    mid-run: the solver cache is rebuilt and both follow the cost."""
    robot = Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.2, 0.4]))
    jdwa, tdwa = _dwa_pair(robot)
    _lockstep(robot, jdwa, tdwa, _side_scan(), 3)
    jdwa.add_custom_cost(2.0, _jax_cost)
    tdwa.add_custom_cost(2.0, _torch_cost)
    assert not tdwa._solvers
    _lockstep(robot, jdwa, tdwa, _side_scan(), 6)
    (_spec, solver, _buf), = tdwa._solvers.values()
    assert solver is not tsolver.get_packed_dwa_solver(_spec, CPU)


# --- the debug sampler ------------------------------------------------------------


def _debug_pair(drop=None, **kw):
    robot = Robot(robot_type=RobotType.ACKERMANN,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.1, 0.4]))
    jdwa, tdwa = _dwa_pair(robot, samples=6)
    for d in (jdwa, tdwa):
        d.set_current_state(0.0, 0.0, np.pi / 2)
    return [d.debug_velocity_search((0.3, 0.0, 0.0), drop_samples=drop, **kw)
            for d in (jdwa, tdwa)]


def _assert_debug_parity(jout, tout):
    (jx, jy, jc, ja), (tx, ty, tc, ta) = jout, tout
    assert tx.shape == np.asarray(jx).shape and tc.shape == np.asarray(jc).shape
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(np.isinf(tc), np.isinf(np.asarray(jc)))
    fin = np.isfinite(tc)
    np.testing.assert_allclose(tc[fin], np.asarray(jc)[fin], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tx, np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(ty, np.asarray(jy), atol=1e-5)


@pytest.mark.parametrize("drop", [None, False])
def test_debug_velocity_search_matches_jax(drop):
    """Every rollout, cost and admissibility flag, with a wall in the
    local map (after ``tests/test_dwa_closed_loop.py:171, 396``); in
    truncate mode the paths are the truncated ones."""
    wall = np.stack([np.linspace(-0.5, 0.5, 21), np.full(21, 0.45)], axis=1)
    jout, tout = _debug_pair(drop, map_points_world=wall)
    _assert_debug_parity(jout, tout)
    assert 0 < tout[3].sum() < tout[3].size


def test_debug_sampler_agrees_with_the_packed_solve():
    """After ``tests/test_solver_modes.py:458``: on a device-window buffer
    the debug view's minimum is the production solve's winner."""
    jspec = jsolver.SolverSpec(
        is_omni=False, n_vx=3, n_vy=1, n_omega=3, max_points=6,
        num_ctrl_points=2, scan_size=64, seg_size=64, drop_samples=True,
        device_window=True,
    )
    spec = tsolver.spec_from_jax(jspec)
    buf = np.zeros(tsolver.packed_input_size(spec), np.float32)
    buf[3:8] = (4, 32, 1.0, 2.0, spec.max_points)
    buf[8:20] = (0.1, 0.2, 0.05, 2.0, 1.0, 1.0, 0.0, 0.0, 3.0, 0.0, 3.0, 3.0)
    o = tsolver._HDR
    buf[o: o + 12] = (0.3, 0.0, 0.0, 1.0, 5.0, 10.0, 0.0, 0.0, 0.0, 2.0, 3.0, 3.0)
    o += tsolver._window_block_size(spec)
    r, g = spec.scan_size, spec.seg_size
    buf[o: o + 2 * r] = 1e8
    buf[o: o + 4], buf[o + r: o + r + 4] = (5.0, 5.1, 5.2, 5.3), 5.0
    o += 2 * r
    s = 0.05 * np.arange(32, dtype=np.float32)
    buf[o: o + 2 * g] = 1e8
    buf[o: o + 32], buf[o + g: o + g + 32], buf[o + 2 * g: o + 2 * g + 32] = s, 0.0, s
    out = tsolver.get_packed_dwa_solver(spec, CPU)(buf).numpy()
    found, cost, best, *_ = tsolver.unpack_solver_output(spec, out)
    px, py, costs, adm = tsolver.get_debug_dwa_solver(spec, CPU)(buf)
    assert found and int(torch.argmin(costs)) == best
    assert float(costs.min()) == cost and bool(adm.any())
    jdebug = jax.jit(lambda b: jsolver.dwa_sample_debug(jspec, b))(jnp.asarray(buf))
    _assert_debug_parity(jdebug, [t.numpy() for t in (px, py, costs, adm)])


# --- the standalone cost evaluator --------------------------------------------------


def _evaluator_inputs(S, T, n_seg=120, G=128, n_obs=30):
    px, py, vels = _heavy_samples(S, T)
    s = np.linspace(0.0, 3.0, n_seg)
    seg_x = np.full(G, 1e8, np.float32)
    seg_y = np.full(G, 1e8, np.float32)
    seg_arc = np.zeros(G, np.float32)
    seg_x[:n_seg], seg_y[:n_seg], seg_arc[:n_seg] = s, 0.0, s
    obs = np.full((64, 2), 1e8, np.float32)
    obs[:n_obs] = np.random.default_rng(5).uniform(-1, 3, (n_obs, 2))
    return [px.astype(np.float32), py.astype(np.float32),
            vels.astype(np.float32), obs, np.int32(n_obs), seg_x, seg_y,
            seg_arc, np.int32(n_seg), np.float32(s[-1]), np.float32(s[-1]),
            np.int32(T)]


WEIGHTS = {"reference_path_distance_weight": 1.0, "goal_distance_weight": 1.0,
           "obstacles_distance_weight": 0.7, "smoothness_weight": 1.0,
           "jerk_weight": 1.0}


@pytest.mark.parametrize("with_obstacles,active", [(True, 40), (False, 40),
                                                   (True, 25)])
def test_cost_evaluator_matches_jax(with_obstacles, active):
    """After ``tests/test_cost_evaluator_standalone.py:44, 117``: every
    cost of the given trajectories and the winner; with
    ``with_obstacles=False`` the obstacle at the path adds nothing."""
    args = _evaluator_inputs(9, 40)
    args[-1] = np.int32(active)
    if not with_obstacles:
        args[3] = np.zeros((64, 2), np.float32)  # an obstacle AT the path
    jparams = jsolver.SolverParams.create(0.05, 0.3, 0.05, WEIGHTS, (3.0, 3.0, 3.0),
                                          10.0 / 3)
    tparams = tsolver.SolverParams.create(0.05, 0.3, 0.05, WEIGHTS, (3.0, 3.0, 3.0),
                                          10.0 / 3, device=CPU)
    jres = jsolver.get_cost_evaluator(with_obstacles)(
        jparams, *(jnp.asarray(a) for a in args))
    tres = tsolver.get_cost_evaluator(CPU, with_obstacles)(tparams, *args)
    np.testing.assert_allclose(tres.costs.numpy(), np.asarray(jres.costs),
                               rtol=1e-4, atol=1e-6)
    assert int(tres.best_index) == int(jres.best_index)
    assert bool(tres.found) and int(tres.num_admissible) == 9
    np.testing.assert_allclose(tres.path.numpy(), np.asarray(jres.path))
    np.testing.assert_allclose(tres.velocities.numpy(), np.asarray(jres.velocities))
    if not with_obstacles:
        no_obs = dict(WEIGHTS, obstacles_distance_weight=0.0)
        zero = tsolver.get_cost_evaluator(CPU, True)(tsolver.SolverParams.create(
            0.05, 0.3, 0.05, no_obs, (3.0, 3.0, 3.0), 10.0 / 3, device=CPU), *args)
        assert torch.equal(zero.costs, tres.costs)


def test_cost_evaluator_rows_are_independent_and_take_custom_costs():
    """A row's cost does not depend on the other rows (the card check
    compares a sample of rows), and a custom cost adds its weighted
    value."""
    args = _evaluator_inputs(9, 40)
    params = tsolver.SolverParams.create(0.05, 0.3, 0.05, WEIGHTS, (3.0, 3.0, 3.0),
                                         10.0 / 3, device=CPU)
    ev = tsolver.get_cost_evaluator(CPU, False)
    whole = ev(params, *args)
    rows = [1, 4, 8]
    part = ev(params, *(a[rows] for a in args[:3]), *args[3:])
    assert torch.equal(part.costs, whole.costs[rows])
    custom = ev(params, *args, custom_costs=((2.0, _torch_cost),))
    extra = _torch_cost(*(torch.from_numpy(a) for a in (args[2], args[0], args[1])),
                        None)
    assert torch.equal(custom.costs, whole.costs + 2.0 * extra)
