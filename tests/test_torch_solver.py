"""The port's DWA solver (kompass_core_tpu_torch/ops/solver.py) against the
JAX package's, on the CPU.

One packed buffer, written by the JAX package's ``pack_solver_input``,
feeds both packages. Required, per tick:

- the same ``found`` and ``num_admissible`` and the same inf pattern in
  the per-sample costs;
- finite costs within rel 1e-4 (the tolerance the JAX package is held to
  against the reference oracle, ``tests/test_oracle_parity.py``): the
  port's rollout is an f32 cumsum where the JAX one is a triangular
  matmul, so positions differ in the last bits;
- ``best_index`` equal, or a tie: the JAX costs of both winners within
  rel 1e-6;
- the packed output vectors agree (winning command and path at 1e-5).

The same holds in moving-obstacle mode (each obstacle at o + v * t * dt,
TPU kernel K3's function) in drop and truncate mode, and in device-window
mode, whose float32 window must equal the JAX one bit for bit. A batch of
robots through one ``dwa_solve`` gives each robot's own solve exactly.

Per ``SolverSpec.backend`` the port runs the JAX backend's sweep kernel
(K1, K2, K4 and K6 static; K3, K7 and K8 with movers), the JAX side its
Pallas kernels in interpret mode, and the same tolerances hold for every
backend: the expanded forms' rounding (an ulp or two of |p|^2 + |o|^2 at
these coordinates, within about 5 m of the origin) stays below them. The
ring probe puts every point at the collision margin, where only the
exact rounding of each form decides.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kompass_core_tpu.ops import pallas_kernels as jpallas
from kompass_core_tpu.ops import solver as jsolver
from kompass_core_tpu.ops.window import (
    compute_linear_sample_split,
    num_angular_slots,
    sample_velocity_window,
)
from kompass_core_tpu_torch.datatypes import InterpolationType, ReferencePath
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.ops.fleet_solver import (
    FleetSpec,
    fleet_spec_from_jax,
    make_fleet_tick,
)
from kompass_core_tpu_torch.parallel import FleetMesh
from kompass_core_tpu_torch.parallel.fleet import (
    make_fleet_solver,
    make_sample_parallel_solver,
)
from kompass_core_tpu_torch.ops import kernels
from kompass_core_tpu_torch.ops.kernels import fused_min_dist_sq_reference
from kompass_core_tpu_torch.ops.window import VelocityWindow

from test_oracle_parity import _scenario_inputs
from test_torch_kernels import jax_without_fma, xla_cpu_fields

torch.set_num_threads(2)
CPU = torch.device("cpu")
REL_TOL = 1e-4
TIE_REL = 1e-6
GOLDEN_PATH = os.path.join(
    os.path.dirname(__file__), "resources", "cost_parity_golden.json"
)


def _jax_spec(is_omni, drop, n_lin=5, n_ang=4, max_points=12, scan=64, seg=128):
    n_vx, n_vy = compute_linear_sample_split(is_omni, n_lin)
    return jsolver.SolverSpec(
        is_omni=is_omni, n_vx=n_vx, n_vy=n_vy, n_omega=num_angular_slots(n_ang),
        max_points=max_points, num_ctrl_points=2, scan_size=scan, seg_size=seg,
        drop_samples=drop,
    )


def _pack(jspec, sc, obs_vel=None):
    """The JAX package's packing of one randomized oracle-style scenario
    (``obs_vel`` [n_obs, 2] fills a moving spec's velocity block)."""
    limits = sc["limits"].copy()
    if not jspec.is_omni:
        limits[3:6] = 0.0
    window = sample_velocity_window(
        sc["current_vel"], limits, 0.1, jspec.n_vx, jspec.n_vy, jspec.n_omega,
        jspec.is_omni,
    )
    obs = np.full((jspec.scan_size, 2), 1e8, np.float32)
    obs[: len(sc["obs"])] = sc["obs"]
    n_seg = len(sc["seg_x"])
    seg = [np.full(jspec.seg_size, 1e8, np.float32) for _ in range(2)]
    seg_arc = np.zeros(jspec.seg_size, np.float32)
    seg[0][:n_seg], seg[1][:n_seg], seg_arc[:n_seg] = (
        sc["seg_x"], sc["seg_y"], sc["seg_arc"],
    )
    w = sc["weights"]
    params_vec = np.array(
        [0.1, sc["radius"], sc["margin"], w["reference_path_distance_weight"],
         w["goal_distance_weight"], w["obstacles_distance_weight"],
         w["smoothness_weight"], w["jerk_weight"], sc["limits"][1],
         sc["limits"][4], sc["limits"][7], sc["max_obs_dist"]],
        np.float32,
    )
    args = (params_vec, sc["start_pose"], window, obs, len(sc["obs"]),
            seg[0], seg[1], seg_arc, n_seg, sc["seg_total"], sc["ref_total"],
            sc["active_points"])
    kw = {}
    if jspec.device_window:
        args = args[:2] + (None,) + args[3:]
        kw = dict(current_vel=sc["current_vel"], limits_vec=limits)
    if obs_vel is not None:
        vel = np.zeros((jspec.scan_size, 2), np.float32)
        vel[: len(obs_vel)] = obs_vel
        kw["obs_vel_xy"] = vel
    buf = np.zeros(jsolver.packed_input_size(jspec), np.float32)
    jsolver.pack_solver_input(jspec, buf, *args, **kw)
    tspec = tsolver.spec_from_jax(jspec)
    tbuf = np.zeros(tsolver.packed_input_size(tspec), np.float32)
    tsolver.pack_solver_input(tspec, tbuf, *args, **kw)
    assert tbuf.tobytes() == buf.tobytes(), "packed layouts diverged"
    return buf


_JAX_SOLVERS = {}


def _jax_solve(jspec, buf):
    if jspec not in _JAX_SOLVERS:
        def solve(b):
            u = jsolver._unpack_inputs(jspec, b)
            res = jsolver.dwa_solve(jspec, *u[:12], obs_vel=u[12])
            return res, jsolver._unpack_and_solve(jspec, b)

        _JAX_SOLVERS[jspec] = jax.jit(solve)
    res, out = _JAX_SOLVERS[jspec](jnp.asarray(buf))
    return res, np.asarray(out)


def _port_solve(jspec, buf):
    tspec = tsolver.spec_from_jax(jspec)
    b = torch.from_numpy(buf.copy())
    res = tsolver.dwa_solve(tspec, *tsolver._unpack_inputs(tspec, b))
    out = tsolver.make_packed_dwa_solver(tspec, CPU)(buf.copy())
    return res, out.numpy()


def assert_tick_parity(jres, jout, tres, tout):
    jc = np.asarray(jres.costs)
    tc = tres.costs.numpy()
    assert bool(tres.found) == bool(jres.found)
    assert int(tres.num_admissible) == int(jres.num_admissible)
    np.testing.assert_array_equal(np.isinf(tc), np.isinf(jc))
    fin = np.isfinite(jc)
    np.testing.assert_allclose(tc[fin], jc[fin], rtol=REL_TOL, atol=1e-6)
    jb, tb = int(jres.best_index), int(tres.best_index)
    if jb != tb:
        assert abs(jc[tb] - jc[jb]) <= TIE_REL * abs(jc[jb]), (
            f"winner {tb} vs JAX {jb} is not a tie: {jc[tb]} vs {jc[jb]}"
        )
        return
    np.testing.assert_allclose(tout[:4], jout[:4], rtol=REL_TOL)
    np.testing.assert_allclose(tout[4:], jout[4:], rtol=1e-5, atol=1e-5)


CONFIGS = [
    ("diff_drive_drop", 11, False, True),
    ("diff_drive_truncate", 22, False, False),
    ("omni_drop", 33, True, True),
    ("omni_truncate", 44, True, False),
]


@pytest.mark.parametrize("name,seed,is_omni,drop", CONFIGS)
def test_randomized_packed_tick_parity(name, seed, is_omni, drop):
    jspec = _jax_spec(is_omni, drop)
    rng = np.random.default_rng(seed)
    for i in range(12):
        active = int(rng.integers(4, jspec.max_points + 1))
        buf = _pack(jspec, _scenario_inputs(rng, is_omni, active))
        try:
            assert_tick_parity(*_jax_solve(jspec, buf), *_port_solve(jspec, buf))
        except AssertionError as e:
            raise AssertionError(f"[{name} scenario {i}] {e}") from e


def test_truncate_mode_truncates_and_matches():
    """A straight-ahead family with an obstacle at 1 m: truncated samples
    exist, and their frozen-point distance patch matches JAX."""
    jspec = _jax_spec(False, False, n_lin=3, n_ang=3, max_points=20, scan=32,
                      seg=64)
    rng = np.random.default_rng(0)
    sc = _scenario_inputs(rng, False, 20)
    sc.update(
        obs=np.array([[1.0, 0.0]]), start_pose=(0.0, 0.0, 0.0),
        current_vel=(0.9, 0.0, 0.0), radius=0.2, margin=0.05,
        seg_x=np.linspace(0, 3.9, 40), seg_y=np.zeros(40),
        seg_arc=np.linspace(0, 3.9, 40), seg_total=3.9, ref_total=3.9,
    )
    sc["limits"][:3] = (1.0, 5.0, 10.0)
    buf = _pack(jspec, sc)
    jres, jout = _jax_solve(jspec, buf)
    tres, tout = _port_solve(jspec, buf)
    assert_tick_parity(jres, jout, tres, tout)
    drop_res, _ = _port_solve(dataclasses.replace(jspec, drop_samples=True), buf)
    assert int(tres.num_admissible) > int(drop_res.num_admissible)


def test_enclosed_robot_finds_nothing():
    """Every sample collides: found=False, no admissible sample, all
    costs inf, in both packages."""
    jspec = _jax_spec(False, True)
    rng = np.random.default_rng(5)
    sc = _scenario_inputs(rng, False, 12)
    ang = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    x, y, _ = sc["start_pose"]
    sc["obs"] = np.stack([x + 0.12 * np.cos(ang), y + 0.12 * np.sin(ang)], 1)
    sc["current_vel"] = (0.5, 0.0, 0.0)
    buf = _pack(jspec, sc)
    jres, jout = _jax_solve(jspec, buf)
    tres, tout = _port_solve(jspec, buf)
    assert not bool(tres.found) and int(tres.num_admissible) == 0
    assert np.isinf(tres.costs.numpy()).all()
    assert_tick_parity(jres, jout, tres, tout)


def test_cost_parity_golden_dump():
    """The scenario of tests/test_cost_parity.py through the port: its
    per-sample costs match the committed golden dump at rel 1e-4."""
    limits = np.array([1.0, 5.0, 10.0, 0.0, 0.0, 0.0, 2.0, 3.0, 3.0])
    win = sample_velocity_window((0.5, 0.0, 0.1), limits, 0.1, 5, 1, 5, False)
    rng = np.random.default_rng(42)
    obs = np.full((64, 2), 1e8, np.float32)
    ang = rng.uniform(0, 2 * np.pi, 40)
    r = rng.uniform(0.8, 5.0, 40)
    obs[:40, 0] = r * np.cos(ang)
    obs[:40, 1] = r * np.sin(ang)
    s = np.linspace(0, 4.0, 100).astype(np.float32)
    seg_x = np.full(128, 1e8, np.float32)
    seg_y = np.full(128, 1e8, np.float32)
    seg_arc = np.zeros(128, np.float32)
    seg_x[:100], seg_y[:100], seg_arc[:100] = s, 0.1 * np.sin(s), s
    spec = tsolver.SolverSpec(
        is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=15,
        num_ctrl_points=2, scan_size=64, seg_size=128,
    )
    params = tsolver.SolverParams.create(
        0.1, 0.2, 0.05,
        {"reference_path_distance_weight": 2.0, "goal_distance_weight": 1.0,
         "obstacles_distance_weight": 1.0, "smoothness_weight": 0.1,
         "jerk_weight": 0.05},
        (5.0, 0.0, 3.0), 10 / 3, device=CPU,
    )
    t = torch.as_tensor
    res = tsolver.dwa_solve(
        spec, params, t([0.0, 0.05, 0.05], dtype=torch.float32),
        VelocityWindow(*(t(a) for a in win)), t(obs), t(40, dtype=torch.int32),
        t(seg_x), t(seg_y), t(seg_arc), t(100, dtype=torch.int32),
        t(s[-1]), t(s[-1]), t(15, dtype=torch.int32),
    )
    golden = json.load(open(GOLDEN_PATH))["tests"]["dwa_mixed_costs"]
    costs = res.costs.numpy()
    costs = costs[np.isfinite(costs)]
    np.testing.assert_allclose(costs, golden["costs"], rtol=REL_TOL, atol=1e-6)
    assert int(res.best_index) == golden["best_index"]


# --- the golden values of tests/test_costs.py --------------------------------


def _straight_segment():
    p = ReferencePath([(0.0, 0.0), (10.0, 0.0)])
    p.interpolate(1.0, InterpolationType.LINEAR)
    p.segment(5.0, 10000)
    sl = p.segment_slice(0)
    n = sl.stop - sl.start
    seg_x = np.full(64, 1e8, np.float32)
    seg_y = np.full(64, 1e8, np.float32)
    seg_arc = np.zeros(64, np.float32)
    seg_x[:n], seg_y[:n], seg_arc[:n] = p.xs[sl], p.ys[sl], p.arc_lengths[sl]
    seg_len = float(np.hypot(np.diff(p.xs[sl]), np.diff(p.ys[sl])).sum())
    return (torch.as_tensor(seg_x), torch.as_tensor(seg_y),
            torch.as_tensor(seg_arc), n, seg_len, p.total_path_length())


def _traj(points):
    pts = torch.as_tensor(np.asarray(points, np.float32))
    return pts[None, :, 0].contiguous(), pts[None, :, 1].contiguous()


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


@pytest.mark.parametrize("offset,expected", [(0.0, 0.6), (0.1, 0.61), (0.5, 0.65)])
def test_goal_cost_golden(offset, expected):
    seg_x, seg_y, seg_arc, _n, _len, total = _straight_segment()
    px, py = _traj([(4.0, offset)] * 5)
    cost = tsolver._goal_cost(px, py, seg_x, seg_y, seg_arc, _f32(total), _i32(5))
    assert float(cost[0]) == pytest.approx(expected, abs=1e-4)


@pytest.mark.parametrize("d", [0.0, 0.5])
def test_path_cost_golden(d):
    seg_x, seg_y, _arc, n, seg_len, _total = _straight_segment()
    px, py = _traj([(float(i), d) for i in range(5)])
    d2_seg, _ = fused_min_dist_sq_reference(
        px, py, torch.stack([seg_x, seg_y], 1), seg_x, seg_y, _i32(5)
    )
    cost = tsolver._path_cost(
        px, py, d2_seg, (seg_x[n - 1], seg_y[n - 1]), _f32(seg_len), _i32(5)
    )
    assert float(cost[0]) == pytest.approx((d + d / seg_len) / 2.0, abs=1e-4)


ACC = (_f32(1.0), _f32(1.0), _f32(1.0))


def _vel(vx_seq):
    v = torch.zeros(1, len(vx_seq), 3)
    v[0, :, 0] = torch.tensor(vx_seq, dtype=torch.float32)
    return v


@pytest.mark.parametrize(
    "fn,seq,expected",
    [
        (tsolver._smoothness_cost, [1, 1, 1, 1], 0.0),
        (tsolver._smoothness_cost, [0, 1, 1, 1], 1.0 / 12.0),
        (tsolver._jerk_cost, [0.1, 0.2, 0.3, 0.4], 0.0),
        (tsolver._jerk_cost, [0, 1, 3, 6], 2.0 / 12.0),
    ],
)
def test_velocity_cost_goldens(fn, seq, expected):
    assert float(fn(_vel(seq), _i32(5), ACC)[0]) == pytest.approx(expected, abs=1e-4)


@pytest.mark.parametrize(
    "obstacle,active,expected",
    [((20.0, 0.0), 5, 0.0), ((0.0, 0.0), 5, 1.0), ((5.0, 0.0), 5, 0.5),
     ((100.0, 100.0), 3, 0.0)],
)
def test_obstacles_cost_golden(obstacle, active, expected):
    """Cost 0 / 1 / 0.5 at max distance 10; masked points (the last two,
    placed on the obstacle) do not contribute."""
    px, py = _traj([(0.0, 0.0)] * active + [(100.0, 100.0)] * (5 - active))
    obs = torch.full((32, 2), 1e8)
    obs[0] = torch.tensor(obstacle)
    seg = torch.zeros(1)
    d2_obs, _ = fused_min_dist_sq_reference(px, py, obs, seg, seg, _i32(active))
    cost = tsolver._obstacles_cost(d2_obs, _f32(10.0))
    assert float(cost[0]) == pytest.approx(expected, abs=1e-4)


# --- state carried across: spec conversion and unported paths ----------------


def test_spec_from_jax_copies_every_field():
    jspec = jsolver.SolverSpec(
        is_omni=True, n_vx=7, n_vy=3, n_omega=9, max_points=20,
        num_ctrl_points=4, scan_size=512, seg_size=384, drop_samples=False,
        backend="pallas_vpu",
    )
    tspec = tsolver.spec_from_jax(jspec)
    for f in dataclasses.fields(tspec):
        assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    assert tspec.num_samples == jspec.num_samples
    assert tsolver.packed_input_size(tspec) == jsolver.packed_input_size(jspec)


@pytest.mark.parametrize("backend", tsolver.BACKENDS)
def test_spec_from_jax_accepts_same_function_backends(backend):
    """Every JAX backend is accepted and kept: each runs its own sweep
    kernel's port (``_sweeps``)."""
    jspec = dataclasses.replace(_jax_spec(False, True), backend=backend)
    tspec = tsolver.spec_from_jax(jspec)
    assert tspec.backend == backend
    assert tspec == dataclasses.replace(
        tsolver.spec_from_jax(_jax_spec(False, True)), backend=backend)


def test_spec_from_jax_rejects_other_backends():
    jspec = dataclasses.replace(_jax_spec(False, True), backend="mosaic")
    with pytest.raises(ValueError, match="mosaic"):
        tsolver.spec_from_jax(jspec)


def _split_mover_tick(spec):
    """The split mover sweep (item 5e) is ported: its tick builds from the
    port's image of the JAX package's split fleet spec (the tick's
    numbers against JAX: ``test_torch_fleet_moving.py``)."""
    from kompass_core_tpu.ops.fleet_solver import FleetSpec as JaxFleetSpec

    jfleet = JaxFleetSpec(
        dataclasses.replace(_jax_spec(False, True), device_window=True),
        path_capacity=64, max_segments=4, tracked_obstacles=1,
        split_mover_sweep=True,
    )
    fleet = FleetSpec(dataclasses.replace(spec, device_window=True),
                      path_capacity=64, max_segments=4, tracked_obstacles=1,
                      split_mover_sweep=True)
    assert fleet_spec_from_jax(jfleet) == fleet
    assert callable(make_fleet_tick(fleet, CPU))


def _mesh_rows(build):
    """A mesh solver's rows of the same buffers against the one-device
    solver's: (its output on the host, the one-device output)."""
    spec = tsolver.spec_from_jax(_jax_spec(False, True))
    bufs = np.stack([_pack(_jax_spec(False, True), _scenario_inputs(
        np.random.default_rng(60 + i), False, 6)) for i in range(2)])
    mesh = FleetMesh([CPU, CPU])
    out = mesh.host_rows(build(spec, mesh)(bufs))
    return out, make_fleet_solver(spec, CPU)(bufs).numpy(), mesh


@pytest.mark.parametrize(
    "build,item",
    [(lambda s, mesh: make_fleet_solver(s, mesh=mesh), "1"),
     (lambda s, mesh: make_sample_parallel_solver(s, mesh), "1"),
     (_split_mover_tick, "5e")],
)
def test_unported_modes_raise_naming_their_roadmap_item(build, item):
    """Every mode is ported: the mesh solvers (item 1, scale-out) give the
    one-device rows (the sharded solver each row, the sample-parallel
    solver the lower-cost row on every shard); the split mover tick (5e)
    builds."""
    if item == "5e":
        build(tsolver.spec_from_jax(_jax_spec(False, True)))
        return
    out, one, mesh = _mesh_rows(build)
    if mesh.collectives["all_reduce"]:
        win = int(np.argmin(one[:, 1]))
        np.testing.assert_array_equal(out, np.stack([one[win], one[win]]) + 0.0)
    else:
        np.testing.assert_array_equal(out, one)


def test_packed_solver_rejects_a_wrong_size_buffer():
    spec = tsolver.spec_from_jax(_jax_spec(False, True))
    solve = tsolver.make_packed_dwa_solver(spec, CPU)
    with pytest.raises(ValueError, match="packed input"):
        solve(np.zeros(tsolver.packed_input_size(spec) + 1, np.float32))


# --- moving obstacles (K3's function), device window, robot axis ------------


def _moving_scenario(rng, is_omni, active):
    """An oracle-style scenario whose obstacles move at up to 1.2 m/s."""
    sc = _scenario_inputs(rng, is_omni, active)
    vel = rng.uniform(-1.2, 1.2, (len(sc["obs"]), 2)).astype(np.float32)
    return sc, vel


@pytest.mark.parametrize(
    "name,seed,is_omni,drop",
    [("diff_drive_drop", 55, False, True),
     ("diff_drive_truncate", 66, False, False),
     ("omni_truncate", 77, True, False)],
)
def test_moving_packed_tick_parity(name, seed, is_omni, drop):
    jspec = dataclasses.replace(_jax_spec(is_omni, drop), moving_obstacles=True)
    rng = np.random.default_rng(seed)
    for i in range(8):
        active = int(rng.integers(4, jspec.max_points + 1))
        buf = _pack(jspec, *_moving_scenario(rng, is_omni, active))
        try:
            assert_tick_parity(*_jax_solve(jspec, buf), *_port_solve(jspec, buf))
        except AssertionError as e:
            raise AssertionError(f"[{name} scenario {i}] {e}") from e


def test_moving_truncate_mode_sweeps_again_from_the_frozen_points():
    """An obstacle crossing ahead: truncated samples exist, their costs
    come from a second moving sweep over the frozen points (the frozen
    pose keeps meeting the moving track), and they match JAX."""
    jspec = dataclasses.replace(
        _jax_spec(False, False, n_lin=3, n_ang=3, max_points=20, scan=32, seg=64),
        moving_obstacles=True,
    )
    rng = np.random.default_rng(1)
    sc = _scenario_inputs(rng, False, 20)
    sc.update(
        obs=np.array([[1.0, 0.6]]), start_pose=(0.0, 0.0, 0.0),
        current_vel=(0.9, 0.0, 0.0), radius=0.2, margin=0.05,
        seg_x=np.linspace(0, 3.9, 40), seg_y=np.zeros(40),
        seg_arc=np.linspace(0, 3.9, 40), seg_total=3.9, ref_total=3.9,
    )
    sc["limits"][:3] = (1.0, 5.0, 10.0)
    buf = _pack(jspec, sc, np.array([[0.0, -0.5]], np.float32))
    jres, jout = _jax_solve(jspec, buf)
    tres, tout = _port_solve(jspec, buf)
    assert_tick_parity(jres, jout, tres, tout)
    drop_res, _ = _port_solve(dataclasses.replace(jspec, drop_samples=True), buf)
    assert int(tres.num_admissible) > int(drop_res.num_admissible)


def test_moving_spec_with_zero_velocity_equals_the_static_spec():
    """The velocity block at zero gives the static solve's output vector
    bit for bit."""
    jspec = _jax_spec(False, False)
    mspec = dataclasses.replace(jspec, moving_obstacles=True)
    rng = np.random.default_rng(3)
    sc = _scenario_inputs(rng, False, 10)
    _, static_out = _port_solve(jspec, _pack(jspec, sc))
    _, moving_out = _port_solve(mspec, _pack(mspec, sc, np.zeros((len(sc["obs"]), 2))))
    np.testing.assert_array_equal(static_out, moving_out)


def test_velocities_need_the_moving_spec():
    tspec = tsolver.spec_from_jax(_jax_spec(False, True))
    buf = np.zeros(tsolver.packed_input_size(tspec), np.float32)
    rng = np.random.default_rng(4)
    sc = _scenario_inputs(rng, False, 10)
    window = sample_velocity_window((0.2, 0.0, 0.0), sc["limits"], 0.1,
                                    tspec.n_vx, tspec.n_vy, tspec.n_omega, False)
    obs = np.full((tspec.scan_size, 2), 1e8, np.float32)
    seg = np.zeros(tspec.seg_size, np.float32)
    with pytest.raises(ValueError, match="moving_obstacles=False"):
        tsolver.pack_solver_input(
            tspec, buf, np.zeros(12, np.float32), (0.0, 0.0, 0.0), window, obs,
            0, seg, seg, seg, 1, 0.0, 1.0, 10, obs_vel_xy=np.zeros_like(obs),
        )


@pytest.mark.parametrize("is_omni", [False, True])
def test_device_window_equals_jax_bit_for_bit(is_omni):
    from kompass_core_tpu.ops.solver import _device_window as jax_device_window

    jspec = dataclasses.replace(_jax_spec(is_omni, True, n_lin=7, n_ang=9),
                                device_window=True)
    tspec = tsolver.spec_from_jax(jspec)
    rng = np.random.default_rng(9)
    for _ in range(20):
        vel = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
        limits = rng.uniform(0.0, 4.0, 9).astype(np.float32)
        if rng.integers(0, 2):
            limits[3:6] = 0.0  # a non-omni row of a mixed fleet
        dt = np.float32(rng.choice([0.1, 0.05, 0.2]))
        jw = jax_device_window(jspec, jnp.asarray(vel), jnp.asarray(limits),
                               jnp.float32(dt))
        tw = tsolver._device_window(tspec, torch.from_numpy(vel),
                                    torch.from_numpy(limits), torch.tensor(dt))
        for j, t in zip(jw, tw):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("is_omni,moving", [(False, False), (True, True)])
def test_device_window_packed_tick_parity(is_omni, moving):
    jspec = dataclasses.replace(_jax_spec(is_omni, True), device_window=True,
                                moving_obstacles=moving)
    rng = np.random.default_rng(88)
    for i in range(6):
        sc, vel = _moving_scenario(rng, is_omni, int(rng.integers(4, 13)))
        buf = _pack(jspec, sc, vel if moving else None)
        try:
            assert_tick_parity(*_jax_solve(jspec, buf), *_port_solve(jspec, buf))
        except AssertionError as e:
            raise AssertionError(f"[scenario {i}] {e}") from e


@pytest.mark.parametrize("drop,moving", [(True, True), (False, False), (False, True)])
def test_batched_solve_equals_per_robot_solves(drop, moving):
    """Three packed buffers solved as one [3, ...] batch give each
    robot's own solve bit for bit: the robot axis changes no value."""
    jspec = dataclasses.replace(_jax_spec(False, drop), moving_obstacles=moving)
    tspec = tsolver.spec_from_jax(jspec)
    rng = np.random.default_rng(99)
    bufs = []
    for _ in range(3):
        sc, vel = _moving_scenario(rng, False, int(rng.integers(4, 13)))
        bufs.append(_pack(jspec, sc, vel if moving else None))
    batch = tsolver.dwa_solve(
        tspec, *tsolver._unpack_inputs(tspec, torch.from_numpy(np.stack(bufs)))
    )
    for b, buf in enumerate(bufs):
        one = tsolver.dwa_solve(
            tspec, *tsolver._unpack_inputs(tspec, torch.from_numpy(buf[None]))
        )
        for field, got, want in zip(one._fields, batch, one):
            assert torch.equal(got[b], want[0]), field


# --- SolverSpec.backend: each JAX backend against its kernel's port ----------

@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX package's Pallas sweeps in interpret mode, as
    ``tests/test_pallas_kernels.py`` runs them on the CPU."""
    fused, single = jpallas.fused_min_dist_sq, jpallas.min_obstacle_dist_sq_mxu
    monkeypatch.setattr(jpallas, "fused_min_dist_sq",
                        lambda *a, **k: fused(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jpallas, "min_obstacle_dist_sq_mxu",
                        lambda *a, **k: single(*a, **{**k, "interpret": True}))


def _jax_solver(jspec):
    """_jax_solve's function, traced anew (under the interpret patch)."""
    def solve(b):
        u = jsolver._unpack_inputs(jspec, b)
        return (jsolver.dwa_solve(jspec, *u[:12], obs_vel=u[12]),
                jsolver._unpack_and_solve(jspec, b))

    jitted = jax.jit(solve)

    def run(buf):
        res, out = jitted(jnp.asarray(buf))
        return res, np.asarray(out)

    return run


@pytest.mark.parametrize(
    "backend,drop,moving",
    [(b, d, False) for b in tsolver.BACKENDS for d in (True, False)]
    + [(b, False, True) for b in ("pallas_vpu", "pallas", "pallas_v1")],
)
def test_backend_packed_tick_parity(jax_pallas_interpret, backend, drop, moving):
    """The port's solve with each backend against the JAX solve with the
    same backend, its Pallas kernels in interpret mode; with movers the
    Pallas backends run the 7-feature forms on both sides (K7 for
    "pallas" and "pallas_v1", K8 for "pallas_vpu"). The solver's
    tolerance holds for every backend."""
    jspec = dataclasses.replace(_jax_spec(False, drop), backend=backend,
                                moving_obstacles=moving)
    solve = _jax_solver(jspec)
    rng = np.random.default_rng(200 + 10 * tsolver.BACKENDS.index(backend)
                                + 2 * drop + moving)
    for i in range(4):
        sc, vel = _moving_scenario(rng, False, int(rng.integers(4, 13)))
        buf = _pack(jspec, sc, vel if moving else None)
        try:
            assert_tick_parity(*solve(buf), *_port_solve(jspec, buf))
        except AssertionError as e:
            raise AssertionError(f"[{backend} scenario {i}] {e}") from e


@pytest.mark.parametrize(
    "backend,drop,moving,expected",
    [("xla", True, False, {"K1": 1}),
     ("pallas_vpu", False, False, {"K6": 1}),
     ("pallas", False, False, {"K2": 1}),
     ("pallas_v1", True, False, {"K4": 2}),
     ("pallas", True, True, {"K7": 1}),
     ("pallas_v1", False, True, {"K7": 2}),
     ("pallas_vpu", False, True, {"K8": 2}),
     ("xla", False, True, {"K3": 2})],
)
def test_backend_runs_its_kernel(monkeypatch, backend, drop, moving, expected):
    """One solve calls exactly the kernels its backend names: K4 once
    for the obstacles and once for the segment; with movers K7 or K8 (or
    K3 for "xla"), again for the truncate-mode re-sweep from the frozen
    points, as the JAX package re-sweeps both fields there."""
    calls = {}
    for key, fn in kernels.SWEEP_KERNELS.items():
        def counted(*args, _fn=fn, _key=key):
            calls[_key] = calls.get(_key, 0) + 1
            return _fn(*args)

        monkeypatch.setattr(tsolver, fn.__name__, counted)
    jspec = dataclasses.replace(_jax_spec(False, drop), backend=backend,
                                moving_obstacles=moving)
    sc, vel = _moving_scenario(np.random.default_rng(7), False, 10)
    _port_solve_packed_only(jspec, _pack(jspec, sc, vel if moving else None))
    assert calls == expected


# --- the ring probe: every point at the collision margin ----------------------

RING_CENTRE = (10.0, 10.0)
RING_RADIUS = np.float32(0.3)
RING_VEL = (0.4, -0.3)
RING_DT = np.float32(0.1)


def _ring(moving, S=128, T=32):
    """4096 points on a 0.3 m circle around one obstacle at (10, 10), the
    circle centred at step t on the obstacle's position o + v * tau there
    when ``moving``; 255 pad rows at 1e8; a segment of 128 rows."""
    o = np.array(RING_CENTRE, np.float32)
    v = np.array(RING_VEL if moving else (0.0, 0.0), np.float32)
    tau = np.arange(T, dtype=np.float32) * RING_DT
    centre = o[:, None] + v[:, None] * tau[None, :]  # [2, T], f32
    th = 2 * np.pi * np.arange(S * T).reshape(S, T) / (S * T)
    px = (centre[0] + RING_RADIUS * np.cos(th).astype(np.float32)).astype(np.float32)
    py = (centre[1] + RING_RADIUS * np.sin(th).astype(np.float32)).astype(np.float32)
    obs = np.full((256, 2), 1e8, np.float32)
    obs[0] = o
    vel = np.zeros((256, 2), np.float32)
    vel[0] = v
    s = np.linspace(0.0, 3.0, 128).astype(np.float32)
    return px, py, obs, vel, 9.0 + s, 10.5 + 0.0 * s


def _jax_ring(backend, moving, px, py, obs, vel, sx, sy):
    """The JAX package's obstacle sweep for ``backend`` (dwa_solve's
    dispatch, ``kompass_core_tpu/ops/solver.py:687-727``), under jax.jit."""
    T = px.shape[1]

    def run(px, py, obs, vel, sx, sy):
        mask = jnp.ones(T, bool)
        if moving and backend == "xla":
            return jsolver._min_obstacle_dist_sq_moving(px, py, obs, vel, RING_DT, mask)
        if moving:
            variant = "vpu" if backend == "pallas_vpu" else "mxu"
            return jpallas.fused_min_dist_sq(px, py, obs, sx, sy, mask,
                                             variant=variant, obs_vel=vel,
                                             time_step=RING_DT, interpret=True)[0]
        if backend == "xla":
            return jsolver._min_obstacle_dist_sq(px, py, obs, mask)
        if backend == "pallas_v1":
            return jpallas.min_obstacle_dist_sq_mxu(px, py, obs, mask, interpret=True)
        variant = "mxu" if backend == "pallas" else "vpu"
        return jpallas.fused_min_dist_sq(px, py, obs, sx, sy, mask,
                                         variant=variant, interpret=True)[0]

    return np.asarray(jax.jit(run)(px, py, obs, vel, sx, sy))


# each kernel's form, for its XLA-contracted twin (xla_cpu_fields)
_TWIN_FORMS = {"K1": "direct", "K3": "direct", "K2": "expanded",
               "K4": "single", "K7": "expanded", "K6": "broadcast",
               "K8": "broadcast"}


def _port_ring(backend, moving, ring, twins=False, monkeypatch=None):
    """The port's obstacle field for ``backend`` through ``_sweeps``; with
    ``twins`` each kernel's CPU path is its form as XLA's CPU backend
    contracts it (``xla_cpu_fields``)."""
    px, py, obs, vel, sx, sy = (torch.from_numpy(a.copy()) for a in ring)
    T = px.shape[1]
    if twins:
        for key, fn in kernels.SWEEP_KERNELS.items():
            def twin(px, py, rows, *rest, _key=key):
                v = (rest[0], float(rest[1])) if _key in ("K3", "K7", "K8") else (None, None)
                seg = rest[-3:-1] if _key != "K4" else (rows[:, 0], rows[:, 1])
                fields = xla_cpu_fields(_TWIN_FORMS[_key], px, py, rows, *seg,
                                        int(rest[-1]), *v)
                return fields[0] if _key == "K4" else fields

            monkeypatch.setattr(tsolver, fn.__name__, twin)
    spec = dataclasses.replace(tsolver.spec_from_jax(_jax_spec(False, True)),
                               backend=backend, moving_obstacles=moving)
    sweep = tsolver._sweeps(spec, obs, vel if moving else None,
                            torch.tensor(RING_DT), sx, sy,
                            torch.tensor(T, dtype=torch.int32))
    return sweep(px, py)[0].numpy()


@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("backend", tsolver.BACKENDS)
def test_ring_probe_collision_decisions_equal_jax(monkeypatch, backend, moving):
    """The ring probe: 4096 points on the collision margin (d^2 < 0.3^2
    decides on the last bits of each form). With each kernel's form as
    XLA's CPU backend contracts it, the port's dispatch gives JAX's
    decisions exactly, for every backend. The production forms, rounded
    as the card and the TPU round them, stay within the expanded forms'
    tolerance of JAX's d^2 (their decisions against JAX compiled without
    FMA: ``test_ring_probe_production_decisions_equal_jax_without_fma``)."""
    ring = _ring(moving)
    r2 = RING_RADIUS * RING_RADIUS
    want = _jax_ring(backend, moving, *ring) < r2
    got = _port_ring(backend, moving, ring, twins=True, monkeypatch=monkeypatch) < r2
    assert int((got != want).sum()) == 0
    monkeypatch.undo()
    production = _port_ring(backend, moving, ring)
    np.testing.assert_allclose(production, _jax_ring(backend, moving, *ring),
                               rtol=2e-4, atol=1e-4)


def jax_fields_without_fma():
    """The ring probe's JAX obstacle field per (backend, moving), for
    ``test_torch_kernels.jax_without_fma``."""
    return {f"{backend}/{moving}": _jax_ring(backend, moving, *_ring(moving))
            for backend in tsolver.BACKENDS for moving in (False, True)}


@pytest.fixture(scope="module")
def ring_without_fma(tmp_path_factory):
    return jax_without_fma("test_torch_solver",
                           tmp_path_factory.mktemp("no_fma") / "ring.npz")


@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("backend", tsolver.BACKENDS)
def test_ring_probe_production_decisions_equal_jax_without_fma(
        ring_without_fma, backend, moving):
    """The ring probe with the production forms (the card kernels' plain
    versions) against JAX compiled without FMA, every operation of its
    sweep rounded on its own as on the TPU's vector unit: the same d^2
    bit for bit, so no collision decision differs, for every backend
    (K7's dot included: XLA's CPU dot runs K7's chosen FMA chain). The
    probe tells the forms apart: the XLA form in a Pallas backend's place
    (fault 1) would flip a quarter of the decisions or more."""
    ring = _ring(moving)
    r2 = RING_RADIUS * RING_RADIUS
    want = ring_without_fma[f"{backend}/{moving}"]
    production = _port_ring(backend, moving, ring)
    assert int(((production < r2) != (want < r2)).sum()) == 0
    np.testing.assert_array_equal(production, want)
    if backend != "xla":
        direct = _port_ring("xla", moving, ring)
        assert int(((direct < r2) != (want < r2)).sum()) >= 1024


def _port_solve_packed_only(jspec, buf):
    tspec = tsolver.spec_from_jax(jspec)
    return tsolver.make_packed_dwa_solver(tspec, CPU)(buf.copy())
