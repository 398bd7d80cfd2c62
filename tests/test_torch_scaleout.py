"""The port's scale-out (``parallel/multihost.py``, the mesh forms of
``parallel/fleet.py``, ``ops/fleet_solver.py`` and ``parallel/fleet_v2.py``)
against the JAX package's on the CPU.

The JAX side runs on the virtual 8-device CPU mesh of ``conftest.py``;
the port on ``FleetMesh(["cpu"] * S)`` with the same S (2 to 8 shards),
on the same numpy inputs. Tolerances:

- against JAX: the fleet rows of ``test_torch_safety.assert_rows_close``
  (``found``, ``reached``, ``active_points`` and ``num_admissible`` equal,
  the cost within rel 1e-4, the command within 1e-4 or a tie, the final
  states within rel 1e-5) and, for packed solver rows,
  ``test_torch_fleet_solver.assert_rows_agree`` (the same found flag and
  count, the cost within rel 1e-4, the same winner or a tie), the tie
  rules of ROADMAP section 3 items 1 and 2;
- against the port on one device: bit for bit (``np.array_equal``).

The JAX package's Pallas sweeps do not run under its ``shard_map`` on the
CPU (``pallas_call`` refuses an output without a ``vma``), so the
``pallas`` and ``pallas_v1`` solver rows are held against JAX's one-device
solver in interpret mode; the fleets run the ``xla`` backend.

The collective counts are the port's counterpart of
``tests/test_scaling_hlo.py``: no collective for the fleet solver and the
row-local ticks, exactly one all-gather per peer tick and k per peer
k-tick call, and only all-reduces for the sample-parallel solve.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.ops.solver import pack_solver_input as jpack
from kompass_core_tpu.ops.window import VelocityWindow
from kompass_core_tpu.parallel import fleet as jfleet
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet as JaxDeviceFleet
from kompass_core_tpu.parallel.fleet_v2 import FleetSafetyConfig as JaxSafety
from kompass_core_tpu_torch import serving
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.ops.fleet_solver import make_fleet_tick
from kompass_core_tpu_torch.parallel import (
    DeviceFleet,
    FleetMesh,
    FleetPlanner,
    FleetRuntime,
    FleetSafetyConfig,
    build_fleet_mesh,
    initialize_multihost,
    make_fleet_solver,
    make_sample_parallel_solver,
)

from test_fleet import SPEC as SP_SPEC
from test_fleet import _scenario_kwargs
from test_torch_fleet_solver import _fleet_inputs, assert_rows_agree
from test_torch_host_modules import to_port
from test_torch_safety import assert_rows_close
from test_torch_solver import _jax_spec

torch.set_num_threads(2)

CPU = torch.device("cpu")
N_RAYS = 32
ANGLES = np.linspace(-np.pi, np.pi, N_RAYS, endpoint=False)
DT = 0.1
M = 2  # tracked slots
NO_COLLECTIVE = {"all_gather": 0, "all_reduce": 0}


def jax_mesh(shards, axis="robots"):
    return Mesh(np.array(jax.devices()[:shards]), (axis,))


def port_mesh(shards, axis="robots"):
    return FleetMesh([CPU] * shards, axis_name=axis)


# --- the fleet scene ---------------------------------------------------------


def _robots(n):
    return [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.3, 0.4])) for _ in range(n)]


def _limits():
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0,
                                       max_steer=np.pi),
    )


def _config():
    return DWAConfig(
        max_linear_samples=5, max_angular_samples=5,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            smoothness_weight=0.0, jerk_weight=0.0, obstacles_distance_weight=0.5,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=DT,
    )


class Scene:
    """Head-on pairs on lanes 3 m apart: robot 2j drives +x from (0, 3j),
    robot 2j + 1 drives -x from (4, 3j + 0.03); with tracked slots one
    mover walks across each robot's lane ahead of it. The states advance
    with the JAX commands."""

    def __init__(self, n):
        lane = 3.0 * (np.arange(n) // 2)
        back = np.arange(n) % 2 == 1
        x0 = np.where(back, 4.0, 0.0)
        y0 = lane + 0.03 * back
        self.paths = [np.array([[x0[i], y0[i]], [4.0 - x0[i], y0[i]]])
                      for i in range(n)]
        self.states = np.zeros((n, 4), np.float32)
        self.states[:, 0], self.states[:, 1] = x0, y0 + 0.02
        self.states[:, 2] = np.where(back, np.pi, 0.0)
        self.vels = np.zeros((n, 3), np.float32)
        rng = np.random.default_rng(n)
        self.ranges = rng.uniform(1.5, 8.0, (n, N_RAYS)).astype(np.float32)
        self.tracked = np.full((n, M, 4), np.nan, np.float32)
        self.tracked[:, 0] = np.stack(
            [np.full(n, 2.0), y0 - 1.0, np.zeros(n), np.full(n, 0.4)], 1)

    def inputs(self, tracked):
        return (self.states, self.vels, self.ranges, ANGLES,
                self.tracked if tracked else None)

    def advance(self, out):
        cmd = [np.asarray(out[k], np.float32) for k in ("vx", "vy", "omega")]
        if cmd[0].ndim == 2:  # a k-tick call: its final states
            self.states = np.asarray(out["final_states"], np.float32).copy()
            self.vels = np.stack([c[:, -1] for c in cmd], 1)
            return
        s = self.states
        c, sn = np.cos(s[:, 2]), np.sin(s[:, 2])
        s[:, 0] += DT * (cmd[0] * c - cmd[1] * sn)
        s[:, 1] += DT * (cmd[0] * sn + cmd[1] * c)
        s[:, 2] += DT * cmd[2]
        s[:, 3] = np.hypot(cmd[0], cmd[1])
        self.vels = np.stack(cmd, 1)


# name -> (robots, shards, DeviceFleet options)
FLEETS = {
    "peers_predict": (8, 4, dict(peer_avoidance=True, peer_prediction=True,
                                 safety=True, tracked_obstacles=M)),
    "peers": (8, 2, dict(peer_avoidance=True)),
    "safety_tracked": (16, 8, dict(safety=True, tracked_obstacles=M)),
    "split": (8, 4, dict(tracked_obstacles=M, split_mover_sweep=True)),
}


def _fleet(pkg, name, shards="mesh"):
    """FLEETS[name] of ``pkg`` ("jax" on the JAX mesh, "port" on the port's
    mesh or, with ``shards=None``, on the CPU device); its paths set."""
    n, s, opts = FLEETS[name]
    opts = dict(opts)
    safety = opts.pop("safety", False)
    kw = dict(path_capacity=512, max_segments=8, **opts)
    if pkg == "jax":
        fleet = JaxDeviceFleet(_robots(n), _limits(), _config(), N_RAYS,
                               mesh=jax_mesh(s),
                               safety_config=JaxSafety() if safety else None, **kw)
    else:
        place = dict(device="cpu") if shards is None else dict(mesh=port_mesh(s))
        fleet = DeviceFleet(*to_port((_robots(n), _limits())), _config(), N_RAYS,
                            safety_config=FleetSafetyConfig() if safety else None,
                            **place, **kw)
    fleet.set_paths(Scene(n).paths)
    return fleet


@pytest.fixture(scope="module")
def jax_fleets():
    """The JAX mesh fleets, built once for the module (each test resets
    their carry with ``set_paths``)."""
    return {name: _fleet("jax", name) for name in FLEETS}


def _trio(jax_fleets, name):
    jf = jax_fleets[name]
    jf.set_paths(Scene(FLEETS[name][0]).paths)
    return jf, _fleet("port", name), _fleet("port", name, shards=None)


def assert_bit_equal(got, want, where):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{where} {key}")
        assert np.signbit(got[key]).tolist() == np.signbit(want[key]).tolist(), key


def lockstep(fleets, scene, calls, k=None, tracked=False):
    """``calls`` ticks (or k-tick calls) of (JAX mesh, port mesh, port one
    device) on the same inputs: the port's mesh == its one device bit for
    bit, both against JAX within the module's tolerance."""
    jf, mesh_fleet, one = fleets
    for call in range(calls):
        inputs = scene.inputs(tracked)
        if k is None:
            outs = [f.tick(*inputs[:4], tracked=inputs[4]) for f in fleets]
        else:
            outs = [f.run_ticks_on_device(k, *inputs[:4], tracked=inputs[4])
                    for f in fleets]
        assert_bit_equal(outs[1], outs[2], f"call {call}")
        assert_rows_close(outs[0], outs[1], f"call {call}")
        scene.advance(outs[0])
    return outs[1]


# --- the mesh and the process group ------------------------------------------


def test_fleet_mesh_requires_devices_and_chooses_no_backend():
    with pytest.raises(ValueError, match="at least one device"):
        build_fleet_mesh([])
    with pytest.raises(TypeError):
        build_fleet_mesh()
    mesh = build_fleet_mesh(["cpu", "cpu", "cpu"])
    assert (mesh.size, mesh.process_count, mesh.group) == (3, 1, None)
    assert mesh.devices == (CPU, CPU, CPU) and mesh.axis_name == "robots"
    initialize_multihost("127.0.0.1:1", 1, 0)  # one process: a no-op
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="gloo"):
        initialize_multihost("127.0.0.1:1", 2, 0)


def test_fleet_mesh_rows_and_collectives():
    """split/place/host_rows keep the row order; the gather joins the
    shards' blocks on every shard and counts one call; the sum adds the
    shards in order (one shard's -0.0 stays, two give +0.0)."""
    mesh = port_mesh(4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    parts = mesh.split(x)
    assert [p.shape[0] for p in parts] == [2] * 4
    np.testing.assert_array_equal(mesh.host_rows(parts), x)
    np.testing.assert_array_equal(mesh.host_rows(mesh.place(x)), x)
    assert [list(mesh.row_ids(d, 8)) for d in range(4)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="divide"):
        mesh.rows_per_shard(10)
    gathered = mesh.all_gather_rows(parts)
    assert len(gathered) == 4 and all(torch.equal(g, torch.from_numpy(x)) for g in gathered)
    assert mesh.collectives == {"all_gather": 1, "all_reduce": 0}
    neg = torch.tensor([-0.0, 1.0])
    one = port_mesh(1).all_reduce([neg], "sum")[0]
    assert torch.signbit(one[0])
    two = port_mesh(2).all_reduce([neg, torch.zeros(2)], "sum")[0]
    assert not torch.signbit(two[0]) and two[1] == 1.0
    assert port_mesh(3).all_reduce(
        [torch.tensor([3.0]), torch.tensor([1.0]), torch.tensor([2.0])], "min")[1] == 1.0


# --- make_fleet_solver on the mesh --------------------------------------------


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    from kompass_core_tpu.ops import pallas_kernels as jpallas

    fused, single = jpallas.fused_min_dist_sq, jpallas.min_obstacle_dist_sq_mxu
    monkeypatch.setattr(jpallas, "fused_min_dist_sq",
                        lambda *a, **k: fused(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jpallas, "min_obstacle_dist_sq_mxu",
                        lambda *a, **k: single(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("n", [16, 13])
@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_v1"])
def test_fleet_solver_on_the_mesh(jax_pallas_interpret, backend, n):
    """16 and 13 robots on 8 shards through ``FleetPlanner`` (13 padded to
    16: the pad rows solve to found=False): the port's mesh rows equal its
    one-device rows bit for bit and JAX's (its mesh for ``xla``) within
    the solver tolerance; no collective."""
    jspec = dataclasses.replace(_jax_spec(False, True), backend=backend)
    tspec = tsolver.spec_from_jax(jspec)
    bufs = _fleet_inputs(jspec, 70 + n, n)
    mesh = port_mesh(8)
    planner = FleetPlanner(tspec, n, mesh=mesh)
    assert planner.inputs.shape[0] == 16
    planner.inputs[:n] = bufs
    out = planner.step()
    one = make_fleet_solver(tspec, CPU)(planner.inputs).numpy()
    np.testing.assert_array_equal(out, one[:n])
    assert not one[n:, 0].any(), "a pad row found a command"
    if backend == "xla":
        jplanner = jfleet.FleetPlanner(jspec, n, mesh=jax_mesh(8))
        jplanner.inputs[:] = planner.inputs
        jout = jplanner.step()
    else:
        jout = np.asarray(jfleet.make_fleet_solver(jspec)(bufs))
    assert_rows_agree(tspec, out, jout)
    assert mesh.collectives == NO_COLLECTIVE
    with pytest.raises(IndexError, match="out of range"):
        planner.set_scenario(n)


def test_fleet_solver_chunks_each_shard():
    """Each shard runs its rows in chunks (6 rows a shard, chunks of 4: a
    padded tail per shard), monolithic with ``chunk_size=None``; both
    equal the one-device rows; ragged rows are refused."""
    jspec = _jax_spec(False, False)
    tspec = tsolver.spec_from_jax(jspec)
    bufs = _fleet_inputs(jspec, 80, 24)
    one = make_fleet_solver(tspec, CPU, chunk_size=None)(bufs).numpy()
    mesh = port_mesh(4)
    for chunk in (4, None):
        out = make_fleet_solver(tspec, mesh=mesh, chunk_size=chunk)(bufs)
        assert len(out) == 4 and all(o.shape[0] == 6 for o in out)
        np.testing.assert_array_equal(mesh.host_rows(out), one)
    with pytest.raises(ValueError, match="divide"):
        make_fleet_solver(tspec, mesh=mesh)(bufs[:13])
    with pytest.raises(ValueError, match="not both"):
        make_fleet_solver(tspec, CPU, mesh=mesh)


# --- the sample-parallel solve -------------------------------------------------


def _sample_parallel_inputs(shards, y0):
    """``test_fleet.py``'s omega split: shard c keeps the omega samples c,
    c + shards, ...; with y0 = -0.0 the winner's path starts at -0.0."""
    kw = _scenario_kwargs(vel=(0.5, 0.0, 0.0), y0=y0)
    full = kw["window"]
    bufs = np.zeros((shards, tsolver.packed_input_size(tsolver.spec_from_jax(SP_SPEC))),
                    np.float32)
    for c in range(shards):
        mask = np.zeros_like(full.omega_mask)
        mask[c::shards] = full.omega_mask[c::shards]
        window = VelocityWindow(full.vx_vals, full.vx_mask, full.vy_vals,
                                full.vy_mask, full.omega_vals, mask)
        jpack(SP_SPEC, bufs[c], **dict(kw, window=window))
    whole = np.zeros(bufs.shape[1], np.float32)
    jpack(SP_SPEC, whole, **kw)
    return bufs, whole


@pytest.mark.parametrize("shards,y0", [(2, 0.0), (4, -0.0), (8, 0.0)])
def test_sample_parallel_solve(shards, y0):
    """Every shard holds the winner's output: the one-device full-window
    solve's found flag, winner, cost and trajectory, JAX's sample-parallel output within the
    solver tolerance (a -0.0 of the winner comes out +0.0 in both, the
    masked sum), the CPU port's own bit for bit on every shard; three
    all-reduces and no gather."""
    tspec = tsolver.spec_from_jax(SP_SPEC)
    bufs, whole = _sample_parallel_inputs(shards, y0)
    mesh = port_mesh(shards, "sp")
    out = mesh.host_rows(make_sample_parallel_solver(tspec, mesh)(bufs))
    assert mesh.collectives == {"all_gather": 0, "all_reduce": 3}
    assert (out == out[0]).all()
    ref = tsolver.make_packed_dwa_solver(tspec, CPU)(whole).numpy()
    got, want = (tsolver.unpack_solver_output(tspec, r) for r in (out[0], ref))
    assert got[0] == want[0] and got[0]
    assert got[1] == pytest.approx(want[1], rel=1e-6)
    # num_admissible (column 3) counts the winning shard's samples alone
    win, full = np.delete(out[0], 3), np.delete(ref, 3)
    np.testing.assert_array_equal(np.abs(win), np.abs(full))
    if y0 == 0.0:
        np.testing.assert_array_equal(np.signbit(win), np.signbit(full))
    else:
        assert np.signbit(ref).any() and not np.signbit(out[0][ref == 0.0]).any()
    jout = np.asarray(jfleet.make_sample_parallel_solver(SP_SPEC, jax_mesh(shards, "sp"))(bufs))
    assert_rows_agree(tspec, out, jout)
    assert np.signbit(jout[0][ref == 0.0]).tolist() == np.signbit(out[0][ref == 0.0]).tolist()


# --- the mesh fleet ticks --------------------------------------------------------


@pytest.mark.parametrize("name", ["peers_predict", "peers"])
def test_peer_mesh_tick(jax_fleets, name):
    """Peers (and prediction, safety and tracked slots) on the mesh: 3
    ticks in lockstep, exactly one all-gather per tick."""
    fleets = _trio(jax_fleets, name)
    tracked = bool(FLEETS[name][2].get("tracked_obstacles"))
    out = lockstep(fleets, Scene(FLEETS[name][0]), 3, tracked=tracked)
    assert out["found"].any()
    assert fleets[1].mesh.collectives == {"all_gather": 3, "all_reduce": 0}


def test_peer_mesh_k_loop(jax_fleets):
    """The k = 3 loop with peers, prediction, safety and tracked slots: two
    calls in lockstep, one gather of the live state per tick (3 per
    call)."""
    fleets = _trio(jax_fleets, "peers_predict")
    out = lockstep(fleets, Scene(8), 2, k=3, tracked=True)
    assert out["vx"].shape == (8, 3) and out["final_states"].shape == (8, 4)
    assert fleets[1].mesh.collectives == {"all_gather": 6, "all_reduce": 0}


@pytest.mark.parametrize("name", ["safety_tracked", "split"])
def test_row_local_mesh_ticks(jax_fleets, name):
    """The safety-gated tracked fleet and the split mover fleet on the mesh:
    2 ticks and a k = 3 call in lockstep, no collective."""
    fleets = _trio(jax_fleets, name)
    scene = Scene(FLEETS[name][0])
    lockstep(fleets, scene, 2, tracked=True)
    if name == "safety_tracked":
        lockstep(fleets, scene, 1, k=3, tracked=True)
    assert fleets[1].mesh.collectives == NO_COLLECTIVE


def test_mesh_tick_program_equals_the_one_device_program():
    """``make_fleet_tick(mesh=...)`` on the shards' lists (``mesh.split`` of
    the one-device program's arguments, the inputs as host rows) gives
    the one-device carry and outputs bit for bit, with one gather."""
    one = _fleet("port", "peers", shards=None)
    one._prepare_tick_inputs(*Scene(8).inputs(False))
    args = (one._paths, one._cfg, one._carry, one._angles)
    mesh = port_mesh(2)
    tick = make_fleet_tick(one.spec, mesh=mesh, peer_cfg=one._peer_cfg)
    carry, outs = tick(*(mesh.split(a) for a in args),
                       [one._inputs[:4], one._inputs[4:]])
    want_carry, want = make_fleet_tick(one.spec, CPU, peer_cfg=one._peer_cfg)(
        *args, one._inputs)
    assert torch.equal(torch.cat(outs), want)
    for got, ref in zip(zip(*carry), want_carry):
        assert torch.equal(torch.cat(got), ref)
    assert mesh.collectives == {"all_gather": 1, "all_reduce": 0}


def test_update_path_and_set_paths_on_the_mesh(jax_fleets):
    """``update_path`` writes only the owning shard (robot 5 on shard 2 of
    4); the fleets stay in lockstep; ``set_paths`` resets every shard."""
    fleets = _trio(jax_fleets, "peers_predict")
    scene = Scene(8)
    lockstep(fleets, scene, 1, tracked=True)
    before = [shard.x.clone() for shard in fleets[1]._paths]
    new = np.array([[scene.states[5, 0], scene.states[5, 1]], [0.0, 6.0]])
    for f in fleets:
        f.update_path(5, new)
    changed = [not torch.equal(shard.x, b) for shard, b in zip(fleets[1]._paths, before)]
    assert changed == [False, False, True, False]
    assert fleets[1]._carry[2].pos_in_seg[1] == -1.0
    lockstep(fleets, scene, 2, tracked=True)
    for f in fleets:
        f.set_paths(Scene(8).paths)
    lockstep(fleets, Scene(8), 1, tracked=True)


def test_state_dict_across_mesh_and_single(jax_fleets):
    """A snapshot of the mesh fleet resumes on one device and the one
    device's on the mesh (the same padded N), and the JAX mesh fleet's on
    the port's mesh: the same next ticks bit for bit (JAX within the
    tolerance)."""
    jf, mesh_fleet, one = _trio(jax_fleets, "peers_predict")
    scene = Scene(8)
    lockstep((jf, mesh_fleet, one), scene, 2, tracked=True)
    sd_mesh, sd_one, sd_jax = mesh_fleet.state_dict(), one.state_dict(), jf.state_dict()
    assert sd_mesh.keys() == sd_one.keys()
    for key in sd_one:
        np.testing.assert_array_equal(sd_mesh[key], sd_one[key], err_msg=key)
    resumed_one = _fleet("port", "peers_predict", shards=None)
    resumed_one.load_state_dict(sd_mesh)
    resumed_mesh = _fleet("port", "peers_predict")
    resumed_mesh.load_state_dict(sd_one)
    lockstep((jf, resumed_mesh, resumed_one), scene, 2, tracked=True)
    from_jax = _fleet("port", "peers_predict")
    from_jax.load_state_dict(sd_jax)
    for key, value in from_jax.state_dict().items():
        np.testing.assert_array_equal(value, np.asarray(sd_jax[key]), err_msg=key)


def test_export_refuses_a_mesh_fleet(tmp_path):
    """A mesh fleet's program is not exported (as in the JAX package):
    the one-device fleet's is, and ``sharded_fleet_call`` shards it."""
    fleet = _fleet("port", "safety_tracked")
    for export in (lambda p: serving.export_fleet_tick(fleet, p, device="cpu"),
                   lambda p: serving.export_fleet_ticks_on_device(fleet, 2, p,
                                                                  device="cpu")):
        with pytest.raises(NotImplementedError, match="mesh"):
            export(tmp_path / "fleet.kct")
    assert not list(tmp_path.iterdir())


def test_fleet_runtime_on_the_mesh_equals_one_device():
    """``FleetRuntime`` over an 8-shard mesh (6 robots padded to 8) gives the
    one-device runtime's commands bit for bit, tick by tick; neither fails
    a dispatch."""
    from kompass_core_tpu_torch.control import DWAConfig as PortConfig
    from kompass_core_tpu_torch.datatypes import LaserScanData

    robots = to_port(_robots(6))
    config = PortConfig(max_linear_samples=4, max_angular_samples=4,
                        prediction_horizon=10, control_horizon=2,
                        control_time_step=DT)
    mesh = port_mesh(8)
    runtimes = (FleetRuntime(robots, to_port(_limits()), config, mesh=mesh),
                FleetRuntime(robots, to_port(_limits()), config, device="cpu"))
    paths = [np.array([[0.5 * i, 0.0], [0.5 * i + 2.0, 1.0]]) for i in range(6)]
    for rt in runtimes:
        rt.set_paths(paths)
    for robot, i in zip(robots, range(6)):
        robot.state.x = 0.5 * i
    scans = [LaserScanData(ranges=np.full(N_RAYS, 4.0), angles=ANGLES)] * 6
    for _ in range(3):
        results = [rt.tick([r.state for r in robots], scans) for rt in runtimes]
        assert results[0] == results[1]
        for robot, res in zip(robots, results[0]):
            if res.get("found"):
                robot.set_control(velocity_x=res["vx"], velocity_y=res["vy"],
                                  omega=res["omega"])
                robot.get_state(dt=DT)
    assert runtimes[0]._inputs.shape[0] == 8 and runtimes[1]._inputs.shape[0] == 6
    assert [rt.solver_failures for rt in runtimes] == [0, 0]
    assert mesh.collectives == NO_COLLECTIVE
    with pytest.raises(ValueError, match="not both"):
        FleetRuntime(robots, to_port(_limits()), config, mesh=mesh, device="cpu")
    assert math.isfinite(runtimes[0].last_tick_seconds)
