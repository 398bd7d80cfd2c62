"""The port's scale-out across two processes (``torch.distributed`` over
gloo on localhost), the counterpart of ``tests/test_multiprocess.py``.

Each worker joins the group with ``initialize_multihost(...,
backend="gloo")``, builds ``build_fleet_mesh(["cpu"] * shards)`` (the
group's processes, ``shards`` each) and feeds its own rows. The inputs
are made here, by the JAX package's ``__graft_entry__._scenario_buffer``,
and reach the workers as a ``.npz``: the workers import no JAX. Every
worker holds its rows bit for bit against the port's one-process result
of the whole fleet and writes them back; this process holds them against
JAX's ``make_fleet_solver(mesh=None)`` on the same buffers (within the
solver tolerance) and the port's one-device solve (bit for bit). A
third scenario runs a peer fleet over 2 processes x 2 shards: every tick
gathers the robots' states across the processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kompass_core_tpu.ops.solver import SolverSpec, packed_input_size
from kompass_core_tpu.parallel.fleet import make_fleet_solver as jax_fleet_solver
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.parallel import make_fleet_solver

from test_torch_fleet_solver import assert_rows_agree
from test_torch_scaleout import Scene, _sample_parallel_inputs

SPEC = SolverSpec(is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=8,
                  num_ctrl_points=2, scan_size=64, seg_size=64)
WORKER_TIMEOUT = 240

WORKER = r'''
import os, sys
rank, world, port, shards, data_path, scenario = sys.argv[1:7]
rank, world, shards = int(rank), int(world), int(shards)
import numpy as np
import torch
torch.set_num_threads(1)
from kompass_core_tpu_torch.ops.solver import SolverSpec
from kompass_core_tpu_torch.parallel import (
    DeviceFleet, build_fleet_mesh, initialize_multihost, make_fleet_solver,
    make_sample_parallel_solver)

initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
mesh = build_fleet_mesh(["cpu"] * shards)
assert (mesh.size, mesh.process_index) == (world * shards, rank), mesh
data = np.load(data_path)
out = {}
if scenario == "solver":
    spec = SolverSpec(is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=8,
                      num_ctrl_points=2, scan_size=64, seg_size=64)
    solver = make_fleet_solver(spec, mesh=mesh)
    for key in [k for k in data.files if k.startswith("fleet_")]:
        full = data[key]
        rows = mesh.local_rows(len(full))
        got = mesh.host_rows(solver(full[rows]))
        single = make_fleet_solver(spec, "cpu")(full).numpy()
        assert np.array_equal(got, single[rows]), key
        out[key] = got
    assert mesh.collectives == {"all_gather": 0, "all_reduce": 0}, mesh.collectives
    if "sp_bufs" in data.files:
        sp = data["sp_bufs"]
        spec = SolverSpec(is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=10,
                          num_ctrl_points=2, scan_size=64, seg_size=64,
                          drop_samples=True)
        n_loc = len(sp) // world
        got = mesh.host_rows(make_sample_parallel_solver(spec, mesh)(
            sp[rank * n_loc:(rank + 1) * n_loc]))
        from kompass_core_tpu_torch.parallel import FleetMesh
        local = FleetMesh(["cpu"] * len(sp))
        want = local.host_rows(make_sample_parallel_solver(spec, local)(sp))
        assert np.array_equal(got, want[rank * n_loc:(rank + 1) * n_loc])
        assert mesh.collectives["all_reduce"] == 3
        out["sp"] = got
else:
    from kompass_core_tpu_torch.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType)
    from kompass_core_tpu_torch.parallel import FleetSafetyConfig

    n = len(data["states"])
    def fleet(**place):
        robots = [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                        geometry_type=RobotGeometry.Type.CYLINDER,
                        geometry_params=np.array([0.3, 0.4])) for _ in range(n)]
        limits = RobotCtrlLimits(
            vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
            omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0,
                                           max_steer=np.pi))
        config = DWAConfig(
            max_linear_samples=5, max_angular_samples=5,
            costs_weights=TrajectoryCostsWeights(
                reference_path_distance_weight=3.0, goal_distance_weight=1.0,
                smoothness_weight=0.0, jerk_weight=0.0,
                obstacles_distance_weight=0.5),
            prediction_horizon=10, control_horizon=2, control_time_step=0.1)
        f = DeviceFleet(robots, limits, config, data["ranges"].shape[1],
                        path_capacity=512, max_segments=8, peer_avoidance=True,
                        peer_prediction=True, safety_config=FleetSafetyConfig(),
                        tracked_obstacles=data["tracked"].shape[1], **place)
        f.set_paths(list(data["paths"]))
        return f
    sharded, one = fleet(mesh=mesh), fleet(device="cpu")
    mine = sharded.local_robots
    assert len(mine) == n // world
    states, vels = data["states"].copy(), data["vels"].copy()
    args = lambda: (states, vels, data["ranges"], data["angles"])
    for tick in range(3):
        got = sharded.tick(*args(), tracked=data["tracked"])
        want = one.tick(*args(), tracked=data["tracked"])
        for key in want:
            assert np.array_equal(got[key], want[key][mine.start:mine.stop]), key
        out[f"tick{tick}"] = np.stack([got[k] for k in ("vx", "vy", "omega", "cost")])
        cmd = [want[k].astype(np.float32) for k in ("vx", "vy", "omega")]
        c, s = np.cos(states[:, 2]), np.sin(states[:, 2])
        states[:, 0] += 0.1 * (cmd[0] * c - cmd[1] * s)
        states[:, 1] += 0.1 * (cmd[0] * s + cmd[1] * c)
        states[:, 2] += 0.1 * cmd[2]
        vels = np.stack(cmd, 1)
    got = sharded.run_ticks_on_device(2, *args(), tracked=data["tracked"])
    want = one.run_ticks_on_device(2, *args(), tracked=data["tracked"])
    for key in want:
        assert np.array_equal(got[key], want[key][mine.start:mine.stop]), key
    out["final_states"] = got["final_states"]
    assert mesh.collectives == {"all_gather": 5, "all_reduce": 0}, mesh.collectives
np.savez(os.path.join(os.path.dirname(data_path), f"rows_{rank}.npz"), **out)
assert "jax" not in sys.modules and not any(
    m.split(".")[0] == "kompass_core_tpu" for m in sys.modules)
print(f"proc {rank}: OK", flush=True)
'''


def run_workers(tmp_path, data, shards, scenario, num_procs=2):
    """Start ``num_procs`` workers on a free localhost port with ``data``
    (a dict of arrays) and return each one's rows; a worker that fails or
    outlives WORKER_TIMEOUT fails the test and both are killed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    data_path = tmp_path / "data.npz"
    np.savez(data_path, **data)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.getcwd(), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(num_procs), str(port),
         str(shards), str(data_path), scenario],
        cwd=os.getcwd(), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(num_procs)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                pytest.fail("multiprocess worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: OK" in out
    return [dict(np.load(tmp_path / f"rows_{i}.npz")) for i in range(num_procs)]


def goal_point_tie(tspec, buf, port_row, jax_row):
    """ROADMAP section 3 item 8: the same winner whose costs differ by the
    goal cost's nearest path point alone. Both rollouts' end points lie
    within 2 ulps of the bisector of the same two path points, and the
    costs differ by the arc between them over the reference length."""
    fields = tsolver._unpack_inputs(tspec, torch.from_numpy(buf[None]))
    seg_x, seg_y, seg_arc = (f[0].numpy().astype(np.float64) for f in fields[5:8])
    ref, last = float(fields[10][0]), int(fields[11][0]) - 1
    T, pairs = tspec.max_points, []
    for row in (port_row, jax_row):
        ex, ey = row[4 + 3 * (T - 1) + last], row[4 + 3 * (T - 1) + T + last]
        dist = np.hypot(ex - seg_x, ey - seg_y)
        pair = tuple(sorted(np.argsort(dist)[:2]))
        ulp = np.spacing(np.float32(max(abs(ex), abs(ey))))
        if abs(dist[pair[0]] - dist[pair[1]]) > 2 * ulp:
            return False
        pairs.append(pair)
    step = abs(seg_arc[pairs[0][1]] - seg_arc[pairs[0][0]]) / ref
    return (pairs[0] == pairs[1] and port_row[2] == jax_row[2]
            and abs(abs(port_row[1] - jax_row[1]) - step) <= 1e-6)


def _held_against_jax(rows, full, n_real):
    """The processes' rows in order: the port's one-device solve bit for
    bit, JAX's one-device solver within the solver tolerance but for rows
    that are a goal-point tie (``goal_point_tie``); real rows found, pad
    rows not. Returns the tied rows."""
    got = np.concatenate(rows)
    tspec = tsolver.spec_from_jax(SPEC)
    np.testing.assert_array_equal(got, make_fleet_solver(tspec, "cpu")(full).numpy())
    jout = np.asarray(jax_fleet_solver(SPEC, mesh=None)(full))
    ties = [r for r in range(len(got))
            if got[r, 0] > 0.5 and jout[r, 0] > 0.5
            and abs(got[r, 1] - jout[r, 1]) > 1e-4 * abs(jout[r, 1])
            and goal_point_tie(tspec, full[r], got[r], jout[r])]
    keep = np.setdiff1d(np.arange(len(got)), ties)
    assert_rows_agree(tspec, got[keep], jout[keep])
    assert (got[:n_real, 0] > 0.5).all(), "a real robot found no command"
    assert not (got[n_real:, 0] > 0.5).any(), "a pad row reported found"
    return ties


def test_two_process_fleet(tmp_path):
    """8 robots over 2 processes x 2 shards, and the sample-parallel solve
    over the same 4 shards (its all-reduces cross the processes)."""
    from __graft_entry__ import _scenario_buffer

    full = np.stack([_scenario_buffer(SPEC, i) for i in range(8)])
    sp_bufs, _ = _sample_parallel_inputs(4, 0.0)
    rows = run_workers(tmp_path, {"fleet_8": full, "sp_bufs": sp_bufs}, 2, "solver")
    # robot 4's winning end point lies midway between two path points
    # (ROADMAP section 3 item 8)
    assert _held_against_jax([r["fleet_8"] for r in rows], full, 8) == [4]
    sp = np.concatenate([r["sp"] for r in rows])
    assert (sp == sp[0]).all() and sp[0, 0] > 0.5


def test_128_robots_two_process_bit_parity(tmp_path):
    """The BASELINE north star at test scale: 128 robots (and 100 padded to
    104) over 2 processes x 4 shards, every process's rows bit-equal to
    the one-process fleet."""
    from __graft_entry__ import _scenario_buffer

    base = _scenario_buffer(SPEC, 0)
    data = {}
    for n_real, n_padded in ((128, 128), (100, 104)):
        full = np.zeros((n_padded, packed_input_size(SPEC)), np.float32)
        full[:n_real] = base
        full[:n_real, 0] += 1e-3 * np.arange(n_real, dtype=np.float32)
        data[f"fleet_{n_real}"] = full
    rows = run_workers(tmp_path, data, 4, "solver")
    for n_real in (128, 100):
        _held_against_jax([r[f"fleet_{n_real}"] for r in rows],
                          data[f"fleet_{n_real}"], n_real)


def test_peer_fleet_across_two_processes(tmp_path):
    """A peer fleet with prediction, safety and tracked slots, 8 robots
    over 2 processes x 2 shards: 3 ticks and a k = 2 call, every process's
    rows bit-equal to the one-process fleet's, 5 gathers across the
    processes."""
    scene = Scene(8)
    data = dict(states=scene.states, vels=scene.vels, ranges=scene.ranges,
                angles=np.linspace(-np.pi, np.pi, scene.ranges.shape[1],
                                   endpoint=False),
                tracked=scene.tracked, paths=np.stack(scene.paths))
    rows = run_workers(tmp_path, data, 2, "fleet")
    final = np.concatenate([r["final_states"] for r in rows])
    assert final.shape == (8, 4) and np.isfinite(final).all()
