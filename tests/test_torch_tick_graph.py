"""``DeviceFleet.tick`` and its CUDA graph, on the CPU.

On a CUDA device ``tick`` replays a captured graph of the tick program
(``fleet._tick_fn``), and ``run_ticks_on_device`` one of its k-tick loop;
both drop a graph that read tensors the fleet no longer holds
(``fleet_v2.graph_is_stale``). On the CPU, and over a mesh of CPU
devices, ``tick`` captures nothing and its outputs and carry are the
tick program's, bit for bit. The graphs themselves are held on the card
by ``tests/test_torch_cuda.py``.
"""

import types

import numpy as np
import pytest
import torch

from kompass_core_tpu_torch.control import DWAConfig
from kompass_core_tpu_torch.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch.ops.fleet_solver import OUT_FIELDS, FleetCarry
from kompass_core_tpu_torch.parallel import DeviceFleet, FleetMesh
from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig, graph_is_stale

torch.set_num_threads(2)

N, RAYS, TRACKED = 4, 64, 2


def _fleet(**kw):
    robots = [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                    geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.2, 0.4])) for _ in range(N)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0, max_decel=6.0),
    )
    config = DWAConfig(max_linear_samples=8, max_angular_samples=8,
                       prediction_horizon=10, control_horizon=2)
    kw.setdefault("device", "cpu")
    fleet = DeviceFleet(robots, limits, config, RAYS, path_capacity=256,
                        max_segments=8, tracked_obstacles=TRACKED, **kw)
    fleet.set_paths([np.array([[0.0, 2.0 * i], [5.0, 2.0 * i]]) for i in range(N)])
    return fleet


def _inputs(call):
    rng = np.random.default_rng(call)
    states = np.zeros((N, 4), np.float32)
    states[:, 0] = 0.1 * call
    states[:, 1] = 2.0 * np.arange(N)
    vels = np.tile(np.float32([0.3, 0.0, 0.05]), (N, 1))
    ranges = rng.uniform(0.8, 8.0, (N, RAYS)).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, RAYS, endpoint=False).astype(np.float32)
    tracked = np.full((N, TRACKED, 4), np.nan, np.float32)
    tracked[:, 0] = (2.0, 0.8, 0.0, -0.5)
    tracked[:, 0, 1] += states[:, 1]
    return states, vels, ranges, angles, tracked


def _rows(value):
    """A one-device tensor, or a mesh's per-shard list of them, as one host
    array in fleet row order."""
    if isinstance(value, list):
        return np.concatenate([v.cpu().numpy() for v in value])
    return value.cpu().numpy()


KINDS = {  # the fleet's construction arguments, made per test
    "plain": dict,
    "peers_safety": lambda: dict(peer_avoidance=True, peer_prediction=True,
                                 safety_config=FleetSafetyConfig()),
    "mesh": lambda: dict(device=None, mesh=FleetMesh(["cpu"] * 2)),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cpu_tick_builds_no_graph_and_equals_the_tick_program(kind):
    """Over closed-loop calls on the CPU (one device, peers with the safety
    gate, a two-shard mesh) ``tick`` captures no graph, and its outputs
    and carry equal the tick program's on the same packed inputs, bit
    for bit."""
    fleet = _fleet(**KINDS[kind]())
    for call in range(3):
        states, vels, ranges, angles, tracked = _inputs(call)
        safety = fleet._prepare_tick_inputs(states, vels, ranges, angles, tracked)
        carry = fleet._carry
        if isinstance(carry, list):
            carry = [FleetCarry(*(t.clone() for t in c)) for c in carry]
        else:
            carry = FleetCarry(*(t.clone() for t in carry))
        inputs = torch.from_numpy(fleet._inputs.copy())
        if fleet.mesh is not None:
            n_loc = fleet.mesh.rows_per_shard(fleet._n)
            inputs = [inputs[d * n_loc:(d + 1) * n_loc] for d in range(2)]
        want_carry, want = fleet._tick_fn(fleet._paths, fleet._cfg, carry, fleet._angles,
                                          inputs, *safety)
        out = fleet.tick(states, vels, ranges, angles, tracked=tracked)
        got = np.stack([np.asarray(out[f], np.float32) for f in OUT_FIELDS], 1)
        np.testing.assert_array_equal(got.view(np.int32), _rows(want)[:N].view(np.int32))
        if fleet.mesh is None:
            want_carry, have = [want_carry], [fleet._carry]
        else:
            have = fleet._carry
        for a, b in zip(have, want_carry):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert fleet.tick_graphs == {}
    fleet.run_ticks_on_device(2, *_inputs(3)[:4], tracked=_inputs(3)[4])
    assert fleet.tick_graphs == {}


def _stand_in(paths, angles, safety):
    """A captured graph's record of the fleet's tensors, in small."""
    return types.SimpleNamespace(paths=paths, angles=angles, safety=safety)


def _tables(safety=True):
    paths = types.SimpleNamespace(x=torch.zeros(3, 5), y=torch.zeros(3, 5))
    return paths, torch.zeros(3, 8), (torch.ones(3, 8) if safety else None)


@pytest.mark.parametrize("change,stale", [
    ("nothing", False),
    ("nothing, without safety tables", False),
    ("row written in place", False),
    ("new paths", True),
    ("new angles", True),
    ("new safety tables", True),
    ("safety tables dropped", True),
])
def test_graph_is_stale_on_new_tensors_and_not_on_rows_written_in_place(change, stale):
    """A graph is stale once the fleet holds another path, angle or safety
    tensor than the one it read (``set_paths``, ``load_state_dict``, a new
    angle grid); a row written into the same tensors (``update_path``)
    leaves it fresh."""
    paths, angles, safety = _tables(safety=change != "nothing, without safety tables")
    graph = _stand_in(paths, angles, safety)
    if change == "row written in place":
        paths.x[1] = 7.0
        angles[1] = 0.5
        safety[1] = 0.0
    elif change == "new paths":
        paths = types.SimpleNamespace(x=paths.x.clone(), y=paths.y)
    elif change == "new angles":
        angles = angles.clone()
    elif change == "new safety tables":
        safety = safety.clone()
    elif change == "safety tables dropped":
        safety = None
    assert graph_is_stale(graph, paths, angles, safety) is stale
