"""Collective counts of the fleet's mesh programs: the evidence for the
scaling claim.

Counterpart of ``kompass_core_tpu/benchmark/scaling_proof.py``. The claim
is that the steady-state fleet programs are embarrassingly parallel over
the robot axis: run over a mesh, they make no collective, so adding
shards adds no communication. The JAX package reads the collectives off
the optimized HLO of each program compiled over an 8-device mesh and
counts them by op name (its ``count_collectives`` parses the HLO text).
The port has no compiled program text to parse: its mesh programs call
``FleetMesh.all_gather_rows`` and ``FleetMesh.all_reduce``
(``parallel/multihost.py``), and each call adds one to
``mesh.collectives``. So here each program runs once over the mesh of the
devices given, after one warm-up call, and its counts are the calls that
one call made, keyed by the JAX package's HLO names (``"all-gather"``,
``"all-reduce"``; a zero count left out). There is no ``count_collectives``.

The seven programs, at the JAX module's tiny shapes:

* ``make_fleet_solver(mesh=)``, the packed fleet solver (K1): none;
* ``DeviceFleet(mesh=)``'s tick, plain (K1), with ``safety_config`` (K1),
  with 2 tracked slots (K3) and with them as split movers (K1 and K3s):
  none;
* the tick with ``peer_avoidance`` (K1): exactly one all-gather, of the
  fleet's [N, 7] state and velocity block;
* ``make_sample_parallel_solver`` (K1): all-reduces only (three: the min
  cost, the min winning shard, the masked sum).

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.scaling_proof
--device cuda [--shards 2]`` (a mesh of that many shards on the one
device; prints the JSON, writes no file).
"""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np

# FleetMesh.collectives' keys -> the JAX package's HLO op names
HLO_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce"}


def _counts(mesh, call) -> Dict[str, int]:
    """The collectives ``call()`` makes over ``mesh``, by HLO name (zero
    counts left out): the steady state, after one warm-up call."""
    call()
    before = dict(mesh.collectives)
    call()
    return {HLO_NAMES[k]: n - before[k] for k, n in mesh.collectives.items()
            if n != before[k]}


def _tiny_spec():
    from ..ops.solver import SolverSpec

    return SolverSpec(
        is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=10,
        num_ctrl_points=2, scan_size=64, seg_size=64, drop_samples=True,
    )


def fleet_solver_collectives(mesh, n_robots: int = 16) -> Dict[str, int]:
    """The packed fleet solver over ``mesh`` on ``n_robots`` zero rows."""
    from ..ops.solver import packed_input_size
    from ..parallel.fleet import make_fleet_solver

    spec = _tiny_spec()
    solver = make_fleet_solver(spec, mesh=mesh)
    args = np.zeros((n_robots, packed_input_size(spec)), np.float32)
    return _counts(mesh, lambda: solver(args))


def sample_parallel_collectives(mesh) -> Dict[str, int]:
    """One sample-parallel solve over ``mesh``'s devices (its own mesh,
    axis ``"sp"``, as the JAX module builds it), one zero row per shard."""
    from ..ops.solver import packed_input_size
    from ..parallel.fleet import make_sample_parallel_solver
    from ..parallel.multihost import FleetMesh

    spec = _tiny_spec()
    sp_mesh = FleetMesh(mesh.devices, group=mesh.group, axis_name="sp")
    solver = make_sample_parallel_solver(spec, sp_mesh)
    args = np.zeros((len(sp_mesh.devices), packed_input_size(spec)), np.float32)
    return _counts(sp_mesh, lambda: solver(args))


def tiny_fleet(mesh, n_robots: int = 8, safety: bool = False, tracked: int = 0,
               peers: bool = False, split: bool = False):
    """The JAX module's tick fleet (``fleet_tick_hlo``): ``n_robots``
    diff-drive robots of radius 0.1, 4 x 4 samples, 10 steps, 72 rays,
    paths and angles set, over ``mesh``."""
    from ..control import DWAConfig, TrajectoryCostsWeights
    from ..models import (
        AngularCtrlLimits,
        LinearCtrlLimits,
        Robot,
        RobotCtrlLimits,
        RobotGeometry,
        RobotType,
    )
    from ..parallel.fleet_v2 import DeviceFleet, FleetSafetyConfig

    n_rays = 72
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=4,
        max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=n_rays, path_capacity=512,
        max_segments=16, mesh=mesh,
        safety_config=FleetSafetyConfig() if safety else None,
        tracked_obstacles=tracked,
        peer_avoidance=peers,
        split_mover_sweep=split,
    )
    fleet.set_paths(
        [np.array([[1.0 * i, 0.0], [1.0 * i, 2.5]]) for i in range(n_robots)]
    )
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, n_rays, endpoint=False))
    return fleet


def fleet_tick_collectives(mesh, n_robots: int = 8, safety: bool = False,
                           tracked: int = 0, peers: bool = False,
                           split: bool = False) -> Dict[str, int]:
    """One steady-state tick of ``tiny_fleet`` over ``mesh``, on the
    fleet's own tick arguments (``tick_example_args``: the zero input
    matrix, its tracked slots at the pad)."""
    fleet = tiny_fleet(mesh, n_robots, safety, tracked, peers, split)
    args = fleet.tick_example_args()
    return _counts(mesh, lambda: fleet._tick_fn(*args))


STEADY_STATE = (
    "fleet_solver_packed", "fleet_v2_tick", "fleet_v2_tick_safety",
    "fleet_v2_tick_tracked", "fleet_v2_tick_tracked_split",
)


def build_proof(mesh) -> dict:
    """Run the seven programs over ``mesh`` and return the artifact dict,
    asserting the JAX module's claims (a failed claim raises)."""
    programs = {
        "fleet_solver_packed": fleet_solver_collectives(mesh),
        "fleet_v2_tick": fleet_tick_collectives(mesh),
        "fleet_v2_tick_safety": fleet_tick_collectives(mesh, safety=True),
        "fleet_v2_tick_tracked": fleet_tick_collectives(mesh, tracked=2),
        "fleet_v2_tick_tracked_split": fleet_tick_collectives(
            mesh, tracked=2, split=True
        ),
        "fleet_v2_tick_peers_mesh": fleet_tick_collectives(mesh, peers=True),
        "sample_parallel_solver": sample_parallel_collectives(mesh),
    }
    entries = {
        name: {"collective_counts": counts,
               "total_collectives": sum(counts.values())}
        for name, counts in programs.items()
    }
    for name in STEADY_STATE:
        assert entries[name]["total_collectives"] == 0, (
            f"{name}: steady-state fleet program must make zero "
            f"cross-shard collectives, found {entries[name]}"
        )
    sp = entries["sample_parallel_solver"]["collective_counts"]
    assert set(sp) == {"all-reduce"} and sp["all-reduce"] >= 1, (
        f"sample-parallel combine must use all-reduces only, found {sp}"
    )
    pm = entries["fleet_v2_tick_peers_mesh"]["collective_counts"]
    assert pm == {"all-gather": 1}, (
        "mesh peer tick must make exactly one all-gather and no other "
        f"collective, found {pm}"
    )
    return {
        "mesh_devices": mesh.size,
        "platform": mesh.devices[0].type,
        "claim": (
            "steady-state fleet tick is embarrassingly parallel over the"
            " robot axis: zero cross-shard collectives per call => adding"
            " shards adds no communication; the peer tick gathers the"
            " fleet's [N, 7] state block once per tick, the sample-parallel"
            " solve combines by all-reduces alone"
        ),
        "method": "FleetMesh.collectives delta around one call after a warm-up call",
        "programs": entries,
    }


def main(devices: Sequence) -> dict:
    from ..parallel.multihost import FleetMesh

    proof = build_proof(FleetMesh(devices))
    print(json.dumps(proof, indent=1))
    return proof


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--shards", type=int, default=2)
    _device, _args = parse_device_args(_parser)
    main([_device] * _args.shards)
