"""Serving restart on the PyTorch port: artifact + fleet snapshot, resumed
bit for bit.

Process A (the long-lived server) exports its fleet-tick program and
snapshots mid-mission state to disk. Process B (the restart, simulated
here with fresh objects) loads both and continues the mission exactly
where A stopped: no tracing, no path re-interpolation, and the first
post-restart tick (one static obstacle sweep) is bit-identical to what A
would have produced.

Run: python examples_torch/serving_restart_demo.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kompass_core_tpu_torch.benchmark.runner import parse_device_args  # noqa: E402
from kompass_core_tpu_torch.control import DWAConfig, TrajectoryCostsWeights  # noqa: E402
from kompass_core_tpu_torch.models import (  # noqa: E402
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet  # noqa: E402
from kompass_core_tpu_torch.serving import (  # noqa: E402
    export_fleet_tick,
    load_artifact,
    read_artifact_header,
)

N, RAYS = 4, 64
TICKS_BEFORE = 6


def build_fleet(device):
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.2, 0.4]),
        )
        for _ in range(N)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0,
                                       max_decel=6.0, max_steer=np.pi),
    )
    config = DWAConfig(
        max_linear_samples=6, max_angular_samples=6,
        prediction_horizon=12, control_horizon=2, control_time_step=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
        ),
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=RAYS, path_capacity=512,
        max_segments=16, device=device,
    )
    fleet.set_paths(
        [np.array([[0.0, 1.5 * i], [5.0, 1.5 * i]]) for i in range(N)]
    )
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, RAYS, endpoint=False))
    return fleet


def inputs(step):
    states = np.zeros((N, 4), np.float32)
    states[:, 0] = 0.05 * step
    states[:, 1] = 1.5 * np.arange(N)
    vels = np.full((N, 3), 0.0, np.float32)
    vels[:, 0] = 0.4
    ranges = np.full((N, RAYS), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, RAYS, endpoint=False)
    return states, vels, ranges, angles


def run(device):
    """Serve, export and snapshot with fleet A on ``device``, restart as
    fleet B through the artifact. Asserts what the JAX demo asserts;
    returns the outcome figures."""
    with tempfile.TemporaryDirectory(prefix="kompass_serving_") as tmp:
        art_path = os.path.join(tmp, "fleet_tick.ktpuart")
        snap_path = os.path.join(tmp, "mission_state.npz")

        # ---- process A: serve 6 ticks, then export + snapshot ----
        fleet_a = build_fleet(device)
        for step in range(TICKS_BEFORE):
            fleet_a.tick(*inputs(step))
        export_fleet_tick(fleet_a, art_path, device=device)
        np.savez(snap_path, **fleet_a.state_dict())
        next_a = fleet_a.tick(*inputs(TICKS_BEFORE))  # what A WOULD do next
        size_kb = os.path.getsize(art_path) // 1024

        # ---- process B: load artifact + snapshot, continue ----
        hdr = read_artifact_header(art_path)
        art = load_artifact(art_path, device=device)
        fleet_b = build_fleet(device)  # config only; mission state from the snapshot
        with np.load(snap_path) as snap:
            fleet_b.load_state_dict(dict(snap))
    # drive B's next tick through the ARTIFACT program
    fleet_b._write_tracked(None)
    s, v, r, _ = inputs(TICKS_BEFORE)
    fleet_b._inputs[:N, :4] = s
    fleet_b._inputs[:N, 4:7] = v
    fleet_b._inputs[:N, 7 : 7 + RAYS] = r
    _, out_mat = art.call(*fleet_b.tick_example_args())
    vx_b = out_mat.cpu().numpy()[:N, 2]

    same = np.array_equal(vx_b, next_a["vx"])
    assert same
    return {"ticks": TICKS_BEFORE, "size_kb": size_kb, "kind": hdr["kind"],
            "robots": hdr["meta"]["n_robots"], "platforms": hdr["platforms"],
            "vx": vx_b, "same": same}


def lines(r):
    """The JAX demo's outcome lines for the figures ``r``."""
    return [
        f"A served {r['ticks']} ticks, exported artifact "
        f"({r['size_kb']} KiB) + snapshot",
        f"B inventory: kind={r['kind']} robots={r['robots']} "
        f"platforms={r['platforms']}",
        f"B's first post-restart commands: {np.round(r['vx'], 4)}",
        f"bit-identical to A's next tick: {r['same']}",
    ]


def main(argv=None):
    device, _ = parse_device_args(
        argparse.ArgumentParser(prog="serving_restart_demo.py"), argv)
    for line in lines(run(device)):
        print(line)
    print("serving restart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
