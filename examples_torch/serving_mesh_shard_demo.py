"""Shard at the serving site on the PyTorch port: one single-device fleet
artifact, N devices.

The build box exports the fleet-tick program for a SHARD-sized fleet
(here 4 robots) as a hermetic artifact. The serving box loads that one
artifact and drives a 4x-larger fleet by row-chunking the argument tree
across its devices (``serving.sharded_fleet_call``): the tick is
row-local per robot (one static obstacle sweep per shard), so serving
on many devices needs no sharded program, no re-trace and no mesh-aware
export. The demo verifies that the sharded outputs are bit-identical to
a monolithic live fleet of the full size.

The serving devices are 4 shards of the one device given (the same card,
or the CPU, 4 times).

Run: python examples_torch/serving_mesh_shard_demo.py [--device cpu]
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
    sharded_fleet_call,
)

N_SHARD, N_DEV, RAYS = 4, 4, 64


def build_fleet(n, device):
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.2, 0.4]),
        )
        for _ in range(n)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=RAYS, path_capacity=512,
        max_segments=16, device=device,
    )
    fleet.set_paths([
        np.array([[0.0, 2.0 * i], [4.0, 2.0 * i]]) for i in range(n)
    ])
    fleet.set_scan_angles(
        np.linspace(0, 2 * np.pi, RAYS, endpoint=False)
    )
    fleet._inputs[:n, 0] = 0.1
    fleet._inputs[:n, 1] = 2.0 * np.arange(n)
    fleet._inputs[:n, 7:] = 10.0
    return fleet


def run(device):
    """Export the shard-sized tick on ``device``, serve the 16-robot fleet
    over 4 shards of it and hold the result against the monolithic live
    tick. Asserts what the JAX demo asserts; returns the outcome
    figures."""
    devices = [device] * N_DEV

    # --- build box: export the shard-sized program --------------------
    shard_fleet = build_fleet(N_SHARD, device)
    with tempfile.TemporaryDirectory() as tmp:
        art_path = os.path.join(tmp, "fleet_shard.ktpuart")
        header = export_fleet_tick(shard_fleet, art_path, device=device)
        size = os.path.getsize(art_path)

        # --- serving box: one artifact, N_DEV devices -----------------
        art = load_artifact(art_path, device=device)
    full = build_fleet(N_SHARD * N_DEV, device)  # state lives host/device-side
    args = full.tick_example_args()
    carry, out = sharded_fleet_call(art, args, devices)

    # ground truth: the monolithic live program on the full fleet
    live_carry, live_out = full._tick_fn(*args)
    np.testing.assert_array_equal(live_out.cpu().numpy(), out)
    for a, b in zip(live_carry, carry):
        np.testing.assert_array_equal(a.cpu().numpy(), b)
    return {"kind": header["kind"], "robots": header["meta"]["n_robots"],
            "path": art_path, "bytes": size, "served": out.shape[0],
            "devices": N_DEV}


def lines(r):
    """The JAX demo's outcome lines for the figures ``r``."""
    return [
        f"exported {r['kind']} for {r['robots']} robots -> {r['path']} "
        f"({r['bytes']} bytes)",
        f"served {r['served']} robots across {r['devices']} devices with the "
        f"{r['robots']}-robot artifact (one async dispatch per device)",
        "sharded serving outputs are bit-identical to the monolithic fleet",
    ]


def main(argv=None):
    device, _ = parse_device_args(
        argparse.ArgumentParser(prog="serving_mesh_shard_demo.py"), argv)
    for line in lines(run(device)):
        print(line)
    print("SERVING MESH SHARD DEMO PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
