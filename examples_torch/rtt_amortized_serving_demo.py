"""RTT-amortized serving on the PyTorch port: one robot, K control ticks
per host round trip.

A blocking single solve costs a host round trip per command. The
supported answer is ``DeviceFleet.run_ticks_on_device(k)``: the scan is
frozen to world obstacles at the tick-0 pose, K solve->apply->integrate
ticks run in one call (one CUDA graph replay on the card, a static
obstacle sweep per tick), and the host gets K commands back per round
trip.

Run: python examples_torch/rtt_amortized_serving_demo.py [k] [--device cpu]
"""

import argparse
import os
import sys
import time

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

N_RAYS = 128
N_SINGLE = 5  # timed single-tick round trips
N_BATCHES = 5  # timed k-tick round trips


def run(device, k=8, timings=None):
    """Serve one robot on ``device`` tick by tick and k ticks per call;
    returns the outcome figures (k and the last call's k commands).
    ``timings``, a dict, receives the ms per tick of each way."""
    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.1, 0.4]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=8,
        max_angular_samples=8,
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0
        ),
    )
    fleet = DeviceFleet([robot], limits, config, scan_rays=N_RAYS,
                        path_capacity=512, max_segments=16, device=device)
    fleet.set_paths([np.array([[0.0, 0.0], [0.0, 3.0]])])
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)

    state = np.array([[0.0, 0.0, np.pi / 2, 0.0]])
    vel = np.zeros((1, 3))
    ranges = np.full((1, N_RAYS), 10.0)

    # warm both programs (the card's first k-tick call captures its graph)
    fleet.run_ticks_on_device(k, state, vel, ranges, angles)
    fleet.tick(state, vel, ranges, angles)

    # --- single-tick serving: one round trip per command ---
    t0 = time.perf_counter()
    s = state.copy()
    for _ in range(N_SINGLE):
        s[0, 0] += 1e-4  # distinct inputs
        fleet.tick(s, vel, ranges, angles)
    per_tick_single = (time.perf_counter() - t0) / N_SINGLE * 1e3

    # --- K-tick serving: one round trip per K commands ---
    t0 = time.perf_counter()
    for _ in range(N_BATCHES):
        s[0, 0] += 1e-4
        out = fleet.run_ticks_on_device(k, s, vel, ranges, angles)
    per_tick_k = (time.perf_counter() - t0) / (N_BATCHES * k) * 1e3
    if timings is not None:
        timings.update(single_ms=per_tick_single, k_ms=per_tick_k)
    return {"k": k, "vx": out["vx"][0]}


def lines(r):
    """The JAX demo's outcome line for the figures ``r`` (its two timing
    lines are not among them)."""
    return [f"commands per round trip: vx={np.round(r['vx'], 3)}"]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="rtt_amortized_serving_demo.py")
    parser.add_argument("k", nargs="?", type=int, default=8)
    device, args = parse_device_args(parser, argv)
    timings = {}
    r = run(device, args.k, timings=timings)
    single, per_k = timings["single_ms"], timings["k_ms"]
    print(f"single-tick serving : {single:7.2f} ms/tick e2e")
    print(f"k={args.k:<3d} tick serving : {per_k:7.2f} ms/tick e2e "
          f"({single / max(per_k, 1e-9):.1f}x)")
    for line in lines(r):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
