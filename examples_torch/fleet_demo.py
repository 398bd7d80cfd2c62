"""Fleet demo on the PyTorch port: N robots controlled by one device
dispatch per tick.

Spawns a row of robots, each with its own straight path, and drives them
all with the device-resident `DeviceFleet` (whole follower pipeline on
the device, one static obstacle sweep per tick; pass --host to use the
host-follower `FleetRuntime` instead).

Pass --peers for the fleet-mutual-avoidance showcase: robots run in
CROSSING pairs (X-shaped paths that intersect at the center) with
`peer_avoidance=True`: each robot sees the others as live obstacle discs
on the device, and the demo verifies no two robots ever get closer than
the contact distance. --predict also advects the peer discs along their
commanded velocities within every rollout (the moving-obstacle sweep).

Pass --mesh to run the peer scenario with the robot axis sharded over a
fleet mesh of 8 shards of the one device: the peer state crosses the
shards as one all-gather per tick.

Run: python examples_torch/fleet_demo.py [num_robots] [--host|--peers|--predict|--mesh] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kompass_core_tpu_torch.benchmark.runner import parse_device_args  # noqa: E402
from kompass_core_tpu_torch.control import DWAConfig, TrajectoryCostsWeights  # noqa: E402
from kompass_core_tpu_torch.datatypes import LaserScanData  # noqa: E402
from kompass_core_tpu_torch.models import (  # noqa: E402
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch.parallel import (  # noqa: E402
    DeviceFleet,
    FleetRuntime,
    build_fleet_mesh,
)

MESH_SHARDS = 8
N_RAYS = 72
LANE_TICKS = 80
CROSSING_TICKS = 150


def _limits():
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )


def run(device, n_robots=100, host_mode=False, peers=False, predict=False,
        mesh=False, timings=None):
    """Drive the fleet on ``device`` in the JAX demo's mode. Asserts what
    the JAX demo asserts; returns the outcome figures. ``timings``, a
    dict, receives the steady tick's seconds (lane modes)."""
    if peers or predict or mesh:
        return run_peers(device, n_robots, predict=predict, use_mesh=mesh)
    robots = [
        Robot(
            robot_type=RobotType.ACKERMANN,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = _limits()
    config = DWAConfig(
        max_linear_samples=8,
        max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    if host_mode:
        fleet = FleetRuntime(robots, limits, config, device=device)
    else:
        fleet = DeviceFleet(
            robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
            max_segments=16, device=device,
        )

    paths = []
    for i, robot in enumerate(robots):
        x0 = 1.0 * i
        robot.state.x, robot.state.y, robot.state.yaw = x0, 0.0, np.pi / 2
        paths.append(np.array([[x0, 0.0], [x0, 3.0]]))
    fleet.set_paths(paths)

    reached = np.zeros(n_robots, bool)
    tick_times = []
    scans = [LaserScanData(ranges=np.full(N_RAYS, 10.0), angles=angles)] * n_robots
    ranges = np.full((n_robots, N_RAYS), 10.0)
    for _ in range(LANE_TICKS):
        if host_mode:
            results = fleet.tick([r.state for r in robots], scans)
            found = [r["found"] for r in results]
            vx = [r.get("vx", 0.0) for r in results]
            vy = [r.get("vy", 0.0) for r in results]
            om = [r.get("omega", 0.0) for r in results]
            reached |= np.array(
                [r.get("reason") == "goal_reached" for r in results]
            )
        else:
            states = np.array(
                [[r.state.x, r.state.y, r.state.yaw, r.state.speed]
                 for r in robots]
            )
            vels = np.array(
                [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
            )
            out = fleet.tick(states, vels, ranges, angles)
            found, vx, vy, om = out["found"], out["vx"], out["vy"], out["omega"]
            reached |= out["reached"]
        tick_times.append(fleet.last_tick_seconds)
        for i, robot in enumerate(robots):
            if not reached[i] and found[i]:
                robot.set_control(
                    velocity_x=vx[i], velocity_y=vy[i], omega=om[i]
                )
                robot.get_state(dt=0.1)
        if reached.all():
            break
    if timings is not None:
        timings["steady_tick_s"] = float(
            np.median(tick_times[2:]) if len(tick_times) > 3 else tick_times[-1])
    result = {"mode": "host-follower" if host_mode else "device-resident",
              "reached": int(reached.sum()), "robots": n_robots,
              "ticks": len(tick_times)}
    assert reached.sum() >= n_robots - 1
    return result


def run_peers(device, n_robots=8, predict=False, use_mesh=False):
    """Fleet mutual avoidance: crossing pairs, on-device peer discs.
    With ``predict``, peer discs also advect along their live commanded
    velocities within every rollout (peer motion prediction). With
    ``use_mesh``, the fleet shards over a mesh of 8 shards of ``device``:
    mutual avoidance then runs across the shards via one all-gather of
    the [N, 7] peer state per tick."""
    mesh = build_fleet_mesh([device] * MESH_SHARDS) if use_mesh else None
    n_robots = max(2, (n_robots // 2) * 2)
    radius = 0.3
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([radius, 0.4]),
        )
        for _ in range(n_robots)
    ]
    config = DWAConfig(
        max_linear_samples=6,
        max_angular_samples=6,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=1.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    fleet = DeviceFleet(
        robots, _limits(), config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16, peer_avoidance=True, peer_prediction=predict,
        mesh=mesh, device=None if use_mesh else device,
    )
    # crossing pairs: an X per pair. The second robot starts 1.2 m
    # earlier along its lane, so the two reach the intersection at
    # different times: the follower then only needs to yield, not to
    # solve a perfectly symmetric stand-off (which a reciprocal planner
    # would deadlock on; DWA has no explicit coordination)
    paths = []
    for p in range(n_robots // 2):
        x0 = 6.0 * p
        a, b = robots[2 * p], robots[2 * p + 1]
        a.state.x, a.state.y, a.state.yaw = x0, 0.0, np.pi / 4
        b.state.x, b.state.y, b.state.yaw = x0 + 3.85, -0.85, 3 * np.pi / 4
        paths.append(np.array([[x0, 0.0], [x0 + 3.0, 3.0]]))
        paths.append(np.array([[x0 + 3.85, -0.85], [x0, 3.0]]))
    fleet.set_paths(paths)

    ranges = np.full((n_robots, N_RAYS), 10.0)
    reached = np.zeros(n_robots, bool)
    min_pair_d = np.inf
    ticks = 0
    for ticks in range(1, CROSSING_TICKS + 1):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, r.state.speed]
             for r in robots]
        )
        vels = np.array(
            [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
        )
        out = fleet.tick(states, vels, ranges, angles)
        reached |= out["reached"]
        for i, robot in enumerate(robots):
            if not reached[i] and out["found"][i]:
                robot.set_control(
                    velocity_x=out["vx"][i], velocity_y=out["vy"][i],
                    omega=out["omega"][i],
                )
                robot.get_state(dt=0.1)
        xy = np.array([[r.state.x, r.state.y] for r in robots])
        d = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
        d[np.arange(n_robots), np.arange(n_robots)] = np.inf
        min_pair_d = min(min_pair_d, float(d.min()))
        if reached.all():
            break
    result = {
        "where": f"sharded over {mesh.size} devices" if mesh is not None
        else "single device",
        "reached": int(reached.sum()), "robots": n_robots, "ticks": ticks,
        "closest": min_pair_d, "contact": 2 * radius,
    }
    assert min_pair_d > 2 * radius, "robots collided!"
    assert reached.sum() >= n_robots - 1
    return result


def lines(r):
    """The JAX demo's outcome lines for the figures ``r`` (the lane modes'
    steady tick, a time, is not among them)."""
    if "closest" in r:
        return [
            f"fleet[peer-avoidance, {r['where']}]: {r['reached']}/"
            f"{r['robots']} robots reached crossing goals in {r['ticks']} ticks; "
            f"closest approach {r['closest']:.2f} m "
            f"(contact = {r['contact']:.2f} m)"
        ]
    return [f"fleet[{r['mode']}]: {r['reached']}/{r['robots']} robots reached "
            f"goals in {r['ticks']} ticks"]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="fleet_demo.py")
    parser.add_argument("num_robots", nargs="?", type=int, default=100)
    for flag in ("--host", "--peers", "--predict", "--mesh"):
        parser.add_argument(flag, action="store_true")
    device, args = parse_device_args(parser, argv)
    timings = {}
    r = run(device, args.num_robots, host_mode=args.host, peers=args.peers,
            predict=args.predict, mesh=args.mesh, timings=timings)
    (line,) = lines(r)
    if "steady_tick_s" in timings:
        steady = timings["steady_tick_s"]
        line += (f"; steady tick {steady * 1e3:.1f} ms "
                 f"({r['robots'] / steady:,.0f} solves/s end-to-end)")
    print(line)
    print("FLEET PEER DEMO PASSED" if "closest" in r else "FLEET DEMO PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
