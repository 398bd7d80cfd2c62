"""Full-stack demo on the PyTorch port: global planning -> DWA following
-> mapping -> e-stop.

A robot in a room with a wall must reach a goal behind it:

1. `GlobalPlanner` (PRM) plans a path around the wall from a point-cloud
   map of the room.
2. `DWA` follows the planned path in closed loop, with the wall visible in
   the simulated laser scan (one obstacle sweep per solve).
3. `LocalMapper` builds the egocentric occupancy grid each tick (one
   scan-to-grid pass per update).
4. `EmergencyChecker` monitors the critical zone.

Run: python examples_torch/full_stack_demo.py [--device cpu]
"""

import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kompass_core_tpu_torch.benchmark.runner import parse_device_args  # noqa: E402
from kompass_core_tpu_torch.control import (  # noqa: E402
    DWA,
    DWAConfig,
    TrajectoryCostsWeights,
)
from kompass_core_tpu_torch.datatypes import LaserScanData  # noqa: E402
from kompass_core_tpu_torch.datatypes.pose import PoseData  # noqa: E402
from kompass_core_tpu_torch.datatypes.scan_model import ScanModelConfig  # noqa: E402
from kompass_core_tpu_torch.mapping import (  # noqa: E402
    OCCUPANCY_TYPE,
    LocalMapper,
    MapConfig,
)
from kompass_core_tpu_torch.models import (  # noqa: E402
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch.planning import (  # noqa: E402
    GlobalPlanner,
    GlobalPlannerConfig,
)
from kompass_core_tpu_torch.utils.emergency_stop import EmergencyChecker  # noqa: E402

# --- world: 10x10 room with a wall at y=5 (gap at x in [7, 9]) -------------

WALL_SEGMENTS = [  # (x0, y0, x1, y1)
    (0, 0, 10, 0), (0, 10, 10, 10), (0, 0, 0, 10), (10, 0, 10, 10),  # walls
    (0, 5, 7, 5),  # interior wall with a gap at x in (7, 10)
]
START = (2.0, 2.0)
GOAL = (2.0, 8.0)
MAX_STEPS = 600


def raycast(x, y, yaw, angles, max_range=12.0):
    """Exact 2D raycast of the world's segments."""
    ranges = np.full(len(angles), max_range)
    for i, a in enumerate(angles):
        dx, dy = math.cos(yaw + a), math.sin(yaw + a)
        best = max_range
        for x0, y0, x1, y1 in WALL_SEGMENTS:
            ex, ey = x1 - x0, y1 - y0
            denom = dx * ey - dy * ex  # d x e
            if abs(denom) < 1e-12:
                continue
            sx, sy = x0 - x, y0 - y
            t = (sx * ey - sy * ex) / denom  # (s0-p) x e / (d x e)
            u = (sx * dy - sy * dx) / denom  # (s0-p) x d / (d x e)
            if t > 1e-6 and 0.0 <= u <= 1.0:
                best = min(best, t)
        ranges[i] = best
    return ranges


def wall_cloud():
    pts = []
    for x0, y0, x1, y1 in WALL_SEGMENTS:
        n = int(math.hypot(x1 - x0, y1 - y0) / 0.05) + 1
        t = np.linspace(0, 1, n)
        pts.append(
            np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0), np.zeros(n)], 1)
        )
    return np.concatenate(pts)


def make_robot():
    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.2, 0.5]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.5, max_acc=5.0, max_decel=5.0),
    )
    return robot, limits


def plan(device):
    """The PRM path around the wall on ``device``: (path [N, 2], its arc
    length)."""
    robot, _ = make_robot()
    planner = GlobalPlanner(
        robot,
        config=GlobalPlannerConfig(
            planner_id="PRM", num_samples=512, seed=2, connection_radius=4.0,
            # margin must exceed the e-stop's critical reach beyond the
            # robot radius (emergency_distance 0.25 + radius 0.2 = 0.45 m
            # from obstacle points): a 0.1 m margin lets the shortcut
            # route graze a wall-gap corner inside the critical cone, and
            # the e-stop then freezes forward motion for good
            margin=0.5,
        ),
        device=device,
    )
    meta = {"resolution": 0.1, "width": 100, "height": 100,
            "origin_x": 0.0, "origin_y": 0.0}
    planner.setup_problem(meta, *START, 0.0, *GOAL, 0.0, wall_cloud())
    path = planner.solve()
    assert path is not None, "global planner found no path"
    return path, planner.path_cost


def path_length(path):
    """Arc length of an [N, 2] path (``GlobalPlanner.path_cost``'s)."""
    return float(np.hypot(*np.diff(np.asarray(path), axis=0).T).sum())


def run(device, plan_path=None):
    """Plan (or take ``plan_path``, an [N, 2] world path), then follow it
    with DWA while mapping and monitoring the critical zone, on
    ``device``. Asserts what the JAX demo asserts; returns the outcome
    figures."""
    if plan_path is None:
        path, cost = plan(device)
    else:
        path, cost = np.asarray(plan_path), path_length(plan_path)
    assert cost > 7.0  # must detour through the gap

    robot, limits = make_robot()
    config = DWAConfig(
        max_linear_samples=8,
        max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=1.0,
            smoothness_weight=0.0,
            jerk_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
        max_point_interpolation_distance=0.05,
    )
    dwa = DWA(robot=robot, ctrl_limits=limits, config=config, device=device)
    dwa.set_path(path)
    mapper = LocalMapper(
        MapConfig(width=6.0, height=6.0, resolution=0.1),
        ScanModelConfig(p_prior=0.5),
        device=device,
    )
    estop = EmergencyChecker(
        robot, emergency_distance=0.25, slowdown_distance=0.5,
        emergency_angle=120.0, device=device,
    )

    robot.state.x, robot.state.y, robot.state.yaw = START[0], START[1], math.pi / 2
    angles = np.linspace(-np.pi, np.pi, 180, endpoint=False)
    min_slowdown = 1.0
    steps = 0
    while steps < MAX_STEPS and not dwa.reached_end():
        ranges = raycast(robot.state.x, robot.state.y, robot.state.yaw, angles)
        scan = LaserScanData(ranges=ranges, angles=angles)

        factor = estop.run(scan=scan, forward=True)
        min_slowdown = min(min_slowdown, factor)

        pose = PoseData()
        pose.set_position(robot.state.x, robot.state.y)
        pose.set_yaw(robot.state.yaw)
        mapper.update_from_scan(pose, scan)

        if not dwa.loop_step(current_state=robot.state, laser_scan=scan):
            break
        for vx, vy, om in zip(
            dwa.linear_x_control, dwa.linear_y_control, dwa.angular_control
        ):
            robot.set_control(velocity_x=vx * factor, velocity_y=vy * factor,
                              omega=om)
            robot.get_state(dt=0.1)
            steps += 1
            if dwa.reached_end():
                break

    n_occ = int(np.sum(mapper.occupancy == OCCUPANCY_TYPE.OCCUPIED.value))
    result = {
        "waypoints": len(path), "path_cost": cost, "reached": dwa.reached_end(),
        "steps": steps, "final_x": robot.state.x, "final_y": robot.state.y,
        "occupied": n_occ, "min_slowdown": min_slowdown,
    }
    assert result["reached"], "robot did not reach the goal"
    assert n_occ > 20, "mapper saw no walls"
    assert math.hypot(robot.state.x - GOAL[0], robot.state.y - GOAL[1]) < 0.5
    return result


def lines(r):
    """The JAX demo's outcome lines for the figures ``r``."""
    return [
        f"[plan] {r['waypoints']} waypoints, cost {r['path_cost']:.2f} m "
        "(straight-line would be 6.0 m, blocked)",
        f"[follow] reached={r['reached']} steps={r['steps']} "
        f"final=({r['final_x']:.2f},{r['final_y']:.2f}) goal={GOAL}",
        f"[map] occupied cells in last egocentric grid: {r['occupied']}",
        f"[estop] min slowdown factor seen: {r['min_slowdown']:.2f}",
    ]


def main(argv=None):
    device, _ = parse_device_args(
        argparse.ArgumentParser(prog="full_stack_demo.py"), argv)
    t_start = time.time()
    for line in lines(run(device)):
        print(line, flush=True)
    print(f"[demo] wall clock {time.time() - t_start:.1f} s", flush=True)
    print("FULL STACK DEMO PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
