"""Dynamic-world pipeline on the PyTorch port: vision tracker ->
predictive local planner.

A pedestrian crosses the robot's aisle. Each tick:
  1. a (simulated) detector yields a noisy 3D bbox of the pedestrian;
  2. `FeatureBasedBboxTracker` Kalman-filters it (position + velocity);
  3. the filtered track becomes an obstacle disc with per-point
     velocities (`DWA.tracked_obstacle_disc`);
  4. the moving-obstacle DWA (`DWAConfig(moving_obstacles=True)`, one
     moving-obstacle sweep per solve) evaluates collision + obstacle cost
     against the pedestrian's PREDICTED positions along the rollout and
     steers clear of a spot that is currently empty.

Run: python examples_torch/dynamic_world_demo.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kompass_core_tpu_torch.benchmark.runner import parse_device_args  # noqa: E402
from kompass_core_tpu_torch.control import (  # noqa: E402
    DWA,
    DWAConfig,
    TrajectoryCostsWeights,
)
from kompass_core_tpu_torch.datatypes.tracking import Bbox3D  # noqa: E402
from kompass_core_tpu_torch.models import (  # noqa: E402
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch.vision.tracker import FeatureBasedBboxTracker  # noqa: E402

TICKS = 200
REPORT_EVERY = 20


def run(device):
    """Drive the pedestrian crossing on ``device``. Asserts what the JAX
    demo asserts; returns the outcome figures: the tick the goal was
    reached, the least clearance and the status of every 20th tick."""
    rng = np.random.default_rng(0)
    dt = 0.1

    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.2, 0.5]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0,
                                       max_decel=6.0, max_steer=np.pi),
    )
    dwa = DWA(
        robot=robot, ctrl_limits=limits,
        config=DWAConfig(
            max_linear_samples=8, max_angular_samples=8,
            prediction_horizon=20, control_horizon=2,
            control_time_step=dt, moving_obstacles=True,
            costs_weights=TrajectoryCostsWeights(
                reference_path_distance_weight=2.0,
                goal_distance_weight=1.0,
                obstacles_distance_weight=0.5,
                smoothness_weight=0.0, jerk_weight=0.0,
            ),
        ),
        device=device,
    )
    dwa.set_path(np.array([[0.0, 0.0], [6.0, 0.0]]))

    tracker = FeatureBasedBboxTracker(
        time_step=dt, e_pos=0.05, e_vel=0.1, e_acc=0.2,
    )

    # ground truth pedestrian: crossing the aisle at 0.5 m/s
    ped = np.array([3.0, 1.5, 0.0])
    ped_v = np.array([0.0, -0.5, 0.0])

    def detect(tick):
        """Noisy 3D detection of the pedestrian (stands in for the
        DepthDetector; see vision_follow_demo.py for the image-space
        pipeline)."""
        c = ped + rng.normal(0.0, 0.02, 3)
        return Bbox3D(
            center=c.astype(np.float32),
            size=np.array([0.5, 0.5, 1.7], np.float32),
            timestamp=float(tick) * dt,
        )

    x = y = yaw = 0.0
    vx = 0.5
    min_clearance = np.inf
    trace, goal_tick = [], None
    for tick in range(TICKS):
        det = detect(tick)
        if not tracker.tracker_initialized():
            tracker.set_initial_tracking_box(det)
        else:
            tracker.update_tracking([det])

        dwa.set_current_state(x, y, yaw)
        if dwa.reached_end():
            goal_tick = tick
            break

        tracked = tracker.get_raw_tracking()
        if tracked is not None and tracker.tracker_initialized():
            pts, vels = DWA.tracked_obstacle_disc(
                tracked.box.center[:2], 0.3, tracked.vel[:2], ring=8
            )
            res = dwa.compute_velocity_commands(
                (vx, 0.0, 0.0), map_points_world=pts,
                obstacle_velocities_world=vels,
            )
        else:
            res = dwa.compute_velocity_commands(
                (vx, 0.0, 0.0),
                map_points_world=np.zeros((0, 2), np.float32),
            )
        if res.is_found:
            vx = float(res.trajectory.vx[0])
            om = float(res.trajectory.omega[0])
            yaw += om * dt
            x += vx * np.cos(yaw) * dt
            y += vx * np.sin(yaw) * dt
        else:
            vx = 0.0  # robot holds; the WORLD keeps moving below
        ped = ped + ped_v * dt
        min_clearance = min(
            min_clearance, float(np.hypot(x - ped[0], y - ped[1]))
        )
        if tick % REPORT_EVERY == 0:
            est_v = tracked.vel[:2] if tracked is not None else (0, 0)
            trace.append({"t": tick * dt, "x": x, "y": y, "ped_x": ped[0],
                          "ped_y": ped[1], "est_vx": est_v[0],
                          "est_vy": est_v[1], "vx": vx})
    if goal_tick is None:
        raise SystemExit("goal not reached")
    assert min_clearance > 0.5, f"too close: {min_clearance:.3f} m"
    return {"goal_tick": goal_tick, "min_clearance": min_clearance,
            "trace": trace}


def lines(r):
    """The JAX demo's outcome lines for the figures ``r``."""
    out = [
        f"t={s['t']:4.1f}s robot=({s['x']:5.2f},{s['y']:5.2f}) "
        f"ped=({s['ped_x']:4.2f},{s['ped_y']:5.2f}) "
        f"est_v=({s['est_vx']:+.2f},{s['est_vy']:+.2f}) vx={s['vx']:.2f}"
        for s in r["trace"]
    ]
    out.append(f"goal reached at tick {r['goal_tick']}; min pedestrian "
               f"clearance {r['min_clearance']:.3f} m")
    return out


def main(argv=None):
    device, _ = parse_device_args(
        argparse.ArgumentParser(prog="dynamic_world_demo.py"), argv)
    for line in lines(run(device)):
        print(line)
    print("dynamic-world pipeline OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
