"""Offline tooling walkthrough on the PyTorch port: record -> persist ->
calibrate -> evaluate.

Mirrors the reference front-end's offline workflows end to end:

1. drive a simulated robot and record its path + motion
   (``py_path_tools.PathExecutor``),
2. persist/reload the path through the reference "Points" XML schema,
3. fit the kinematic motion model from the recording
   (``calibration.Calibration``) and replay it,
4. evaluate a Stanley controller on a canonical path
   (``performance.MotionEvaluation``),
5. rasterize a PCD point cloud into an occupancy grid
   (``datatypes.get_occupancy_grid_from_pcd``).

A host workflow: it runs on the CPU, launches no kernel and takes no
device.

Run: python examples_torch/offline_pipeline_demo.py
"""

import argparse
import math
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kompass_core_tpu_torch.calibration import Calibration  # noqa: E402
from kompass_core_tpu_torch.control import Stanley, StanleyConfig  # noqa: E402
from kompass_core_tpu_torch.datatypes import get_occupancy_grid_from_pcd  # noqa: E402
from kompass_core_tpu_torch.models import (  # noqa: E402
    AngularCtrlLimits,
    LinearCtrlLimits,
    MotionModel2D,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch.performance import MotionEvaluation  # noqa: E402
from kompass_core_tpu_torch.py_path_tools import (  # noqa: E402
    PathExecutor,
    PathExecutorParams,
)
from kompass_core_tpu_torch.simulation import MotionPaths, RobotSim  # noqa: E402


def run(out_dir=None):
    """The five steps, writing their files to ``out_dir`` (a new temporary
    directory by default). Asserts what the JAX demo asserts; returns the
    outcome figures."""
    out_dir = out_dir or tempfile.mkdtemp(prefix="kompass_offline_")

    # 1. simulate a drive with a slightly miscalibrated base and record it
    true_model = MotionModel2D(x_dot_prop_vx=0.92, yaw_dot_prop_omega=0.85)
    sim = RobotSim(model=true_model)
    n = 300
    vx = np.full(n, 0.5)
    omega = 0.4 * np.sin(np.linspace(0, 2 * math.pi, n))
    motion = sim.simulate_motion(vx, omega, time_step=0.05)

    executor = PathExecutor(PathExecutorParams(min_segment_length=0.02))
    executor.start_path_recording()
    executor.start_motion_recording(
        recording_period=n * 0.05, recording_step=0.05
    )
    for i in range(n):
        executor.record_path_point(
            motion.x_points[i],
            motion.y_points[i],
            motion.heading_points[i],
            vel=float(vx[i]),
        )
        executor.record_motion_point(
            motion.x_points[i],
            motion.y_points[i],
            motion.heading_points[i],
            time=float(motion.time_points[i]),
            linear_ctr_x=float(vx[i]),
            linear_ctr_y=0.0,
            angular_ctr=float(omega[i]),
        )

    # 2. persist + reload through the reference XML schema and csv
    assert executor.save_path_to_xml(out_dir, "recorded_path", frame_id="map")
    assert executor.save_motion_to_csv(out_dir, "recorded_motion")
    reloaded = PathExecutor()
    assert reloaded.read_path_from_xml(out_dir, "recorded_path")

    # 3. calibrate the motion model from the recording and replay it
    fitted = Calibration.calibrate_data(motion)
    _, rms = Calibration.simulate_calibrated_model_data(motion, fitted)

    # 4. closed-loop controller evaluation on a canonical path
    robot = Robot(
        robot_type=RobotType.ACKERMANN,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.15, 0.4]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=10.0, max_decel=10.0, max_steer=math.pi / 3
        ),
    )
    controller = Stanley(
        robot=robot,
        ctrl_limits=limits,
        config=StanleyConfig(wheel_base=robot.wheelbase),
    )
    evaluation = MotionEvaluation(robot=robot)
    result = evaluation.run_test(
        controller,
        MotionPaths.generate_circle_path(radius=3.0, arc=math.pi),
        max_steps=600,
    )
    evaluation.export(out_dir, "stanley_eval")

    # 5. PCD -> occupancy grid
    pcd = os.path.join(out_dir, "room.pcd")
    rng = np.random.default_rng(0)
    walls = np.concatenate(
        [
            np.stack(
                [np.full(60, 3.9), np.linspace(0, 3.9, 60), np.full(60, 0.8)],
                axis=1,
            ),
            np.stack(
                [np.linspace(0, 3.9, 60), np.full(60, 3.9), np.full(60, 0.8)],
                axis=1,
            ),
            # floor returns
            np.column_stack(
                [rng.uniform(0, 4, 200), rng.uniform(0, 4, 200), np.zeros(200)]
            ),
        ]
    ).astype(np.float32)
    with open(pcd, "w") as f:
        f.write(
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
            f"COUNT 1 1 1\nWIDTH {len(walls)}\nHEIGHT 1\n"
            f"POINTS {len(walls)}\nDATA ascii\n"
        )
        for p in walls:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
    grid, origin = get_occupancy_grid_from_pcd(
        pcd, grid_resolution=0.2, z_ground_limit=0.1, robot_height=2.0
    )
    return {
        "out_dir": out_dir, "recorded": len(executor.ref_path),
        "length": executor.total_length, "reloaded": len(reloaded.ref_path),
        "x_dot_prop_vx": fitted.x_dot_prop_vx, "yaw_dot_prop": fitted.yaw_dot_prop,
        "rms": rms, "reached": result.reached_end,
        "lateral_error": result.lateral_error_mean,
        "time_to_goal": result.time_to_goal, "grid_shape": grid.shape,
        "occupied": int(np.count_nonzero(grid == 100)),
        "free": int(np.count_nonzero(grid == 0)), "origin": origin[:2],
    }


def lines(r):
    """The JAX demo's outcome lines for the figures ``r``."""
    return [
        f"artifacts -> {r['out_dir']}",
        f"recorded {r['recorded']} path points, total length {r['length']:.2f} m",
        f"reloaded {r['reloaded']} points from XML",
        "fitted model: "
        f"x_dot_prop_vx={r['x_dot_prop_vx']:.3f} (true 0.92), "
        f"yaw_dot_prop={r['yaw_dot_prop']:.3f} (true 0.85)",
        f"replay RMS position error: {r['rms']:.4f} m",
        f"Stanley on half-circle: reached={r['reached']}, mean lateral error "
        f"{r['lateral_error']:.3f} m, time-to-goal {r['time_to_goal']:.1f} s",
        f"PCD grid {r['grid_shape']}: {r['occupied']} occupied / {r['free']} free "
        f"cells, origin {r['origin']}",
    ]


def main(argv=None):
    argparse.ArgumentParser(prog="offline_pipeline_demo.py").parse_args(argv)
    for line in lines(run()):
        print(line)
    print("offline pipeline demo OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
