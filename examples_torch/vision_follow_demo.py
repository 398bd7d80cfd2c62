"""Vision target-following demo on the PyTorch port: RGB (image-space) and
RGBD (3D) loops.

Simulates a target walking across the camera's view and a robot that
must keep it centered and at range (the reference's `rgb_follower` /
`rgbd_follower` scenario) driven through the port's public controllers:

* **RGB stage**: a 2D bounding box drifts off-center; the follower's
  P-control on (size-ratio, center error) must steer it back and report
  shrinking errors.
* **Target-lost stage**: detections stop; the follower must enter its
  rotate/pause search state machine and emit nonzero angular commands.
* **RGBD stage**: 3D detections with a Kalman-tracked pose; the
  pure-tracking control must close distance toward the standoff range.

The followers are host controllers: they run on the CPU and launch no
kernel, so the demo takes no device.

Run: python examples_torch/vision_follow_demo.py
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kompass_core_tpu_torch.control import (  # noqa: E402
    VisionRGBDFollower,
    VisionRGBDFollowerConfig,
    VisionRGBFollower,
    VisionRGBFollowerConfig,
)
from kompass_core_tpu_torch.datatypes.tracking import Bbox2D, Bbox3D  # noqa: E402
from kompass_core_tpu_torch.models import (  # noqa: E402
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotState,
    RobotType,
)


def make_robot():
    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.2, 0.4]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=1.5, max_acc=3.0, max_decel=3.0),
    )
    return robot, limits


def box(cx, cy=240.0, size=120):
    b = Bbox2D(
        top_left_corner=np.array([cx - size / 2, cy - size / 2]),
        size=np.array([size, size]),
    )
    b.set_img_size(np.array([640, 480]))
    return b


def rgb_stage():
    """The RGB and target-lost stages; returns their figures."""
    robot, limits = make_robot()
    follower = VisionRGBFollower(
        robot=robot,
        ctrl_limits=limits,
        config=VisionRGBFollowerConfig(control_time_step=0.1),
    )
    follower.set_initial_tracking_2d_target(box(320, 240))

    # target drifts to the right of the image; the follower must produce
    # a command turning toward it (negative omega for right-of-center
    # under the image-frame convention) and shrink the error over time
    cx = 440.0
    errs = []
    for _ in range(25):
        ok = follower.loop_step(detections_2d=[box(cx)])
        assert ok, "target visible but follower reported failure"
        omega = follower.angular_control[0]
        # close the loop: camera pans with the robot's rotation
        cx += omega * 0.1 * (640 / 1.5)
        errs.append(abs(follower.orientation_error))
    omega_now = follower.angular_control[0]
    assert errs[-1] < errs[0] * 0.5, "error did not shrink"

    # lost target -> search state machine must emit rotation commands
    search_cmds = []
    for _ in range(10):
        found = follower.loop_step(detections_2d=None)
        if found:
            search_cmds.append(follower.angular_control[0])
    assert any(abs(w) > 1e-3 for w in search_cmds), "no search rotation"
    return {"error_first": errs[0], "error_last": errs[-1],
            "omega": omega_now, "search_commands": len(search_cmds)}


def rgbd_stage():
    """The RGBD stage; returns its figures."""
    robot, limits = make_robot()
    cfg = VisionRGBDFollowerConfig(
        control_time_step=0.1, target_distance=1.0
    )
    follower = VisionRGBDFollower(robot=robot, ctrl_limits=limits, config=cfg)
    follower.set_camera_intrinsics(500.0, 500.0, 320.0, 240.0)

    def target_at(x, y, t=0.0):
        return Bbox3D(
            center=np.array([x, y, 0.0], np.float32),
            size=np.array([0.4, 0.4, 1.6], np.float32),
            center_img_frame=np.array([320.0, 240.0]),
            size_img_frame=np.array([120, 240]),
            timestamp=t,
            label="person",
        )

    assert follower.set_initial_tracking_3d(320, 240, [target_at(3.0, 0.0)])
    x_rel = 3.0
    dists = [x_rel]
    for k in range(40):
        ok = follower.loop_step(
            detections_3d=[target_at(x_rel, 0.0, t=0.1 * (k + 1))],
            current_state=RobotState(x=0.0, y=0.0, yaw=0.0, speed=0.0),
        )
        assert ok
        vx = follower.linear_x_control[0]
        x_rel -= vx * 0.1  # robot closes on a static target
        dists.append(x_rel)
    assert dists[-1] < 1.6, "did not approach the standoff range"
    return {"distance_first": dists[0], "distance_last": dists[-1],
            "standoff": cfg.target_distance}


def run():
    """The three stages on the host. Asserts what the JAX demo asserts;
    returns the outcome figures."""
    return {**rgb_stage(), **rgbd_stage()}


def lines(r):
    """The JAX demo's outcome lines for the figures ``r``."""
    return [
        f"[rgb] off-center target recentred: orientation error "
        f"{r['error_first']:.3f} -> {r['error_last']:.3f} (omega now "
        f"{r['omega']:+.3f})",
        f"[rgb] target lost -> search state machine issued "
        f"{r['search_commands']} rotate/pause commands",
        f"[rgbd] distance to target {r['distance_first']:.2f} m -> "
        f"{r['distance_last']:.2f} m (standoff {r['standoff']} m)",
    ]


def main(argv=None):
    argparse.ArgumentParser(prog="vision_follow_demo.py").parse_args(argv)
    for line in lines(run()):
        print(line)
    print("VISION FOLLOW DEMO PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
