"""The port's vision followers and vision modules against the JAX
package's, on the CPU.

``vision/`` (Kalman filter, feature-based box tracker, depth detector),
``datatypes/tracking.py`` and ``control/vision_followers.py`` are copies
of the JAX package's JAX-free modules, so they must give the same values
exactly:

- the RGB follower on a drifting, vanishing 2-D target and the RGBD
  follower's core on the moving target of ``test_rgbd_closed_loop.py``
  (local and global coordinates), in lockstep with the JAX package's,
  every command equal;
- the JAX package's own vision tests, run again with every import
  pointed at the port (``port_twin``): ``test_vision.py``,
  ``test_vision_fixtures.py`` (the committed depth-image fixtures),
  ``test_vision_oracle.py`` (the in-repo oracle) and
  ``test_rgbd_closed_loop.py``.
"""

import math

import numpy as np
import pytest

from kompass_core_tpu.control import vision_followers as jvf
from kompass_core_tpu.datatypes import tracking as jtracking
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch.control import vision_followers as tvf
from kompass_core_tpu_torch.datatypes import tracking as ttracking

from test_torch_host_modules import port_twin, twin_tests, to_port

twin_tests(globals(), port_twin("test_vision"))
twin_tests(globals(), port_twin("test_vision_fixtures"))
twin_tests(globals(), port_twin("test_vision_oracle"))
_RGBD = port_twin("test_rgbd_closed_loop")
twin_tests(globals(), _RGBD)

DT = 0.1


def _limits():
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=2.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=4.0, max_acc=3.0,
                                       max_decel=3.0, max_steer=1.57),
    )


def _box2d(tracking, step, img=(640, 480)):
    """A 2-D target drifting right and growing; gone on steps 12-15."""
    if 12 <= step < 16:
        return None
    box = tracking.Bbox2D(top_left_corner=np.array([260 + 9 * step, 180]),
                          size=np.array([60 + 2 * step, 90 + 3 * step]))
    box.set_img_size(np.array(img))
    return box


def test_rgb_follower_lockstep_with_jax():
    robot = Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.2, 0.5]))
    followers = [
        vf.VisionRGBFollower(robot=r, ctrl_limits=lim,
                             config=vf.VisionRGBFollowerConfig(control_time_step=DT))
        for vf, r, lim in ((jvf, robot, _limits()),
                           (tvf, to_port(robot), to_port(_limits())))
    ]
    for f, tracking in zip(followers, (jtracking, ttracking)):
        assert f.set_initial_tracking_2d_target(_box2d(tracking, 0))
    for step in range(30):
        oks = [f.loop_step(detections_2d=[b] if (b := _box2d(tr, step)) else None)
               for f, tr in zip(followers, (jtracking, ttracking))]
        assert oks[1] == oks[0], f"step {step}"
        for attr in ("linear_x_control", "linear_y_control", "angular_control"):
            assert list(getattr(followers[1], attr)) == list(
                getattr(followers[0], attr)), f"step {step} {attr}"


@pytest.mark.parametrize("use_local", [True, False], ids=["local", "global"])
def test_rgbd_core_lockstep_with_jax(use_local):
    """``test_rgbd_closed_loop.py``'s moving target and decoys through both
    packages' ``RGBDFollowerCore``; the robot advances with the JAX
    commands; every command equal."""
    cores = []
    for vf in (jvf, tvf):
        limits = _limits() if vf is jvf else to_port(_limits())
        cfg = vf.VisionRGBDFollowerConfig(
            control_time_step=DT, control_horizon=2, prediction_horizon=20,
            use_local_coordinates=use_local, target_distance_m=0.2,
            target_orientation=0.0, distance_tolerance=0.1, min_vel=0.0)
        robot_type = RobotType.DIFFERENTIAL_DRIVE
        shape = RobotGeometry.Type.CYLINDER
        if vf is tvf:
            robot_type, shape = to_port(robot_type), to_port(shape)
        cores.append(vf.RGBDFollowerCore(robot_type, limits, shape,
                                         np.array([0.1, 0.4]), cfg))
    rx, ry, ryaw, ts = -0.8, 0.0, 0.0, 0.0
    centers = [(0.7 * i, 0.7 * i, 0.0) for i in range(3)]

    def boxes(tracking):
        out = [tracking.Bbox3D(center=np.asarray(c, np.float32),
                               size=np.array([0.5, 0.5, 1.0], np.float32),
                               center_img_frame=np.array([150 + 50 * i] * 2),
                               size_img_frame=np.array([25, 25]), timestamp=ts)
               for i, c in enumerate(centers)]
        if use_local:
            # the twin's helper builds the port's boxes; the JAX ones are
            # turned into the robot frame the same way, field by field
            local = _RGBD._world_to_local(
                [to_port(b) for b in out], rx, ry, ryaw)
            out = [tracking.Bbox3D(center=b.center, size=b.size,
                                   center_img_frame=b.center_img_frame,
                                   size_img_frame=b.size_img_frame,
                                   timestamp=b.timestamp) for b in local]
        return out

    for core, tracking in zip(cores, (jtracking, ttracking)):
        core.set_current_state(rx, ry, ryaw)
        assert core.set_initial_tracking_boxes_3d(150, 150, boxes(tracking))
    heading = 0.0
    for step in range(40):
        vels = []
        for core, tracking in zip(cores, (jtracking, ttracking)):
            core.set_current_state(rx, ry, ryaw)
            vels.append(core.get_tracking_ctrl_3d(boxes(tracking), None))
        np.testing.assert_array_equal(np.asarray(vels[1]), np.asarray(vels[0]),
                                      err_msg=f"step {step}")
        assert vels[0], f"step {step}: the target was lost"
        for vx, vy, om in vels[0][:2]:
            rx += (vx * math.cos(ryaw) - vy * math.sin(ryaw)) * DT
            ry += (vx * math.sin(ryaw) + vy * math.cos(ryaw)) * DT
            ryaw += om * DT
            dx, dy = 0.1 * math.cos(heading) * DT, 0.1 * math.sin(heading) * DT
            heading += 0.1 * DT
            centers = [(c[0] + dx, c[1] + dy, c[2]) for c in centers]
            ts += DT
