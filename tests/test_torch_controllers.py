"""The port's host controllers against the JAX package's, on the CPU.

The port's Stanley, DVZ, Pure Pursuit and PID (``control/``) and the
DVZ algorithm (``algorithms/dvz.py``) are copies of the JAX package's
JAX-free modules, so they must give the same commands exactly:

- in lockstep with the JAX controllers on the same robots (``to_port``),
  paths and scans, every command equal for 60 closed-loop steps, with an
  obstacle beside the path that DVZ and Pure Pursuit react to;
- through the JAX package's own tests of the controllers, the follower
  and the registry, run again with every import pointed at the port
  (``port_twin``): ``test_classic_controllers.py``,
  ``test_controller_oracle.py`` (the in-repo oracles),
  ``test_pp_scenario_matrix.py``, ``test_dvz_goldens.py`` (the committed
  goldens), ``test_follower_oracle.py`` and ``test_blocked_detection.py``
  (the port's ``Follower``), and the registry and controller-surface
  cases of ``test_api_surface.py``. Where a twin builds the port's
  ``DWA`` it passes the CPU (``torch_twin_adapters.classic_replace``,
  which ``test_torch_twin_cuda_main.py`` runs on the card): the port's
  entry points take their device explicitly.
"""

import math

import numpy as np
import pytest

from kompass_core_tpu import control as jcontrol
from kompass_core_tpu.datatypes import LaserScanData as JaxLaserScanData
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch import control as tcontrol
from kompass_core_tpu_torch.datatypes import LaserScanData

from test_torch_host_modules import port_twin, twin_tests, to_port
from torch_twin import device_env
from torch_twin_adapters import classic_replace

port_twin("test_dwa_closed_loop")  # the classic twin imports its helpers
twin_tests(globals(), port_twin(
    "test_classic_controllers", replace=classic_replace("torch_twin_test_dwa_closed_loop"),
    env=device_env("cpu")))
twin_tests(globals(), port_twin("test_controller_oracle"))
twin_tests(globals(), port_twin("test_pp_scenario_matrix"))
twin_tests(globals(), port_twin("test_dvz_goldens"))
twin_tests(globals(), port_twin("test_follower_oracle"))
twin_tests(globals(), port_twin("test_blocked_detection"))
twin_tests(globals(), port_twin("test_api_surface"),
           names=("test_control_registry_accepts_enum_and_string",
                  "test_follower_template_surface_complete"))

STEPS = 60
DT = 0.1
RAYS = 180


def _robot(robot_type):
    return Robot(robot_type=robot_type,
                 geometry_type=RobotGeometry.Type.CYLINDER,
                 geometry_params=np.array([0.2, 0.4]))


def _limits():
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=3.0, max_decel=5.0),
        vy_limits=LinearCtrlLimits(max_vel=0.6, max_acc=3.0, max_decel=5.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0,
                                       max_decel=6.0, max_steer=1.0),
    )


def _path():
    t = np.linspace(0.0, 1.0, 12)
    return np.stack([6.0 * t, 1.2 * np.sin(2.0 * t)], axis=1)


def _scan(cls, state, post=(3.0, 1.05), radius=0.25):
    """A ray-cast scan of one round post from the robot's pose (robot
    frame), max range elsewhere."""
    angles = np.linspace(-np.pi, np.pi, RAYS, endpoint=False)
    ranges = np.full(RAYS, 8.0)
    dx, dy = post[0] - state.x, post[1] - state.y
    for i, a in enumerate(angles):
        heading = state.yaw + a
        along = dx * math.cos(heading) + dy * math.sin(heading)
        perp2 = dx * dx + dy * dy - along * along
        if along > 0 and perp2 < radius * radius:
            ranges[i] = along - math.sqrt(radius * radius - perp2)
    return cls(ranges=ranges, angles=angles, range_max=8.0)


def _build(pkg, name, robot, limits):
    cls = pkg.ControlClasses[name]
    config_cls = pkg.ControlConfigClasses[name]
    if name == pkg.ControllersID.PURE_PURSUIT:
        config = config_cls(wheel_base=robot.wheelbase, lookahead_distance=0.6)
    else:
        config = config_cls()
    return cls(robot=robot, ctrl_limits=limits, config=config,
               control_time_step=DT)


@pytest.mark.parametrize("name", ["Stanley", "DVZ", "PurePursuit"])
@pytest.mark.parametrize("robot_type", [RobotType.DIFFERENTIAL_DRIVE,
                                        RobotType.ACKERMANN, RobotType.OMNI])
def test_controllers_lockstep_with_jax(name, robot_type):
    """The same robot, path and scans through the JAX and the port
    controller of the registry entry ``name``: every step's status and
    commands equal exactly; the robots advance with the JAX commands."""
    jrobot = _robot(robot_type)
    trobot = to_port(jrobot)
    jctl = _build(jcontrol, name, jrobot, _limits())
    tctl = _build(tcontrol, name, trobot, to_port(_limits()))
    for ctl in (jctl, tctl):
        ctl.set_path(_path())
    moved = 0.0
    for step in range(STEPS):
        for field in ("x", "y", "yaw", "speed", "vx", "vy", "omega"):
            setattr(trobot.state, field, getattr(jrobot.state, field))
        ok_j = jctl.loop_step(current_state=jrobot.state,
                              laser_scan=_scan(JaxLaserScanData, jrobot.state))
        ok_t = tctl.loop_step(current_state=trobot.state,
                              laser_scan=_scan(LaserScanData, trobot.state))
        assert ok_t == ok_j, f"step {step}"
        assert tctl.reached_end() == jctl.reached_end(), f"step {step}"
        for attr in ("linear_x_control", "linear_y_control", "angular_control"):
            np.testing.assert_array_equal(
                np.asarray(getattr(tctl, attr)), np.asarray(getattr(jctl, attr)),
                err_msg=f"step {step} {attr}")
        if not ok_j or jctl.reached_end():
            break
        vx, vy, om = (jctl.linear_x_control[0], jctl.linear_y_control[0],
                      jctl.angular_control[0])
        moved += abs(vx) * DT
        jrobot.set_control(velocity_x=vx, velocity_y=vy, omega=om)
        jrobot.get_state(dt=DT)
    assert moved > 0.5, f"{name} never moved the robot"


def test_pid_matches_jax():
    rng = np.random.default_rng(3)
    jpid = jcontrol.PID(kp=1.3, ki=0.4, kd=0.05)
    tpid = tcontrol.PID(kp=1.3, ki=0.4, kd=0.05)
    for target, current in rng.uniform(-2.0, 2.0, (50, 2)):
        assert tpid.compute(target, current, DT) == jpid.compute(target, current, DT)


def test_registry_lists_the_jax_controllers():
    assert list(map(str, tcontrol.ControlClasses)) == list(map(str, jcontrol.ControlClasses))
    assert [c.__name__ for c in tcontrol.ControlClasses.values()] == [
        c.__name__ for c in jcontrol.ControlClasses.values()]
    assert [c.__name__ for c in tcontrol.ControlConfigClasses.values()] == [
        c.__name__ for c in jcontrol.ControlConfigClasses.values()]
    assert tcontrol.FollowerTemplate is tcontrol.Follower
    assert all(cls.__module__.startswith("kompass_core_tpu_torch.")
               for cls in tcontrol.ControlClasses.values())
