"""The port's DWA controller against the JAX package's, on the CPU.

Both controllers take a Robot, RobotCtrlLimits and DWAConfig built from
the same values (the port's own host objects, ``to_port``) and run in
lockstep on the scenarios of
``tests/test_dwa_closed_loop.py``: every tick both see the same state,
which is then advanced with the JAX command. The commanded velocities
must agree within 1e-4 per tick (the solver parity tolerance; the
rollouts differ only in the last bits, see ``test_torch_solver.py``).
The port must also reach the goal on its own.

In moving-obstacle mode the two controllers run in lockstep on the
crossing-mover scenario of ``tests/test_moving_obstacles.py``, with the
same command tolerance.
"""

import numpy as np
import pytest
import torch

from kompass_core_tpu.control import DWA as JaxDWA
from kompass_core_tpu.control import DWAConfig as JaxDWAConfig
from kompass_core_tpu.datatypes import PointCloudData
from kompass_core_tpu.datatypes.laserscan import LaserScanData
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotState,
    RobotType,
)
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet as JaxDeviceFleet
from kompass_core_tpu_torch.control import DWA, DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu_torch.datatypes import LaserScanData as PortLaserScanData
from kompass_core_tpu_torch.models import RobotState as PortRobotState
from kompass_core_tpu_torch.ops.fleet_solver import fleet_spec_from_jax
from kompass_core_tpu_torch.parallel import DeviceFleet, FleetMesh

from test_dwa_closed_loop import make_global_path
from test_torch_host_modules import to_port

torch.set_num_threads(2)
CMD_TOL = 1e-4


def _robot(robot_type=RobotType.ACKERMANN, geometry=RobotGeometry.Type.CYLINDER,
           params=(0.1, 0.4)):
    return Robot(
        robot_type=robot_type, geometry_type=geometry,
        geometry_params=np.array(params),
    )


def _limits():
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )


def _config(samples, obstacles_weight, path_weight=3.0, cls=JaxDWAConfig):
    return cls(
        max_linear_samples=samples, max_angular_samples=samples,
        octree_resolution=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=path_weight,
            goal_distance_weight=1.0,
            obstacles_distance_weight=obstacles_weight,
            smoothness_weight=0.0, jerk_weight=0.0,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=0.1,
    )


def _commands(dwa):
    return np.array(
        [dwa.linear_x_control, dwa.linear_y_control, dwa.angular_control],
        np.float64,
    )


def _clutter_scan():
    angles = np.linspace(np.pi * 0.6, np.pi * 0.9, 15)
    return LaserScanData(ranges=np.full(15, 1.2), angles=angles)


def _start(robot):
    robot.state.x, robot.state.y, robot.state.yaw = -0.5, 0.0, np.pi / 2


def _run_lockstep(robot, config, scan, max_steps=150):
    """Drive both controllers from one state, advanced with the JAX
    command; returns (goal reached, ticks)."""
    jdwa = JaxDWA(robot=robot, ctrl_limits=_limits(), config=config)
    tdwa = DWA(robot=to_port(robot), ctrl_limits=to_port(_limits()),
               config=config, device="cpu")
    for d in (jdwa, tdwa):
        d.set_path(make_global_path())
    _start(robot)
    steps = ticks = 0
    while steps < max_steps:
        ok = jdwa.loop_step(current_state=robot.state, laser_scan=scan)
        assert tdwa.loop_step(current_state=to_port(robot.state),
                              laser_scan=to_port(scan)) == ok
        if not ok:
            assert tdwa.reached_end() == jdwa.reached_end()
            return jdwa.reached_end(), ticks
        ticks += 1
        assert tdwa.has_result() == jdwa.has_result()
        np.testing.assert_allclose(
            _commands(tdwa), _commands(jdwa), atol=CMD_TOL,
            err_msg=f"tick {ticks}",
        )
        for vx, vy, w in _commands(jdwa).T:
            robot.set_control(velocity_x=vx, velocity_y=vy, omega=w)
            robot.get_state(dt=0.1)
            steps += 1
            if jdwa.reached_end():
                return True, ticks
    return False, ticks


def _run_port_alone(robot, config, scan, max_steps=150):
    robot, scan = to_port(robot), to_port(scan)
    dwa = DWA(robot=robot, ctrl_limits=to_port(_limits()), config=config,
              device="cpu")
    dwa.set_path(make_global_path())
    _start(robot)
    steps = 0
    while steps < max_steps:
        if not dwa.loop_step(current_state=robot.state, laser_scan=scan):
            return dwa.reached_end()
        for vx, vy, w in zip(
            dwa.linear_x_control, dwa.linear_y_control, dwa.angular_control
        ):
            robot.set_control(velocity_x=vx, velocity_y=vy, omega=w)
            robot.get_state(dt=0.1)
            steps += 1
            if dwa.reached_end():
                return True
    return False


@pytest.mark.parametrize(
    "robot_type",
    [RobotType.ACKERMANN, RobotType.DIFFERENTIAL_DRIVE, RobotType.OMNI],
)
@pytest.mark.parametrize("with_obstacles", [False, True])
def test_lockstep_scenario_matrix(robot_type, with_obstacles):
    scan = _clutter_scan() if with_obstacles else LaserScanData()
    config = _config(5, 1.0 if with_obstacles else 0.0)
    reached, ticks = _run_lockstep(_robot(robot_type), config, scan)
    assert reached and ticks > 5


def test_lockstep_canonical_truncate_mode():
    """The reference's canonical 4x4 Ackermann run, in truncate mode."""
    config = _config(4, 1.0)
    config.drop_samples = False
    reached, _ = _run_lockstep(_robot(), config, _clutter_scan())
    assert reached


@pytest.mark.parametrize(
    "robot_type",
    [RobotType.ACKERMANN, RobotType.DIFFERENTIAL_DRIVE, RobotType.OMNI],
)
def test_port_alone_reaches_goal(robot_type):
    config = _config(5, 1.0, cls=DWAConfig)
    assert _run_port_alone(_robot(robot_type), config, _clutter_scan())


def _one_tick_pair(config, state, **inputs):
    robot = _robot()
    out = []
    for d in (
        JaxDWA(robot=robot, ctrl_limits=_limits(), config=config),
        DWA(robot=to_port(robot), ctrl_limits=to_port(_limits()),
            config=config, device="cpu"),
    ):
        d.set_path(np.array([[0.0, 0.0], [0.0, 3.0]]))
        d.set_current_state(*state)
        out.append((d, d.compute_velocity_commands((0.0, 0.0, 0.0), **inputs)))
        inputs = {k: to_port(v) for k, v in inputs.items()}
    return out


def test_head_on_wall_from_every_input_path():
    """A wall ahead given as a scan, a point cloud and world map points:
    both packages find the same clear command."""
    xs = np.linspace(-0.3, 0.3, 21)
    angles = np.linspace(-0.5, 0.5, 21)
    inputs = [
        dict(laser_scan=LaserScanData(ranges=np.full(21, 0.45), angles=angles)),
        dict(point_cloud=PointCloudData(points=np.stack(
            [np.full_like(xs, 0.45), -xs, np.zeros_like(xs)], 1
        ).astype(np.float32))),
        dict(map_points_world=np.stack([xs, np.full_like(xs, 0.45)], 1)),
    ]
    for kw in inputs:
        (jd, jr), (td, tr) = _one_tick_pair(_config(6, 1.0, 2.0), (0.0, 0.0, np.pi / 2), **kw)
        assert tr.is_found and jr.is_found
        assert np.max(tr.trajectory.path_y) < 0.45 - 0.1
        np.testing.assert_allclose(_commands(td), _commands(jd), atol=CMD_TOL)
        assert tr.cost == pytest.approx(jr.cost, rel=1e-4)


def test_enclosed_robot_gets_a_zero_command():
    angles = np.linspace(0, 2 * np.pi, 72, endpoint=False)
    scan = LaserScanData(ranges=np.full_like(angles, 0.12), angles=angles)
    for d, res in _one_tick_pair(_config(4, 1.0), (0.0, 0.0, np.pi / 2), laser_scan=scan):
        assert not res.is_found and not d.has_result()
        assert list(d.linear_x_control) == [0.0]
        assert list(d.angular_control) == [0.0]


def test_nan_in_scan_and_cloud_is_dropped():
    """Non-finite scan ranges and NaN cloud points never reach the
    sweep: a command is still found, with a finite cost, equal to JAX's."""
    angles = np.linspace(-0.5, 0.5, 21)
    ranges = np.full(21, 0.45)
    ranges[[3, 10]] = [np.nan, np.inf]
    cloud = np.stack([np.full(21, 0.45), -np.linspace(-0.5, 0.5, 21),
                      np.zeros(21)], 1).astype(np.float32)
    cloud[5, :2] = np.nan
    for kw in (dict(laser_scan=LaserScanData(ranges=ranges, angles=angles)),
               dict(point_cloud=PointCloudData(points=cloud))):
        (jd, jr), (td, tr) = _one_tick_pair(_config(6, 1.0, 2.0), (0.0, 0.0, np.pi / 2), **kw)
        assert tr.is_found and np.isfinite(tr.cost)
        np.testing.assert_allclose(_commands(td), _commands(jd), atol=CMD_TOL)


def test_rotate_in_place_keeps_corrected_sign():
    """Target to the left of a diff-drive robot: rotate counter-clockwise,
    the same command as the JAX package, without a device solve."""
    robot = _robot(RobotType.DIFFERENTIAL_DRIVE)
    config = _config(4, 0.0)
    dwas = [JaxDWA(robot=robot, ctrl_limits=_limits(), config=config),
            DWA(robot=to_port(robot), ctrl_limits=to_port(_limits()),
                config=config, device="cpu")]
    for d, state in zip(dwas, (RobotState, PortRobotState)):
        d.set_path(np.array([[0.0, 0.0], [0.0, 3.0]]))
        assert d.loop_step(current_state=state(x=0.0, y=0.0, yaw=0.0))
    assert dwas[1].angular_control[0] > 0.0
    assert dwas[1].last_solver_io is None
    np.testing.assert_allclose(_commands(dwas[1]), _commands(dwas[0]), atol=1e-6)


def test_loop_step_before_set_path_is_false():
    dwa = DWA(robot=to_port(_robot()), ctrl_limits=to_port(_limits()),
              config=_config(4, 0.0), device="cpu")
    assert not dwa.loop_step(current_state=PortRobotState())
    with pytest.raises(ValueError, match="path"):
        dwa.compute_velocity_commands((0.0, 0.0, 0.0))


def test_device_is_required_and_explicit():
    with pytest.raises(TypeError):
        DWA(robot=to_port(_robot()), ctrl_limits=to_port(_limits()))
    dwa = DWA(robot=to_port(_robot()), ctrl_limits=to_port(_limits()), device="cpu")
    assert dwa.device == torch.device("cpu")


def test_unported_paths_raise_naming_their_roadmap_item():
    # the mesh (item 5g) is ported: a peer fleet builds on a mesh, padded
    # to the mesh size, and refuses a device beside its mesh
    mesh = FleetMesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="not both"):
        DeviceFleet([to_port(_robot())], to_port(_limits()),
                    _config(4, 0.0, cls=DWAConfig), scan_rays=16,
                    peer_avoidance=True, mesh=mesh, device="cpu")
    sharded = DeviceFleet([to_port(_robot())], to_port(_limits()),
                          _config(4, 0.0, cls=DWAConfig), scan_rays=16,
                          peer_avoidance=True, mesh=mesh)
    assert sharded._n == 2 and sharded.device is None
    # a BOX robot's fleet (item 5f) builds the oriented-box solver as the
    # JAX package's does (its ticks: test_torch_box_fleet.py)
    jbox = _robot(geometry=RobotGeometry.Type.BOX, params=(0.5, 0.3, 0.4))
    box = to_port(jbox)
    fleet = DeviceFleet([box], to_port(_limits()), _config(4, 0.0, cls=DWAConfig),
                        scan_rays=16, device="cpu")
    jfleet = JaxDeviceFleet([jbox], _limits(), _config(4, 0.0, cls=DWAConfig),
                            scan_rays=16)
    assert fleet.spec == fleet_spec_from_jax(jfleet.spec)
    assert fleet.spec.solver.dynamic_box
    np.testing.assert_array_equal(fleet._cfg.collision_box2.numpy(),
                                  np.asarray(jfleet._cfg.collision_box2))
    # what no longer raises: peers, BOX robots, custom costs, the debug
    # search
    DeviceFleet([to_port(_robot())], to_port(_limits()),
                _config(4, 0.0, cls=DWAConfig), scan_rays=16,
                peer_avoidance=True, device="cpu")
    dwa = DWA(robot=box, ctrl_limits=to_port(_limits()), device="cpu")
    dwa.add_custom_cost(1.0, lambda vel, px, py, ap: px[..., -1] * 0.0)
    with pytest.raises(ValueError, match="No debugging samples"):
        dwa.get_debugging_samples()


def test_check_states_feasibility():
    dwa = DWA(robot=to_port(_robot()), ctrl_limits=to_port(_limits()), device="cpu")
    dwa.set_current_state(0.0, 0.0, 0.0)
    scan = PortLaserScanData(ranges=np.array([1.0]), angles=np.array([0.0]))
    free = [PortRobotState(x=0.0, y=0.0), PortRobotState(x=0.0, y=0.5)]
    assert not dwa.check_states_feasibility(free, laser_scan=scan)
    assert dwa.check_states_feasibility([PortRobotState(x=0.95, y=0.0)],
                                        laser_scan=scan)


# --- moving obstacles --------------------------------------------------------


def _moving_pair(moving=True):
    """The crossing-mover controllers of tests/test_moving_obstacles.py,
    one per package."""
    robot = _robot(RobotType.DIFFERENTIAL_DRIVE, params=(0.2, 0.5))
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
        ),
    )
    config = JaxDWAConfig(
        max_linear_samples=8, max_angular_samples=8, prediction_horizon=20,
        control_horizon=2, control_time_step=0.1, moving_obstacles=moving,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5, smoothness_weight=0.0,
            jerk_weight=0.0,
        ),
    )
    pair = (JaxDWA(robot=robot, ctrl_limits=limits, config=config),
            DWA(robot=to_port(robot), ctrl_limits=to_port(limits),
                config=config, device="cpu"))
    for d in pair:
        d.set_path(np.array([[0.0, 0.0], [6.0, 0.0]]))
        d.set_current_state(0.0, 0.0, 0.0)
    return pair


def test_moving_obstacle_disc_matches_jax():
    args = ((1.0, 1.2), 0.15, (0.0, -1.2), 6)
    for got, want in zip(DWA.tracked_obstacle_disc(*args),
                         JaxDWA.tracked_obstacle_disc(*args)):
        np.testing.assert_array_equal(got, want)


def test_moving_lockstep_crossing_mover():
    """A mover crossing the path at 1.2 m/s, given as a tracked disc with
    its velocity: both packages give the same command every tick (the
    state advanced with the JAX command, the mover along its track), and
    the port's first plan clears the mover's track, which the static
    model does not."""
    jdwa, tdwa = _moving_pair()
    center, vel = np.array([1.0, 1.2]), np.array([0.0, -1.2])
    x = y = yaw = 0.0
    vx, om = 0.9, 0.0
    dt = 0.1
    for tick in range(25):
        pts, vels = DWA.tracked_obstacle_disc(center, 0.1, vel)
        res = []
        for d in (jdwa, tdwa):
            d.set_current_state(x, y, yaw, vx)
            res.append(d.compute_velocity_commands(
                (vx, 0.0, om), map_points_world=pts,
                obstacle_velocities_world=vels,
            ))
        assert res[1].is_found == res[0].is_found, f"tick {tick}"
        if not res[0].is_found:
            break
        np.testing.assert_allclose(_commands(tdwa), _commands(jdwa),
                                   atol=CMD_TOL, err_msg=f"tick {tick}")
        assert res[1].cost == pytest.approx(res[0].cost, rel=1e-4)
        if tick == 0:
            t = np.arange(len(res[1].trajectory.path_x)) * dt
            gap = np.hypot(res[1].trajectory.path_x - (center[0] + vel[0] * t),
                           res[1].trajectory.path_y - (center[1] + vel[1] * t))
            assert gap.min() > 0.25
        vx, om = float(jdwa.linear_x_control[0]), float(jdwa.angular_control[0])
        yaw += om * dt
        x += vx * np.cos(yaw) * dt
        y += vx * np.sin(yaw) * dt
        center = center + vel * dt
    assert x > 1.0, "the robot did not get past the crossing"


def test_moving_nan_velocity_rows_are_dropped():
    """A NaN velocity row is dropped like a NaN position: the tick finds a
    finite command, the same as without that row, and the same as JAX."""
    jdwa, tdwa = _moving_pair()
    pts = np.array([[0.6, 0.0], [2.0, 2.0]])
    vels = np.array([[np.nan, 0.0], [0.0, -1.0]])
    res = [d.compute_velocity_commands((0.5, 0.0, 0.0), map_points_world=pts,
                                       obstacle_velocities_world=vels)
           for d in (jdwa, tdwa)]
    assert res[1].is_found and np.isfinite(res[1].cost)
    np.testing.assert_allclose(_commands(tdwa), _commands(jdwa), atol=CMD_TOL)
    _, clean = _moving_pair()
    res_clean = clean.compute_velocity_commands(
        (0.5, 0.0, 0.0), map_points_world=pts[1:], obstacle_velocities_world=vels[1:]
    )
    np.testing.assert_array_equal(res[1].trajectory.path_x,
                                  res_clean.trajectory.path_x)


def test_moving_input_guards():
    _, static = _moving_pair(moving=False)
    with pytest.raises(ValueError, match="moving_obstacles=True"):
        static.compute_velocity_commands(
            (0.5, 0.0, 0.0), map_points_world=np.array([[1.0, 1.0]]),
            obstacle_velocities_world=np.array([[0.0, 1.0]]),
        )
    _, moving = _moving_pair()
    with pytest.raises(ValueError, match="align"):
        moving.compute_velocity_commands(
            (0.5, 0.0, 0.0), map_points_world=np.array([[1.0, 1.0]]),
            obstacle_velocities_world=np.zeros((2, 2)),
        )
