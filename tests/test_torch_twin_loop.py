"""The JAX package's closed-loop and configuration tests run against the
port on the CPU (``torch_twin.port_twin``): the DWA closed loop
(``test_dwa_closed_loop.py``), moving obstacles
(``test_moving_obstacles.py``), the configuration fuzz
(``test_config_fuzz.py``), the datatypes and configuration surface
(``test_datatypes_config.py``) and the native host library
(``test_native.py``).

The adapters (``LOOP_REPLACE``, ``loop_env(device)``: the CPU here, the
card in ``test_torch_twin_cuda_main.py``): every port entry point that
takes a device gets it (``_on_device``), ``jax.numpy``'s constructors
make the port's tensors on it (``torch_twin.jnp_on``), and a private JAX
function whose port form takes other arguments gets the JAX signature
over the port's function in ``env`` (named beside it). No test is left
out.
"""

import torch
from torch.utils import _pytree

from kompass_core_tpu_torch.ops import fleet_solver, kernels

from torch_twin import JNP, NP, device_env, port_twin, tensor_args, twin_tests

torch.set_num_threads(2)

DWA_ON = ("DWA(robot=", "_on_device(DWA)(robot=")
NO_JAX = ("    import jax\n", "    pass\n")  # after JNP: the one bare import left

LOOP_REPLACE = {
    "test_dwa_closed_loop": [NP, DWA_ON],
    "test_moving_obstacles": [
        JNP, NO_JAX, NP, DWA_ON,
        ("    _min_obstacle_dist_sq_moving,\n", "\n"),
        ("get_packed_dwa_solver(s_spec)", '_on_device(get_packed_dwa_solver)(s_spec)'),
        ("make_packed_dwa_solver(", "_on_device(make_packed_dwa_solver)("),
        ("make_fleet_solver(m_spec)", '_on_device(make_fleet_solver)(m_spec)'),
        # the port's programs are eager: a call on zeros gives the shapes
        ("jax.eval_shape(", "_call("),
        ("jax.tree_util.tree_map(", "_pytree.tree_map("),
        ("make_fleet_tick(spec, peer_cfg=peer)",
         "_on_device(make_fleet_tick)(spec, peer_cfg=peer)"),
        ("make_fleet_ticks_on_device(spec, 3, peer_cfg=peer)",
         "_on_device(make_fleet_ticks_on_device)(spec, 3, peer_cfg=peer)"),
        ("    from kompass_core_tpu_torch.ops.fleet_solver import _scan_to_world_obs\n",
         "    _scan_to_world_obs = _one_robot_scan_to_world_obs\n")],
    "test_config_fuzz": [
        NP, DWA_ON,
        ("LocalMapper(config, ScanModelConfig(p_prior=0.5))",
         "_on_device(LocalMapper)(config, ScanModelConfig(p_prior=0.5))")],
}


def loop_env(device):
    """The closed-loop twins' adapters on ``device``."""
    env = device_env(device)
    device = env["_device"]

    def _min_obstacle_dist_sq_moving(px, py, obs_xy, obs_vel, time_step, pt_mask):
        """JAX's per-point moving-obstacle sweep, over K3 (the port sweeps
        the obstacles and the segment in one pass)."""
        far = torch.full((1,), 1e8, device=device)
        active = pt_mask.sum().to(torch.int32)
        return kernels.fused_min_dist_sq_moving(
            px, py, obs_xy, obs_vel, time_step, far, far, active)[0]

    def _one_robot_scan_to_world_obs(spec, ranges, angles, sensor_pose, x, y, yaw):
        """JAX's one-robot scan-to-world, over the port's fleet form (a
        robot axis first)."""
        one = [torch.as_tensor(v, dtype=torch.float32, device=device)[None]
               for v in (ranges, angles, sensor_pose, x, y, yaw)]
        return fleet_solver._scan_to_world_obs(spec, *one)[0]

    return {**env,
            "_min_obstacle_dist_sq_moving": tensor_args(_min_obstacle_dist_sq_moving, device),
            "_one_robot_scan_to_world_obs": _one_robot_scan_to_world_obs,
            "_call": lambda f, *args: f(*args), "_pytree": _pytree}


LOOP_ENV = loop_env("cpu")

# test_torch_controllers.py loads this file's helpers without adapters,
# so this twin registers under another name
twin_tests(globals(), port_twin("test_dwa_closed_loop", replace=LOOP_REPLACE["test_dwa_closed_loop"],
                                env=LOOP_ENV, as_name="test_dwa_closed_loop_cpu"))
twin_tests(globals(), port_twin("test_moving_obstacles",
                                replace=LOOP_REPLACE["test_moving_obstacles"], env=LOOP_ENV))
twin_tests(globals(), port_twin("test_config_fuzz", replace=LOOP_REPLACE["test_config_fuzz"],
                                env=LOOP_ENV))
twin_tests(globals(), port_twin("test_datatypes_config", replace=[
    # the port's helper returns the one device to run on, not jax's list
    ('"print([d.platform for d in devs])"', '"print(devs.type)"'),
]))
twin_tests(globals(), port_twin("test_native"))
