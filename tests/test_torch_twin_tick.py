"""The JAX package's tests of the DWA tick run against the port on the CPU
(``torch_twin.port_twin``): the reference oracle (``test_oracle_parity.py``,
``test_cost_evaluator_standalone.py``), the golden cost dump
(``test_cost_parity.py``), each cost kernel's analytic values
(``test_costs.py``), the solver's modes (``test_solver_modes.py``), the
dynamic window (``test_window.py``), the reference path
(``test_path.py``) and the collision model (``test_collision_model.py``).

The adapters (``TICK_REPLACE``, ``tick_env(device)``: the CPU here, the
card in ``test_torch_twin_cuda_main.py``): every port entry point that
takes a device gets it (``_on_device``), ``jax.numpy``'s constructors
make the port's tensors on it (``torch_twin.jnp_on``), and where a test
calls a private JAX function whose port form takes other arguments,
``env`` gives it the JAX signature over the port's function (named
beside it). No test is left out.
"""

import torch

from kompass_core_tpu_torch.ops import kernels, solver

from torch_twin import JNP, NP, device_env, port_twin, tensor_args, twin_tests

torch.set_num_threads(2)

# dwa_solve takes tensors where the JAX tests pass the host window's numpy
SOLVE = ("    dwa_solve,\n", "\n")
PARAMS = ("SolverParams.create(", "_on_device(SolverParams.create)(")

TICK_REPLACE = {
    "test_oracle_parity": [
        JNP, NP, PARAMS, ("make_dwa_solver(spec)", "_on_device(make_dwa_solver)(spec)")],
    "test_cost_evaluator_standalone": [
        JNP, NP, PARAMS, ("get_cost_evaluator()", "get_cost_evaluator(_device)"),
        ("get_cost_evaluator(True)", "get_cost_evaluator(_device, True)"),
        ("get_cost_evaluator(False)", "get_cost_evaluator(_device, False)")],
    "test_cost_parity": [
        JNP, NP, PARAMS,
        # the "pallas" backend's sweep is K2, whose CPU operator is its plain
        # version and whose card operator is the kernel: nothing to stand in for
        ("import kompass_core_tpu_torch.ops.pallas_kernels as pk",
         "import kompass_core_tpu_torch.ops.kernels as pk"),
        ("        import jax\n", "        pass\n"),
        ('if jax.devices()[0].platform != "tpu":', "if False:"), SOLVE],
    "test_costs": [
        JNP, NP,
        ("    _min_obstacle_dist_sq,\n", "\n"),
        ("    _path_cost,\n", "\n"),
        ("    _goal_cost,\n", "\n")],
    "test_solver_modes": [
        JNP, NP, PARAMS,
        ("DWA(robot=robot, ctrl_limits=_limits(), config=config)",
         "_on_device(DWA)(robot=robot, ctrl_limits=_limits(), config=config)"),
        ("get_packed_dwa_solver(spec", "_on_device(get_packed_dwa_solver)(spec"),
        ("make_packed_dwa_solver(spec", "_on_device(make_packed_dwa_solver)(spec"), SOLVE],
    "test_collision_model": [NP],
}


def tick_env(device):
    """The tick twins' adapters on ``device``."""
    env = device_env(device)
    device = env["_device"]

    def _min_obstacle_dist_sq(px, py, obs_xy, pt_mask):
        """JAX's per-point obstacle sweep, over K1 (the port sweeps the
        obstacles and the segment in one pass)."""
        active = pt_mask.sum().to(torch.int32)
        far = torch.full((1,), 1e8, device=device)
        return kernels.fused_min_dist_sq(px, py, obs_xy, far, far, active)[0]

    def _path_cost(px, py, seg_x, seg_y, seg_last_xy, seg_total_len, active_points):
        """JAX's path cost, which sweeps the segment itself; the port's takes
        the segment sweep's d2 from K1."""
        far = torch.full((1, 2), 1e8, device=device)
        d2_seg = kernels.fused_min_dist_sq(px, py, far, seg_x, seg_y, active_points)[1]
        return solver._path_cost(px, py, d2_seg, seg_last_xy, seg_total_len,
                                 active_points)

    return {**env, **{name: tensor_args(f, device) for name, f in (
        ("dwa_solve", solver.dwa_solve), ("_min_obstacle_dist_sq", _min_obstacle_dist_sq),
        ("_path_cost", _path_cost), ("_goal_cost", solver._goal_cost))}}


SOLVE_ENV = tick_env("cpu")

for _name in TICK_REPLACE:
    if _name == "test_collision_model":  # the JAX package's order
        twin_tests(globals(), port_twin("test_window"))
        twin_tests(globals(), port_twin("test_path"))
    twin_tests(globals(), port_twin(_name, replace=TICK_REPLACE[_name], env=SOLVE_ENV))
