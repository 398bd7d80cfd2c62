from .kernels import (  # noqa: F401
    fused_min_dist_sq,
    fused_min_dist_sq_expanded,
    fused_min_dist_sq_reference,
    min_dist_sq_expanded,
)
from .solver import (  # noqa: F401
    BACKENDS,
    SolverParams,
    SolverSpec,
    SolveResult,
    dwa_sample_debug,
    dwa_solve,
    evaluate_trajectory_costs,
    get_cost_evaluator,
    get_debug_dwa_solver,
    get_packed_dwa_solver,
    make_dwa_solver,
    make_packed_dwa_solver,
    pack_solver_input,
    packed_input_size,
    spec_from_jax,
    unpack_solver_output,
)
from .window import MIN_VEL, sample_velocity_window  # noqa: F401
