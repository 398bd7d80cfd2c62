from .kernels import (  # noqa: F401
    fused_min_dist_sq,
    fused_min_dist_sq_reference,
)
from .solver import (  # noqa: F401
    SolverParams,
    SolverSpec,
    SolveResult,
    dwa_solve,
    make_packed_dwa_solver,
    pack_solver_input,
    packed_input_size,
    spec_from_jax,
    unpack_solver_output,
)
from .window import MIN_VEL, sample_velocity_window  # noqa: F401
