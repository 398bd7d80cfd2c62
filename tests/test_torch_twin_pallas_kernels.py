"""The JAX package's kernel tests (``tests/test_pallas_kernels.py``) run
against the port on the CPU (``torch_twin.port_twin``), all eight.

The adapters (``pallas_env(device)``), each with the JAX signature over
the port's functions on ``device``, results back on the CPU:

* ``fused_min_dist_sq(px, py, obs, sx, sy, pt_mask, variant, obs_vel,
  time_step, interpret)``, the Pallas kernels: ``variant="mxu"`` is K2
  (``fused_min_dist_sq_expanded``) and, with ``obs_vel``, K7
  (``fused_min_dist_sq_moving_expanded``); ``"vpu"`` is K6 and K8 (the
  ``_broadcast`` forms). ``interpret`` is dropped: the port's kernels
  have no interpret mode (ROADMAP section 3, item 3); on CPU tensors the
  operators run their plain versions, on the card the kernels.
* ``fused_min_dist_sq_reference`` is K1's plain version
  (``kernels.fused_min_dist_sq_reference``), ``_min_obstacle_dist_sq``
  its obstacle sweep alone and ``_min_obstacle_dist_sq_moving`` K3's
  (``min_dist_sq_moving_reference``).
* A prefix ``pt_mask`` becomes ``active_points`` (its count); an
  ``active_points`` tensor (the solver's own call) passes as it is.

The two solver-plumbing tests run ``_truncate_scenario`` of the port's
twin of ``test_solver_modes.py`` (``test_torch_twin_tick.py``), with
``solver`` that twin's ``dwa_solve`` and ``pallas_kernels`` the port's
solver module, whose backend dispatch reads its kernels at call time:
the truncate test substitutes the ``pallas`` backend's kernel (K2,
``fused_min_dist_sq_expanded``) by the reference as the JAX test
substitutes the Pallas kernel. No test is left out.
"""

import types

import torch

from kompass_core_tpu_torch.ops import kernels

from test_torch_twin_tick import SOLVE_ENV
from torch_twin import port_twin, twin_tests

torch.set_num_threads(2)

PALLAS_REPLACE = [
    ("import jax.numpy as jnp", "from torch_twin import jnp"),
    ("from kompass_core_tpu_torch.ops.pallas_kernels import (\n"
     "    fused_min_dist_sq_reference,\n"
     ")\n"
     "from kompass_core_tpu_torch.ops.solver import _min_obstacle_dist_sq\n",
     "# fused_min_dist_sq_reference, _min_obstacle_dist_sq,\n"
     "# _min_obstacle_dist_sq_moving and fused_min_dist_sq: the twin's\n"
     "# adapters over the port's kernels and plain versions\n"
     "# (test_torch_twin_pallas_kernels.pallas_env)\n"),
    ("    from kompass_core_tpu_torch.ops.pallas_kernels import fused_min_dist_sq\n",
     "    pass  # fused_min_dist_sq: the twin's adapter\n"),
    ("    from kompass_core_tpu_torch.ops.solver import _min_obstacle_dist_sq_moving\n",
     "    pass  # _min_obstacle_dist_sq_moving: the twin's adapter\n"),
    ("    from kompass_core_tpu_torch.ops import pallas_kernels, solver\n",
     "    from kompass_core_tpu_torch.ops import solver as pallas_kernels; solver = _solver\n"),
    ("    from tests.test_solver_modes import _truncate_scenario\n",
     "    from torch_twin_test_solver_modes import _truncate_scenario\n"),
    ("        import tests.test_solver_modes as tsm\n",
     "        import torch_twin_test_solver_modes as tsm\n"),
    ("    from tests import test_solver_modes\n",
     "    import torch_twin_test_solver_modes as test_solver_modes\n"),
    ('        "fused_min_dist_sq",\n        lambda px, py, obs, sx, sy, pt_mask',
     '        "fused_min_dist_sq_expanded",\n        lambda px, py, obs, sx, sy, pt_mask'),
]
# the tests of the kernels themselves, which the card twin runs too
KERNEL_TESTS = (
    "test_fused_reference_matches_xla_sweeps",
    "test_point_on_obstacle_never_negative",
    "test_fused_moving_kernel_interpret_matches_xla",
    "test_fused_moving_zero_velocity_matches_static_sweep",
    "test_fused_static_kernel_interpret_matches_xla",
)


def pallas_env(device):
    """The twin's adapters on ``device`` (see the module's docstring)."""
    device = torch.device(device)

    def on(t):
        return torch.as_tensor(t, dtype=torch.float32).to(device).contiguous()

    def active(pt_mask):
        if pt_mask.dtype != torch.bool:
            return pt_mask
        n = int(pt_mask.sum())
        assert bool(pt_mask[:n].all()), "the port's mask is a prefix of active steps"
        return torch.tensor(n, dtype=torch.int32, device=device)

    def host(fields):
        return tuple(f.cpu() for f in fields) if isinstance(fields, tuple) else fields.cpu()

    def fused_min_dist_sq_reference(px, py, obs, sx, sy, pt_mask):
        return host(kernels.fused_min_dist_sq_reference(
            on(px), on(py), on(obs), on(sx), on(sy), active(pt_mask)))

    def _min_obstacle_dist_sq(px, py, obs, pt_mask):
        far = torch.full((1,), 1e8, device=device)
        return host(kernels.fused_min_dist_sq_reference(
            on(px), on(py), on(obs), far, far, active(pt_mask))[0])

    def _min_obstacle_dist_sq_moving(px, py, obs, vel, dt, pt_mask):
        return host(kernels.min_dist_sq_moving_reference(
            on(px), on(py), on(obs), on(vel), on(dt), active(pt_mask)))

    def fused_min_dist_sq(px, py, obs, sx, sy, pt_mask, variant="mxu", obs_vel=None,
                          time_step=None, interpret=False):
        form = {"mxu": "expanded", "vpu": "broadcast"}[variant]
        if obs_vel is None:
            fn = getattr(kernels, f"fused_min_dist_sq_{form}")
            return host(fn(on(px), on(py), on(obs), on(sx), on(sy), active(pt_mask)))
        fn = getattr(kernels, f"fused_min_dist_sq_moving_{form}")
        return host(fn(on(px), on(py), on(obs), on(obs_vel), on(time_step), on(sx),
                       on(sy), active(pt_mask)))

    return {
        "fused_min_dist_sq_reference": fused_min_dist_sq_reference,
        "_min_obstacle_dist_sq": _min_obstacle_dist_sq,
        "_min_obstacle_dist_sq_moving": _min_obstacle_dist_sq_moving,
        "fused_min_dist_sq": fused_min_dist_sq,
        # the solver the plumbing tests patch: the solver-modes twin's own
        "_solver": types.SimpleNamespace(dwa_solve=SOLVE_ENV["dwa_solve"]),
    }


twin_tests(globals(), port_twin("test_pallas_kernels", replace=PALLAS_REPLACE,
                                env=pallas_env("cpu")))
