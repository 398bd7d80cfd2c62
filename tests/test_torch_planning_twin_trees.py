"""The JAX package's tree-family solve tests (``tests/test_planning.py``)
against the port on the CPU: see ``test_torch_planning_twin.py``."""

from test_torch_planning_twin import twin
from test_torch_host_modules import twin_tests

twin_tests(globals(), twin, names=[
    "robot", "test_tree_family_planners_solve_around_wall"])
