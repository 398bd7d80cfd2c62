"""The JAX package's roadmap, RRT and extended-family solve tests
(``tests/test_planning.py``) against the port on the CPU: see
``test_torch_planning_twin.py``."""

from test_torch_planning_twin import twin
from test_torch_host_modules import twin_tests

twin_tests(globals(), twin, names=[
    "robot", "test_extended_planners_solve_around_wall",
    "test_planner_solves_around_wall", "test_prm_deterministic"])
