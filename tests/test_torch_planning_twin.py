"""The JAX package's planning tests (``tests/test_planning.py``) run
against the port on the CPU (``test_torch_host_modules.port_twin``), with
every ``GlobalPlanner`` built on ``device="cpu"``: the front end, the
configuration surface, the host passes and the roadmap, RRT and fleet
planners. Every test of that file runs in one of the three twin files;
none is left out. The port draws its own random numbers, so its paths
differ from the JAX package's for the same seed: what these tests hold is
solve quality, which is what they assert."""

from test_torch_host_modules import port_twin, twin_tests

# the test module's GlobalPlanner on the CPU; the replacement keeps the
# original's line numbers
TWIN_DEVICE = (
    "    planner_registry,\n)\n",
    "    planner_registry,\n); from functools import partial as _partial; "
    "GlobalPlanner = _partial(GlobalPlanner, device=\"cpu\")\n",
)

twin = port_twin("test_planning", replace=(TWIN_DEVICE,))

# the families' solve tests run in test_torch_planning_twin_trees.py and
# test_torch_planning_twin_ext.py
ELSEWHERE = ("test_extended_planners_solve_around_wall",
             "test_tree_family_planners_solve_around_wall",
             "test_planner_solves_around_wall", "test_prm_deterministic")

twin_tests(globals(), twin,
           names=[n for n in vars(twin) if n.startswith("test_")
                  and n not in ELSEWHERE] + ["robot"])
