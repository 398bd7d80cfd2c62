"""The JAX package's tests on the reference's recorded fixtures run
against the port on the CPU (``torch_twin.port_twin`` of
``test_reference_fixtures.py``): the recorded path followed by Stanley,
DVZ, DWA and Pure Pursuit, the recorded laser scan and Livox cloud
through ``LocalMapper`` and the emergency stop on the recorded scan.

The one adapter: ``DWA``, ``LocalMapper``, ``EmergencyChecker`` and
``GlobalPlanner`` get the device (``_on_device``: the CPU here, the card
in ``test_torch_twin_cuda.py``). Left out, beside ``LEFT_OUT``: the
turtlebot map solved by each of the reference's 28 planner ids.
"""

import torch

from torch_twin import device_env, port_twin, twin_tests

torch.set_num_threads(2)

FIXTURES_REPLACE = [
    ("DWA(robot=", "_on_device(DWA)(robot="),
    ("    mapper = LocalMapper(\n", "    mapper = _on_device(LocalMapper)(\n"),
    ("    checker = EmergencyChecker(\n", "    checker = _on_device(EmergencyChecker)(\n"),
    ("GlobalPlanner(robot, config=cfg)", "_on_device(GlobalPlanner)(robot, config=cfg)"),
]

# 28 solves of about 65 s on one worker, each bounded by a 10 s
# planning_timeout that a loaded tier-1 run could exhaust (ABIT* took 12 s
# alone); test_torch_planning_twin*.py already solves a wall problem with
# every registry id against the port, and chip_smoke.py's phase_planners
# solves this turtlebot map with all 30 ids on the card
LEFT_OUT = ("test_planner_solves_turtlebot_map",)

twin_tests(globals(), port_twin("test_reference_fixtures", replace=FIXTURES_REPLACE,
                                env=device_env("cpu")),
           leave_out=LEFT_OUT)
