"""The JAX package's fleet soak (``test_fleet_soak.py``) run against the
port on the CPU (``torch_twin.port_twin``): a 64-robot heterogeneous
fleet on an 8-shard mesh with safety, tracked movers, peers and peer
prediction, 500 ticks through ``run_ticks_on_device``, and a snapshot
replayed bit for bit by a fresh fleet. It keeps its ``slow`` marker, so
it stays outside tier-1: ``python -m pytest tests/test_torch_twin_soak.py
-m slow``. The one adapter: the mesh is ``build_fleet_mesh(["cpu"] * 8)``.
"""

import torch

from torch_twin import port_twin, twin_tests

torch.set_num_threads(2)

twin_tests(globals(), port_twin("test_fleet_soak", replace=[
    ("build_fleet_mesh()", 'build_fleet_mesh(["cpu"] * 8)'),
]))
