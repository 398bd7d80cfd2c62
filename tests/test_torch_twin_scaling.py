"""The JAX package's scaling proof (``tests/test_scaling_hlo.py``) run
against the port on the CPU (``torch_twin.port_twin``): its seven program
tests with their asserted counts unchanged, on ``FleetMesh([cpu] * 8)``
in place of the 8-device JAX mesh.

The adapters: the JAX test reads each program's collectives off its
compiled HLO (``count_collectives(<program>_hlo(mesh))``); the port's
mesh programs count their own collective calls, so ``<program>_hlo``
names ``scaling_proof.<program>_collectives``, which returns the counts
by the JAX package's HLO names, and ``count_collectives`` passes them
through. Left out: ``test_count_collectives_parses_hlo_ops``, a test of
the JAX HLO-text parser, which the port does not have (it has no HLO).
"""

import torch

from torch_twin import port_twin, twin_tests

torch.set_num_threads(2)

REPLACE = [
    ("import jax\nfrom jax.sharding import Mesh\n",
     "from kompass_core_tpu_torch.parallel import FleetMesh\n\n"),
    ("from kompass_core_tpu_torch.benchmark.scaling_proof import (\n"
     "    count_collectives,\n"
     "    fleet_solver_hlo,\n"
     "    fleet_tick_hlo,\n"
     "    sample_parallel_hlo,\n"
     ")\n",
     "from kompass_core_tpu_torch.benchmark.scaling_proof import (\n"
     "    fleet_solver_collectives as fleet_solver_hlo,\n"
     "    fleet_tick_collectives as fleet_tick_hlo,\n"
     "    sample_parallel_collectives as sample_parallel_hlo,\n"
     ")\n"
     "count_collectives = dict  # the port's programs count their own calls\n"),
    ("    devices = jax.devices()\n", "    devices = list(_mesh_devices)\n"),
    ('    assert len(devices) == 8, "conftest must provide 8 virtual devices"\n',
     '    assert len(devices) == _shards, "the twin names its mesh\'s shards"\n'),
    ('    return Mesh(np.array(devices), axis_names=("robots",))\n',
     "    return FleetMesh(devices)\n"),
]
LEFT_OUT = ("test_count_collectives_parses_hlo_ops",)


def scaling_env(devices):
    return {"_mesh_devices": [torch.device(d) for d in devices],
            "_shards": len(devices)}


twin_tests(globals(), port_twin("test_scaling_hlo", replace=REPLACE,
                                env=scaling_env(["cpu"] * 8)),
           leave_out=LEFT_OUT)
