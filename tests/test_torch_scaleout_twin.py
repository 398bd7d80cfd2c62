"""The JAX package's scale-out tests run against the port
(``test_host_modules.port_twin``): ``tests/test_fleet.py`` (the sharded
fleet solver, the sample-parallel argmin, the chunked map per shard, the
pad rows of ``FleetPlanner``) and ``tests/test_fleet_runtime.py`` (the
32-robot closed loop on an 8-shard mesh, the retry and safe stop, the
length checks, the scan bucket). Every mesh is
``build_fleet_mesh(["cpu"] * 8)`` (4 shards for the sample-parallel
solve); every one-device form names the CPU; a mesh result is read with
``FleetMesh.host_rows``. No test is left out.
"""

import torch

from test_torch_host_modules import port_twin, twin_tests

torch.set_num_threads(2)

twin_tests(globals(), port_twin("test_fleet", replace=[
    ("from jax.sharding import Mesh, PartitionSpec as P",
     "from kompass_core_tpu_torch.parallel import build_fleet_mesh"),
    ('mesh = Mesh(np.array(devices), axis_names=("robots",))',
     'mesh = build_fleet_mesh(["cpu"] * 8)'),
    ('mesh = Mesh(np.array(devices), axis_names=("sp",))',
     'mesh = build_fleet_mesh(["cpu"] * 4, axis_name="sp")'),
    ("FleetPlanner(SPEC, n, mesh=None)", 'FleetPlanner(SPEC, n, "cpu")'),
    ("get_packed_dwa_solver(SPEC)(buf)", 'get_packed_dwa_solver(SPEC, "cpu")(buf)'),
    ("np.asarray(sp_solver(bufs))", "mesh.host_rows(sp_solver(bufs))"),
    ("make_fleet_solver(SPEC, mesh=None, chunk_size=None)",
     'make_fleet_solver(SPEC, "cpu", chunk_size=None)'),
    ("np.asarray(solver_chunked(full))", "mesh.host_rows(solver_chunked(full))"),
    ('mesh = Mesh(np.array(jax.devices()[:8]), ("robots",))',
     'mesh = build_fleet_mesh(["cpu"] * 8)'),
]))
twin_tests(globals(), port_twin("test_fleet_runtime", replace=[
    ("mesh = build_fleet_mesh()", 'mesh = build_fleet_mesh(["cpu"] * 8)'),
    ("rt = FleetRuntime(robots, limits, config)",
     'rt = FleetRuntime(robots, limits, config, device="cpu")'),
    ("FleetRuntime(robots, [lim] * (len(robots) - 1), rt.controllers[0].config)",
     'FleetRuntime(robots, [lim] * (len(robots) - 1), rt.controllers[0].config,\n'
     '                     device="cpu")'),
]))
