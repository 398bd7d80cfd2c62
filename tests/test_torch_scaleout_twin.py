"""The JAX package's scale-out tests run against the port
(``torch_twin.port_twin``): ``tests/test_fleet.py`` (the sharded fleet
solver, the sample-parallel argmin, the chunked map per shard, the pad
rows of ``FleetPlanner``) and ``tests/test_fleet_runtime.py`` (the
32-robot closed loop on an 8-shard mesh, the retry and safe stop, the
length checks, the scan bucket).

The adapters (``SCALEOUT_REPLACE``, ``scaleout_env(device)``: the CPU
here, the card in ``test_torch_twin_cuda_main.py``): every mesh is
``build_fleet_mesh([device] * 8)`` (its first 4 shards for the
sample-parallel solve; ``_mesh_devices`` also stands for the tests' JAX
devices); every one-device form names the device; a mesh result is read
with ``FleetMesh.host_rows``. No test is left out.
"""

import torch

from torch_twin import NP, device_env, port_twin, twin_tests

torch.set_num_threads(2)

SCALEOUT_REPLACE = {
    "test_fleet": [
        NP,
        ("\nimport jax\n", "\n\n"),
        ("from jax.sharding import Mesh, PartitionSpec as P",
         "from kompass_core_tpu_torch.parallel import build_fleet_mesh"),
        ('mesh = Mesh(np.array(devices), axis_names=("robots",))',
         "mesh = build_fleet_mesh(_mesh_devices)"),
        ('mesh = Mesh(np.array(devices), axis_names=("sp",))',
         'mesh = build_fleet_mesh(_mesh_devices[:4], axis_name="sp")'),
        ("FleetPlanner(SPEC, n, mesh=None)", "FleetPlanner(SPEC, n, _device)"),
        ("get_packed_dwa_solver(SPEC)(buf)", "get_packed_dwa_solver(SPEC, _device)(buf)"),
        ("np.asarray(sp_solver(bufs))", "mesh.host_rows(sp_solver(bufs))"),
        ("make_fleet_solver(SPEC, mesh=None, chunk_size=None)",
         "make_fleet_solver(SPEC, _device, chunk_size=None)"),
        ("np.asarray(solver_chunked(full))", "mesh.host_rows(solver_chunked(full))"),
        ("    import jax\n    from jax.sharding import Mesh\n", "    pass\n    pass\n"),
        ('mesh = Mesh(np.array(jax.devices()[:8]), ("robots",))',
         "mesh = build_fleet_mesh(_mesh_devices)"),
        ("jax.devices()", "_mesh_devices")],
    "test_fleet_runtime": [
        NP,
        ("mesh = build_fleet_mesh()", "mesh = build_fleet_mesh(_mesh_devices)"),
        ("rt = FleetRuntime(robots, limits, config)",
         "rt = FleetRuntime(robots, limits, config, device=_device)"),
        ("FleetRuntime(robots, [lim] * (len(robots) - 1), rt.controllers[0].config)",
         "FleetRuntime(robots, [lim] * (len(robots) - 1), rt.controllers[0].config,\n"
         "                     device=_device)")],
}


def scaleout_env(device):
    """The scale-out twins' adapters on ``device``."""
    env = device_env(device)
    return {**env, "_mesh_devices": [env["_device"]] * 8}


for _name, _replace in SCALEOUT_REPLACE.items():
    twin_tests(globals(), port_twin(_name, replace=_replace, env=scaleout_env("cpu")))
