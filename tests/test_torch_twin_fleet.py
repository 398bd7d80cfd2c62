"""The JAX package's fleet tests run against the port on the CPU
(``torch_twin.port_twin``): the device fleet (``test_fleet_v2.py``),
tracked movers, peer prediction and the split sweep
(``test_fleet_moving.py``), the safety gate (``test_fleet_safety.py``)
and the k-tick loop (``test_ticks_on_device.py``).

The adapters (``FLEET_REPLACE``, ``fleet_env(device)``: the CPU here, the
card in ``test_torch_twin_cuda_main.py``): a ``DeviceFleet`` built
without a mesh gets the device (``_fleet``), every mesh is
``build_fleet_mesh([device] * 8)`` (``_mesh_devices``, which also answers
the tests' count of JAX devices), other port entry points that take a
device get it (``_on_device``), and ``jax.tree_util`` is torch's pytree.
No test is left out.
"""

import torch
from torch.utils import _pytree

from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet

from torch_twin import NP, device_env, port_twin, twin_tests

torch.set_num_threads(2)

FLEET = ("from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet",
         "from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet as _DeviceFleet")
MESH = ("build_fleet_mesh()", "build_fleet_mesh(_mesh_devices)")
# no jax: its count of devices is the twin's mesh, its tree_util torch's
# pytree
NO_JAX_IMPORT = [("    import jax\n", "    pass\n"),
                 ("len(jax.devices())", "len(_mesh_devices)")]

FLEET_REPLACE = {
    "test_fleet_v2": [
        NP, FLEET, MESH, ("\nimport jax\n", "\nfrom torch.utils import _pytree\n"),
        *NO_JAX_IMPORT, ("jax.tree_util.tree_map(", "_pytree.tree_map("),
        ("FleetRuntime(host_robots, limits, config)",
         "_on_device(FleetRuntime)(host_robots, limits, config)")],
    "test_fleet_moving": [
        NP, FLEET, MESH, *NO_JAX_IMPORT,
        ("make_fleet_tick(bad)", "_on_device(make_fleet_tick)(bad)")],
    "test_fleet_safety": [
        NP, FLEET, MESH,
        ("checker = EmergencyChecker(", "checker = _on_device(EmergencyChecker)("),
        ("make_fleet_tick(fleet.spec, safety=True)",
         "_on_device(make_fleet_tick)(fleet.spec, safety=True)")],
    "test_ticks_on_device": [NP, FLEET],
}


def fleet_env(device):
    """The fleet twins' adapters on ``device``."""
    env = device_env(device)
    device = env["_device"]

    def _fleet(*args, mesh=None, **kwargs):
        """``DeviceFleet`` on the device, or over ``mesh`` where a test gives
        one."""
        if mesh is None:
            return DeviceFleet(*args, device=device, **kwargs)
        return DeviceFleet(*args, mesh=mesh, **kwargs)

    return {**env, "DeviceFleet": _fleet, "_mesh_devices": [device] * 8,
            "_pytree": _pytree}


FLEET_ENV = fleet_env("cpu")

for _name, _replace in FLEET_REPLACE.items():
    twin_tests(globals(), port_twin(_name, replace=_replace, env=FLEET_ENV))
