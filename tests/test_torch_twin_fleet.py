"""The JAX package's fleet tests run against the port on the CPU
(``torch_twin.port_twin``): the device fleet (``test_fleet_v2.py``),
tracked movers, peer prediction and the split sweep
(``test_fleet_moving.py``), the safety gate (``test_fleet_safety.py``)
and the k-tick loop (``test_ticks_on_device.py``).

The adapters: a ``DeviceFleet`` built without a mesh gets
``device="cpu"`` (``_fleet``), every mesh is ``build_fleet_mesh(["cpu"] *
8)``, and other port entry points that take a device get ``"cpu"``
(``_on_device``). No test is left out.
"""

import torch

from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet

from torch_twin import on_device, port_twin, twin_tests

torch.set_num_threads(2)


def _fleet(*args, mesh=None, **kwargs):
    """``DeviceFleet`` on the CPU, or over ``mesh`` where a test gives one."""
    if mesh is None:
        return DeviceFleet(*args, device="cpu", **kwargs)
    return DeviceFleet(*args, mesh=mesh, **kwargs)


FLEET = ("from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet",
         "from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet as _DeviceFleet")
MESH = ("build_fleet_mesh()", 'build_fleet_mesh(["cpu"] * 8)')
ENV = {"DeviceFleet": _fleet, "_on_device": on_device("cpu")}

twin_tests(globals(), port_twin("test_fleet_v2", replace=[
    FLEET, MESH,
    ("FleetRuntime(host_robots, limits, config)",
     "_on_device(FleetRuntime)(host_robots, limits, config)"),
], env=ENV))
twin_tests(globals(), port_twin("test_fleet_moving", replace=[
    FLEET, MESH, ("make_fleet_tick(bad)", "_on_device(make_fleet_tick)(bad)"),
], env=ENV))
twin_tests(globals(), port_twin("test_fleet_safety", replace=[
    FLEET, MESH,
    ("checker = EmergencyChecker(", "checker = _on_device(EmergencyChecker)("),
    ("make_fleet_tick(fleet.spec, safety=True)",
     "_on_device(make_fleet_tick)(fleet.spec, safety=True)"),
], env=ENV))
twin_tests(globals(), port_twin("test_ticks_on_device", replace=[FLEET], env=ENV))
