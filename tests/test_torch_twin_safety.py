"""The JAX package's emergency-stop tests run against the port on the CPU
(``torch_twin.port_twin``): ``EmergencyChecker`` on scans and clouds
(``test_emergency_stop.py``) and the critical zone in lockstep with the
reference oracle (``test_critical_zone_oracle.py``). The one adapter:
``EmergencyChecker`` and the zone's checker get the device (``_device``,
``_on_device``: the CPU here, the card in ``test_torch_twin_cuda.py``).
No test is left out.
"""

import torch

from torch_twin import device_env, port_twin, twin_tests

torch.set_num_threads(2)

STOP_REPLACE = [("EmergencyChecker(\n", "_on_device(EmergencyChecker)(\n")]
ZONE_REPLACE = [("get_critical_zone_checker(spec)",
                 "get_critical_zone_checker(spec, _device)")]


def safety_env(device):
    return device_env(device)


twin_tests(globals(), port_twin("test_emergency_stop", replace=STOP_REPLACE,
                                env=safety_env("cpu")))
twin_tests(globals(), port_twin("test_critical_zone_oracle", replace=ZONE_REPLACE,
                                env=safety_env("cpu")))
