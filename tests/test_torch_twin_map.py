"""The JAX package's mapper tests run against the port on the CPU
(``torch_twin.port_twin``): the occupancy mapper and ``LocalMapper``
(``test_mapping.py``) and the raw pointcloud-to-scan conversion
(``test_pointcloud_raw.py``).

The adapters: each mapper getter and ``LocalMapper`` gets the device
(``_device``, ``_on_device``: the CPU here, the card in
``test_torch_twin_cuda.py`` and ``test_torch_twin_cuda_main.py``), the
functions a test calls with numpy arrays get tensors on it
(``torch_twin.tensor_args``) and the probability grid
is copied with ``clone`` (a tensor on the port's device, where JAX has an
array). Left out, beside ``LEFT_OUT``: the JAX package's TPU layout
helpers, which the port does not have (its cell pass is one kernel).
"""

import torch

from kompass_core_tpu_torch.ops import mapping

from torch_twin import NP, device_env, port_twin, tensor_args, twin_tests

torch.set_num_threads(2)

GETTERS = [
    (f"{getter}({spec})", f"{getter}({spec}, _device)")
    for getter, spec in [
        ("get_scan_to_grid", "SPEC"), ("get_scan_to_grid_bayesian", "SPEC"),
        ("get_warp_previous_grid", "SPEC"), ("get_pointcloud_to_scan", "8"),
        ("get_scan_to_grid_fleet", "spec"), ("get_scan_to_grid", "spec"),
        ("get_scan_to_grid_bayesian_fleet", "spec"),
        ("get_scan_to_grid_bayesian", "spec")]
]
MAPPING_REPLACE = [NP] + GETTERS + [
    ("LocalMapper(config", "_on_device(LocalMapper)(config"),
    ("    mapper = LocalMapper(\n", "    mapper = _on_device(LocalMapper)(\n"),
    ("mapper._prev_prob.copy()", "mapper._prev_prob.clone()"),
    ("        scan_to_grid,\n        scan_to_grid_bayesian,\n    )", "\n\n    )"),
]


def mapping_env(device):
    env = device_env(device)
    return {**env, "scan_to_grid": tensor_args(mapping.scan_to_grid, env["_device"]),
            "scan_to_grid_bayesian": tensor_args(mapping.scan_to_grid_bayesian,
                                                 env["_device"])}


# the JAX package's TPU layout helpers: the dense form of the cloud's
# bin-min and the banded lookup plan of K5's Pallas form (the port's cell
# pass is one kernel; test_torch_mapping.py holds it against both lookups)
LEFT_OUT = ("test_bin_min_dense_matches_scatter", "test_banded_lookup_bit_equals_full",
            "test_banded_plan_eligibility_gates")

twin_tests(globals(), port_twin("test_mapping", replace=MAPPING_REPLACE,
                                env=mapping_env("cpu")), leave_out=LEFT_OUT)
twin_tests(globals(), port_twin("test_pointcloud_raw"))
