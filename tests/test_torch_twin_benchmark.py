"""The JAX package's benchmark tests (``test_benchmark_runner.py``) run
against the port on the CPU (``torch_twin.port_twin``), all seven. The
adapters: ``BenchmarkRunner`` and ``make_dwa_device_loop`` get the device
(``_device``: the CPU here), and the device-loop test puts its variants
on it with ``torch.as_tensor`` where the JAX test calls
``jax.device_put`` (and imports torch where it imports jax).
"""

import torch

from torch_twin import port_twin, twin_tests

torch.set_num_threads(2)

REPLACE = [
    ("BenchmarkRunner()", "BenchmarkRunner(_device)"),
    ("    import jax\n\n    from kompass_core_tpu_torch.benchmark.device_loop",
     "    import torch\n\n    from kompass_core_tpu_torch.benchmark.device_loop"),
    ("variants.append(jax.device_put(v))", "variants.append(torch.as_tensor(v))"),
    ("make_dwa_device_loop(spec, k)", "make_dwa_device_loop(spec, k, _device)"),
]

twin_tests(globals(), port_twin("test_benchmark_runner", replace=REPLACE,
                                env={"_device": torch.device("cpu")}))
