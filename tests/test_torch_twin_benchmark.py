"""The JAX package's benchmark tests (``test_benchmark_runner.py``) run
against the port on the CPU (``torch_twin.port_twin``), all seven. The
adapters (``BENCHMARK_REPLACE`` with ``torch_twin.device_env``: the CPU
here, the card in ``test_torch_twin_cuda_main.py``): ``BenchmarkRunner``
and ``make_dwa_device_loop`` get the device (``_device``), and the
device-loop test puts its variants on it with ``torch.as_tensor`` where
the JAX test calls ``jax.device_put`` (and imports torch where it imports
jax).
"""

import torch

from torch_twin import NP, device_env, port_twin, twin_tests

torch.set_num_threads(2)

BENCHMARK_REPLACE = [
    NP,
    ("BenchmarkRunner()", "BenchmarkRunner(_device)"),
    ("    import jax\n\n    from kompass_core_tpu_torch.benchmark.device_loop",
     "    import torch\n\n    from kompass_core_tpu_torch.benchmark.device_loop"),
    ("variants.append(jax.device_put(v))",
     "variants.append(torch.as_tensor(v, device=_device))"),
    ("make_dwa_device_loop(spec, k)", "make_dwa_device_loop(spec, k, _device)"),
]

twin_tests(globals(), port_twin("test_benchmark_runner", replace=BENCHMARK_REPLACE,
                                env=device_env("cpu")))
