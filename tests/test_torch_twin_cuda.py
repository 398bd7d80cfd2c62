"""The JAX package's assertions against the reference's recordings, run
on the card: the twins of ``test_reference_fixtures.py`` (without its
planner cases, as in ``test_torch_twin_fixtures.py``),
``test_emergency_stop.py``, ``test_critical_zone_oracle.py`` and the
``LocalMapper`` tests of ``test_mapping.py`` (the empty cloud included),
with every port entry point on ``device="cuda"``, so they hold the
hand-written kernels and not only their plain versions; the seven
program tests of ``test_scaling_hlo.py`` on a mesh ``[cuda, cuda]`` (as
``test_torch_twin_scaling.py`` runs them on eight CPU shards); and the
five kernel tests of ``test_pallas_kernels.py`` with K2, K6, K7 and K8 on
the card (``test_torch_twin_pallas_kernels.py``'s adapters).

Marked ``cuda``: each test skips on a host without a CUDA device (the
decision is taken inside the test, never at import). Nothing here
imports jax or the JAX package, so on a GPU host without jax run
``python -m pytest --noconftest tests/test_torch_twin_cuda.py -m cuda``.
"""

import functools

import pytest
import torch

from test_torch_twin_fixtures import FIXTURES_REPLACE
from test_torch_twin_fixtures import LEFT_OUT as FIXTURES_LEFT_OUT
from test_torch_twin_map import MAPPING_REPLACE, mapping_env
from test_torch_twin_pallas_kernels import KERNEL_TESTS, PALLAS_REPLACE, pallas_env
from test_torch_twin_safety import STOP_REPLACE, ZONE_REPLACE, safety_env
from test_torch_twin_scaling import LEFT_OUT as SCALING_LEFT_OUT
from test_torch_twin_scaling import REPLACE as SCALING_REPLACE
from test_torch_twin_scaling import scaling_env
from torch_twin import device_env, port_twin, twin_tests

pytestmark = pytest.mark.cuda

CARD = "cuda"


def _on_card(test):
    @functools.wraps(test)  # keeps the test's fixtures and parametrisation
    def run(*args, **kwargs):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
        return test(*args, **kwargs)
    return run


# the LocalMapper tests of test_mapping.py (test_torch_twin_cuda_main.py
# runs the rest on the card)
MAPPING_CARD_TESTS = (
    "test_local_mapper_end_to_end_laserscan", "test_local_mapper_bayesian_accumulates",
    "test_local_mapper_pointcloud_ring", "test_bayesian_grid_shift_follows_robot_motion",
    "test_local_mapper_pointcloud_z_filter_above_ceiling",
    "test_local_mapper_pointcloud_origin_only_points_filtered",
    "test_local_mapper_pointcloud_empty_cloud",
    "test_partial_fov_blind_sector_stays_unexplored")

_twin = functools.partial(twin_tests, globals(), wrap=_on_card)
_twin(port_twin("test_reference_fixtures", replace=FIXTURES_REPLACE,
                env=device_env(CARD), as_name="test_reference_fixtures_cuda"),
      leave_out=FIXTURES_LEFT_OUT)
_twin(port_twin("test_emergency_stop", replace=STOP_REPLACE, env=safety_env(CARD),
                as_name="test_emergency_stop_cuda"))
_twin(port_twin("test_critical_zone_oracle", replace=ZONE_REPLACE, env=safety_env(CARD),
                as_name="test_critical_zone_oracle_cuda"))
_twin(port_twin("test_mapping", replace=MAPPING_REPLACE, env=mapping_env(CARD),
                as_name="test_mapping_cuda"), names=MAPPING_CARD_TESTS)
class _CardShards:
    """The mesh fixture's devices: ``n`` shards on the card, or a skip on
    a host without one (the fixture runs before the wrapped test)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
        return iter([torch.device(CARD)] * self.n)


_twin(port_twin("test_scaling_hlo", replace=SCALING_REPLACE,
                env={**scaling_env([]), "_mesh_devices": _CardShards(2), "_shards": 2},
                as_name="test_scaling_hlo_cuda"), leave_out=SCALING_LEFT_OUT)
_twin(port_twin("test_pallas_kernels", replace=PALLAS_REPLACE, env=pallas_env(CARD),
                as_name="test_pallas_kernels_cuda"), names=KERNEL_TESTS)
