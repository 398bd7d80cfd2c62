"""The JAX package's own main-path tests on the card
(``torch_twin.port_twin``), with every port entry point on
``device="cuda"`` and every mesh ``[cuda] * n``, so that they hold the
hand-written kernels, the CUDA graphs and the card's rounding, where
their CPU twins hold only the kernels' plain versions:

- the tick: ``test_oracle_parity.py``, ``test_cost_evaluator_standalone.py``,
  ``test_cost_parity.py`` (its golden dump, and the ``"pallas"`` backend,
  K2, against ``"xla"``, K1), ``test_costs.py``, ``test_collision_model.py``
  and ``test_solver_modes.py`` (the BOX corridor: K9);
- the loop: ``test_dwa_closed_loop.py``, ``test_moving_obstacles.py``
  (K3, K7, K8), ``test_config_fuzz.py``, ``test_classic_controllers.py``;
- the fleet: ``test_fleet_v2.py``, ``test_ticks_on_device.py`` (the
  k-tick CUDA graph), ``test_fleet_moving.py`` (K3, K3s) and
  ``test_fleet_safety.py``;
- scale-out: ``test_fleet.py`` and ``test_fleet_runtime.py`` on
  ``[cuda] * 8`` (``[cuda] * 4`` for the sample-parallel solve);
- the mapper: the ``test_mapping.py`` tests that ``test_torch_twin_cuda.py``
  does not run (K5) and ``test_pointcloud_raw.py`` (a host function);
- planning: ``test_planning.py`` and ``test_reference_fixtures.py``'s
  turtlebot map solved by each of the reference's 28 planner ids (its
  tier-1 CPU twin leaves them out for time);
- serving: ``test_serving_export.py``, artifacts exported for
  ``("cpu", "cuda")`` and loaded on the card, and the fresh processes it
  starts serving on the card;
- ``test_benchmark_runner.py``.

Each JAX file's tests are one class (``Test_<file>``), so that two files'
fixtures of one name stay apart. The adapters are the CPU twins' own
(``TICK_REPLACE`` and ``tick_env``, ``LOOP_REPLACE`` and ``loop_env``, and
so on), called with the card: numpy reads a tensor on the card as it
reads a JAX device array (``torch_twin._OnHost``), and ``jax.numpy``'s
constructors make tensors on the card. Left out, as from the CPU twins:
``test_mapping.py``'s TPU layout helpers. Host-only files (the window,
the path, the native library, the configuration surface, the offline
tools, vision and the host controllers) have no device and are not
twinned here.

Marked ``cuda``: each test skips on a host without a CUDA device (the
decision is taken inside the test, never at import). Nothing here
imports jax or the JAX package, so on a GPU host without jax run
``python -m pytest --noconftest tests/test_torch_twin_cuda_main.py -m cuda``.
"""

import pytest

from test_torch_planning_twin import PLANNING_REPLACE
from test_torch_scaleout_twin import SCALEOUT_REPLACE, scaleout_env
from test_torch_twin_benchmark import BENCHMARK_REPLACE
from test_torch_twin_cuda import CARD, MAPPING_CARD_TESTS, _on_card
from test_torch_twin_fixtures import FIXTURES_REPLACE
from test_torch_twin_fleet import FLEET_REPLACE, fleet_env
from test_torch_twin_loop import LOOP_REPLACE, loop_env
from test_torch_twin_map import LEFT_OUT as MAPPING_LEFT_OUT
from test_torch_twin_map import MAPPING_REPLACE, mapping_env
from test_torch_twin_tick import TICK_REPLACE, tick_env
from torch_twin import device_env, port_twin, twin_tests
from torch_twin_adapters import classic_replace, serving_env, serving_replace

pytestmark = pytest.mark.cuda


def _card_twin(name, replace=(), env=None, as_name=None, **which):
    """The card's twin of ``tests/<name>.py`` as the class ``Test_<name>``:
    its tests (or those ``which`` names, as ``twin_tests`` takes them),
    each skipping on a host without a card."""
    mod = port_twin(name, replace=replace, env=env, as_name=as_name or f"{name}_cuda")
    tests = {}
    twin_tests(tests, mod, wrap=_on_card, **which)
    cls = f"Test_{name[len('test_'):]}"
    assert cls not in globals(), f"{cls} is defined twice"
    globals()[cls] = type(cls, (), {k: staticmethod(v) for k, v in tests.items()})


# 1. the tick
for _name, _replace in TICK_REPLACE.items():
    _card_twin(_name, _replace, tick_env(CARD))

# 2. the loop
_LOOP = loop_env(CARD)
for _name, _replace in LOOP_REPLACE.items():
    _card_twin(_name, _replace, _LOOP)
_card_twin("test_classic_controllers", classic_replace("torch_twin_test_dwa_closed_loop_cuda"),
           device_env(CARD))

# 3. the fleet
for _name, _replace in FLEET_REPLACE.items():
    _card_twin(_name, _replace, fleet_env(CARD))

# 4. scale-out
for _name, _replace in SCALEOUT_REPLACE.items():
    _card_twin(_name, _replace, scaleout_env(CARD))

# 5. the mapper (test_torch_twin_cuda.py runs the LocalMapper tests)
_card_twin("test_mapping", MAPPING_REPLACE, mapping_env(CARD),
           leave_out=MAPPING_LEFT_OUT + MAPPING_CARD_TESTS)
_card_twin("test_pointcloud_raw")

# 6. planning
_card_twin("test_planning", PLANNING_REPLACE, device_env(CARD))
_card_twin("test_reference_fixtures", FIXTURES_REPLACE, device_env(CARD),
           names=("test_planner_solves_turtlebot_map",))

# 7. serving
_card_twin("test_serving_export", serving_replace(CARD), serving_env(CARD))

# 8. the benchmark runner
_card_twin("test_benchmark_runner", BENCHMARK_REPLACE, device_env(CARD))
