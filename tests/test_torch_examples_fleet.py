"""The port's fleet workflows (``examples_torch/``) against the
unmodified JAX demos (``examples/``) on the CPU: ``fleet_demo`` at 8
robots in each mode (device-resident, host-follower, crossing peers,
peer prediction, peers over a mesh of 8 shards), the serving restart and
the artifact sharded at the serving site.

Every JAX demo of this module starts at once in its own subprocess (XLA
without FMA, see ``torch_examples``); each test runs the port's
``run(...)`` in this process meanwhile and compares the outcome figures
as printed.
"""

import importlib
import sys

import pytest

import torch_examples as tx

sys.path.insert(0, str(tx.REPO))

FLEET_ROBOTS = 8  # the card runs the lane modes at the README's 100
FLEET_MODES = {  # mode: (JAX flags, the port's run() keywords)
    "lanes": ((), {}),
    "host": (("--host",), {"host_mode": True}),
    "peers": (("--peers",), {"peers": True}),
    "predict": (("--predict",), {"predict": True}),
    "mesh": (("--mesh",), {"mesh": True}),
}
SERVING = ("serving_restart_demo", "serving_mesh_shard_demo")


def port(name):
    return importlib.import_module(f"examples_torch.{name}")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    procs = {mode: tx.start_jax_demo("fleet_demo", tmp_path_factory.mktemp(mode),
                                     (str(FLEET_ROBOTS), *flags))
             for mode, (flags, _) in FLEET_MODES.items()}
    procs.update({name: tx.start_jax_demo(name, tmp_path_factory.mktemp(name))
                  for name in SERVING})
    yield procs
    tx.stop_all(procs.values())


@pytest.mark.parametrize("mode", FLEET_MODES)
def test_fleet_demo_matches_jax(jax_runs, mode):
    out = tx.finish(jax_runs[mode], "fleet_demo")
    mod = port("fleet_demo")
    r = mod.run("cpu", FLEET_ROBOTS, **FLEET_MODES[mode][1])
    tx.assert_same_figures("fleet_demo", out, r, mod.lines(r))


@pytest.mark.parametrize("name", SERVING)
def test_serving_demo_matches_jax(jax_runs, name):
    out = tx.finish(jax_runs[name], name)
    mod = port(name)
    r = mod.run("cpu")
    tx.assert_same_figures(name, out, r, mod.lines(r))


def test_fleet_demo_timings_stay_out_of_the_figures():
    """The lane modes' steady tick goes to ``timings``, not to the
    outcome figures (card == CPU compares those)."""
    mod = port("fleet_demo")
    timings = {}
    r = mod.run("cpu", 2, timings=timings)
    assert r == {"mode": "device-resident", "reached": 2, "robots": 2,
                 "ticks": r["ticks"]}
    assert timings["steady_tick_s"] > 0
