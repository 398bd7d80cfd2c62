"""The port's one-robot and host workflows (``examples_torch/``) against
the unmodified JAX demos (``examples/``) on the CPU: full stack, dynamic
world, RTT-amortized serving, AOT artifact, vision following and the
offline pipeline.

Every JAX demo of this module starts at once in its own subprocess (XLA
without FMA, see ``torch_examples``); each test runs the port's
``run(...)`` in this process meanwhile and compares the outcome figures
as printed. The full stack's PRM plan differs between the packages by
design (the draws), so it is held twice: both plans pass the demo's own
assertions, and both packages follow, map and e-stop equally on one
fixed path (the port's plan), the JAX demo running under a wrapper that
makes ``GlobalPlanner.solve`` return that path.
"""

import importlib
import sys

import numpy as np
import pytest

import torch_examples as tx

sys.path.insert(0, str(tx.REPO))

FIXED_PATH_WRAPPER = """\
import runpy
import sys

import numpy as np

sys.path.insert(0, {repo!r})
from kompass_core_tpu.planning import GlobalPlanner

PATH = np.load({path!r})


def solve(self):
    self.solution = PATH.copy()  # path_cost is the arc length of solution
    return self.solution


GlobalPlanner.solve = solve
sys.argv = [{script!r}]
runpy.run_path({script!r}, run_name="__main__")
"""

JAX_RUNS = {  # test key: (demo, arguments)
    "full_stack": ("full_stack_demo", ()),
    "dynamic_world": ("dynamic_world_demo", ()),
    "rtt": ("rtt_amortized_serving_demo", ("8",)),
    "aot": ("aot_artifact_demo", ()),
    "vision": ("vision_follow_demo", ()),
    "offline": ("offline_pipeline_demo", ()),
}


def port(name):
    return importlib.import_module(f"examples_torch.{name}")


@pytest.fixture(scope="module")
def fixed_path(tmp_path_factory):
    """The port's PRM plan on the CPU, saved for the JAX wrapper."""
    path, _ = port("full_stack_demo").plan("cpu")
    out = tmp_path_factory.mktemp("plan") / "path.npy"
    np.save(out, np.asarray(path))
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, fixed_path):
    procs = {key: tx.start_jax_demo(name, tmp_path_factory.mktemp(key), args)
             for key, (name, args) in JAX_RUNS.items()}
    wrapper = tmp_path_factory.mktemp("wrapper") / "fixed_path_full_stack.py"
    wrapper.write_text(FIXED_PATH_WRAPPER.format(
        repo=str(tx.REPO), path=str(fixed_path),
        script=str(tx.REPO / "examples" / "full_stack_demo.py")))
    procs["full_stack_fixed"] = tx.start_jax_demo(
        "full_stack_demo", tmp_path_factory.mktemp("fixed"), script=wrapper)
    yield procs
    tx.stop_all(procs.values())


def test_full_stack_plans_pass_the_demo_assertions(jax_runs, capsys):
    out = tx.finish(jax_runs["full_stack"], "full_stack_demo")
    jax_fig = tx.figures("full_stack_demo", out)
    mod = port("full_stack_demo")
    r = mod.run("cpu")  # asserts the demo's assertions
    with capsys.disabled():
        print(f"\nfull stack plans: JAX cost {jax_fig['path_cost']} m "
              f"({jax_fig['waypoints']} waypoints), port cost {r['path_cost']:.2f} m "
              f"({r['waypoints']} waypoints)")
    assert float(jax_fig["path_cost"]) > 7.0 and r["path_cost"] > 7.0
    assert jax_fig["reached"] == "True" and r["reached"]


def test_full_stack_follow_map_estop_on_one_path(jax_runs, fixed_path):
    out = tx.finish(jax_runs["full_stack_fixed"], "full_stack_demo")
    mod = port("full_stack_demo")
    r = mod.run("cpu", plan_path=np.load(fixed_path))
    jax_fig, _ = tx.assert_same_figures("full_stack_demo", out, r, mod.lines(r))
    assert int(jax_fig["waypoints"]) == len(np.load(fixed_path))


@pytest.mark.parametrize("key,size", [
    ("dynamic_world", {}),
    ("rtt", {"k": 8}),
    ("aot", {}),
])
def test_device_demo_matches_jax(jax_runs, key, size):
    name = JAX_RUNS[key][0]
    out = tx.finish(jax_runs[key], name)
    mod = port(name)
    r = mod.run("cpu", **size)
    tx.assert_same_figures(name, out, r, mod.lines(r))


@pytest.mark.parametrize("key", ["vision", "offline"])
def test_host_demo_matches_jax(jax_runs, key, tmp_path):
    name = JAX_RUNS[key][0]
    out = tx.finish(jax_runs[key], name)
    mod = port(name)
    r = mod.run(str(tmp_path)) if key == "offline" else mod.run()
    tx.assert_same_figures(name, out, r, mod.lines(r))

