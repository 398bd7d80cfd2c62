"""The port's RRT family, RRT-Connect, EST, KPIECE1 and SST scans against
the JAX package's, on JAX's own draws, the JAX side compiled without FMA
(``test_torch_planning_cores`` has the method): parents, the chosen node,
found flags and bridges equal; nodes and costs within rel 1e-4."""

from functools import partial

import numpy as np
import pytest
import torch

from kompass_core_tpu.planning import planner as JP
from kompass_core_tpu.planning import planners_ext as JE
from kompass_core_tpu_torch.planning import planner as TP
from kompass_core_tpu_torch.planning import planners_ext as TE

from test_torch_kernels import jax_without_fma
from test_torch_planning_cores import (
    CHECKS,
    assert_outputs,
    box,
    case_draws,
    case_outputs,
    gumbel,
    jax_draws,
    jax_grid,
    port_grid,
    run_cases,
    space_args,
    split_uniform,
    uniform,
)

I = 192
STEP = np.float32(0.5)

# name: (seed, flags); flags as the registry passes them
RRT_CASES = {
    "RRT": (1, dict()),
    "RRTstar": (2, dict(rewire=True)),
    "InformedRRTstar": (3, dict(rewire=True, informed=True)),
    "RRTXstatic": (4, dict(rewire=True, informed=True, cascade=True)),
    "LazyRRT": (5, dict(check_edges=False)),
    "LazyLBTRRT": (6, dict(rewire=True, check_edges=False)),
}
RRT_EPSILON = {"LazyLBTRRT": 0.4}
RRT_EPS_CONSISTENCY = {"RRTXstatic": 0.02}


def _rrt_scalars(name):
    # step, goal tolerance, goal bias, rewire factor, epsilon, eps consistency
    return (STEP, STEP, np.float32(0.1), np.float32(1.1),
            np.float32(RRT_EPSILON.get(name, 0.0)),
            np.float32(RRT_EPS_CONSISTENCY.get(name, 0.0)))


def _rrt_draw_fields(informed):
    fields = [(1, box)]
    if informed:
        fields += [(2, split_uniform(0)), (2, split_uniform(1))]
    return fields + [(0, uniform)]


def _jax_rrt(name):
    seed, flags = RRT_CASES[name]
    import jax

    outs = JP._rrt_solve(jax_grid(), *space_args(), *_rrt_scalars(name),
                         jax.random.PRNGKey(seed), max_iterations=I,
                         edge_check_points=CHECKS, **flags)
    return outs, jax_draws(seed, I, 3, _rrt_draw_fields(flags.get("informed")))


CONNECT = (9, 256, 6)  # seed, iterations, connect steps


def _jax_connect():
    import jax

    seed, iters, steps = CONNECT
    outs = JP._rrt_connect_solve(jax_grid(), *space_args(), STEP,
                                 jax.random.PRNGKey(seed), max_iterations=iters,
                                 edge_check_points=CHECKS, connect_steps=steps)
    keys = jax.random.split(jax.random.PRNGKey(seed), iters)
    draws = jax.jit(jax.vmap(box))(keys)
    return outs, [np.asarray(draws)]


GROW = 256  # iterations of the density explorers
N = GROW + 2
EST = (8, np.float32(0.2), np.float32(1.0))  # seed, goal bias, density radius
KPIECE = {"KPIECE1": (9, np.float32(0.9)), "ProjEST": (10, np.float32(0.5))}
SST = (11, np.float32(0.2), np.float32(1.0), np.float32(0.3))


def _jax_est():
    import jax

    seed, bias, radius = EST
    space = space_args()
    outs = JE.est_solve(jax_grid(), *space, STEP, bias, radius, STEP,
                        jax.random.PRNGKey(seed), max_iterations=GROW,
                        edge_check_points=CHECKS)
    return outs, jax_draws(seed, GROW, 4, [(0, gumbel(N)), (1, uniform),
                                           (2, uniform), (3, uniform)])


def _jax_kpiece(name):
    import jax

    seed, border = KPIECE[name]
    outs = JE.kpiece_solve(jax_grid(), *space_args(), STEP, np.float32(0.2),
                           border, STEP, jax.random.PRNGKey(seed),
                           max_iterations=GROW, edge_check_points=CHECKS)
    return outs, jax_draws(seed, GROW, 5, [(0, gumbel(32 * 32)), (1, gumbel(N)),
                                           (2, uniform), (3, uniform)])


def _jax_sst():
    import jax

    seed, bias, sel, prune = SST
    outs = JE.sst_solve(jax_grid(), *space_args(), STEP, bias, sel, prune, STEP,
                        jax.random.PRNGKey(seed), max_iterations=GROW,
                        edge_check_points=CHECKS)
    return outs, jax_draws(seed, GROW, 3, [(0, uniform), (1, box)])


def jax_fields_without_fma():
    cases = {f"rrt/{n}": partial(_jax_rrt, n) for n in RRT_CASES}
    cases["connect"] = _jax_connect
    cases["est"] = _jax_est
    cases.update({f"kpiece/{n}": partial(_jax_kpiece, n) for n in KPIECE})
    cases["sst"] = _jax_sst
    return run_cases(cases)


@pytest.fixture(scope="module")
def trees_without_fma(tmp_path_factory):
    return jax_without_fma("test_torch_planning_trees",
                           tmp_path_factory.mktemp("no_fma") / "trees.npz")


TREE_DISCRETE = (False, True, True, False)  # nodes, parents, best, cost


def _grown(parents, iterations):
    """Nodes grown; asserts that at least 5% of the extensions failed, so
    that the masked updates of a failed one are held too."""
    grown = int((np.asarray(parents) >= 0).sum())
    assert grown <= 0.95 * iterations
    return grown


@pytest.mark.parametrize("name", sorted(RRT_CASES))
def test_rrt_scan_equals_jax(trees_without_fma, name):
    seed, flags = RRT_CASES[name]
    key = f"rrt/{name}"
    got = TP._rrt_solve(port_grid(), *space_args(), *_rrt_scalars(name),
                        case_draws(trees_without_fma, key), max_iterations=I,
                        edge_check_points=CHECKS, **flags)
    want = case_outputs(trees_without_fma, key)
    assert _grown(want[1], I) > 30
    assert_outputs(name, got, want, TREE_DISCRETE)


def test_rrt_connect_scan_equals_jax(trees_without_fma):
    _, iters, steps = CONNECT
    got = TP._rrt_connect_solve(port_grid(), *space_args(), STEP,
                                case_draws(trees_without_fma, "connect"),
                                max_iterations=iters, edge_check_points=CHECKS,
                                connect_steps=steps)
    want = case_outputs(trees_without_fma, "connect")
    assert bool(want[2])  # the trees met
    # nodes, parents, found, bridge
    assert_outputs("connect", got, want, (False, True, True, True))


def test_est_scan_equals_jax(trees_without_fma):
    _, bias, radius = EST
    got = TE.est_solve(port_grid(), *space_args(), STEP, bias, radius, STEP,
                       case_draws(trees_without_fma, "est"),
                       max_iterations=GROW, edge_check_points=CHECKS)
    want = case_outputs(trees_without_fma, "est")
    assert _grown(want[1], GROW) > 60
    assert_outputs("est", got, want, TREE_DISCRETE)


@pytest.mark.parametrize("name", sorted(KPIECE))
def test_kpiece_scan_equals_jax(trees_without_fma, name):
    _, border = KPIECE[name]
    got = TE.kpiece_solve(port_grid(), *space_args(), STEP, np.float32(0.2),
                          border, STEP,
                          case_draws(trees_without_fma, f"kpiece/{name}"),
                          max_iterations=GROW, edge_check_points=CHECKS)
    want = case_outputs(trees_without_fma, f"kpiece/{name}")
    assert _grown(want[1], GROW) > 60
    assert_outputs(name, got, want, TREE_DISCRETE)


def test_sst_scan_equals_jax(trees_without_fma):
    _, bias, sel, prune = SST
    got = TE.sst_solve(port_grid(), *space_args(), STEP, bias, sel, prune, STEP,
                       case_draws(trees_without_fma, "sst"),
                       max_iterations=GROW, edge_check_points=CHECKS)
    want = case_outputs(trees_without_fma, "sst")
    assert _grown(want[1], GROW) > 30
    assert_outputs("sst", got, want, TREE_DISCRETE)


def test_draw_fields_name_the_jax_calls():
    """The planner makes the same draws the tests inject, field by field:
    shapes per iteration and kinds."""
    assert [f.name for f in TP.rrt_fields(True)] == [
        "uniform", "informed_r", "informed_ang", "coin"]
    assert [f.shape for f in TE.est_fields(N)] == [(N,), (), (), ()]
    assert [f.shape for f in TE.kpiece_fields(N)] == [(1024,), (N,), (), ()]
    assert [f.kind for f in TE.sst_fields()] == ["uniform", "box"]
    draws = TP.GeneratorDraws(0, TE.est_fields(N), *space_args()[1:3])(0, 5)
    assert [tuple(d.shape) for d in draws] == [(5, N), (5,), (5,), (5,)]
    assert torch.isfinite(draws[0]).all()
