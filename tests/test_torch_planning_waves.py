"""The port's FMT* and BFMT* wavefronts, TRRT, the bidirectional tree scan
(BiEST, SBL, BKPIECE1, LBKPIECE1) and PDST / STRIDE against the JAX
package's, on JAX's own draws and samples, the JAX side compiled without
FMA (``test_torch_planning_cores`` has the method): parents, the chosen
or meeting node, found flags and bridges equal; nodes and costs within
rel 1e-4."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kompass_core_tpu.planning import planners_ext as JE
from kompass_core_tpu.planning import planners_trees as JT
from kompass_core_tpu_torch.planning import planners_ext as TE
from kompass_core_tpu_torch.planning import planners_trees as TT

from test_torch_kernels import jax_without_fma
from test_torch_planning_cores import (
    CHECKS,
    HI,
    LO,
    RES,
    assert_outputs,
    case_draws,
    case_outputs,
    gumbel,
    jax_draws,
    jax_grid,
    port_grid,
    run_cases,
    space_args,
    uniform,
    box,
)

STEP = np.float32(0.5)
K = 200  # wavefront samples
FMT_RADIUS = np.float32(1.2)
GROW = 256
N = GROW + 2

BIDIR = {  # name: (seed, selection, check_edges)
    "BiEST": (21, "est", True),
    "SBL": (22, "grid", False),
    "BKPIECE1": (23, "border", True),
    "LBKPIECE1": (24, "border", False),
}
PDST = {"PDST": (25, False), "STRIDE": (26, True)}
TRRT = (27, 192)  # seed, iterations


def _samples(seed):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (K, 2),
                                         minval=LO, maxval=HI, dtype=jnp.float32))


def _jax_fmt(seed):
    outs = JE.fmt_solve(jax_grid(), *space_args(), FMT_RADIUS,
                        jax.random.PRNGKey(seed), num_samples=K,
                        edge_check_points=CHECKS)
    return outs, [_samples(seed)]


def _jax_bfmt(seed):
    outs = JT.bfmt_solve(jax_grid(), *space_args(), FMT_RADIUS,
                         jax.random.PRNGKey(seed), num_samples=K,
                         edge_check_points=CHECKS)
    return outs, [_samples(seed)]


def cost_field():
    return JT.clearance_cost_field(np.asarray(jax_grid()), RES)


def _trrt_scalars():
    # step, goal bias, goal tolerance, init temperature, frontier threshold
    return STEP, np.float32(0.1), STEP, np.float32(100.0), np.float32(0.125)


def _jax_trrt():
    seed, iters = TRRT
    outs = JT.trrt_solve(jax_grid(), *space_args(), jnp.asarray(cost_field()),
                         *_trrt_scalars(), jax.random.PRNGKey(seed),
                         max_iterations=iters, edge_check_points=CHECKS)
    return outs, jax_draws(seed, iters, 4, [(0, uniform), (1, box), (2, uniform)])


def _bidir_draw_fields(selection):
    picks = ([(0, gumbel(N))] if selection == "est"
             else [(0, gumbel(32 * 32)), (1, gumbel(N))])
    return picks + [(2, uniform), (3, uniform)]


def _jax_bidir(name):
    seed, selection, check_edges = BIDIR[name]
    outs = JT.bidir_tree_solve(
        jax_grid(), *space_args(), STEP, STEP, np.float32(0.9),
        jax.random.PRNGKey(seed), max_iterations=GROW, edge_check_points=CHECKS,
        selection=selection, check_edges=check_edges)
    return outs, jax_draws(seed, GROW, 4, _bidir_draw_fields(selection))


def _jax_pdst(name):
    seed, stride = PDST[name]
    outs = JT.pdst_stride_solve(
        jax_grid(), *space_args(), STEP, np.float32(0.2), STEP,
        jax.random.PRNGKey(seed), max_iterations=GROW, edge_check_points=CHECKS,
        stride=stride)
    pick_key = 0 if stride else 4
    return outs, jax_draws(seed, GROW, 5, [(pick_key, gumbel(N)), (1, uniform),
                                           (2, uniform), (3, uniform)])


def jax_fields_without_fma():
    cases = {"fmt": partial(_jax_fmt, 31), "bfmt": partial(_jax_bfmt, 32),
             "trrt": _jax_trrt}
    cases.update({f"bidir/{n}": partial(_jax_bidir, n) for n in BIDIR})
    cases.update({f"pdst/{n}": partial(_jax_pdst, n) for n in PDST})
    return run_cases(cases)


@pytest.fixture(scope="module")
def waves_without_fma(tmp_path_factory):
    return jax_without_fma("test_torch_planning_waves",
                           tmp_path_factory.mktemp("no_fma") / "waves.npz")


def test_fmt_wavefront_equals_jax(waves_without_fma):
    (samples,) = case_draws(waves_without_fma, "fmt")
    got = TE.fmt_solve(port_grid(), *space_args(), FMT_RADIUS, samples,
                       num_samples=K, edge_check_points=CHECKS)
    want = case_outputs(waves_without_fma, "fmt")
    assert np.isfinite(want[2])  # the wavefront reached the goal
    assert_outputs("fmt", got, want, (False, True, False))


def test_bfmt_wavefronts_equal_jax(waves_without_fma):
    (samples,) = case_draws(waves_without_fma, "bfmt")
    got = TT.bfmt_solve(port_grid(), *space_args(), FMT_RADIUS, samples,
                        num_samples=K, edge_check_points=CHECKS)
    want = case_outputs(waves_without_fma, "bfmt")
    assert np.isfinite(want[4])
    # pts, parent fwd, parent rev, meet, total
    assert_outputs("bfmt", got, want, (False, True, True, True, False))


def test_trrt_scan_equals_jax(waves_without_fma):
    _, iters = TRRT
    got = TT.trrt_solve(port_grid(), *space_args(), cost_field(),
                        *_trrt_scalars(), case_draws(waves_without_fma, "trrt"),
                        max_iterations=iters, edge_check_points=CHECKS)
    want = case_outputs(waves_without_fma, "trrt")
    assert 20 < (want[1] >= 0).sum() <= 0.95 * iters
    assert_outputs("trrt", got, want, (False, True, True, False))


@pytest.mark.parametrize("name", sorted(BIDIR))
def test_bidir_tree_scan_equals_jax(waves_without_fma, name):
    _, selection, check_edges = BIDIR[name]
    got = TT.bidir_tree_solve(
        port_grid(), *space_args(), STEP, STEP, np.float32(0.9),
        case_draws(waves_without_fma, f"bidir/{name}"), max_iterations=GROW,
        edge_check_points=CHECKS, selection=selection, check_edges=check_edges)
    want = case_outputs(waves_without_fma, f"bidir/{name}")
    assert 60 < (want[1] >= 0).sum() <= 0.95 * GROW
    # nodes, parents, found, bridge
    assert_outputs(name, got, want, (False, True, True, True))


@pytest.mark.parametrize("name", sorted(PDST))
def test_pdst_stride_scan_equals_jax(waves_without_fma, name):
    _, stride = PDST[name]
    got = TT.pdst_stride_solve(
        port_grid(), *space_args(), STEP, np.float32(0.2), STEP,
        case_draws(waves_without_fma, f"pdst/{name}"), max_iterations=GROW,
        edge_check_points=CHECKS, stride=stride)
    want = case_outputs(waves_without_fma, f"pdst/{name}")
    assert 60 < (want[1] >= 0).sum() <= 0.95 * GROW
    assert_outputs(name, got, want, (False, True, True, False))
