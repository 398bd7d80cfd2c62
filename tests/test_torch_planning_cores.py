"""The port's planning geometry and roadmap programs against the JAX
package, and the shared machinery of the planning core tests.

Every device program of ``kompass_core_tpu_torch/planning`` is held
against its JAX function on the same inputs and on JAX's own draws: the
draws of a scan core are the ``jax.random`` calls of the JAX body, made
outside the scan from the same keys (``jax.random.split(key, I)``, then
the body's own split of each key), so they are the values the JAX scan
drew. The JAX side runs in a fresh process whose XLA emits no FMA
(``test_torch_kernels.jax_without_fma``): the port rounds each operation
on its own, and against XLA's fused multiply-adds a one-ulp difference
in a node's coordinates can flip a later point test and split the trees.
Discrete outputs (parents, counts, chosen nodes, found flags, bridges,
predecessors) must be equal; floats within rel 1e-4 (they differ only
through the transcendental functions, an ulp or so).

Here: the inflated grid, ``point_free``, ``segment_free`` and the check
parameters (bit for bit, in process: none of them fuses), the edge
tensor's inf pattern with and without ``knn_cap``, ``minplus_relax``,
``_graph_shortest_path``, ``fleet_shortest_paths`` and ``run_scan``'s
chunking. The tree and wavefront scans are in
``test_torch_planning_trees.py`` and ``test_torch_planning_waves.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kompass_core_tpu.planning import fleet_planner as JF
from kompass_core_tpu.planning import geometry as JG
from kompass_core_tpu.planning import planner as JP
from kompass_core_tpu_torch.planning import _scan
from kompass_core_tpu_torch.planning import fleet_planner as TF
from kompass_core_tpu_torch.planning import geometry as TG
from kompass_core_tpu_torch.planning import planner as TP

from test_torch_kernels import jax_without_fma

RTOL = 1e-4

# --- the problem: a 6 x 6 m map at 0.1 m with a wall across it, a gap on
# the right, and posts; the robot's inflation radius 0.25 m ----------------

RES = 0.1
SIZE = 60
INFLATION = 0.25
ORIGIN = np.zeros(2, np.float32)
LO = ORIGIN
HI = np.array([SIZE * RES, SIZE * RES], np.float32)
START = np.array([1.0, 1.0], np.float32)
GOAL = np.array([1.2, 5.0], np.float32)
CHECKS = 32


def wall_points():
    """The wall, and 14 posts so that a good share of every explorer's
    extensions fail (the masked updates of a failed one are held too)."""
    xs = np.arange(0.0, 4.0, 0.05)
    wall = np.stack([xs, np.full_like(xs, 3.0), np.zeros_like(xs)], axis=1)
    posts = np.random.default_rng(1).uniform(0.3, 5.7, (14, 3)) * [1, 1, 0]
    posts[:3, :2] = [[1.0, 1.9], [1.9, 1.0], [0.2, 1.1]]
    return np.concatenate([wall, posts])


def jax_grid():
    return JG.build_inflated_grid(wall_points(), (0.0, 0.0), SIZE, SIZE, RES,
                                  INFLATION)


def port_grid():
    return TG.build_inflated_grid(wall_points(), (0.0, 0.0), SIZE, SIZE, RES,
                                  INFLATION, device="cpu")


def space_args():
    """(origin, lo, hi, resolution, start, goal), as both packages take
    them."""
    return ORIGIN, LO, HI, np.float32(RES), START, GOAL


# --- JAX's draws ----------------------------------------------------------


def uniform(k):
    return jax.random.uniform(k)


def box(k):
    return jax.random.uniform(k, (2,), minval=LO, maxval=HI, dtype=jnp.float32)


def gumbel(n):
    return lambda k: jax.random.gumbel(k, (n,))


def split_uniform(j):
    """The uniform of the j-th key of a key's own split in two (the
    informed sample's)."""
    return lambda k: jax.random.uniform(jax.random.split(k)[j])


def jax_draws(seed, iterations, n_keys, fields):
    """JAX's draws of a scan core: ``fields`` is a list of (key index,
    fn) over the body's ``jax.random.split(key_i, n_keys)``; returns
    [iterations, ...] arrays."""
    keys = jax.random.split(jax.random.PRNGKey(seed), iterations)
    sub = jax.vmap(lambda k: jax.random.split(k, n_keys))(keys)
    return [np.asarray(jax.jit(jax.vmap(lambda ks, j=j, f=f: f(ks[j])))(sub))
            for j, f in fields]


def run_cases(cases):
    """{case/out/i: array, case/draw/i: array} of each (name, fn) in
    ``cases``: fn() -> (outputs, draws)."""
    fields = {}
    for name, fn in cases.items():
        outs, draws = fn()
        for i, o in enumerate(outs):
            fields[f"{name}/out/{i}"] = np.asarray(o)
        for i, d in enumerate(draws):
            fields[f"{name}/draw/{i}"] = np.asarray(d)
    return fields


def case_draws(fields, name):
    out = []
    while f"{name}/draw/{len(out)}" in fields:
        out.append(torch.from_numpy(fields[f"{name}/draw/{len(out)}"]))
    return tuple(out)


def case_outputs(fields, name):
    out = []
    while f"{name}/out/{len(out)}" in fields:
        out.append(fields[f"{name}/out/{len(out)}"])
    return out


def assert_outputs(name, got, want, discrete):
    """``discrete`` says per output whether it must be equal (else
    within ``RTOL``; infinities equal)."""
    assert len(got) == len(want) == len(discrete), name
    for i, (g, w, exact) in enumerate(zip(got, want, discrete)):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        msg = f"{name}: output {i}"
        assert g.shape == w.shape, msg
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=msg)
        else:
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=msg)
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL, atol=0,
                                       err_msg=msg)


# --- the roadmap programs -------------------------------------------------

GRAPH_K = 96


def roadmap_points(seed, K=GRAPH_K):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(LO, HI, (K, 2)).astype(np.float32)
    pts[0], pts[1] = START, GOAL
    pts[-3:] = 1e9  # parked slots, as BIT* leaves them
    return pts


GRAPH_CASES = {"knn0": (11, 2.0, 0), "knn6": (12, 2.5, 6)}
FLEET_ROBOTS = 4


def fleet_inputs():
    rng = np.random.default_rng(5)
    starts = rng.uniform(LO + 0.3, HI - 0.3, (FLEET_ROBOTS, 2)).astype(np.float32)
    goals = rng.uniform(LO + 0.3, HI - 0.3, (FLEET_ROBOTS, 2)).astype(np.float32)
    goals[-1] = starts[-1]  # an idle robot
    samples = rng.uniform(LO, HI, (80, 2)).astype(np.float32)
    return starts, goals, samples


def _jax_graph(seed, radius, knn):
    pts = roadmap_points(seed)
    return JP._graph_shortest_path(jax_grid(), ORIGIN, np.float32(RES), pts,
                                   jnp.float32(radius), edge_check_points=CHECKS,
                                   num_relax_iters=64, knn_cap=knn), ()


def _jax_fleet():
    starts, goals, samples = fleet_inputs()
    return JF.fleet_shortest_paths(
        jax_grid(), ORIGIN, np.float32(RES), starts, goals, samples,
        jnp.float32(2.0), n_robots=FLEET_ROBOTS, edge_check_points=CHECKS,
        num_relax_iters=48, knn_cap=0), ()


def jax_fields_without_fma():
    cases = {f"graph/{k}": (lambda v=v: _jax_graph(*v))
             for k, v in GRAPH_CASES.items()}
    cases["fleet"] = _jax_fleet
    return run_cases(cases)


@pytest.fixture(scope="module")
def roadmap_without_fma(tmp_path_factory):
    return jax_without_fma("test_torch_planning_cores",
                           tmp_path_factory.mktemp("no_fma") / "roadmap.npz")


# --- geometry ---------------------------------------------------------------


@pytest.mark.parametrize("inflation,res,size", [
    (0.25, 0.1, 60),  # r_cells 3
    (0.0, 0.1, 60),  # r_cells 0: the raster alone
    (0.1, 0.05000000074505806, 77),  # the turtlebot map's resolution
    (0.42, 0.07, 41),
])
def test_inflated_grid_is_bit_equal(inflation, res, size):
    rng = np.random.default_rng(int(inflation * 100) + size)
    pts = rng.uniform(-0.5, size * res + 0.5, (300, 3))
    # points on cell edges and just below the origin
    pts[:40, 0] = np.round(pts[:40, 0] / res) * res
    pts[40:50, :2] = -1e-9
    want = np.asarray(JG.build_inflated_grid(pts, (0.0, 0.0), size, size + 3,
                                             res, inflation))
    got = TG.build_inflated_grid(pts, (0.0, 0.0), size, size + 3, res,
                                 inflation, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_points(rng, n):
    """World points on and next to cell edges (0, 1 and 2 ulps off), out
    of bounds on each side, and random points. The edge at the origin is
    not stepped off: an ulp from 0 is subnormal
    (``test_point_free_keeps_subnormal_offsets``)."""
    edges = (np.round(rng.uniform(-0.3, SIZE * RES + 0.3, (n, 2)) / RES)
             * RES).astype(np.float32)
    steps = rng.integers(-2, 3, (n, 2)) * (edges != 0)
    for _ in range(2):
        edges = np.where(steps > 0, np.nextafter(edges, np.float32(np.inf)),
                         np.where(steps < 0,
                                  np.nextafter(edges, np.float32(-np.inf)),
                                  edges))
        steps = steps - np.sign(steps)
    return np.concatenate([edges.astype(np.float32),
                           rng.uniform(-1, 7, (n, 2)).astype(np.float32)])


def test_point_free_is_bit_equal_at_cell_edges():
    rng = np.random.default_rng(3)
    xy = _edge_points(rng, 400)
    want = np.asarray(JG.point_free(jax_grid(), ORIGIN, np.float32(RES), xy))
    got = TG.point_free(port_grid(), torch.from_numpy(ORIGIN),
                        torch.tensor(RES, dtype=torch.float32),
                        torch.from_numpy(xy))
    np.testing.assert_array_equal(got.numpy(), want)


def test_point_free_keeps_subnormal_offsets():
    """A point a subnormal distance left of or below the origin: XLA's CPU
    backend flushes the offset to -0 (cell 0, in bounds), the port keeps
    IEEE subnormals on every device (cell -1, out of bounds). Recorded in
    ROADMAP section 3; no map puts a point within 1.2e-38 m of its edge."""
    tiny = np.float32(1.4e-45)
    xy = np.array([[-tiny, 2.35], [2.35, -tiny], [tiny, 2.35]], np.float32)
    got = TG.point_free(port_grid(), torch.from_numpy(ORIGIN),
                        torch.tensor(RES, dtype=torch.float32),
                        torch.from_numpy(xy)).numpy()
    jax_says = np.asarray(JG.point_free(jax_grid(), ORIGIN, np.float32(RES), xy))
    np.testing.assert_array_equal(got, [False, False, True])
    np.testing.assert_array_equal(jax_says, [True, True, True])


@pytest.mark.parametrize("num", [2, 3, 7, 32, 33, 64, 100, 512])
def test_linspace_params_are_jax_linspace(num):
    want = np.asarray(jnp.linspace(0.0, 1.0, num))
    got = TG.linspace_params(num, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [2, 32, 64])
def test_segment_free_is_bit_equal(num):
    rng = np.random.default_rng(num)
    a = _edge_points(rng, 150)
    b = a[::-1] + rng.normal(0, 0.5, a.shape).astype(np.float32)
    want = np.asarray(JG.segment_free(jax_grid(), ORIGIN, np.float32(RES),
                                      a, b, num))
    got = TG.segment_free(port_grid(), torch.from_numpy(ORIGIN),
                          torch.tensor(RES, dtype=torch.float32),
                          torch.from_numpy(a), torch.from_numpy(b), num)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("knn", [0, 6])
def test_edge_weights_inf_pattern(knn):
    pts = roadmap_points(21)
    want = np.asarray(JP.build_edge_weights(
        jax_grid(), ORIGIN, np.float32(RES), jnp.asarray(pts),
        jnp.float32(2.5), CHECKS, knn))
    got = TP.build_edge_weights(
        port_grid(), torch.from_numpy(ORIGIN),
        torch.tensor(RES, dtype=torch.float32), torch.from_numpy(pts),
        torch.tensor(2.5, dtype=torch.float32), CHECKS, knn).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isfinite(want).sum() > 100
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=0)


# --- the roadmap solves -----------------------------------------------------


def test_minplus_relax_equals_jax():
    rng = np.random.default_rng(8)
    M = 40
    W = rng.uniform(0.1, 3.0, (M, M)).astype(np.float32)
    W[rng.random((M, M)) < 0.8] = np.inf
    W[:, 7] = W[:, 5]  # ties: the first index wins in both
    d0 = np.full((3, M), np.inf, np.float32)
    d0[[0, 1, 2], [0, 9, 21]] = 0.0
    p0 = np.full((3, M), -1, np.int32)
    want = JP.minplus_relax(jnp.asarray(W), jnp.asarray(d0), jnp.asarray(p0), 12)
    got = TP.minplus_relax(torch.from_numpy(W), torch.from_numpy(d0),
                           torch.from_numpy(p0), 12)
    assert_outputs("minplus", got, [np.asarray(w) for w in want],
                   (False, True))


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph_shortest_path_equals_jax(roadmap_without_fma, name):
    seed, radius, knn = GRAPH_CASES[name]
    got = TP._graph_shortest_path(port_grid(), ORIGIN, np.float32(RES),
                                  roadmap_points(seed), radius,
                                  edge_check_points=CHECKS, num_relax_iters=64,
                                  knn_cap=knn)
    want = case_outputs(roadmap_without_fma, f"graph/{name}")
    assert np.isfinite(want[0][1])  # the goal is reached
    assert_outputs(name, got, want, (False, True))


def test_fleet_shortest_paths_equals_jax(roadmap_without_fma):
    starts, goals, samples = fleet_inputs()
    got = TF.fleet_shortest_paths(
        port_grid(), ORIGIN, np.float32(RES), starts, goals, samples, 2.0,
        n_robots=FLEET_ROBOTS, edge_check_points=CHECKS, num_relax_iters=48)
    want = case_outputs(roadmap_without_fma, "fleet")
    assert_outputs("fleet", got, want, (False, False, True))
    assert np.isfinite(np.diag(want[1][:, FLEET_ROBOTS:])).sum() >= 2


# --- run_scan ---------------------------------------------------------------


def _toy_body(carry, c, i, draw):
    x, n = carry
    (u,) = draw
    x = x * c["a"] + u + i.to(torch.float32)
    return x, n + (u > 0.5).to(n.dtype)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_run_scan_chunks_equal_one_loop(chunk):
    g = torch.Generator().manual_seed(0)
    u = torch.rand(64, 3, generator=g)
    consts = {"a": torch.tensor(0.9)}
    x, n = torch.zeros(3), torch.zeros((), dtype=torch.int64)
    for i in range(64):
        x, n = _toy_body((x, n), consts, torch.tensor(i), (u[i],))
    got = _scan.run_scan(_toy_body, (torch.zeros(3), torch.zeros((), dtype=torch.int64)),
                         (u,), iterations=64, chunk=chunk, consts=consts)
    assert torch.equal(got[0], x) and torch.equal(got[1], n)


@pytest.mark.parametrize("chunk", [1, 7, 100])
def test_generator_draws_do_not_depend_on_the_chunking(chunk):
    fields = [_scan.Field("u", "uniform"), _scan.Field("p", "box", (2,)),
              _scan.Field("g", "gumbel", (5,))]
    whole = _scan.GeneratorDraws(4, fields, LO, HI)(0, 100)
    parts = _scan.GeneratorDraws(4, fields, LO, HI)
    rows = [parts(s, min(s + chunk, 100)) for s in range(0, 100, chunk)]
    for j, w in enumerate(whole):
        assert torch.equal(torch.cat([r[j] for r in rows]), w)
    assert (whole[1] >= torch.from_numpy(LO)).all()
    assert (whole[1] < torch.from_numpy(HI)).all()
    with pytest.raises(ValueError):
        parts(0, 1)  # draws are asked for in order
