"""Extended planner family: EST, KPIECE1, SST, FMT*, BIT*.

Counterpart of ``kompass_core_tpu/planning/planners_ext.py`` (its
docstring has the algorithms). Every sequential planner is a
fixed-capacity scan (``_scan.run_scan``: static shapes, masked growth)
that takes its draws as inputs and picks categorical choices by
Gumbel-argmax over Gumbel noise it is given; BIT* runs its batch loop on
the host (NumPy's generator, as the JAX package does) over the dense
roadmap solve PRM uses.
"""

import math
from functools import partial
from typing import Optional

import numpy as np
import torch

from ._scan import Field, GeneratorDraws, f64, norm, put, run_scan, scalar, take
from .planner import (
    INF,
    Core,
    connect_goal,
    free,
    seg_free,
    space_consts,
    steer,
)

_PROJ = 32  # KPIECE projection-grid resolution per axis

# iterations per captured chunk (a graph of a few thousand kernels)
TREE_CHUNK = 32
FMT_CHUNK = 64


def _proj_cell_of(bounds_lo, span):
    """Flattened projection-grid cell index fn (shared by the
    discretization-guided scans: KPIECE, bidir EST/SBL, PDST)."""

    def cell_of(p):
        c = torch.floor((p - bounds_lo) / span * _PROJ)
        c = torch.clamp(c, 0, _PROJ - 1).to(torch.int64)
        return c[..., 1] * _PROJ + c[..., 0]

    return cell_of


def _proj_border(occupied_flat):
    """Border mask on the flattened projection grid: occupied cells with
    at least one unoccupied 4-neighbor."""
    occ2d = occupied_flat.reshape(_PROJ, _PROJ)
    pad = torch.nn.functional.pad(occ2d, (1, 1, 1, 1), value=False)
    nbr_all = (
        pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    )
    return (occ2d & ~nbr_all).reshape(-1)


def _gumbel_pick(noise, log_weights):
    """Categorical sample via Gumbel-argmax over the given Gumbel noise
    (first index on ties, as ``jnp.argmax``). -inf weights are never
    picked (unless all are)."""
    return torch.argmax(log_weights + noise)


def _mu_free(blocked, res: float) -> float:
    """Free-space area of the inflated grid (one fetch: hoist out of
    batch loops)."""
    blocked = torch.as_tensor(blocked)
    return max(float((~blocked).sum().item()) * res * res, 1e-6)


def _edge_checks_for_radius(cfg, res: float, radius: float) -> int:
    """Edge-check count covering a given connection radius at map
    resolution (pow2-quantized, capped at the validator max 512)."""
    needed = int(math.ceil(radius / max(res, 1e-9))) + 1
    n = max(int(cfg.edge_check_points), needed)
    n = 1 << (n - 1).bit_length()
    return min(n, 512)


def _rgg_radius(mu_free: float, res: float, n: int, rewire: float) -> float:
    """PRM*/BIT* shrinking RGG connection radius for n samples."""
    gamma = rewire * 2.0 * np.sqrt(1.5) * np.sqrt(mu_free / np.pi)
    return max(gamma * np.sqrt(np.log(max(n, 2)) / n), 2.0 * res)


def _fmt_radius(mu_free: float, res: float, K: int, mult: float) -> float:
    """FMT* connection radius r_n = mult * sqrt((2/pi) mu_free log n / n)
    (Janson & Pavone 2013, d=2)."""
    r = mult * 2.0 * np.sqrt((mu_free / np.pi) * np.log(max(K, 2)) / max(K, 2))
    return max(r, 2.0 * res)


def _informed_batch(rng, start, goal, best_cost, m, lo, hi):
    """m samples for one BIT*-family batch: uniform before an incumbent
    solution exists, else direct samples of the prolate hyperspheroid with
    foci start/goal and transverse diameter ``best_cost`` (Gammell 2014)."""
    if not np.isfinite(best_cost):
        return rng.uniform(lo, hi, (m, 2))
    c_min = float(np.linalg.norm(goal - start))
    r1 = best_cost / 2.0
    r2 = np.sqrt(max(best_cost**2 - c_min**2, 1e-12)) / 2.0
    theta = np.arctan2(goal[1] - start[1], goal[0] - start[0])
    rr = np.sqrt(rng.uniform(size=m))
    aa = rng.uniform(0, 2 * np.pi, m)
    ex = r1 * rr * np.cos(aa)
    ey = r2 * rr * np.sin(aa)
    ct, st = np.cos(theta), np.sin(theta)
    centre = (start + goal) / 2.0
    batch = np.stack(
        [ct * ex - st * ey + centre[0], st * ex + ct * ey + centre[1]],
        axis=1,
    )
    return np.clip(batch, lo, hi)


def _grow_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution, start,
                 goal, edge_check_points, N, **scalars):
    """``space_consts`` plus the named float32 scalars."""
    c = space_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N)
    for name, value in scalars.items():
        c[name] = scalar(value, blocked.device)
    return c


def _tree_init(c, N):
    """nodes [N, 2] (start at 0), parents [N] = -1, costs [N] = inf but
    0 at the root, count = 1."""
    device = c["blocked"].device
    nodes = torch.zeros((N, 2), device=device)
    nodes[0] = c["start"]
    parents = torch.full((N,), -1, dtype=torch.int32, device=device)
    costs = torch.full((N,), INF, device=device)
    costs[0] = 0.0
    count = torch.ones((), dtype=torch.int64, device=device)
    return nodes, parents, costs, count


def _direction(q, goal, ang_u, length, coin, goal_bias, step):
    """The density explorers' extension: a random direction of
    ``length``, or toward the goal (at most ``step``) on the goal-bias
    coin."""
    ang = ang_u * 2.0 * math.pi
    rand_dir = torch.stack([f64(torch.cos, ang), f64(torch.sin, ang)]) * length
    to_goal = goal - q
    gd = torch.clamp(norm(to_goal), min=1e-9)
    goal_dir = to_goal / gd * torch.minimum(gd, step)
    return torch.where(coin < goal_bias, goal_dir, rand_dir)


# ---------------------------------------------------------------------------
# EST
# ---------------------------------------------------------------------------


def est_fields(N):
    """``est_solve``'s draws per iteration (keys 1-4 of the JAX body):
    the node pick's Gumbel noise [N], the direction's angle and length
    uniforms, the goal-bias coin."""
    return [Field("gumbel", "gumbel", (N,)), Field("ang", "uniform"),
            Field("length", "uniform"), Field("coin", "uniform")]


def _est_body(N, carry, c, i, draw):
    nodes, parents, costs, density, count = carry
    noise, ang_u, len_u, coin = draw
    alive = c["ar"] < count
    logw = torch.where(alive, -f64(torch.log1p, density), -INF)
    pick = _gumbel_pick(noise, logw)
    q = take(nodes, pick)
    direction = _direction(q, c["goal"], ang_u, len_u * c["step"], coin,
                           c["goal_bias"], c["step"])
    new_pt = torch.clamp(q + direction, c["lo"], c["hi"])
    ok = seg_free(c, q, new_pt) & free(c, new_pt) & (count < N)
    idx = torch.clamp(count, max=N - 1)
    nodes = put(nodes, idx, new_pt, ok)
    parents = put(parents, idx, pick, ok)
    costs = put(costs, idx, take(costs, pick) + norm(new_pt - q), ok)
    # O(N) density maintenance: the new node raises every alive
    # neighbor's count and inherits theirs (+1 for itself)
    near_new = alive & (norm(nodes - new_pt) <= c["density_radius"])
    density = torch.where(ok, put(torch.where(near_new, density + 1.0, density),
                                  idx, near_new.to(torch.float32).sum() + 1.0),
                          density)
    count = count + ok.to(count.dtype)
    return nodes, parents, costs, density, count


def est_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, goal_bias, density_radius, goal_tolerance, draws,
    max_iterations: int, edge_check_points: int, *, graphs=None,
):
    """EST: node picked with probability ∝ 1/(1+density), then a random
    bounded extension. ``draws``: ``est_fields(max_iterations + 2)``."""
    N = max_iterations + 2
    c = _grow_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N, step=step_size,
                     goal_bias=goal_bias, density_radius=density_radius,
                     goal_tolerance=goal_tolerance)
    nodes, parents, costs, count = _tree_init(c, N)
    density = torch.zeros((N,), device=blocked.device)
    density[0] = 1.0
    nodes, parents, costs, density, count = run_scan(
        partial(_est_body, N), (nodes, parents, costs, density, count), draws,
        iterations=max_iterations, chunk=TREE_CHUNK, consts=c, graphs=graphs,
        key=("est", N, edge_check_points))
    best, best_cost = connect_goal(c, nodes, costs, c["ar"] < count,
                                   c["goal_tolerance"])
    return nodes, parents, best, best_cost


# ---------------------------------------------------------------------------
# KPIECE1
# ---------------------------------------------------------------------------


def kpiece_fields(N):
    """``kpiece_solve``'s draws per iteration (keys 1-4 of the JAX body;
    key 5 is unused there): the cell pick's Gumbel noise [32 * 32], the
    node pick's [N], the angle uniform, the goal-bias coin."""
    return [Field("cell_gumbel", "gumbel", (_PROJ * _PROJ,)),
            Field("node_gumbel", "gumbel", (N,)), Field("ang", "uniform"),
            Field("coin", "uniform")]


def _kpiece_body(N, carry, c, i, draw):
    nodes, parents, costs, cells, visits, count = carry
    cell_noise, node_noise, ang_u, coin = draw
    cell_of = _proj_cell_of(c["lo"], c["span"])
    alive = c["ar"] < count
    occupied = visits > 0
    border = _proj_border(occupied)
    # KPIECE cell selection: border cells with prob border_fraction,
    # scored down by visit count
    bf = c["border_fraction"]
    pref = torch.where(border, bf, 1.0 - bf)
    logw = torch.where(occupied, f64(torch.log, pref + 1e-9) - f64(torch.log1p, visits),
                       -INF)
    cell_pick = _gumbel_pick(cell_noise, logw)
    # pick a node inside the chosen cell uniformly
    in_cell = alive & (cells == cell_pick)
    pick = _gumbel_pick(node_noise, torch.where(in_cell, 0.0, -INF))
    q = take(nodes, pick)
    direction = _direction(q, c["goal"], ang_u, c["step"], coin,
                           c["goal_bias"], c["step"])
    new_pt = torch.clamp(q + direction, c["lo"], c["hi"])
    ok = seg_free(c, q, new_pt) & free(c, new_pt) & (count < N)
    idx = torch.clamp(count, max=N - 1)
    new_cell = cell_of(new_pt)
    nodes = put(nodes, idx, new_pt, ok)
    parents = put(parents, idx, pick, ok)
    costs = put(costs, idx, take(costs, pick) + norm(new_pt - q), ok)
    cells = put(cells, idx, new_cell, ok)
    visits = put(visits, new_cell, take(visits, new_cell) + 1.0, ok)
    count = count + ok.to(count.dtype)
    return nodes, parents, costs, cells, visits, count


def kpiece_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, goal_bias, border_fraction, goal_tolerance, draws,
    max_iterations: int, edge_check_points: int, *, graphs=None,
):
    """KPIECE1: a fixed 32x32 projection of the workspace tracks visit
    counts; expansion prefers border/less-visited cells. ``draws``:
    ``kpiece_fields(max_iterations + 2)``."""
    N = max_iterations + 2
    c = _grow_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N, step=step_size,
                     goal_bias=goal_bias, border_fraction=border_fraction,
                     goal_tolerance=goal_tolerance)
    c["span"] = torch.clamp(c["hi"] - c["lo"], min=1e-6)
    cell_of = _proj_cell_of(c["lo"], c["span"])
    nodes, parents, costs, count = _tree_init(c, N)
    cells = torch.zeros((N,), dtype=torch.int64, device=blocked.device)
    start_cell = cell_of(c["start"])
    cells[0] = start_cell
    visits = torch.zeros((_PROJ * _PROJ,), device=blocked.device)
    visits[start_cell] += 1.0
    nodes, parents, costs, cells, visits, count = run_scan(
        partial(_kpiece_body, N), (nodes, parents, costs, cells, visits, count),
        draws, iterations=max_iterations, chunk=TREE_CHUNK, consts=c, graphs=graphs,
        key=("kpiece", N, edge_check_points))
    best, best_cost = connect_goal(c, nodes, costs, c["ar"] < count,
                                   c["goal_tolerance"])
    return nodes, parents, best, best_cost


# ---------------------------------------------------------------------------
# SST
# ---------------------------------------------------------------------------


def sst_fields():
    """``sst_solve``'s draws per iteration: the goal-bias coin (key 1),
    the uniform sample (key 2)."""
    return [Field("coin", "uniform"), Field("uniform", "box", (2,))]


def _sst_body(N, carry, c, i, draw):
    nodes, parents, costs, active, wit_pts, wit_rep, wit_count, count = carry
    coin, uniform = draw
    sample = torch.where(coin < c["goal_bias"], c["goal"], uniform)
    # BestNear selection: best-cost ACTIVE node within selection_radius
    # of the sample; fall back to nearest active node
    d = torch.where(active, norm(nodes - sample), INF)
    near = d <= c["selection_radius"]
    sel_cost = torch.where(near, costs, INF)
    pick = torch.where(torch.any(near), torch.argmin(sel_cost), torch.argmin(d))
    q = take(nodes, pick)
    new_pt, dn = steer(q, sample, c["step"])
    new_cost = take(costs, pick) + torch.minimum(dn, c["step"])
    ok = seg_free(c, q, new_pt) & free(c, new_pt) & (count < N)

    # witness check: closest witness within pruning_radius
    wd = norm(wit_pts - new_pt)
    wnear = torch.argmin(wd)
    has_witness = take(wd, wnear) <= c["pruning_radius"]
    rep = take(wit_rep, wnear)
    rep_cost = torch.where(rep >= 0, take(costs, torch.clamp(rep, min=0)), INF)
    accept = ok & (~has_witness | (new_cost < rep_cost))

    idx = torch.clamp(count, max=N - 1)
    nodes = put(nodes, idx, new_pt, accept)
    parents = put(parents, idx, pick, accept)
    costs = put(costs, idx, new_cost, accept)
    active = put(active, idx, True, accept)
    # deactivate the dominated representative (sparsity pruning)
    dominated = accept & has_witness & (rep >= 0)
    active = put(active, torch.clamp(rep, min=0), False, dominated)
    # update / create witness
    wit_rep = put(wit_rep, wnear, idx, accept & has_witness)
    new_wit = accept & ~has_witness & (wit_count < N)
    widx = torch.clamp(wit_count, max=N - 1)
    wit_pts = put(wit_pts, widx, new_pt, new_wit)
    wit_rep = put(wit_rep, widx, idx, new_wit)
    wit_count = wit_count + new_wit.to(wit_count.dtype)
    count = count + accept.to(count.dtype)
    return nodes, parents, costs, active, wit_pts, wit_rep, wit_count, count


def sst_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, goal_bias, selection_radius, pruning_radius, goal_tolerance,
    draws, max_iterations: int, edge_check_points: int, *, graphs=None,
):
    """SST: a witness set with ``pruning_radius`` keeps only the
    locally-best-cost node; selection picks the best-cost node within
    ``selection_radius`` of the sample (BestNear). ``draws``:
    ``sst_fields()``."""
    N = max_iterations + 2
    c = _grow_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N, step=step_size,
                     goal_bias=goal_bias, selection_radius=selection_radius,
                     pruning_radius=pruning_radius,
                     goal_tolerance=goal_tolerance)
    device = blocked.device
    nodes, parents, costs, count = _tree_init(c, N)
    active = torch.zeros((N,), dtype=torch.bool, device=device)
    active[0] = True
    # witness set: wit_pt, wit_rep (node index of the local best)
    wit_pts = torch.full((N, 2), 1e9, device=device)
    wit_pts[0] = c["start"]
    wit_rep = torch.full((N,), -1, dtype=torch.int32, device=device)
    wit_rep[0] = 0
    wit_count = torch.ones((), dtype=torch.int64, device=device)
    nodes, parents, costs, active, _, _, _, count = run_scan(
        partial(_sst_body, N),
        (nodes, parents, costs, active, wit_pts, wit_rep, wit_count, count),
        draws, iterations=max_iterations, chunk=TREE_CHUNK, consts=c, graphs=graphs,
        key=("sst", N, edge_check_points))
    alive = (c["ar"] < count) & active
    best, best_cost = connect_goal(c, nodes, costs, alive, c["goal_tolerance"])
    return nodes, parents, best, best_cost


# ---------------------------------------------------------------------------
# FMT*
# ---------------------------------------------------------------------------


def rgg(c, pts, radius):
    """The r-disc graph of the FMT* wavefronts over ``pts`` [K, 2]:
    (node_free [K], dist [K, K], nbr [K, K], edge_ok [K, K])."""
    node_free = free(c, pts)
    diff = pts[:, None, :] - pts[None, :, :]
    dist = norm(diff)
    seg_ok = seg_free(c, pts[:, None, :], pts[None, :, :])
    nbr = (
        (dist <= radius) & (dist > 0)
        & node_free[:, None] & node_free[None, :]
    )
    return node_free, dist, nbr, nbr & seg_ok


def _fmt_expand(c, cost, parent, open_, closed, gate):
    """One FMT* expansion step over the consts' r-disc graph: (cost,
    parent, open, closed, z_ok, z)."""
    oc = torch.where(open_, cost, INF)
    z = torch.argmin(oc)
    z_ok = torch.isfinite(take(oc, z)) & gate
    # frontier: unvisited neighbors of z
    unv = ~open_ & ~closed & c["node_free"] & take(c["nbr"], z)
    # single-parent connection: best OPEN y within radius of each x
    c_through = torch.where(open_[:, None] & c["nbr"], cost[:, None] + c["dist"],
                            INF)  # [K(y), K(x)]
    c_best, y_best = torch.min(c_through, dim=0)
    ok_edge = torch.gather(c["edge_ok"], 0, y_best[None, :])[0]
    newly = unv & torch.isfinite(c_best) & ok_edge & z_ok
    cost = torch.where(newly, c_best, cost)
    parent = torch.where(newly, y_best.to(torch.int32), parent)
    at_z = (c["ar"] == z) & z_ok
    return cost, parent, (open_ | newly) & ~at_z, closed | at_z, z_ok, z


def _fmt_body(carry, c, i, draw):
    cost, parent, open_, closed, done = carry
    cost, parent, open_, closed, z_ok, z = _fmt_expand(
        c, cost, parent, open_, closed, ~done)
    done = done | ~z_ok | ((z == 1) & z_ok)
    return cost, parent, open_, closed, done


def fmt_graph(blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
              radius, samples, edge_check_points: int):
    """The consts of an FMT*/BFMT* scan: the space, the K points
    (``samples`` with node 0 = start, node 1 = goal) and their r-disc
    graph."""
    K = samples.shape[0]
    c = space_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, K)
    pts = torch.as_tensor(samples).to(blocked.device, torch.float32).clone()
    pts[0] = c["start"]
    pts[1] = c["goal"]
    c["node_free"], c["dist"], c["nbr"], c["edge_ok"] = rgg(
        c, pts, scalar(radius, blocked.device))
    return pts, c


def fmt_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    radius, samples, num_samples: int, edge_check_points: int, *,
    graphs=None,
):
    """FMT* wavefront over an r-disc graph on K uniform samples
    (``samples`` [K, 2], the JAX function's ``jax.random.uniform(key,
    (K, 2), lo, hi)``). Node 0 = start, node 1 = goal. Returns (pts,
    parent, cost_to_goal)."""
    K = num_samples
    pts, c = fmt_graph(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                       start, goal, radius, samples, edge_check_points)
    device = blocked.device
    cost = torch.full((K,), INF, device=device)
    cost[0] = 0.0
    parent = torch.full((K,), -1, dtype=torch.int32, device=device)
    open_ = torch.zeros((K,), dtype=torch.bool, device=device)
    open_[0] = c["node_free"][0]
    closed = torch.zeros((K,), dtype=torch.bool, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    cost, parent, _, _, _ = run_scan(
        _fmt_body, (cost, parent, open_, closed, done), iterations=K,
        chunk=FMT_CHUNK, consts=c, graphs=graphs, key=("fmt", edge_check_points))
    return pts, parent, cost[1]


# ---------------------------------------------------------------------------
# host wrappers (registry signature: (planner, prob, seed) -> path | None)
# ---------------------------------------------------------------------------


def _trace_tree(nodes, parents, best, goal) -> Optional[np.ndarray]:
    from .planner import _walk_predecessors

    nodes = nodes.cpu().numpy()
    path = _walk_predecessors(parents.cpu().numpy(), int(best), 0)
    if path is None:
        return None
    return np.vstack([nodes[path], np.asarray(goal)[None, :]])


def _tree_args(planner, prob):
    return (
        planner._blocked,
        prob["origin"],
        prob["lo"],
        prob["hi"],
        prob["resolution"],
        prob["start"],
        prob["goal"],
    )


def _seed_draws(seed, fields, prob):
    return GeneratorDraws(seed, fields, prob["lo"], prob["hi"])


def _step(planner):
    return planner._param("range", 0.0) or planner._config.step_size


def _solve_tree(core, planner, prob, seed=0) -> Optional[np.ndarray]:
    """A one-tree core's path: the tree's parent walk from the node that
    reaches the goal, or None."""
    nodes, parents, best, cost = core.run(
        planner, prob, core.draws(planner, prob, seed), planner._graphs)
    if not np.isfinite(float(cost)):
        return None
    return _trace_tree(nodes, parents, best, prob["goal"])


def _est_draws(planner, prob, seed):
    return _seed_draws(seed, est_fields(planner._config.max_iterations + 2), prob)


def _est_run(planner, prob, draws, graphs):
    cfg = planner._config
    step = _step(planner)
    return est_solve(
        *_tree_args(planner, prob),
        step,
        planner._param("goal_bias", 0.05),
        planner._param("density_radius", 1.0),
        step,
        draws,
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        graphs=graphs,
    )


def _kpiece_draws(planner, prob, seed):
    return _seed_draws(seed, kpiece_fields(planner._config.max_iterations + 2),
                       prob)


def _kpiece_run(planner, prob, draws, graphs, border_fraction=None):
    """KPIECE1's scan; ``border_fraction`` 0.5 is ProjEST's (no border
    preference: pure density selection)."""
    cfg = planner._config
    step = _step(planner)
    if border_fraction is None:
        border_fraction = planner._param("border_fraction", 0.9)
    return kpiece_solve(
        *_tree_args(planner, prob),
        step,
        planner._param("goal_bias", 0.05),
        border_fraction,
        step,
        draws,
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        graphs=graphs,
    )


def _sst_draws(planner, prob, seed):
    return _seed_draws(seed, sst_fields(), prob)


def _sst_run(planner, prob, draws, graphs):
    cfg = planner._config
    step = _step(planner)
    return sst_solve(
        *_tree_args(planner, prob),
        step,
        planner._param("goal_bias", 0.05),
        planner._param("selection_radius", 1.0),
        planner._param("pruning_radius", 0.3),
        step,
        draws,
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        graphs=graphs,
    )


def _fmt_samples(planner, prob, seed):
    from .planner import _uniform_points

    K = int(planner._param("num_samples", planner._config.num_samples))
    return _uniform_points(seed, K, prob)


def _fmt_run(planner, prob, samples, graphs, solve=None):
    """FMT*'s wavefront (BFMT's with ``solve=bfmt_solve``) at the RGG
    radius of its sample count."""
    cfg = planner._config
    K = samples.shape[0]
    res = float(prob["resolution"])
    r = _fmt_radius(
        _mu_free(planner._blocked_host, res), res, K,
        float(planner._param("radius_multiplier", 1.1)),
    )
    return (solve or fmt_solve)(
        *_tree_args(planner, prob),
        r,
        samples,
        num_samples=K,
        # density must follow the RGG radius actually used, not the
        # (smaller) config connection_radius
        edge_check_points=_edge_checks_for_radius(cfg, res, r),
        graphs=graphs,
    )


EST = Core(_est_draws, _est_run)
KPIECE = Core(_kpiece_draws, _kpiece_run)
SST = Core(_sst_draws, _sst_run)
FMT = Core(_fmt_samples, _fmt_run)
solve_est = partial(_solve_tree, EST)
solve_kpiece = partial(_solve_tree, KPIECE)
solve_sst = partial(_solve_tree, SST)


def solve_fmt(planner, prob, seed=0) -> Optional[np.ndarray]:
    from .planner import _walk_predecessors

    pts, parent, goal_cost = _fmt_run(
        planner, prob, _fmt_samples(planner, prob, seed), planner._graphs)
    if not np.isfinite(float(goal_cost)):
        return None
    path = _walk_predecessors(parent.cpu().numpy())
    return None if path is None else pts.cpu().numpy()[path]


def solve_bitstar(planner, prob, seed=0) -> Optional[np.ndarray]:
    """Batches of informed samples over an accumulating roadmap.

    Each batch: sample ``samples_per_batch`` points (uniform before a
    solution exists, from the informed prolate hyperspheroid after),
    append to the point set, re-solve the whole roadmap with the dense
    graph solve, keep the best solution. Unfilled slots are parked at
    +1e9 (out of bounds -> not free -> no edges), so every batch has one
    shape (and, on a card, one captured relaxation)."""
    from .planner import _graph_shortest_path, _trace_prm_path

    cfg = planner._config
    m = int(planner._param("samples_per_batch", 128))
    B = int(planner._param("batches", 4))
    rewire = float(planner._param("rewire_factor", 1.1))
    K_total = 2 + m * B

    rng = np.random.default_rng(seed)
    start = np.asarray(prob["start"], np.float64)
    goal = np.asarray(prob["goal"], np.float64)
    lo = np.asarray(prob["lo"], np.float64)
    hi = np.asarray(prob["hi"], np.float64)
    pts = np.full((K_total, 2), 1e9, np.float32)
    pts[0] = start
    pts[1] = goal

    res = float(prob["resolution"])
    mu_free = _mu_free(planner._blocked_host, res)

    best_path, best_cost = None, np.inf
    for b in range(B):
        n_cur = 2 + (b + 1) * m
        batch = _informed_batch(rng, start, goal, best_cost, m, lo, hi)
        pts[2 + b * m : 2 + (b + 1) * m] = batch
        r_n = _rgg_radius(mu_free, res, n_cur, rewire)
        dist, pred = _graph_shortest_path(
            planner._blocked,
            prob["origin"],
            prob["resolution"],
            pts,
            r_n,
            edge_check_points=_edge_checks_for_radius(cfg, res, r_n),
            num_relax_iters=min(K_total, 128),
            knn_cap=0,
            graphs=planner._graphs,
        )
        path = _trace_prm_path(pts, dist.cpu().numpy(), pred.cpu().numpy())
        if path is not None:
            cost = float(
                np.hypot(*np.diff(np.asarray(path), axis=0).T).sum()
            )
            if cost < best_cost:
                best_cost = cost
                best_path = path
    return best_path
