"""Second extended planner family: TRRT, the bidirectional / projection
tree planners, and the batch bidirectional wavefront.

Counterpart of ``kompass_core_tpu/planning/planners_trees.py`` (its
docstring has the algorithms): TRRT (the reference front-end's default
planner), BiEST, SBL, BKPIECE1 / LBKPIECE1, ProjEST, PDST, STRIDE and
BFMT* as fixed-capacity scans with draws as inputs, and ABIT* / AIT* as
host batch loops (NumPy's generator, as the JAX package does) over the
dense roadmap solve.
"""

from functools import partial
from typing import Optional

import numpy as np
import torch

from ._scan import Field, f64, norm, put, run_scan, scalar, take
from .planner import INF, Core, connect_goal, free, seg_free, steer
from .planners_ext import (
    FMT,
    FMT_CHUNK,
    KPIECE,
    TREE_CHUNK,
    _PROJ,
    _direction,
    _edge_checks_for_radius,
    _fmt_expand,
    _gumbel_pick,
    _grow_consts,
    _informed_batch,
    _mu_free,
    _proj_border,
    _proj_cell_of,
    _rgg_radius,
    _seed_draws,
    _solve_tree,
    _step,
    _tree_args,
    _tree_init,
    fmt_graph,
)

# ---------------------------------------------------------------------------
# TRRT
# ---------------------------------------------------------------------------


def _edt_numpy(free_cells: np.ndarray, resolution: float) -> np.ndarray:
    """Exact Euclidean distance transform without scipy: per-column
    nearest-obstacle |dy| via two cumulative passes, then an exact row
    sweep ``d²(y,x) = min_x' (x-x')² + g(y,x')²`` chunked over rows
    (O(W²·H), vectorized — a one-time per-map cost)."""
    H, W = free_cells.shape
    BIG = H + W + 1.0
    # pass 1: per-column vertical distance to the nearest obstacle cell
    g = np.where(free_cells, BIG, 0.0)
    for y in range(1, H):
        g[y] = np.minimum(g[y], g[y - 1] + 1.0)
    for y in range(H - 2, -1, -1):
        g[y] = np.minimum(g[y], g[y + 1] + 1.0)
    # pass 2: exact horizontal sweep over candidate columns
    dx2 = (np.arange(W)[:, None] - np.arange(W)[None, :]) ** 2  # [x, x']
    d = np.empty((H, W), np.float64)
    chunk = max(1, int(4e6) // (W * W))
    for y0 in range(0, H, chunk):
        gs = g[y0:y0 + chunk] ** 2  # [h, x']
        d[y0:y0 + chunk] = np.sqrt(
            np.min(gs[:, None, :] + dx2[None, :, :], axis=2)
        )
    return d * resolution


def clearance_edt(blocked: np.ndarray, resolution: float) -> np.ndarray:
    """Exact Euclidean clearance [m] to the nearest occupied cell of the
    (already robot-inflated) occupancy grid, for every cell."""
    free_cells = ~np.asarray(blocked)
    try:
        from scipy.ndimage import distance_transform_edt

        return distance_transform_edt(free_cells, sampling=resolution)
    except ImportError:  # scipy is optional: exact numpy fallback
        return _edt_numpy(free_cells, resolution)


def clearance_cost_field(blocked: np.ndarray, resolution: float) -> np.ndarray:
    """State-cost field for TRRT: inverse obstacle clearance.

    cost = 1 / (resolution + clearance) so the field is finite everywhere,
    highest at obstacle boundaries."""
    clearance = clearance_edt(blocked, resolution)
    return (1.0 / (resolution + clearance)).astype(np.float32)


def _cost_at(cost_field, origin_xy, resolution, xy):
    """Nearest-cell state-cost lookup (clipped to the border)."""
    H, W = cost_field.shape
    gx = torch.clamp(torch.floor((xy[..., 0] - origin_xy[0]) / resolution),
                     0, W - 1).to(torch.int64)
    gy = torch.clamp(torch.floor((xy[..., 1] - origin_xy[1]) / resolution),
                     0, H - 1).to(torch.int64)
    return torch.take(cost_field, gy * W + gx)


def trrt_fields():
    """``trrt_solve``'s draws per iteration: the goal-bias coin (key 1),
    the uniform sample (key 2), the transition test's uniform (key 3)."""
    return [Field("coin", "uniform"), Field("uniform", "box", (2,)),
            Field("accept", "uniform")]


def _trrt_body(N, carry, c, i, draw):
    nodes, parents, costs, scost, count, temp, n_frontier, n_refine = carry
    coin, uniform, accept_u = draw
    sample = torch.where(coin < c["goal_bias"], c["goal"], uniform)
    alive = c["ar"] < count
    d = torch.where(alive, norm(nodes - sample), INF)
    nearest = torch.argmin(d)
    q = take(nodes, nearest)
    new_pt, dn = steer(q, sample, c["step"])
    ext = torch.minimum(dn, c["step"])
    geo_ok = free(c, new_pt) & seg_free(c, q, new_pt) & (count < N)
    # transition test
    c_new = _cost_at(c["cost_field"], c["origin"], c["res"], new_pt)
    d_cost = c_new - take(scost, nearest)
    p_accept = f64(torch.exp, -d_cost / (c["K"] * temp))
    uphill = d_cost > 0
    trans_ok = ~uphill | (accept_u < p_accept)
    # min-expand control: suppress refinement moves (shorter than the
    # frontier threshold) once refinement dominates 10:1
    refinement = ext < c["frontier_threshold"]
    ratio_ok = ~refinement | (n_refine < 10.0 * n_frontier)
    ok = geo_ok & trans_ok & ratio_ok

    # adaptive temperature: reject-heats / uphill-accept-cools
    temp = torch.where(geo_ok & uphill & ~trans_ok,
                       torch.clamp(temp * 2.0, max=1e6), temp)
    temp = torch.where(ok & uphill, torch.clamp(temp * 0.5, min=1e-6), temp)
    n_frontier = n_frontier + (ok & ~refinement).to(torch.float32)
    n_refine = n_refine + (ok & refinement).to(torch.float32)

    idx = torch.clamp(count, max=N - 1)
    nodes = put(nodes, idx, new_pt, ok)
    parents = put(parents, idx, nearest, ok)
    costs = put(costs, idx, take(costs, nearest) + ext, ok)
    scost = put(scost, idx, c_new, ok)
    count = count + ok.to(count.dtype)
    return nodes, parents, costs, scost, count, temp, n_frontier, n_refine


def trrt_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    cost_field, step_size, goal_bias, goal_tolerance, init_temperature,
    frontier_threshold, draws, max_iterations: int, edge_check_points: int,
    *, graphs=None,
):
    """Transition-based RRT as a scan: RRT extension plus the TRRT
    transition test over ``cost_field`` with an adaptive temperature
    (the JAX function's docstring has the rules). ``draws``:
    ``trrt_fields()``."""
    N = max_iterations + 2
    c = _grow_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N, step=step_size,
                     goal_bias=goal_bias, goal_tolerance=goal_tolerance,
                     frontier_threshold=frontier_threshold)
    device = blocked.device
    c["cost_field"] = torch.as_tensor(cost_field).to(device, torch.float32)
    # the field's mean, summed in float64 (the cost scale of the test)
    c["K"] = torch.clamp(c["cost_field"].double().mean().float(), min=1e-6)
    nodes, parents, costs, count = _tree_init(c, N)
    scost = torch.zeros((N,), device=device)
    scost[0] = _cost_at(c["cost_field"], c["origin"], c["res"], c["start"])
    temp = scalar(init_temperature, device)
    # frontier-node / refinement-node balance (nonFrontierNodeRatio)
    n_frontier = torch.ones((), device=device)
    n_refine = torch.zeros((), device=device)
    nodes, parents, costs, scost, count, *_ = run_scan(
        partial(_trrt_body, N),
        (nodes, parents, costs, scost, count, temp, n_frontier, n_refine),
        draws, iterations=max_iterations, chunk=TREE_CHUNK, consts=c, graphs=graphs,
        key=("trrt", N, edge_check_points))
    best, best_cost = connect_goal(c, nodes, costs, c["ar"] < count,
                                   c["goal_tolerance"])
    return nodes, parents, best, best_cost


# ---------------------------------------------------------------------------
# generic bidirectional grown-tree scan (BiEST / SBL / [L]BKPIECE1)
# ---------------------------------------------------------------------------


def bidir_fields(selection: str, N: int):
    """``bidir_tree_solve``'s draws per iteration (keys 1-4 of the JAX
    body): "est" picks a node by Gumbel noise [N] (key 1); "grid" and
    "border" pick a cell [32 * 32] (key 1), then a node in it [N] (key
    2); then the angle and length uniforms (keys 3, 4)."""
    if selection == "est":
        picks = [Field("gumbel", "gumbel", (N,))]
    else:
        picks = [Field("cell_gumbel", "gumbel", (_PROJ * _PROJ,)),
                 Field("node_gumbel", "gumbel", (N,))]
    return picks + [Field("ang", "uniform"), Field("length", "uniform")]


def _tree_row(x, tree):
    """Row ``tree`` (0-d index) of a [2, ...] tensor."""
    return x.index_select(0, tree.reshape(1)).squeeze(0)


def _bidir_body(st, carry, c, i, draw):
    N, selection, check_edges = st
    nodes, parents, density, cells, visits, counts, found, bridge = carry
    a = i % 2  # the tree grown this iteration (alternates)
    b = 1 - a
    cell_of = _proj_cell_of(c["lo"], c["span"])
    cnt_a = take(counts, a)
    alive = c["ar"] < cnt_a
    nodes_a = _tree_row(nodes, a)
    if selection == "est":
        logw = torch.where(alive, -f64(torch.log1p, _tree_row(density, a)), -INF)
        pick = _gumbel_pick(draw[0], logw)
    else:
        visits_a = _tree_row(visits, a)
        occupied = visits_a > 0
        if selection == "border":
            bf = c["border_fraction"]
            pref = torch.where(_proj_border(occupied), bf, 1.0 - bf)
            logc = torch.where(
                occupied,
                f64(torch.log, pref + 1e-9) - f64(torch.log1p, visits_a), -INF)
        else:  # "grid": SBL picks cells inversely to visit count
            logc = torch.where(occupied, -f64(torch.log1p, visits_a), -INF)
        cell_pick = _gumbel_pick(draw[0], logc)
        in_cell = alive & (_tree_row(cells, a) == cell_pick)
        pick = _gumbel_pick(draw[1], torch.where(in_cell, 0.0, -INF))
    ang_u, len_u = draw[-2], draw[-1]

    q = take(nodes_a, pick)
    ang = ang_u * 2.0 * torch.pi
    new_pt = torch.clamp(
        q + torch.stack([f64(torch.cos, ang), f64(torch.sin, ang)])
        * (len_u * c["step"]),
        c["lo"], c["hi"])
    ok = free(c, new_pt) & (cnt_a < N) & ~found
    if check_edges:
        ok = ok & seg_free(c, q, new_pt)
    idx = torch.clamp(cnt_a, max=N - 1)
    new_cell = cell_of(new_pt)
    flat = a * N + idx  # row of (tree a, slot idx) in the [2N, ...] layout
    nodes = put(nodes.view(2 * N, 2), flat, new_pt, ok).view(2, N, 2)
    parents = put(parents.view(2 * N), flat, pick, ok).view(2, N)
    cells = put(cells.view(2 * N), flat, new_cell, ok).view(2, N)
    vflat = a * (_PROJ * _PROJ) + new_cell
    visits_flat = visits.view(-1)
    visits = put(visits_flat, vflat, take(visits_flat, vflat) + 1.0, ok).view(
        visits.shape)
    nodes_a = _tree_row(nodes, a)
    near_new = alive & (norm(nodes_a - new_pt) <= c["density_radius"])
    dens_a = _tree_row(density, a)
    dens_a = put(torch.where(near_new, dens_a + 1.0, dens_a), idx,
                 near_new.to(torch.float32).sum() + 1.0)
    density = put(density, a, dens_a, ok)
    counts = put(counts, a, cnt_a + 1, ok)

    # connect attempt: nearest node of the other tree within step_size
    nodes_b = _tree_row(nodes, b)
    alive_b = c["ar"] < take(counts, b)
    db = torch.where(alive_b, norm(nodes_b - new_pt), INF)
    nb = torch.argmin(db)
    link_ok = ok & (take(db, nb) <= c["step"])
    if check_edges:
        link_ok = link_ok & seg_free(c, new_pt, take(nodes_b, nb))
    new_bridge = torch.where(a == 0, torch.stack([idx, nb]),
                             torch.stack([nb, idx])).to(torch.int32)
    bridge = torch.where(link_ok & ~found, new_bridge, bridge)
    return (nodes, parents, density, cells, visits, counts, found | link_ok,
            bridge)


def bidir_tree_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, density_radius, border_fraction, draws,
    max_iterations: int, edge_check_points: int,
    selection: str = "est",  # "est" | "grid" | "border"
    check_edges: bool = True,
    *, graphs=None,
):
    """Two grown trees (start / goal) with pluggable node selection and a
    connect attempt per iteration (``selection``: "est" BiEST, "grid"
    SBL, "border" BKPIECE1; ``check_edges=False`` lazy growth, SBL /
    LBKPIECE1). ``draws``: ``bidir_fields(selection, max_iterations + 2)``.

    Returns (nodes [2,N,2], parents [2,N], found, bridge [2])."""
    N = max_iterations + 2
    c = _grow_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N, step=step_size,
                     density_radius=density_radius,
                     border_fraction=border_fraction)
    c["span"] = torch.clamp(c["hi"] - c["lo"], min=1e-6)
    cell_of = _proj_cell_of(c["lo"], c["span"])
    device = blocked.device
    nodes = torch.zeros((2, N, 2), device=device)
    nodes[0, 0] = c["start"]
    nodes[1, 0] = c["goal"]
    parents = torch.full((2, N), -1, dtype=torch.int32, device=device)
    density = torch.zeros((2, N), device=device)
    density[:, 0] = 1.0
    cells = torch.zeros((2, N), dtype=torch.int64, device=device)
    cs, cg = cell_of(c["start"]), cell_of(c["goal"])
    cells[0, 0] = cs
    cells[1, 0] = cg
    visits = torch.zeros((2, _PROJ * _PROJ), device=device)
    visits[0, cs] += 1.0
    visits[1, cg] += 1.0
    counts = torch.ones((2,), dtype=torch.int64, device=device)
    found = torch.zeros((), dtype=torch.bool, device=device)
    bridge = torch.full((2,), -1, dtype=torch.int32, device=device)
    st = (N, selection, check_edges)
    nodes, parents, _, _, _, _, found, bridge = run_scan(
        partial(_bidir_body, st),
        (nodes, parents, density, cells, visits, counts, found, bridge),
        draws, iterations=max_iterations, chunk=TREE_CHUNK, consts=c, graphs=graphs,
        key=("bidir",) + st + (edge_check_points,))
    return nodes, parents, found, bridge


# ---------------------------------------------------------------------------
# PDST / STRIDE (unidirectional, non-uniform selection)
# ---------------------------------------------------------------------------


def pdst_fields(N: int):
    """``pdst_stride_solve``'s draws per iteration: the node pick's
    Gumbel noise [N] (key 1 for STRIDE, key 5 for PDST), the angle and
    length uniforms (keys 2, 3), the goal-bias coin (key 4)."""
    return [Field("gumbel", "gumbel", (N,)), Field("ang", "uniform"),
            Field("length", "uniform"), Field("coin", "uniform")]


def _pdst_body(st, carry, c, i, draw):
    N, stride = st
    nodes, parents, costs, cells, cell_prio, nn_d, count = carry
    noise, ang_u, len_u, coin = draw
    cell_of = _proj_cell_of(c["lo"], c["span"])
    alive = c["ar"] < count
    if stride:
        logw = torch.where(alive, 4.0 * f64(torch.log, nn_d + 1e-6), -INF)
        pick = _gumbel_pick(noise, logw)
    else:
        cmin = torch.argmin(cell_prio)
        in_cell = alive & (cells == cmin)
        pick = _gumbel_pick(noise, torch.where(in_cell, 0.0, -INF))
        # demote on SELECTION, not on propagation success — otherwise a
        # cell trapped against an obstacle is re-picked forever
        cell_prio = put(cell_prio, cmin, take(cell_prio, cmin) * 2.0 + 1.0)

    q = take(nodes, pick)
    direction = _direction(q, c["goal"], ang_u, len_u * c["step"], coin,
                           c["goal_bias"], c["step"])
    new_pt = torch.clamp(q + direction, c["lo"], c["hi"])
    ok = free(c, new_pt) & seg_free(c, q, new_pt) & (count < N)
    idx = torch.clamp(count, max=N - 1)
    new_cell = cell_of(new_pt)
    cells = put(cells, idx, new_cell, ok)
    # unseen cell enters the queue at priority = iteration index
    cell_prio = put(cell_prio, new_cell, i.to(torch.float32),
                    ok & torch.isinf(take(cell_prio, new_cell)))
    d_new = norm(nodes - new_pt)
    nn_new = torch.min(torch.where(alive, d_new, INF))
    nn_d = torch.where(
        ok, put(torch.where(alive & (d_new < nn_d), d_new, nn_d), idx, nn_new),
        nn_d)
    # STRIDE stagnation guard: failed extensions shrink the picked
    # node's sparsity estimate so blocked frontier nodes lose weight
    nn_d = put(nn_d, pick, take(nn_d, pick) * 0.7, ~ok)
    nodes = put(nodes, idx, new_pt, ok)
    parents = put(parents, idx, pick, ok)
    costs = put(costs, idx, take(costs, pick) + norm(new_pt - q), ok)
    count = count + ok.to(count.dtype)
    return nodes, parents, costs, cells, cell_prio, nn_d, count


def pdst_stride_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, goal_bias, goal_tolerance, draws,
    max_iterations: int, edge_check_points: int, stride: bool = False,
    *, graphs=None,
):
    """PDST (stride=False): lowest-priority projection-cell selection,
    the cell's priority doubling (+1) on selection; STRIDE (stride=True):
    selection weight ∝ (1-NN distance)⁴. ``draws``:
    ``pdst_fields(max_iterations + 2)``."""
    N = max_iterations + 2
    c = _grow_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N, step=step_size,
                     goal_bias=goal_bias, goal_tolerance=goal_tolerance)
    c["span"] = torch.clamp(c["hi"] - c["lo"], min=1e-6)
    cell_of = _proj_cell_of(c["lo"], c["span"])
    device = blocked.device
    nodes, parents, costs, count = _tree_init(c, N)
    cells = torch.zeros((N,), dtype=torch.int64, device=device)
    start_cell = cell_of(c["start"])
    cells[0] = start_cell
    cell_prio = torch.full((_PROJ * _PROJ,), INF, device=device)
    cell_prio[start_cell] = 0.0
    nn_d = torch.full((N,), INF, device=device)  # STRIDE 1-NN distances
    nn_d[0] = 1e3
    st = (N, bool(stride))
    nodes, parents, costs, _, _, _, count = run_scan(
        partial(_pdst_body, st),
        (nodes, parents, costs, cells, cell_prio, nn_d, count),
        draws, iterations=max_iterations, chunk=TREE_CHUNK, consts=c, graphs=graphs,
        key=("pdst",) + st + (edge_check_points,))
    best, best_cost = connect_goal(c, nodes, costs, c["ar"] < count,
                                   c["goal_tolerance"])
    return nodes, parents, best, best_cost


# ---------------------------------------------------------------------------
# BFMT*
# ---------------------------------------------------------------------------


def _bfmt_body(K, carry, c, i, draw):
    cost, parent, open_, closed, meet, done = carry
    a = i % 2
    ca, pa, oa, cla, z_ok, z = _fmt_expand(
        c, _tree_row(cost, a), _tree_row(parent, a), _tree_row(open_, a),
        _tree_row(closed, a), ~done)
    z = torch.where(z_ok, z, -1)
    cost = put(cost, a, ca)
    parent = put(parent, a, pa)
    open_ = put(open_, a, oa)
    closed = put(closed, a, cla)
    # meet test: the node just expanded is closed by BOTH sides
    zs = torch.clamp(z, min=0)
    hit = (z >= 0) & take(closed[0], zs) & take(closed[1], zs)
    meet = torch.where(hit & (meet < 0), z, meet)
    done = done | hit | (z < 0)
    return cost, parent, open_, closed, meet, done


def bfmt_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    radius, samples, num_samples: int, edge_check_points: int, *,
    graphs=None,
):
    """Bidirectional FMT*: two wavefronts (from start = node 0 and goal =
    node 1) alternate lowest-cost-first expansion over ONE shared r-disc
    graph on ``samples`` [K, 2]; they stop when a side expands a node the
    other side has closed.

    Returns (pts, parent_fwd, parent_rev, meet, total_cost): the path is
    start →(parent_fwd)→ meet →(parent_rev)→ goal."""
    K = num_samples
    pts, c = fmt_graph(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                       start, goal, radius, samples, edge_check_points)
    device = blocked.device
    cost = torch.full((2, K), INF, device=device)
    cost[0, 0] = 0.0
    cost[1, 1] = 0.0
    parent = torch.full((2, K), -1, dtype=torch.int32, device=device)
    open_ = torch.zeros((2, K), dtype=torch.bool, device=device)
    open_[0, 0] = c["node_free"][0]
    open_[1, 1] = c["node_free"][1]
    closed = torch.zeros((2, K), dtype=torch.bool, device=device)
    meet = torch.full((), -1, dtype=torch.int64, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    cost, parent, _, _, meet, _ = run_scan(
        partial(_bfmt_body, K), (cost, parent, open_, closed, meet, done),
        iterations=2 * K, chunk=FMT_CHUNK, consts=c, graphs=graphs,
        key=("bfmt", edge_check_points))
    # fallback meet: cheapest node closed/reached by both sides
    both = torch.isfinite(cost[0]) & torch.isfinite(cost[1])
    total = torch.where(both, cost[0] + cost[1], INF)
    meet = torch.where(meet >= 0, meet, torch.argmin(total))
    return pts, parent[0], parent[1], meet.to(torch.int32), take(total, meet)


# ---------------------------------------------------------------------------
# host wrappers
# ---------------------------------------------------------------------------


def _trrt_draws(planner, prob, seed):
    return _seed_draws(seed, trrt_fields(), prob)


def _trrt_run(planner, prob, draws, graphs):
    cfg = planner._config
    step = _step(planner)
    # key the cache on the grid OBJECT (identity, holding the reference):
    # setup_problem rebinds _blocked, and the field is stale then
    if getattr(planner, "_cost_field_src", None) is not planner._blocked:
        planner._cost_field = torch.from_numpy(
            clearance_cost_field(planner._blocked_host.numpy(),
                                 float(prob["resolution"]))
        ).to(planner._blocked.device)
        planner._cost_field_src = planner._blocked
    return trrt_solve(
        *_tree_args(planner, prob),
        planner._cost_field,
        step,
        planner._param("goal_bias", 0.05),
        step,
        planner._param("init_temperature", 100.0),
        planner._param("frontier_threshold", 0.0) or 0.25 * step,
        draws,
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        graphs=graphs,
    )


def _trace_bidir(nodes, parents, bridge) -> Optional[np.ndarray]:
    from .planner import _walk_predecessors

    nodes = nodes.cpu().numpy()
    parents = parents.cpu().numpy()
    bridge = bridge.cpu().numpy()
    c0 = _walk_predecessors(parents[0], int(bridge[0]), 0)  # start->junction
    c1 = _walk_predecessors(parents[1], int(bridge[1]), 0)  # goal->junction
    if c0 is None or c1 is None:
        return None
    return np.concatenate([nodes[0][c0], nodes[1][c1[::-1]]])


def _bidir_draws(planner, prob, seed, selection="est"):
    N = planner._config.max_iterations + 2
    return _seed_draws(seed, bidir_fields(selection, N), prob)


def _bidir_run(planner, prob, draws, graphs, selection="est",
               check_edges=True):
    cfg = planner._config
    step = _step(planner)
    return bidir_tree_solve(
        *_tree_args(planner, prob),
        step,
        planner._param("density_radius", 0.0) or step,
        planner._param("border_fraction", 0.9),
        draws,
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        selection=selection,
        check_edges=check_edges,
        graphs=graphs,
    )


def solve_bidir(planner, prob, seed=0, selection="est", check_edges=True):
    """BiEST ("est"), SBL ("grid", lazy), BKPIECE1 ("border") and
    LBKPIECE1 ("border", lazy)."""
    nodes, parents, found, bridge = _bidir_run(
        planner, prob, _bidir_draws(planner, prob, seed, selection),
        planner._graphs, selection, check_edges)
    if not bool(found):
        return None
    pts = _trace_bidir(nodes, parents, bridge)
    if pts is None:
        return None
    if not check_edges:
        # lazy growth: validate the traced solution; on failure repair by
        # re-solving the same seed with motion checks on
        for a, b in zip(pts[:-1], pts[1:]):
            if not planner._segment_free_host(a, b):
                return solve_bidir(planner, prob, seed=seed,
                                   selection=selection, check_edges=True)
    return pts


def _pdst_draws(planner, prob, seed):
    return _seed_draws(seed, pdst_fields(planner._config.max_iterations + 2),
                       prob)


def _pdst_run(planner, prob, draws, graphs, stride=False):
    cfg = planner._config
    step = _step(planner)
    return pdst_stride_solve(
        *_tree_args(planner, prob),
        step,
        planner._param("goal_bias", 0.05),
        step,
        draws,
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        stride=stride,
        graphs=graphs,
    )


TRRT = Core(_trrt_draws, _trrt_run)
BIDIR = Core(_bidir_draws, _bidir_run)
# ProjEST: EST with projection-grid density, KPIECE's grid scan with the
# border preference off (pure visit-count density: ProjEST's selection)
PROJ_EST = Core(KPIECE.draws, partial(KPIECE.run, border_fraction=0.5))
PDST = Core(_pdst_draws, _pdst_run)
STRIDE = Core(_pdst_draws, partial(_pdst_run, stride=True))
BFMT = Core(FMT.draws, partial(FMT.run, solve=bfmt_solve))
solve_trrt = partial(_solve_tree, TRRT)
solve_proj_est = partial(_solve_tree, PROJ_EST)
solve_pdst = partial(_solve_tree, PDST)
solve_stride = partial(_solve_tree, STRIDE)




def solve_bfmt(planner, prob, seed=0) -> Optional[np.ndarray]:
    from .planner import _walk_predecessors

    pts, parent_f, parent_r, meet, total = BFMT.run(
        planner, prob, BFMT.draws(planner, prob, seed), planner._graphs)
    if not np.isfinite(float(total)):
        return None
    pts = pts.cpu().numpy()
    meet = int(meet)
    fwd = _walk_predecessors(parent_f.cpu().numpy(), meet, 0)  # start -> meet
    rev = _walk_predecessors(parent_r.cpu().numpy(), meet, 1)  # goal -> meet
    if fwd is None or rev is None:
        return None
    return pts[fwd + rev[::-1][1:]]


def solve_abitstar(planner, prob, seed=0) -> Optional[np.ndarray]:
    """ABIT* (Strub & Gammell 2020): BIT* batches with an INFLATED search
    radius schedule (2.0 -> 1.0 across batches) and informed PRUNING of
    accumulated samples whose ``|x - start| + |x - goal|`` exceeds the
    incumbent solution cost (parked out of bounds)."""
    from .planner import _graph_shortest_path, _trace_prm_path

    cfg = planner._config
    m = int(planner._param("samples_per_batch", 128))
    B = int(planner._param("batches", 4))
    rewire = float(planner._param("rewire_factor", 1.1))
    infl0 = float(planner._param("initial_inflation", 2.0))
    K_total = 2 + m * B

    rng = np.random.default_rng(seed)
    start = np.asarray(prob["start"], np.float64)
    goal = np.asarray(prob["goal"], np.float64)
    lo = np.asarray(prob["lo"], np.float64)
    hi = np.asarray(prob["hi"], np.float64)
    res = float(prob["resolution"])
    pts = np.full((K_total, 2), 1e9, np.float32)
    pts[0] = start
    pts[1] = goal
    mu_free = _mu_free(planner._blocked_host, res)  # one fetch, not per batch

    best_path, best_cost = None, np.inf
    for b in range(B):
        batch = _informed_batch(rng, start, goal, best_cost, m, lo, hi)
        pts[2 + b * m : 2 + (b + 1) * m] = batch
        # informed pruning of ALL accumulated samples (keep start/goal)
        if np.isfinite(best_cost):
            live = pts[2:, 0] < 1e8
            f_hat = np.linalg.norm(pts[2:] - start, axis=1) + np.linalg.norm(
                pts[2:] - goal, axis=1
            )
            pts[2:][live & (f_hat > best_cost)] = 1e9
        n_cur = 2 + int((pts[2:, 0] < 1e8).sum())
        # inflation schedule: aggressive-then-tight
        infl = infl0 + (1.0 - infl0) * (b / max(B - 1, 1))
        r_n = _rgg_radius(mu_free, res, n_cur, rewire) * infl
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
            cost = float(np.hypot(*np.diff(np.asarray(path), axis=0).T).sum())
            if cost < best_cost:
                best_cost = cost
                best_path = path
    return best_path


def solve_aitstar(planner, prob, seed=0) -> Optional[np.ndarray]:
    """AIT* (Strub & Gammell 2020): per batch, a REVERSE search from the
    goal over the current roadmap gives an admissible heuristic h(v); the
    forward search then only keeps vertices whose g_hat(v) + h(v) can
    beat the incumbent (the rest are parked out of the roadmap for that
    batch). Both searches are the dense roadmap solve."""
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
    res = float(prob["resolution"])
    pts = np.full((K_total, 2), 1e9, np.float32)
    pts[0] = start
    pts[1] = goal
    mu_free = _mu_free(planner._blocked_host, res)  # one fetch, not per batch

    best_path, best_cost = None, np.inf
    for b in range(B):
        batch = rng.uniform(lo, hi, (m, 2))
        pts[2 + b * m : 2 + (b + 1) * m] = batch
        n_cur = 2 + (b + 1) * m
        r_n = _rgg_radius(mu_free, res, n_cur, rewire)
        checks = _edge_checks_for_radius(cfg, res, r_n)

        # reverse search: goal as node 0 (swap roles) -> h(v)
        pts_rev = pts.copy()
        pts_rev[0], pts_rev[1] = pts[1], pts[0]
        h_dist, _ = _graph_shortest_path(
            planner._blocked, prob["origin"], prob["resolution"],
            pts_rev, r_n, edge_check_points=checks,
            num_relax_iters=min(K_total, 128), knn_cap=0,
            graphs=planner._graphs,
        )
        h = h_dist.cpu().numpy().copy()
        h[0], h[1] = h[1], h[0]  # back to original indexing

        # forward search with heuristic vertex pruning
        pts_fwd = pts.copy()
        if np.isfinite(best_cost):
            g_hat = np.linalg.norm(pts - start, axis=1)
            prune = (g_hat + h > best_cost) & (pts[:, 0] < 1e8)
            prune[:2] = False
            pts_fwd[prune] = 1e9
        dist, pred = _graph_shortest_path(
            planner._blocked, prob["origin"], prob["resolution"],
            pts_fwd, r_n, edge_check_points=checks,
            num_relax_iters=min(K_total, 128), knn_cap=0,
            graphs=planner._graphs,
        )
        path = _trace_prm_path(pts_fwd, dist.cpu().numpy(), pred.cpu().numpy())
        if path is not None:
            cost = float(np.hypot(*np.diff(np.asarray(path), axis=0).T).sum())
            if cost < best_cost:
                best_cost = cost
                best_path = path
    return best_path
