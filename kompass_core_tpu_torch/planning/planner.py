"""Global path planning: batched sampling-based planners in PyTorch.

Counterpart of ``kompass_core_tpu/planning/planner.py``: the role of the
reference's OMPL integration (``planning/ompl.cpp`` +
``ompl_bindings/bindings.cpp`` + ``third_party/ompl/planner.py``), the
whole planning problem (sampling, edge validity, graph search) as dense
tensor programs on the planner's device.

Every device program keeps the JAX body's static shapes and masked
growth: the roadmap solve (a K x K edge tensor, then min-plus
Bellman-Ford) and the tree and wavefront scans, each a plain function of
tensors run by ``_scan.run_scan`` (the eager loop on the CPU, one CUDA
graph per chunk of iterations on a card). The scans take their random
draws as inputs, named after the ``jax.random`` calls of the JAX body in
its order; ``GlobalPlanner`` makes them from CPU ``torch.Generator``
streams seeded from ``seed + round``, so the two packages plan different
paths for one seed and agree core by core on the same draws.

Registry (30 ids; the reference binds 28 OMPL planners,
``ompl_bindings/bindings.cpp:63-444``): the roadmap family (``PRM``,
``PRMstar``, ``LazyPRM``, ``LazyPRMstar``), the RRT family (``RRT``,
``RRTstar``, ``InformedRRTstar``, ``RRTConnect``, ``LazyRRT``,
``LBTRRT``, ``LazyLBTRRT``, ``RRTsharp``, ``RRTXstatic``), and the
families of ``planners_ext.py`` and ``planners_trees.py``.
``core_registry`` holds the device program behind each id that runs one
(its draws and its call with the arguments ``solve()`` passes), so that
the program can be run on given draws apart from the path it yields.

The ``OMPLGeometric``-compatible wrapper keeps the reference front-end
surface: ``setup_problem(map_meta, start..., goal..., map_3d)``,
``solve()``, ``path_cost``, ``planner_params`` get/set,
``available_planners`` param-map introspection.
"""

import logging
import math
import time
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from attrs import define, field

from ..models import Robot, RobotGeometry
from ..ops.kernels import _sqrt
from ..utils.config import BaseAttrs, base_validators
from . import _scan
from ._scan import Field, GeneratorDraws, f64, norm, put, run_scan, scalar, take, vec
from .geometry import (
    build_inflated_grid,
    linspace_params,
    point_free,
    segment_free,
)
from .params import PLANNER_PARAMS, create_config_class, default_planner_params

logger = logging.getLogger("kompass_core_tpu_torch")

INF = math.inf

# iterations per captured chunk (a graph of a few thousand kernels)
RELAX_CHUNK = 128
RRT_CHUNK = 32
CONNECT_CHUNK = 8


@define
class GlobalPlannerConfig(BaseAttrs):
    """Planner configuration (role of ``OMPLGeometricConfig``)."""

    # the reference front-end's default planner is TRRT
    # (third_party/ompl/planner.py:34)
    planner_id: str = field(default="TRRT")
    # retry budget: rounds with fresh seeds run until a solution is found
    # or the timeout expires (the reference hands this to OMPL's solve())
    planning_timeout: float = field(
        default=5.0, validator=base_validators.in_range(0.0, 1e6)
    )
    # deliberate multi-round refinement: solve this many rounds (seeds
    # seed, seed+1, ...) and keep the cheapest solution. Deterministic.
    optimize_rounds: int = field(
        default=1, validator=base_validators.in_range(1, 64)
    )
    map_resolution: float = field(
        default=0.05, validator=base_validators.in_range(1e-4, 10.0)
    )
    num_samples: int = field(
        default=512, validator=base_validators.in_range(16, 8192)
    )
    connection_radius: float = field(default=3.0)
    edge_check_points: int = field(
        default=32, validator=base_validators.in_range(2, 512)
    )
    margin: float = field(default=0.0)
    seed: int = field(default=0)
    simplify: bool = field(default=True)
    max_iterations: int = field(default=2048)  # RRT-family expansions
    step_size: float = field(default=0.5)  # extension step fallback
    # reference-surface knobs (third_party/ompl/planner.py:19-41), honored:
    # final waypoint must land within goal_tolerance of the goal
    goal_tolerance: float = field(
        default=1e-3, validator=base_validators.in_range(1e-9, 1e3)
    )
    # wall-time budget for the shortcut simplification pass
    simplification_timeout: float = field(
        default=1.0, validator=base_validators.in_range(1e-6, 1e6)
    )
    # round-selection objective: "length" (PathLengthOptimizationObjective),
    # "max_min_clearance" (MaximizeMinClearanceObjective, scored on the
    # inflated-grid EDT), "mechanical_work" (MechanicalWorkOptimization-
    # Objective — no elevation term in SE2, reduces to path length)
    optimization_objective: str = field(
        default="length",
        validator=base_validators.in_(
            [
                "length",
                "PathLengthOptimizationObjective",
                "max_min_clearance",
                "MaximizeMinClearanceObjective",
                "mechanical_work",
                "MechanicalWorkOptimizationObjective",
            ]
        ),
    )
    # stop refinement rounds once the objective is at least this good
    # (OMPL's ProblemDefinition objective threshold); None = never
    # satisfied: the reference front-end declares the knob but never
    # passes it to OMPL (planner.py:36)
    optimization_objective_threshold: Optional[float] = field(
        default=None, validator=base_validators.in_range(1e-9, 1e3)
    )


# ---------------------------------------------------------------------------
# roadmap kernel (PRM family + BIT* batches)
# ---------------------------------------------------------------------------


def build_edge_weights(
    blocked, origin_xy, resolution, pts, connection_radius,
    edge_check_points: int, knn_cap: int = 0,
):
    """[M, M] roadmap edge-weight tensor: euclidean length where the
    straight segment is collision-free, within ``connection_radius``, and
    both endpoints are free; +inf elsewhere. ``knn_cap`` > 0 keeps an
    edge only if it is within either endpoint's ``knn_cap`` nearest
    connections (OMPL PRM's max_nearest_neighbors, the k-th smallest of
    each row through ``kthvalue``). Shared by the single-source roadmap
    solve and the fleet planner."""
    M = pts.shape[0]
    node_free = point_free(blocked, origin_xy, resolution, pts)
    diff = pts[:, None, :] - pts[None, :, :]
    dist = norm(diff)  # [M, M]
    seg_ok = segment_free(
        blocked, origin_xy, resolution, pts[:, None, :], pts[None, :, :],
        edge_check_points,
    )
    connected = (
        seg_ok
        & (dist <= connection_radius)
        & node_free[:, None]
        & node_free[None, :]
        & (dist > 0)
    )
    if knn_cap > 0:
        k = min(knn_cap, M - 1)
        cand = torch.where(connected, dist, INF)
        kth = torch.kthvalue(cand, k, dim=1).values  # k-th nearest per row
        in_knn = cand <= kth[:, None]
        connected = connected & (in_knn | in_knn.T)
    return torch.where(connected, dist, INF)


def _relax_body(carry, c, i, draw):
    d, p = carry
    cand = d[:, :, None] + c["W"][None, :, :]  # [N, M(j), M(k)]
    best_d, best_j = torch.min(cand, dim=1)  # first index on ties
    improved = best_d < d
    return (torch.where(improved, best_d, d),
            torch.where(improved, best_j.to(torch.int32), p))


def minplus_relax(W, d0, p0, num_iters: int, *, graphs=None):
    """Batched min-plus Bellman-Ford: ``d[i,k] = min_j d[i,j] + W[j,k]``
    for ``num_iters`` rounds. ``d0``/``p0`` are [N, M] initial distance /
    predecessor tables (N = source count)."""
    return run_scan(_relax_body, (d0, p0), iterations=num_iters, chunk=RELAX_CHUNK,
                    consts={"W": W}, graphs=graphs, key=("minplus",))


def _graph_shortest_path(
    blocked,
    origin_xy,
    resolution,
    pts,  # [K, 2] node positions (invalid slots parked out of bounds)
    connection_radius,
    edge_check_points: int,
    num_relax_iters: int,
    knn_cap: int = 0,
    *,
    graphs=None,
):
    """Dense roadmap solve: K x K edges -> Bellman-Ford from node 0."""
    device = blocked.device
    pts = vec(pts, device)
    K = pts.shape[0]
    W = build_edge_weights(
        blocked, vec(origin_xy, device), scalar(resolution, device), pts,
        scalar(connection_radius, device), edge_check_points, knn_cap,
    )
    dist0 = torch.full((1, K), INF, device=device)
    dist0[0, 0] = 0.0
    pred0 = torch.full((1, K), -1, dtype=torch.int32, device=device)
    dist_final, pred = minplus_relax(W, dist0, pred0, num_relax_iters,
                                     graphs=graphs)
    return dist_final[0], pred[0]


def _walk_predecessors(pred, goal_idx=1, start_idx=0):
    """Node-index chain goal -> start through a predecessor array, with
    cycle/-1 guards; returns start -> goal order or None on a broken
    chain. THE parent-walk for every planner (roadmap, tree, bidir,
    fleet)."""
    path = [goal_idx]
    while path[-1] != start_idx:
        nxt = int(pred[path[-1]])
        if nxt < 0 or nxt in path:
            return None
        path.append(nxt)
    return path[::-1]


def _trace_prm_path(pts, dist, pred) -> Optional[np.ndarray]:
    """Walk predecessors goal (node 1) -> start (node 0)."""
    if not np.isfinite(dist[1]):
        return None
    path = _walk_predecessors(pred)
    return None if path is None else pts[path]


# ---------------------------------------------------------------------------
# shared inputs of the tree scans
# ---------------------------------------------------------------------------


def space_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution, start,
                 goal, edge_check_points: int, capacity: int):
    """The consts every tree scan reads, as tensors on the grid's device:
    the grid, origin, bounds, resolution, start, goal, the edge checks'
    parameters ``t`` and ``ar`` = arange(capacity)."""
    device = blocked.device
    return {
        "blocked": blocked,
        "origin": vec(origin_xy, device),
        "lo": vec(bounds_lo, device),
        "hi": vec(bounds_hi, device),
        "res": scalar(resolution, device),
        "start": vec(start, device),
        "goal": vec(goal, device),
        "t": linspace_params(edge_check_points, device),
        "ar": torch.arange(capacity, device=device),
    }


def free(c, xy):
    """``point_free`` against the scan's grid."""
    return point_free(c["blocked"], c["origin"], c["res"], xy)


def seg_free(c, a, b):
    """``segment_free`` against the scan's grid at its check count."""
    return segment_free(c["blocked"], c["origin"], c["res"], a, b,
                        c["t"].shape[0], t=c["t"])


def steer(q, target, step):
    """The JAX bodies' bounded extension from q toward target:
    (new point, the clamped distance dn)."""
    direction = target - q
    dn = torch.clamp(norm(direction), min=1e-9)
    return q + direction / dn * torch.minimum(dn, step), dn


def connect_goal(c, nodes, costs, alive, tolerance, check_edges=True):
    """Best tree node that can reach the goal within ``tolerance`` (with
    a free segment to it, unless ``check_edges`` is off): (index as
    int32, its cost through the goal edge)."""
    goal = c["goal"]
    dgoal = torch.where(alive, norm(nodes - goal), INF)
    if check_edges:
        seg_ok = seg_free(c, nodes, goal.expand_as(nodes))
    else:
        seg_ok = torch.ones_like(alive)
    reach = torch.where(alive & seg_ok & (dgoal <= tolerance),
                        costs + dgoal, INF)
    best = torch.argmin(reach)
    return best.to(torch.int32), take(reach, best)


# ---------------------------------------------------------------------------
# RRT / RRT*
# ---------------------------------------------------------------------------


def _informed_sample(r_u, a_u, start, goal, c_best, bounds_lo, bounds_hi):
    """Uniform sample from the prolate hyperspheroid with foci start/goal
    and transverse diameter c_best (Informed RRT*, Gammell et al. 2014),
    from the two uniforms ``jax.random.uniform`` gives the JAX body's
    split key: unit-disc sample -> scale by (c_best/2,
    sqrt(c_best^2 - c_min^2)/2) -> rotate onto the start-goal axis ->
    translate to the midpoint."""
    r = _sqrt(r_u)
    ang = a_u * 2.0 * math.pi
    bx, by = r * f64(torch.cos, ang), r * f64(torch.sin, ang)
    c_min = norm(goal - start)
    r1 = c_best / 2.0
    r2 = _sqrt(torch.clamp(c_best * c_best - c_min * c_min, min=1e-12)) / 2.0
    theta = f64(torch.atan2, goal[1] - start[1], goal[0] - start[0])
    ct, st = f64(torch.cos, theta), f64(torch.sin, theta)
    ex = r1 * bx
    ey = r2 * by
    pt = torch.stack([ct * ex - st * ey, st * ex + ct * ey]) + (start + goal) / 2.0
    return torch.clamp(pt, bounds_lo, bounds_hi)


def rrt_fields(informed: bool):
    """``_rrt_solve``'s draws per iteration, in the JAX body's order:
    the uniform sample (key 2), the informed ball's radius and angle
    uniforms (key 3, split), the goal-bias coin (key 1)."""
    fields = [Field("uniform", "box", (2,))]
    if informed:
        fields += [Field("informed_r", "uniform"), Field("informed_ang", "uniform")]
    return fields + [Field("coin", "uniform")]


def _rrt_body(st, carry, c, i, draw):
    N, rewire, informed, cascade, check_edges = st
    nodes, parents, costs, count, c_best = carry
    uniform, coin = draw[0], draw[-1]
    if informed:
        uniform = torch.where(
            torch.isfinite(c_best),
            _informed_sample(draw[1], draw[2], c["start"], c["goal"], c_best,
                             c["lo"], c["hi"]),
            uniform,
        )
    sample = torch.where(coin < c["goal_bias"], c["goal"], uniform)
    alive = c["ar"] < count
    d = torch.where(alive, norm(nodes - sample), INF)
    nearest = torch.argmin(d)
    q = take(nodes, nearest)
    new_pt, _ = steer(q, sample, c["step"])
    ok = free(c, new_pt)
    if check_edges:
        ok = ok & seg_free(c, q, new_pt)

    parent = nearest
    new_cost = take(costs, nearest) + norm(new_pt - q)
    if rewire:
        radius = c["rewire_factor"] * 2.0 * c["step"]
        d_new = norm(nodes - new_pt)
        near = alive & (d_new <= radius)
        if check_edges:
            seg_ok = seg_free(c, nodes, new_pt.expand_as(nodes))
        else:
            seg_ok = torch.ones_like(near)
        through = torch.where(near & seg_ok, costs + d_new, INF)
        best = torch.argmin(through)
        t_best = take(through, best)
        # LBT-RRT gate: only adopt the cheaper parent when it wins by
        # more than the (1 + eps) approximation factor (eps=0 = RRT*)
        better = t_best * (1.0 + c["epsilon"]) < new_cost
        parent = torch.where(better, best, parent)
        new_cost = torch.where(better, t_best, new_cost)

    idx = count
    nodes = put(nodes, idx, new_pt, ok)
    parents = put(parents, idx, parent, ok)
    costs = put(costs, idx, new_cost, ok)
    count = count + ok.to(count.dtype)
    if cascade:
        # RRT# / RRTX: reverse-rewire the neighborhood through the new
        # node, then one vectorized cost-consistency propagation pass
        via_new = new_cost + d_new
        adopt = ok & alive & near & seg_ok & (via_new < costs - c["eps_consistency"])
        parents = torch.where(adopt, idx.to(torch.int32), parents)
        costs = torch.where(adopt, via_new, costs)
        psafe = torch.clamp(parents, min=0).long()
        pc = costs.index_select(0, psafe) + norm(nodes - nodes.index_select(0, psafe))
        costs = torch.where(
            (parents >= 0) & (pc < costs - c["eps_consistency"]), pc, costs)
    if informed:
        dg = norm(new_pt - c["goal"])
        goal_ok = ok & (dg <= c["goal_tolerance"])
        if check_edges:
            goal_ok = goal_ok & seg_free(c, new_pt, c["goal"])
        c_best = torch.where(goal_ok, torch.minimum(c_best, new_cost + dg), c_best)
    return nodes, parents, costs, count, c_best


def _rrt_solve(
    blocked,
    origin_xy,
    bounds_lo,
    bounds_hi,
    resolution,
    start,
    goal,
    step_size,
    goal_tolerance,
    goal_bias,
    rewire_factor,
    epsilon,
    eps_consistency,
    draws,
    max_iterations: int,
    edge_check_points: int,
    rewire: bool = False,
    informed: bool = False,
    cascade: bool = False,
    check_edges: bool = True,
    *,
    graphs=None,
):
    """RRT(*) as a fixed-capacity scan with masked growth (the JAX
    function's docstring has the algorithm and its optimizing-family
    flags: ``epsilon`` LBT-RRT, ``cascade`` RRT#/RRTX, ``eps_consistency``
    RRTXstatic, ``check_edges=False`` LazyRRT).

    ``draws``: the ``rrt_fields(informed)`` draws, [max_iterations, ...]
    tensors or a callable (start, stop) -> their rows."""
    if cascade and not rewire:
        raise ValueError("cascade requires rewire=True (RRT#/RRTX extend RRT*)")
    N = max_iterations + 2
    c = space_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N)
    device = blocked.device
    for name, value in (("step", step_size), ("goal_tolerance", goal_tolerance),
                        ("goal_bias", goal_bias), ("rewire_factor", rewire_factor),
                        ("epsilon", epsilon), ("eps_consistency", eps_consistency)):
        c[name] = scalar(value, device)
    nodes = torch.zeros((N, 2), device=device)
    nodes[0] = c["start"]
    parents = torch.full((N,), -1, dtype=torch.int32, device=device)
    costs = torch.full((N,), INF, device=device)
    costs[0] = 0.0
    count = torch.ones((), dtype=torch.int64, device=device)
    c_best = torch.full((), INF, device=device)
    st = (N, rewire, informed, cascade, check_edges)
    nodes, parents, costs, count, c_best = run_scan(
        partial(_rrt_body, st), (nodes, parents, costs, count, c_best), draws,
        iterations=max_iterations, chunk=RRT_CHUNK, consts=c, graphs=graphs,
        key=("rrt",) + st + (edge_check_points,))
    # connect to goal: nearest tree node within tolerance with a free segment
    best, cost = connect_goal(c, nodes, costs, c["ar"] < count,
                              c["goal_tolerance"], check_edges)
    return nodes, parents, best, cost


# ---------------------------------------------------------------------------
# RRT-Connect
# ---------------------------------------------------------------------------


def connect_fields():
    """``_rrt_connect_solve``'s draws per iteration: the uniform sample."""
    return [Field("uniform", "box", (2,))]


def _extend(N, c, tree, nodes, parents, counts, target, gate):
    """One EXTEND of ``tree`` (0-d index) toward target; ``gate`` masks
    the whole op. nodes [2, N, 2] and parents [2, N] are flattened
    [2N, ...] here."""
    base = tree * N
    cnt = take(counts, tree)
    tn = nodes.view(2, N, 2).index_select(0, tree.reshape(1)).squeeze(0)
    alive = c["ar"] < cnt
    d = torch.where(alive, norm(tn - target), INF)
    nearest = torch.argmin(d)
    q = take(tn, nearest)
    new_pt, dn = steer(q, target, c["step"])
    ok = gate & (cnt < N) & seg_free(c, q, new_pt) & free(c, new_pt)
    idx = torch.clamp(cnt, max=N - 1)
    nodes = put(nodes, base + idx, new_pt, ok)
    parents = put(parents, base + idx, nearest, ok)
    counts = put(counts, tree, cnt + 1, ok)
    reached = ok & (dn <= c["step"] + 1e-6)
    return ok, reached, idx, new_pt, nodes, parents, counts


def _connect_body(st, carry, c, i, draw):
    N, connect_steps = st
    nodes, parents, counts, found, bridge = carry
    sample = draw[0]
    a = i % 2  # the tree extended this iteration (alternates)
    b = 1 - a
    ok_a, _, idx_a, q_a, nodes, parents, counts = _extend(
        N, c, a, nodes, parents, counts, sample, ~found)
    going = ok_a & ~found
    arrived = torch.zeros_like(found)
    idx_b = torch.full_like(idx_a, -1)
    for _ in range(connect_steps):
        ok_b, reached, idx, _, nodes, parents, counts = _extend(
            N, c, b, nodes, parents, counts, q_a, going)
        arrived = arrived | reached
        idx_b = torch.where(reached & (idx_b < 0), idx, idx_b)
        going = going & ok_b & ~reached
    hit = arrived & ~found
    new_bridge = torch.where(a == 0, torch.stack([idx_a, idx_b]),
                             torch.stack([idx_b, idx_a])).to(torch.int32)
    bridge = torch.where(hit, new_bridge, bridge)
    return nodes, parents, counts, found | arrived, bridge


def _rrt_connect_solve(
    blocked,
    origin_xy,
    bounds_lo,
    bounds_hi,
    resolution,
    start,
    goal,
    step_size,
    draws,
    max_iterations: int,
    edge_check_points: int,
    connect_steps: int = 8,
    *,
    graphs=None,
):
    """Bidirectional RRT-Connect (Kuffner & LaValle 2000) as a scan: two
    fixed-capacity trees rooted at start and goal; each iteration EXTENDs
    the active tree toward a uniform sample, then the other tree runs a
    bounded CONNECT (up to ``connect_steps`` greedy steps) toward the new
    node; once it arrives the bridge is recorded and growth stops.

    Returns (nodes [2,N,2], parents [2,N], found, bridge [2] node indices
    into tree 0 / tree 1 at the junction)."""
    N = max_iterations * (connect_steps + 1) // 2 + 2
    c = space_consts(blocked, origin_xy, bounds_lo, bounds_hi, resolution,
                     start, goal, edge_check_points, N)
    device = blocked.device
    c["step"] = scalar(step_size, device)
    nodes = torch.zeros((2 * N, 2), device=device)
    nodes[0] = c["start"]
    nodes[N] = c["goal"]
    parents = torch.full((2 * N,), -1, dtype=torch.int32, device=device)
    counts = torch.ones((2,), dtype=torch.int64, device=device)
    found = torch.zeros((), dtype=torch.bool, device=device)
    bridge = torch.full((2,), -1, dtype=torch.int32, device=device)
    st = (N, int(connect_steps))
    nodes, parents, counts, found, bridge = run_scan(
        partial(_connect_body, st), (nodes, parents, counts, found, bridge),
        draws, iterations=max_iterations, chunk=CONNECT_CHUNK, consts=c, graphs=graphs,
        key=("connect",) + st + (edge_check_points,))
    return nodes.view(2, N, 2), parents.view(2, N), found, bridge


# ---------------------------------------------------------------------------
# front-end
# ---------------------------------------------------------------------------


class GlobalPlanner:
    """Reference-front-end-compatible global planner
    (role of ``OMPLGeometric``, ``third_party/ompl/planner.py:45-``) on
    ``device`` (required: ``"cuda"`` or ``"cpu"``)."""

    def __init__(
        self,
        robot: Robot,
        log_level: str = "ERROR",
        use_fcl: bool = True,
        config: Optional[GlobalPlannerConfig] = None,
        config_file: Optional[str] = None,
        *,
        device,
        **_,
    ):
        self._device = torch.device(device)
        self._robot = robot
        self._config = config or GlobalPlannerConfig()
        self._defer_config_file = None
        if config_file:
            # accept BOTH file schemas: flat keys at the top level, and
            # the configure() format with the config under an 'ompl' root
            # (+ per-planner param sections)
            import json as _json

            if config_file.endswith((".yaml", ".yml")):
                import yaml as _yaml

                with open(config_file) as f:
                    data = _yaml.safe_load(f) or {}
            elif config_file.endswith(".toml"):
                import tomllib as _toml

                with open(config_file, "rb") as f:
                    data = _toml.load(f)
            else:
                with open(config_file) as f:
                    data = _json.load(f)
            if isinstance(data, dict) and "ompl" in data:
                self._defer_config_file = config_file  # configure() format
            else:
                self._config.from_file(config_file)
        # accept reference-style "ompl.geometric.X" ids (planner.py:34)
        self._config.planner_id = normalize_planner_id(
            self._config.planner_id
        )
        if self._config.planner_id not in planner_registry:
            raise ValueError(
                f"Unknown planner '{self._config.planner_id}'. Available: "
                f"{sorted(planner_registry)}"
            )
        # use_fcl=False disables geometric collision checking entirely
        # (bounds-only state validity) — the reference's FCL toggle
        # (third_party/ompl/planner.py:52,81)
        self._use_fcl = bool(use_fcl)
        self._planner_params = default_planner_params(self._config.planner_id)
        self.solution: Optional[np.ndarray] = None
        self._blocked = None
        self._blocked_host = None
        self._problem = None
        self._clearance_field = None  # lazy EDT for clearance objective
        # captured scan chunks on a CUDA device, per core and shapes, for
        # the grid shape and scan sizes of ``_graph_sizes``
        self._graphs: Dict = {}
        self._graph_sizes = None
        if self._defer_config_file:
            # configure() needs _planner_params in place first
            self.configure(self._defer_config_file)

    def configure(
        self,
        config_file: str,
        root_name: Optional[str] = None,
        planner_id: Optional[str] = None,
    ) -> None:
        """Load config from a yaml/json/toml file (role of
        ``OMPLGeometric.configure``, ``third_party/ompl/planner.py:117-155``):
        the planner config lives under ``[root_name.]ompl`` and the
        per-planner params under ``[root_name.]ompl.<PlannerName>``.
        ``planner_id`` switches the active planner."""
        nested = (root_name + ".ompl") if root_name else "ompl"
        # validate BEFORE mutating self._config so a rejected configure()
        # leaves the planner usable
        staged = GlobalPlannerConfig(**self._config.to_dict())
        staged.from_file(config_file, nested_root_name=nested)
        staged.planner_id = normalize_planner_id(
            planner_id or staged.planner_id
        )
        if staged.planner_id not in planner_registry:
            raise ValueError(
                f"Selected planner is invalid. Available supported planners "
                f"are: {sorted(self.available_planners)}"
            )
        self._config = staged
        self._graphs.clear()  # the scans' sizes may have changed
        name = self._config.planner_id
        self._planner_params = default_planner_params(name)
        if self._planner_params is not None:
            try:
                self._planner_params.from_file(
                    config_file, nested + "." + name
                )
            except KeyError:
                pass  # no per-planner section in the file: keep defaults

    @property
    def available_planners(self) -> Dict[str, Dict[str, tuple]]:
        """Planner-id -> parameter map, in the reference's introspection
        tuple shape (``config.py:30-85``)."""
        return {
            f"kompass.geometric.{name}": dict(PLANNER_PARAMS.get(name, {}))
            for name in planner_registry
        }

    @property
    def planner_id(self) -> str:
        return self._config.planner_id

    # --- per-planner params (reference planner.py:210-237) ---

    @property
    def planner_params(self):
        """The per-planner attrs config instance (auto-generated from the
        param map; see ``params.create_config_class``)."""
        return self._planner_params

    @planner_params.setter
    def planner_params(self, config) -> None:
        expected = None
        if self._config.planner_id in PLANNER_PARAMS:
            expected = create_config_class(
                self._config.planner_id, PLANNER_PARAMS[self._config.planner_id]
            )
        if expected is not None and not isinstance(config, expected):
            raise ValueError(
                f"planner_params for '{self._config.planner_id}' must be a "
                f"{expected.__name__}"
            )
        self._planner_params = config

    def _param(self, name: str, fallback):
        """Read an honored per-planner parameter with fallback."""
        if self._planner_params is not None and hasattr(
            self._planner_params, name
        ):
            return getattr(self._planner_params, name)
        return fallback

    def setup_problem(
        self,
        map_meta_data: Dict,
        start_x: float,
        start_y: float,
        start_yaw: float,
        goal_x: float,
        goal_y: float,
        goal_yaw: float,
        map_3d: Optional[np.ndarray] = None,
    ):
        """Set bounds from the map and rasterize + inflate obstacles
        (role of ``ompl.cpp:22-54``)."""
        meta = dict(map_meta_data)
        if "origin" in meta:  # nested ROS-style meta
            meta["origin_x"] = meta["origin"]["position"]["x"]
            meta["origin_y"] = meta["origin"]["position"]["y"]
        res = float(meta["resolution"])
        width = int(meta["width"])
        height = int(meta["height"])
        ox, oy = float(meta["origin_x"]), float(meta["origin_y"])

        radius = RobotGeometry.get_radius(
            self._robot.geometry_type, self._robot.geometry_params
        )
        # edge-check density must cover the LONGEST edge any planner can
        # create (connection_radius / step_size) at map resolution; the
        # config field is a minimum, raised in place, capped at 512
        needed = int(
            np.ceil(
                max(self._config.connection_radius, self._config.step_size)
                / max(res, 1e-9)
            )
        ) + 1
        if needed > self._config.edge_check_points:
            self._config.edge_check_points = min(needed, 512)
            if needed > 512:
                logger.warning(
                    "edge_check_points clipped to 512 (%d needed for"
                    " connection_radius %.2f at resolution %.3f); long"
                    " edges may under-sample thin obstacles",
                    needed, self._config.connection_radius, res,
                )
        obstacles = (
            np.asarray(map_3d, np.float64)
            if (map_3d is not None and self._use_fcl)
            else np.zeros((0, 3))
        )
        self._blocked = build_inflated_grid(
            obstacles, (ox, oy), width, height, res,
            radius + self._config.margin, device=self._device,
        )
        # the host checks (shortcut, lazy validation) read a CPU copy
        self._blocked_host = self._blocked.cpu()
        # each captured chunk holds device memory: drop them all once the
        # grid's shape or a size of the scans changed (a front end fed maps
        # of changing size would otherwise gain graphs with every new one)
        cfg = self._config
        sizes = (tuple(self._blocked.shape), cfg.edge_check_points,
                 cfg.max_iterations, cfg.num_samples)
        if sizes != self._graph_sizes:
            self._graphs.clear()
            self._graph_sizes = sizes
        self._problem = dict(
            origin=np.array([ox, oy], np.float32),
            lo=np.array([ox, oy], np.float32),
            hi=np.array([ox + width * res, oy + height * res], np.float32),
            resolution=np.float32(res),
            start=np.array([start_x, start_y], np.float32),
            goal=np.array([goal_x, goal_y], np.float32),
            start_yaw=float(start_yaw),
            goal_yaw=float(goal_yaw),
        )
        self._host_space = (
            torch.from_numpy(self._problem["origin"]),
            torch.tensor(float(self._problem["resolution"]), dtype=torch.float32),
        )
        self.solution = None
        self._clearance_field = None  # grid changed — EDT stale

    def solve(self) -> Optional[np.ndarray]:
        """Plan. Returns the path as an [N, 2] array (world frame) or None.

        Rounds: ``optimize_rounds`` deliberate rounds (seed, seed+1, ...)
        keeping the cheapest solution; if no round succeeds, keep retrying
        with fresh seeds until ``planning_timeout`` expires — the role the
        timeout plays in OMPL's anytime solve loop."""
        if self._problem is None:
            raise RuntimeError("Call setup_problem first")
        cfg = self._config
        solver = planner_registry[cfg.planner_id]
        deadline = time.monotonic() + max(cfg.planning_timeout, 0.0)

        best, best_cost = None, float("inf")
        round_i = 0
        while True:
            path = solver(self, self._problem, seed=cfg.seed + round_i)
            if path is not None and cfg.simplify:
                path = self._shortcut(path)
            if path is not None and not self._goal_tolerance_ok(path):
                logger.warning(
                    "solution endpoint misses the goal by more than "
                    "goal_tolerance=%g; round discarded", cfg.goal_tolerance,
                )
                path = None
            if path is not None:
                cost = self._objective_cost(path)
                if cost < best_cost:
                    best, best_cost = path, cost
            round_i += 1
            if time.monotonic() >= deadline:
                break  # planning_timeout strictly bounds wall time
            if best is not None and best_cost <= self._objective_stop_cost():
                break  # objective threshold met — stop refining
            if round_i < cfg.optimize_rounds:
                continue  # deliberate refinement rounds run within budget
            if best is not None:
                break
        self.solution = best
        return best

    def _goal_tolerance_ok(self, path) -> bool:
        end = np.asarray(path)[-1]
        goal = np.asarray(self._problem["goal"], np.float64)
        return float(np.hypot(*(end - goal))) <= self._config.goal_tolerance

    def _objective_cost(self, path) -> float:
        """Round-selection score (lower = better) under the configured
        optimization objective."""
        obj = self._config.optimization_objective
        if obj in ("max_min_clearance", "MaximizeMinClearanceObjective"):
            return -self._min_clearance(path)
        # length + mechanical_work (no elevation term in SE2) -> arc length
        return float(np.hypot(*np.diff(np.asarray(path), axis=0).T).sum())

    def _objective_stop_cost(self) -> float:
        """Internal-cost value at which the objective threshold is met
        (-inf when no threshold is set: never satisfied)."""
        thr = self._config.optimization_objective_threshold
        if thr is None:
            return float("-inf")
        obj = self._config.optimization_objective
        if obj in ("max_min_clearance", "MaximizeMinClearanceObjective"):
            return -thr  # cost = -clearance; met when clearance >= thr
        return thr

    def _min_clearance(self, path) -> float:
        """Minimum obstacle clearance along the path, from the EDT of the
        inflated occupancy grid (clearance to the INFLATED obstacle set —
        add the robot radius + margin back for the physical distance)."""
        from .planners_trees import clearance_edt

        if self._clearance_field is None:
            self._clearance_field = clearance_edt(
                self._blocked_host.numpy(), float(self._problem["resolution"])
            )
        res = float(self._problem["resolution"])
        origin = np.asarray(self._problem["origin"], np.float64)
        pts = np.asarray(path, np.float64)
        # sample each segment at grid pitch so a wall-grazing segment
        # cannot be missed between waypoints
        dense = [pts[0]]
        for a, b in zip(pts[:-1], pts[1:]):
            n = max(int(np.ceil(np.hypot(*(b - a)) / max(res, 1e-9))), 1)
            for t in range(1, n + 1):
                dense.append(a + (b - a) * (t / n))
        dense = np.asarray(dense)
        ij = np.clip(
            ((dense - origin) / res).astype(int),
            0,
            np.array(self._clearance_field.shape[::-1]) - 1,
        )
        return float(self._clearance_field[ij[:, 1], ij[:, 0]].min())

    def get_solution(self) -> Optional[np.ndarray]:
        return self.solution

    def solve_fleet(self, starts, goals, seed=None):
        """Plan N robots over this map in ONE device dispatch (shared
        roadmap, batched multi-source shortest paths); see
        ``planning/fleet_planner.py``. Returns a list of N paths (``None``
        where unsolved)."""
        from .fleet_planner import solve_fleet_prm

        return solve_fleet_prm(self, starts, goals, seed=seed)

    @property
    def path_cost(self) -> float:
        """Solution arc length (role of ``ompl.cpp:77-85``)."""
        if self.solution is None or len(self.solution) < 2:
            return float("inf")
        return float(
            np.hypot(*np.diff(np.asarray(self.solution), axis=0).T).sum()
        )

    # --- helpers ---

    def _segment_free_host(self, a, b) -> bool:
        """One segment check on the CPU copy of the grid, with the scans'
        float32 arithmetic (the shortcut pass reads one answer per check:
        on the card each would cost a sync). The sample count scales with
        the segment's length (shortcut candidates can join vertices tens
        of metres apart), quantized to a power of two."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        res = float(self._problem["resolution"])
        length = float(np.hypot(*(b - a)))
        n = max(
            int(self._config.edge_check_points),
            int(np.ceil(length / max(res, 1e-9))) + 1,
        )
        n = 1 << (n - 1).bit_length()
        origin, resolution = self._host_space
        return bool(
            segment_free(
                self._blocked_host, origin, resolution,
                torch.from_numpy(a.astype(np.float32)),
                torch.from_numpy(b.astype(np.float32)),
                n,
            )
        )

    def _shortcut(self, path: np.ndarray) -> np.ndarray:
        """Greedy path simplification: connect the farthest visible vertex
        (role of OMPL's simplifySolution, ``ompl.cpp:56-67``), bounded by
        ``simplification_timeout`` wall time; on expiry the remaining tail
        is kept verbatim."""
        path = np.asarray(path)
        deadline = time.monotonic() + max(
            self._config.simplification_timeout, 0.0
        )
        out = [path[0]]
        i = 0
        while i < len(path) - 1:
            if time.monotonic() >= deadline:
                out.extend(path[i + 1 :])
                logger.warning(
                    "simplification_timeout=%gs expired with %d vertices "
                    "unsimplified",
                    self._config.simplification_timeout, len(path) - 1 - i,
                )
                return np.asarray(out)
            j = len(path) - 1
            while j > i + 1 and not self._segment_free_host(path[i], path[j]):
                j -= 1
            out.append(path[j])
            i = j
        return np.asarray(out)


# --- planner implementations (registry) -----------------------------------


def _uniform_points(seed: int, count: int, prob) -> torch.Tensor:
    """``count`` roadmap samples uniform in the map's bounds, from the
    round's seed (``jax.random.uniform``'s scaling, on the CPU)."""
    return _scan.uniform_box(_scan.seeded_generator(seed), count,
                             prob["lo"], prob["hi"])


class Core(NamedTuple):
    """A registry id's device program as ``solve()`` runs it:
    ``draws(planner, prob, seed)`` makes its random input (a scan's
    per-iteration draws, or the samples of a roadmap or wavefront) and
    ``run(planner, prob, draws, graphs)`` returns the program's outputs,
    from which the front end traces the path."""

    draws: Callable
    run: Callable


def _prm_samples(planner: GlobalPlanner, prob, seed) -> torch.Tensor:
    pts = _uniform_points(seed, planner._config.num_samples, prob)
    pts[0] = torch.from_numpy(prob["start"])
    pts[1] = torch.from_numpy(prob["goal"])
    return pts


def _prm_run(planner: GlobalPlanner, prob, pts, graphs):
    cfg = planner._config
    # LazyPRM's `range` param (OMPL: max edge length) overrides the
    # connection radius; 0.0 = inherit the config radius
    radius = planner._param("range", 0.0) or cfg.connection_radius
    # the check density must cover the radius ACTUALLY used
    from .planners_ext import _edge_checks_for_radius

    return _graph_shortest_path(
        planner._blocked,
        prob["origin"],
        prob["resolution"],
        pts,
        radius,
        edge_check_points=_edge_checks_for_radius(
            cfg, float(prob["resolution"]), float(radius)
        ),
        num_relax_iters=min(cfg.num_samples, 128),
        knn_cap=int(planner._param("max_nearest_neighbors", 0) or 0),
        graphs=graphs,
    )


PRM = Core(_prm_samples, _prm_run)


def _solve_prm(planner: GlobalPlanner, prob, seed=0) -> Optional[np.ndarray]:
    pts = _prm_samples(planner, prob, seed)
    dist, pred = _prm_run(planner, prob, pts, planner._graphs)
    path = _trace_prm_path(pts.numpy(), dist.cpu().numpy(), pred.cpu().numpy())
    relax_iters = min(planner._config.num_samples, 128)
    if path is not None and len(path) >= relax_iters:
        # Bellman-Ford ran relax_iters rounds; a solution using that many
        # hops may be truncated/suboptimal
        logger.warning(
            "PRM relaxation cap (%d iters) binds: solution uses %d hops; "
            "consider fewer samples or a larger connection radius",
            relax_iters,
            len(path),
        )
    return path


def _rrt_draws(planner: GlobalPlanner, prob, seed, informed=False, **_):
    return GeneratorDraws(seed, rrt_fields(informed), prob["lo"], prob["hi"])


def _rrt_run(planner: GlobalPlanner, prob, draws, graphs, rewire=False,
             informed=False, cascade=False, check_edges=True,
             use_epsilon=False):
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    # check density covers the LONGEST edge actually checked: with
    # rewiring the choose-parent/rewire edges span up to
    # rewire_factor * 2 * step
    from .planners_ext import _edge_checks_for_radius

    checked_span = float(step)
    if rewire:
        checked_span *= 2.0 * max(
            float(planner._param("rewire_factor", 1.0)), 0.5
        )
    checks = _edge_checks_for_radius(
        cfg, float(prob["resolution"]), checked_span
    )
    epsilon = float(planner._param("epsilon", 0.4)) if use_epsilon else 0.0
    return _rrt_solve(
        planner._blocked,
        prob["origin"],
        prob["lo"],
        prob["hi"],
        prob["resolution"],
        prob["start"],
        prob["goal"],
        step,
        step,
        planner._param("goal_bias", 0.1),
        planner._param("rewire_factor", 1.0),
        epsilon,
        planner._param("epsilon_consistency", 0.0) if cascade else 0.0,
        draws,
        max_iterations=cfg.max_iterations,
        edge_check_points=checks,
        rewire=rewire,
        informed=informed,
        cascade=cascade,
        check_edges=check_edges,
        graphs=graphs,
    )


def _solve_rrt(planner: GlobalPlanner, prob, seed=0, **flags):
    nodes, parents, best, cost = _rrt_run(
        planner, prob, _rrt_draws(planner, prob, seed, **flags),
        planner._graphs, **flags)
    if not np.isfinite(float(cost)):
        return None
    nodes = nodes.cpu().numpy()
    parents = parents.cpu().numpy()
    path = _walk_predecessors(parents, int(best), 0)
    if path is None:
        return None
    pts = np.vstack([nodes[path], prob["goal"][None, :]])
    if not flags.get("check_edges", True):
        # lazy semantics: growth skipped motion checks; validate the traced
        # solution now, and on failure re-solve the same seed with motion
        # checks on (the analog of OMPL's check-on-demand repair)
        for a, b in zip(pts[:-1], pts[1:]):
            if not planner._segment_free_host(a, b):
                return _solve_rrt(planner, prob, seed=seed,
                                  **{**flags, "check_edges": True})
    return pts


def _solve_prm_star(planner: GlobalPlanner, prob, seed=0) -> Optional[np.ndarray]:
    """PRM*: the connection radius shrinks with sample count as
    gamma * sqrt(log n / n) (Karaman & Frazzoli 2011, d=2), with gamma
    derived from the measured free-space area of the inflated grid and
    scaled by the honored ``rewire_factor`` param."""
    from .planners_ext import _mu_free

    cfg = planner._config
    n = cfg.num_samples
    res = float(prob["resolution"])
    mu_free = _mu_free(planner._blocked_host, res)
    rewire = float(planner._param("rewire_factor", 1.1))
    gamma = rewire * 2.0 * np.sqrt(1.5) * np.sqrt(mu_free / np.pi)
    r_star = float(gamma * np.sqrt(np.log(max(n, 2)) / n))
    saved = cfg.connection_radius
    try:
        cfg.connection_radius = max(r_star, 2.0 * res)
        return _solve_prm(planner, prob, seed=seed)
    finally:
        cfg.connection_radius = saved


def _connect_draws(planner: GlobalPlanner, prob, seed):
    return GeneratorDraws(seed, connect_fields(), prob["lo"], prob["hi"])


def _connect_run(planner: GlobalPlanner, prob, draws, graphs):
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    from .planners_ext import _edge_checks_for_radius

    checks = _edge_checks_for_radius(
        cfg, float(prob["resolution"]), float(step)
    )
    return _rrt_connect_solve(
        planner._blocked,
        prob["origin"],
        prob["lo"],
        prob["hi"],
        prob["resolution"],
        prob["start"],
        prob["goal"],
        step,
        draws,
        max_iterations=cfg.max_iterations,
        edge_check_points=checks,
        connect_steps=int(planner._param("connect_steps", 8)),
        graphs=graphs,
    )


def _solve_rrt_connect(planner: GlobalPlanner, prob, seed=0) -> Optional[np.ndarray]:
    nodes, parents, found, bridge = _connect_run(
        planner, prob, _connect_draws(planner, prob, seed), planner._graphs)
    if not bool(found):
        return None
    from .planners_trees import _trace_bidir

    return _trace_bidir(nodes, parents, bridge)


from .planners_ext import (  # noqa: E402 — solvers need _graph_shortest_path
    EST,
    FMT,
    KPIECE,
    SST,
    solve_bitstar,
    solve_est,
    solve_fmt,
    solve_kpiece,
    solve_sst,
)
from .planners_trees import (  # noqa: E402
    BFMT,
    BIDIR,
    PDST,
    PROJ_EST,
    STRIDE,
    TRRT,
    solve_abitstar,
    solve_aitstar,
    solve_bfmt,
    solve_bidir,
    solve_pdst,
    solve_proj_est,
    solve_stride,
    solve_trrt,
)

# the RRT family: static-flag modes of the one RRT scan
_RRT_FLAGS = {
    "RRT": dict(rewire=False),
    "RRTstar": dict(rewire=True),
    "InformedRRTstar": dict(rewire=True, informed=True),
    # optimizing-family variants
    "LazyRRT": dict(check_edges=False),
    "LBTRRT": dict(rewire=True, use_epsilon=True),
    "LazyLBTRRT": dict(rewire=True, use_epsilon=True, check_edges=False),
    "RRTsharp": dict(rewire=True, informed=True, cascade=True),
    "RRTXstatic": dict(rewire=True, informed=True, cascade=True),
}
# the bidirectional trees: (selection, check_edges)
_BIDIR_MODES = {
    "BiEST": ("est", True),
    "SBL": ("grid", False),
    "BKPIECE1": ("border", True),
    "LBKPIECE1": ("border", False),
}

# the device program behind each id that runs one (BIT*, ABIT* and AIT*
# loop on the host over the roadmap solve; PRM* and LazyPRM* are PRM at
# a radius of their own)
core_registry: Dict[str, Core] = {
    "PRM": PRM,
    "LazyPRM": PRM,
    **{pid: Core(partial(_rrt_draws, **flags), partial(_rrt_run, **flags))
       for pid, flags in _RRT_FLAGS.items()},
    "RRTConnect": Core(_connect_draws, _connect_run),
    "EST": EST,
    "KPIECE1": KPIECE,
    "SST": SST,
    "FMT": FMT,
    "FMTstar": FMT,
    "TRRT": TRRT,
    **{pid: Core(partial(BIDIR.draws, selection=sel),
                 partial(BIDIR.run, selection=sel, check_edges=checked))
       for pid, (sel, checked) in _BIDIR_MODES.items()},
    "ProjEST": PROJ_EST,
    "PDST": PDST,
    "STRIDE": STRIDE,
    "BFMT": BFMT,
}

planner_registry: Dict[str, Callable] = {
    "PRM": _solve_prm,
    "PRMstar": _solve_prm_star,
    "LazyPRM": _solve_prm,  # every edge is checked up front in one
    # dense program; laziness buys nothing there
    "LazyPRMstar": _solve_prm_star,  # same collapse at the PRM* radius
    **{pid: partial(_solve_rrt, **flags) for pid, flags in _RRT_FLAGS.items()},
    "RRTConnect": _solve_rrt_connect,
    "EST": solve_est,
    "KPIECE1": solve_kpiece,
    "SST": solve_sst,
    "FMTstar": solve_fmt,
    "FMT": solve_fmt,  # OMPL class name (the reference binds "FMT")
    "BITstar": solve_bitstar,
    "TRRT": solve_trrt,  # the reference front-end's default planner
    **{pid: partial(solve_bidir, selection=sel, check_edges=checked)
       for pid, (sel, checked) in _BIDIR_MODES.items()},
    "ProjEST": solve_proj_est,
    "PDST": solve_pdst,
    "STRIDE": solve_stride,
    "BFMT": solve_bfmt,
    "ABITstar": solve_abitstar,
    "AITstar": solve_aitstar,
}


def normalize_planner_id(planner_id: str) -> str:
    """Accept reference-style ids (``ompl.geometric.TRRT``,
    ``kompass.geometric.TRRT``) alongside bare OMPL class names."""
    return planner_id.rsplit(".", 1)[-1]


# reference-compatible aliases
OMPLGeometric = GlobalPlanner
OMPLGeometricConfig = GlobalPlannerConfig
