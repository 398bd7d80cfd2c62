"""The DWA control tick as PyTorch tensor code on an explicit device.

Counterpart of ``kompass_core_tpu/ops/solver.py``:

    grid [S] -> rollout [S, T] (closed-form f32 cumsum)
             -> fused obstacle + segment min-distance sweep [S, T]
                (``ops/kernels.fused_min_dist_sq``: a CUDA kernel on the
                card, its plain version on the CPU)
             -> drop / truncate semantics as masks (no ragged shapes)
             -> five costs -> weighted sum [S] -> first-minimum argmin

Rules kept from the JAX package: every shape is static for a
``SolverSpec``; the adaptive horizon is an ``active_points`` mask, never a
resize; colliding samples get +inf cost instead of being dropped; a
where-select precedes every sum so inf * 0 never makes NaN; everything on
the device is float32 (the velocity window is built on the host in
float64, ``ops/window.py``).

No host sync inside the tick: the scalars (``active_points``,
``obs_count``, ``seg_count``, ...) stay 0-d tensors on the device and
nothing here calls ``.item()`` or branches in Python on a device value.
Python branches only on the static ``SolverSpec``.

The JAX package's TPU layout workarounds (power-of-two sweep padding,
one-hot masked sums in place of per-row gathers) are not carried over;
their outputs are: ``torch.gather`` picks the same rows exactly.

Not ported yet (raise ``NotImplementedError``): BOX robots, moving
obstacles, device-window (fleet) mode, custom costs, the debug sampler and
the standalone cost evaluator; see ROADMAP.md.
"""

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .kernels import fused_min_dist_sq
from .window import MIN_VEL, VelocityWindow

_INF = float("inf")

# Voxel-inflation margin as a multiple of the map resolution (calibrated in
# the JAX package, tests/test_collision_model.py).
COLLISION_MARGIN_FACTOR = 0.7


@dataclasses.dataclass(frozen=True, eq=True)
class SolverSpec:
    """Static geometry of the solver: the JAX ``SolverSpec`` without
    ``backend`` (the port has one sweep implementation)."""

    is_omni: bool
    n_vx: int
    n_vy: int
    n_omega: int
    max_points: int  # T: points per trajectory (>= 2)
    num_ctrl_points: int  # control horizon in steps
    scan_size: int  # padded obstacle-point capacity
    seg_size: int  # padded tracked-segment capacity
    drop_samples: bool = True
    device_window: bool = False
    collision_box: Optional[Tuple[float, float]] = None
    dynamic_box: bool = False
    moving_obstacles: bool = False

    @property
    def num_samples(self) -> int:
        if self.is_omni:
            return self.n_vx * (self.n_vy + self.n_omega)
        return self.n_vx * self.n_omega


# JAX backends that all compute the same sweep function as the port
_SAME_FUNCTION_BACKENDS = ("xla", "pallas_vpu", "pallas")


def spec_from_jax(jax_spec) -> SolverSpec:
    """The port's ``SolverSpec`` for a ``kompass_core_tpu`` ``SolverSpec``,
    field by field as plain Python values. Its ``backend`` must be one
    that computes the port's sweep function."""
    backend = jax_spec.backend
    if backend not in _SAME_FUNCTION_BACKENDS:
        raise ValueError(
            f"backend {backend!r} has no counterpart in the port; expected "
            f"one of {_SAME_FUNCTION_BACKENDS}"
        )
    box = jax_spec.collision_box
    return SolverSpec(
        is_omni=bool(jax_spec.is_omni),
        n_vx=int(jax_spec.n_vx),
        n_vy=int(jax_spec.n_vy),
        n_omega=int(jax_spec.n_omega),
        max_points=int(jax_spec.max_points),
        num_ctrl_points=int(jax_spec.num_ctrl_points),
        scan_size=int(jax_spec.scan_size),
        seg_size=int(jax_spec.seg_size),
        drop_samples=bool(jax_spec.drop_samples),
        device_window=bool(jax_spec.device_window),
        collision_box=None if box is None else (float(box[0]), float(box[1])),
        dynamic_box=bool(jax_spec.dynamic_box),
        moving_obstacles=bool(jax_spec.moving_obstacles),
    )


def _check_ported(spec: SolverSpec) -> None:
    if spec.collision_box is not None or spec.dynamic_box:
        raise NotImplementedError(
            "BOX-robot collision (_min_box_dist_sq) is not ported yet "
            "(ROADMAP queue 1, item 3c)"
        )
    if spec.moving_obstacles:
        raise NotImplementedError(
            "moving obstacles (TPU kernel K3) are not ported yet "
            "(ROADMAP queue 1, item 3d)"
        )
    if spec.device_window:
        raise NotImplementedError(
            "the on-device velocity window (fleet mode) is not ported yet "
            "(ROADMAP queue 1, item 5)"
        )


class SolverParams(NamedTuple):
    """Dynamic solver parameters, each a 0-d float32 tensor."""

    time_step: torch.Tensor
    robot_radius: torch.Tensor
    collision_margin: torch.Tensor  # voxel inflation added to the radius
    weight_path: torch.Tensor
    weight_goal: torch.Tensor
    weight_obstacles: torch.Tensor
    weight_smoothness: torch.Tensor
    weight_jerk: torch.Tensor
    acc_limit_vx: torch.Tensor
    acc_limit_vy: torch.Tensor
    acc_limit_omega: torch.Tensor
    max_obstacles_dist: torch.Tensor  # range at which obstacle cost hits 0

    @classmethod
    def create(
        cls,
        time_step,
        robot_radius,
        collision_margin,
        weights,  # dict-like with the 5 cost weights
        acc_limits,  # (vx_acc, vy_acc, omega_acc)
        max_obstacles_dist,
        *,
        device,
    ) -> "SolverParams":
        def f(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)

        return cls(
            time_step=f(time_step),
            robot_radius=f(robot_radius),
            collision_margin=f(collision_margin),
            weight_path=f(weights["reference_path_distance_weight"]),
            weight_goal=f(weights["goal_distance_weight"]),
            weight_obstacles=f(weights["obstacles_distance_weight"]),
            weight_smoothness=f(weights["smoothness_weight"]),
            weight_jerk=f(weights["jerk_weight"]),
            acc_limit_vx=f(acc_limits[0]),
            acc_limit_vy=f(acc_limits[1]),
            acc_limit_omega=f(acc_limits[2]),
            max_obstacles_dist=f(max_obstacles_dist),
        )


class SolveResult(NamedTuple):
    found: torch.Tensor  # bool scalar
    cost: torch.Tensor  # f32 scalar (winning total cost)
    best_index: torch.Tensor  # int64 scalar
    velocities: torch.Tensor  # [T-1, 3] winning velocity sequence
    path: torch.Tensor  # [T, 2] winning rollout
    costs: torch.Tensor  # [S] total masked costs (inf = inadmissible)
    num_admissible: torch.Tensor  # int32 scalar


# ---------------------------------------------------------------------------
# grid and rollout
# ---------------------------------------------------------------------------


def _each(x, k: int):
    """[n] -> [n * k], every element k times in a row (a view expand, so
    no device sync as repeat_interleave may need)."""
    return x[:, None].expand(x.shape[0], k).reshape(-1)


def _build_velocity_grid(spec: SolverSpec, window):
    """Per-sample velocities [S, 3] + validity [S] in the reference's
    sampling order (vx outer loop ascending; for omni the vy block
    precedes the omega block per vx)."""
    vx_vals, vx_mask, vy_vals, vy_mask, w_vals, w_mask = window
    if not spec.is_omni:
        vx = _each(vx_vals, spec.n_omega)
        w = w_vals.repeat(spec.n_vx)
        valid = (
            _each(vx_mask, spec.n_omega)
            & w_mask.repeat(spec.n_vx)
            & (vx.abs() >= MIN_VEL)
        )
        return torch.stack([vx, torch.zeros_like(vx), w], dim=-1), valid

    # omni: per vx, first the (vx, vy, 0) block then the (vx, 0, omega) block
    blk = spec.n_vy + spec.n_omega
    vx = _each(vx_vals, blk)
    vy = torch.cat([vy_vals, vy_vals.new_zeros(spec.n_omega)]).repeat(spec.n_vx)
    w = torch.cat([w_vals.new_zeros(spec.n_vy), w_vals]).repeat(spec.n_vx)
    ones_w = w_mask.new_ones(spec.n_omega)
    ones_vy = vy_mask.new_ones(spec.n_vy)
    blk_valid = (
        torch.cat([vy_mask, ones_w]) & torch.cat([ones_vy, w_mask])
    ).repeat(spec.n_vx)
    is_omega = torch.cat([~ones_vy, ones_w]).repeat(spec.n_vx)
    # the omega block needs |vx| >= MIN_VEL; an all-~0 sample is skipped
    nonzero = (vx.abs() >= MIN_VEL) | (vy.abs() >= MIN_VEL) | (w.abs() >= MIN_VEL)
    valid = (
        _each(vx_mask, blk)
        & blk_valid
        & nonzero
        & (~is_omega | (vx.abs() >= MIN_VEL))
    )
    return torch.stack([vx, vy, w], dim=-1), valid


def _rollout(spec: SolverSpec, params: SolverParams, state, vels):
    """Constant-velocity unicycle rollout in closed form: the position at
    step t uses the heading yaw0 + omega * t * dt before the step, so the
    [S, T] rollout is an f32 prefix sum of rotated displacements."""
    dt = params.time_step
    x0, y0, yaw0 = state[0], state[1], state[2]
    t = torch.arange(spec.max_points - 1, dtype=torch.float32, device=vels.device)
    vx, vy, w = vels[:, 0:1], vels[:, 1:2], vels[:, 2:3]
    yaw_t = yaw0 + w * t[None, :] * dt  # [S, T-1] heading before each step
    c = torch.cos(yaw_t)
    s = torch.sin(yaw_t)
    dx = (vx * c - vy * s) * dt
    dy = (vx * s + vy * c) * dt
    start = vels.new_zeros(vels.shape[0], 1)
    px = torch.cat([start + x0, x0 + torch.cumsum(dx, dim=1)], dim=1)
    py = torch.cat([start + y0, y0 + torch.cumsum(dy, dim=1)], dim=1)
    return px, py  # each [S, T]


# ---------------------------------------------------------------------------
# admissibility
# ---------------------------------------------------------------------------


def _admissibility(spec, params, d2_obs, active_points, valid):
    """Drop / truncate semantics of the reference sampler as masks.

    A sample collides at a checked pose t in [1, active_points - 1] when
    d2 < (radius + margin)^2. Drop mode rejects it; truncate mode keeps it
    when its last free pose lies past the control horizon."""
    T = d2_obs.shape[1]
    t_idx = torch.arange(T, device=d2_obs.device)
    check_mask = (t_idx >= 1) & (t_idx <= active_points - 1)
    r = params.robot_radius + params.collision_margin
    collide = (d2_obs < r * r) & check_mask[None, :]

    any_col = collide.any(dim=1)
    first_hit = collide.to(torch.int32).argmax(dim=1)  # first True
    first_bad_pose = torch.where(any_col, first_hit, T + 1)
    i_col = first_bad_pose - 1  # step index at which the loop broke
    last_free = torch.where(i_col > 0, i_col - 1, active_points - 1)

    if spec.drop_samples:
        truncate_ok = torch.zeros_like(any_col)
    else:
        truncate_ok = (
            any_col
            & (last_free > spec.num_ctrl_points)
            & (last_free < active_points - 1)
        )
    admissible = valid & (~any_col | truncate_ok)
    return admissible, truncate_ok, i_col, last_free


def _apply_truncation(px, py, vels, truncate_ok, i_col, last_free):
    """Zero the velocities from the collision step on and freeze the path
    at path[last_free] (the reference's exact fill point)."""
    T = px.shape[1]
    t_idx = torch.arange(T, device=px.device)[None, :]
    j_idx = torch.arange(T - 1, device=px.device)[None, :]
    lf = last_free[:, None]
    freeze = truncate_ok[:, None] & (t_idx > i_col[:, None])
    px = torch.where(freeze, px.gather(1, lf), px)
    py = torch.where(freeze, py.gather(1, lf), py)
    zero_vel = truncate_ok[:, None] & (j_idx >= i_col[:, None])  # [S, T-1]
    vel_traj = torch.where(zero_vel[:, :, None], 0.0, vels[:, None, :])
    return px, py, vel_traj, freeze


# ---------------------------------------------------------------------------
# costs (contracts of the reference cost_evaluator.cpp:111-233)
# ---------------------------------------------------------------------------


def _trajectory_end_points(px, py, active_points):
    """[S] end-point coordinates at index active_points - 1."""
    idx = (active_points - 1).clamp(0, px.shape[1] - 1).reshape(1)
    return px.index_select(1, idx)[:, 0], py.index_select(1, idx)[:, 0]


def _path_cost(px, py, d2_seg, seg_last_xy, seg_total_len, active_points):
    """Average distance of the active rollout points to the tracked
    segment plus the normalised end-point distance, halved.

    ``d2_seg``: per-point min squared segment distance [S, T] from the
    fused sweep. A zero-length segment skips the normalised end term."""
    T = px.shape[1]
    pt_mask = torch.arange(T, device=px.device) < active_points
    d = torch.sqrt(d2_seg)
    avg = torch.where(pt_mask[None, :], d, 0.0).sum(dim=1) / active_points.to(
        torch.float32
    )
    end_x, end_y = _trajectory_end_points(px, py, active_points)
    ex = end_x - seg_last_xy[0]
    ey = end_y - seg_last_xy[1]
    end_dist = torch.where(
        seg_total_len > 0.0,
        torch.sqrt(ex * ex + ey * ey) / torch.clamp(seg_total_len, min=1e-9),
        0.0,
    )
    return (avg + end_dist) / 2.0


def _goal_cost(px, py, seg_x, seg_y, seg_arc, ref_total_len, active_points):
    """Remaining arc length from the segment point nearest the end point,
    plus the normalised euclidean tie-breaker; first minimum wins."""
    end_x, end_y = _trajectory_end_points(px, py, active_points)
    dx = end_x[:, None] - seg_x[None, :]
    dy = end_y[:, None] - seg_y[None, :]
    d2 = dx * dx + dy * dy  # [S, G]; pad rows sit at 1e8
    j_star = torch.argmin(d2, dim=1)
    min_d2 = torch.amin(d2, dim=1)
    arc_at = seg_arc[j_star]
    return (ref_total_len - arc_at) / ref_total_len + torch.sqrt(min_d2) / ref_total_len


def _obstacles_cost(d2_obs, max_obstacles_dist):
    """Linear decay 1 -> 0 over [0, max_obstacles_dist] of the rollout's
    minimum obstacle distance."""
    d = torch.sqrt(torch.amin(d2_obs, dim=1))
    return torch.clamp(max_obstacles_dist - d, min=0.0) / max_obstacles_dist


def _smoothness_cost(vel_traj, active_points, acc_limits):
    """Squared velocity first differences over the acceleration limits,
    averaged over 3 * (active_points - 1)."""
    S, Tm1, _ = vel_traj.shape
    j = torch.arange(Tm1, device=vel_traj.device)
    dm = ((j >= 1) & (j <= active_points - 2))[1:]  # aligned with dv
    dv = vel_traj[:, 1:, :] - vel_traj[:, :-1, :]  # [S, T-2, 3]
    cost = vel_traj.new_zeros(S)
    for c, acc in enumerate(acc_limits):
        dvc = dv[:, :, c]
        term = torch.where(dm[None, :], dvc * dvc, 0.0).sum(dim=1) / acc
        cost = cost + torch.where(acc > 0, term, 0.0)
    return cost / (3.0 * (active_points - 1).to(torch.float32))


def _jerk_cost(vel_traj, active_points, acc_limits):
    """Squared velocity second differences, normalised like smoothness."""
    S, Tm1, _ = vel_traj.shape
    j = torch.arange(Tm1, device=vel_traj.device)
    dm = ((j >= 2) & (j <= active_points - 2))[2:]
    ddv = vel_traj[:, 2:, :] - 2.0 * vel_traj[:, 1:-1, :] + vel_traj[:, :-2, :]
    cost = vel_traj.new_zeros(S)
    for c, acc in enumerate(acc_limits):
        ddc = ddv[:, :, c]
        term = torch.where(dm[None, :], ddc * ddc, 0.0).sum(dim=1) / acc
        cost = cost + torch.where(acc > 0, term, 0.0)
    return cost / (3.0 * (active_points - 1).to(torch.float32))


# ---------------------------------------------------------------------------
# full solve
# ---------------------------------------------------------------------------


def dwa_solve(
    spec: SolverSpec,
    params: SolverParams,
    state,  # [3] x, y, yaw (world)
    window,  # VelocityWindow of tensors (host-built values, padded)
    obs_xy,  # [R, 2] obstacle points, world frame, padded with 1e8
    obs_count,  # 0-d int32: number of real obstacle points
    seg_x,  # [SEG] tracked segment x, padded with 1e8
    seg_y,  # [SEG]
    seg_arc,  # [SEG] absolute prefix arc length on the full path
    seg_count,  # 0-d int32
    seg_total_len,  # 0-d f32 (View.totalSegmentLength)
    ref_total_len,  # 0-d f32 (full interpolated path length)
    active_points,  # 0-d int32 <= spec.max_points (adaptive horizon)
) -> SolveResult:
    """One DWA tick on the device of ``state``: the first-minimum
    trajectory over the dynamic window. Every tensor argument lies on
    that device."""
    _check_ported(spec)
    S, T = spec.num_samples, spec.max_points
    vels, valid = _build_velocity_grid(spec, window)
    px, py = _rollout(spec, params, state, vels)

    # both O(S * T * rows) sweeps in one fused pass; the obstacle field
    # serves collision and the obstacle cost, the segment field the path cost
    d2_obs, d2_seg = fused_min_dist_sq(px, py, obs_xy, seg_x, seg_y, active_points)

    admissible, truncate_ok, i_col, last_free = _admissibility(
        spec, params, d2_obs, active_points, valid
    )
    if spec.drop_samples:
        # drop mode never truncates: constant velocity along every row
        vel_traj = vels[:, None, :].expand(S, T - 1, 3)
    else:
        px, py, vel_traj, frozen = _apply_truncation(
            px, py, vels, truncate_ok, i_col, last_free
        )
        # frozen points sit at path[last_free]: both fields take their
        # value there instead of a second sweep
        lf = last_free[:, None]
        d2_obs = torch.where(frozen, d2_obs.gather(1, lf), d2_obs)
        d2_seg = torch.where(frozen, d2_seg.gather(1, lf), d2_seg)

    acc_limits = (params.acc_limit_vx, params.acc_limit_vy, params.acc_limit_omega)
    total = px.new_zeros(S)

    has_path = ref_total_len > 0.0
    last_i = torch.clamp(seg_count - 1, min=0).reshape(1)
    seg_last_xy = (seg_x.index_select(0, last_i)[0], seg_y.index_select(0, last_i)[0])

    goal = _goal_cost(px, py, seg_x, seg_y, seg_arc, ref_total_len, active_points)
    total = total + torch.where(
        has_path & (params.weight_goal > 0), params.weight_goal * goal, 0.0
    )
    pathc = _path_cost(px, py, d2_seg, seg_last_xy, seg_total_len, active_points)
    total = total + torch.where(
        has_path & (params.weight_path > 0), params.weight_path * pathc, 0.0
    )
    obst = _obstacles_cost(d2_obs, params.max_obstacles_dist)
    total = total + torch.where(
        (obs_count > 0) & (params.weight_obstacles > 0),
        params.weight_obstacles * obst,
        0.0,
    )
    if not spec.drop_samples:
        # only truncated samples change velocity; in drop mode both
        # smoothness and jerk are exactly zero
        smooth = _smoothness_cost(vel_traj, active_points, acc_limits)
        total = total + torch.where(
            params.weight_smoothness > 0, params.weight_smoothness * smooth, 0.0
        )
        jerk = _jerk_cost(vel_traj, active_points, acc_limits)
        total = total + torch.where(
            params.weight_jerk > 0, params.weight_jerk * jerk, 0.0
        )

    costs = torch.where(admissible, total, _INF)
    best = torch.argmin(costs)  # first minimum, like the reference's `<` scan
    row = best.reshape(1)
    return SolveResult(
        found=admissible.any(),
        cost=costs.index_select(0, row)[0],
        best_index=best,
        velocities=vel_traj.index_select(0, row)[0],
        path=torch.stack(
            [px.index_select(0, row)[0], py.index_select(0, row)[0]], dim=-1
        ),
        costs=costs,
        num_admissible=admissible.sum().to(torch.int32),
    )


# ---------------------------------------------------------------------------
# single-buffer (packed) interface: byte-for-byte the JAX package's layout,
# so one pack_solver_input buffer feeds both packages
# ---------------------------------------------------------------------------

_HDR = 20  # header scalars, see layout below


def _window_block_size(spec: SolverSpec) -> int:
    """Floats reserved for the window block (device-window mode stores
    current_vel[3] | limits[9] there, so it holds at least 12)."""
    n = 2 * (spec.n_vx + spec.n_vy + spec.n_omega)
    return max(n, 12) if spec.device_window else n


def packed_input_size(spec: SolverSpec) -> int:
    return (
        _HDR
        + _window_block_size(spec)
        + 2 * spec.scan_size
        + 3 * spec.seg_size
        + (2 * spec.scan_size if spec.moving_obstacles else 0)
    )


def pack_solver_input(
    spec: SolverSpec,
    buf,  # np.ndarray [packed_input_size] float32, written in place
    params_vec,  # [12] float32: dt, radius, margin, 5 weights, 3 acc, maxObsDist
    state,  # (x, y, yaw)
    window,
    obs_xy,  # [R, 2] padded
    obs_count: int,
    seg_x,
    seg_y,
    seg_arc,
    seg_count: int,
    seg_total_len: float,
    ref_total_len: float,
    active_points: int,
    current_vel=None,
    limits_vec=None,
    obs_vel_xy=None,  # [R, 2] world-frame obstacle velocities
):
    """Serialize one tick's dynamic inputs into the packed buffer (host,
    numpy). Pass ``window=None`` with ``current_vel``/``limits_vec`` when
    the spec uses device-window mode."""
    if spec.device_window and window is not None:
        raise ValueError(
            "spec.device_window=True: pass window=None with "
            "current_vel/limits_vec, not a host-sampled window"
        )
    if not spec.device_window and window is None:
        raise ValueError(
            "spec.device_window=False: pass a host-sampled window "
            "(window=None is only valid for device-window specs)"
        )
    buf[0:3] = state
    buf[3] = obs_count
    buf[4] = seg_count
    buf[5] = seg_total_len
    buf[6] = ref_total_len
    buf[7] = active_points
    buf[8:20] = params_vec
    o = _HDR
    if window is None:
        buf[o : o + 3] = current_vel
        buf[o + 3 : o + 12] = limits_vec
        o += _window_block_size(spec)
    else:
        for arr in window:
            n = arr.shape[0]
            buf[o : o + n] = arr
            o += n
    r = spec.scan_size
    buf[o : o + r] = obs_xy[:, 0]
    buf[o + r : o + 2 * r] = obs_xy[:, 1]
    o += 2 * r
    g = spec.seg_size
    buf[o : o + g] = seg_x
    buf[o + g : o + 2 * g] = seg_y
    buf[o + 2 * g : o + 3 * g] = seg_arc
    o += 3 * g
    if spec.moving_obstacles:
        if obs_vel_xy is None:
            buf[o : o + 2 * r] = 0.0
        else:
            buf[o : o + r] = obs_vel_xy[:, 0]
            buf[o + r : o + 2 * r] = obs_vel_xy[:, 1]
    elif obs_vel_xy is not None:
        raise ValueError(
            "obs_vel_xy given but the spec has moving_obstacles=False — "
            "the static buffer has no velocity block; build the spec "
            "with moving_obstacles=True"
        )
    return buf


def _unpack_inputs(spec: SolverSpec, buf):
    """Parse the packed layout from a 1-D float32 tensor, on its device.
    Returns (params, state, window, obs_xy, obs_count, seg_x, seg_y,
    seg_arc, seg_count, seg_total_len, ref_total_len, active_points)."""
    p = buf[8:20]
    params = SolverParams(*p.unbind(0))
    o = _HDR
    window = []
    for n in (spec.n_vx, spec.n_vy, spec.n_omega):
        window += [buf[o : o + n], buf[o + n : o + 2 * n] > 0.5]
        o += 2 * n
    r = spec.scan_size
    obs_xy = torch.stack([buf[o : o + r], buf[o + r : o + 2 * r]], dim=1)
    o += 2 * r
    g = spec.seg_size
    return (
        params,
        buf[0:3],
        VelocityWindow(*window),
        obs_xy,
        buf[3].to(torch.int32),
        buf[o : o + g],
        buf[o + g : o + 2 * g],
        buf[o + 2 * g : o + 3 * g],
        buf[4].to(torch.int32),
        buf[5],
        buf[6],
        buf[7].to(torch.int32),
    )


def _unpack_and_solve(spec: SolverSpec, buf):
    """Unpack on the device, solve, and pack the output vector:
    [found, cost, best_index, num_admissible,
     vx[T-1], vy[T-1], omega[T-1], px[T], py[T]]."""
    res = dwa_solve(spec, *_unpack_inputs(spec, buf))
    head = torch.stack(
        [
            res.found.to(torch.float32),
            res.cost,
            res.best_index.to(torch.float32),
            res.num_admissible.to(torch.float32),
        ]
    )
    return torch.cat(
        [head, res.velocities.T.reshape(-1), res.path.T.reshape(-1)]
    )


def unpack_solver_output(spec: SolverSpec, out):
    """Host-side split of the packed output vector (numpy array)."""
    T = spec.max_points
    found = bool(out[0] > 0.5)
    cost = float(out[1])
    best_index = int(out[2])
    num_admissible = int(out[3])
    o = 4
    vx = out[o : o + T - 1]
    vy = out[o + T - 1 : o + 2 * (T - 1)]
    omega = out[o + 2 * (T - 1) : o + 3 * (T - 1)]
    o += 3 * (T - 1)
    px = out[o : o + T]
    py = out[o + T : o + 2 * T]
    return found, cost, best_index, num_admissible, vx, vy, omega, px, py


def make_packed_dwa_solver(spec: SolverSpec, device):
    """Single-buffer solver on ``device``: f32[packed_input_size] (numpy
    or tensor) -> f32[4 + 3*(T-1) + 2*T] tensor on ``device``. The input
    goes to the device in one copy; nothing in the solve waits for the
    device, so the caller's read of the output is the tick's one sync."""
    if spec.dynamic_box:
        raise ValueError(
            "dynamic_box specs are not supported by the packed"
            " single-buffer interface; use the fleet tick"
            " or a static spec.collision_box"
        )
    _check_ported(spec)
    device = torch.device(device)
    size = packed_input_size(spec)

    def solve(buf):
        buf = torch.as_tensor(buf, dtype=torch.float32, device=device)
        if buf.shape != (size,):
            raise ValueError(f"packed input must be [{size}], got {list(buf.shape)}")
        return _unpack_and_solve(spec, buf)

    return solve


def check_states_feasibility(states_xy, obs_xy, radius, margin, *, device):
    """True if any of the given positions collides with the obstacle
    points (the reference's boolean convention: True = collision)."""
    states_xy = torch.as_tensor(states_xy, dtype=torch.float32, device=device)
    obs_xy = torch.as_tensor(obs_xy, dtype=torch.float32, device=device)
    dx = states_xy[:, 0:1] - obs_xy[None, :, 0]
    dy = states_xy[:, 1:2] - obs_xy[None, :, 1]
    r = radius + margin
    return bool(torch.any(torch.amin(dx * dx + dy * dy, dim=-1) < r * r))
