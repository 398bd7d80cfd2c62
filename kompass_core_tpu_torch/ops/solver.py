"""The DWA control tick as PyTorch tensor code on an explicit device.

Counterpart of ``kompass_core_tpu/ops/solver.py``:

    grid [S] -> rollout [S, T] (closed-form f32 cumsum)
             -> obstacle + segment min-distance sweeps [S, T]
                (``ops/kernels.py``: CUDA kernels on the card, their plain
                versions on the CPU; which kernel follows
                ``SolverSpec.backend`` as in the JAX package, see
                ``_sweeps``)
             -> split movers (``mover4``): K3s, min-combined
             -> BOX robots: the oriented-box surface distance [S, T] (K9)
             -> drop / truncate semantics as masks (no ragged shapes)
             -> five costs + custom costs -> weighted sum [S]
             -> first-minimum argmin

A robot axis: every tensor may carry leading batch dimensions, the same
on all of them (``[B, S, T]`` rollouts for ``[B]`` per-robot scalars).
That is the JAX fleet's ``vmap`` written out, so one code path serves the
single-robot packed solver (B = 1) and the fleet tick (B = robots).

Rules kept from the JAX package: every shape is static for a
``SolverSpec``; the adaptive horizon is an ``active_points`` mask, never a
resize; colliding samples get +inf cost instead of being dropped; a
where-select precedes every sum so inf * 0 never makes NaN; everything on
the device is float32 (the single-robot velocity window is built on the
host in float64, ``ops/window.py``; the fleet's on the device in float32,
``_device_window``).

No host sync inside the tick: the scalars (``active_points``,
``obs_count``, ``seg_count``, ...) stay tensors on the device and nothing
here calls ``.item()`` or branches in Python on a device value. Python
branches only on the static ``SolverSpec``.

The JAX package's TPU layout workarounds (power-of-two sweep padding,
one-hot masked sums in place of per-row gathers) are not carried over;
their outputs are: ``torch.gather`` picks the same rows exactly.

Also here: the standalone cost evaluator (``evaluate_trajectory_costs``),
the debug sampler (``dwa_sample_debug``) and the cached solvers.
"""

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .kernels import (
    box_min_dist_sq,
    fused_min_dist_sq,
    fused_min_dist_sq_broadcast,
    fused_min_dist_sq_expanded,
    fused_min_dist_sq_moving,
    fused_min_dist_sq_moving_broadcast,
    fused_min_dist_sq_moving_expanded,
    min_dist_sq_expanded,
    min_dist_sq_moving,
)
from .window import MIN_VEL, VelocityWindow

_INF = float("inf")
_PAD = 1e8

# the JAX package's SolverSpec.backend values, each with its own sweep
# kernel (_sweeps)
BACKENDS = ("xla", "pallas_vpu", "pallas", "pallas_v1")

# Voxel-inflation margin as a multiple of the map resolution (calibrated in
# the JAX package, tests/test_collision_model.py).
COLLISION_MARGIN_FACTOR = 0.7


@dataclasses.dataclass(frozen=True, eq=True)
class SolverSpec:
    """Static geometry of the solver: the JAX ``SolverSpec``, field by
    field."""

    is_omni: bool
    n_vx: int
    n_vy: int
    n_omega: int
    max_points: int  # T: points per trajectory (>= 2)
    num_ctrl_points: int  # control horizon in steps
    scan_size: int  # padded obstacle-point capacity
    seg_size: int  # padded tracked-segment capacity
    drop_samples: bool = True
    # which sweep kernel runs (BACKENDS; dispatch in _sweeps)
    backend: str = "xla"
    # True: the packed window block carries (current_vel[3], limits[9])
    # and the window is built on the device (fleet mode)
    device_window: bool = False
    collision_box: Optional[Tuple[float, float]] = None
    dynamic_box: bool = False
    # obstacles carry world velocities; the sweep evaluates each at
    # obs + v * t * dt for rollout step t
    moving_obstacles: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} is not one of {BACKENDS}"
            )

    @property
    def num_samples(self) -> int:
        if self.is_omni:
            return self.n_vx * (self.n_vy + self.n_omega)
        return self.n_vx * self.n_omega


def spec_from_jax(jax_spec) -> SolverSpec:
    """The port's ``SolverSpec`` for a ``kompass_core_tpu`` ``SolverSpec``,
    field by field as plain Python values."""
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
        backend=str(jax_spec.backend),
        device_window=bool(jax_spec.device_window),
        collision_box=None if box is None else (float(box[0]), float(box[1])),
        dynamic_box=bool(jax_spec.dynamic_box),
        moving_obstacles=bool(jax_spec.moving_obstacles),
    )


class SolverParams(NamedTuple):
    """Dynamic solver parameters, each a float32 tensor (one value per
    robot)."""

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
    """Per robot (leading batch dimensions of the inputs first)."""

    found: torch.Tensor  # bool
    cost: torch.Tensor  # f32 (winning total cost)
    best_index: torch.Tensor  # int64
    velocities: torch.Tensor  # [T-1, 3] winning velocity sequence
    path: torch.Tensor  # [T, 2] winning rollout
    costs: torch.Tensor  # [S] total masked costs (inf = inadmissible)
    num_admissible: torch.Tensor  # int32


def _div(x, divisor: float):
    """x / divisor as a true division on every device: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal instead, one
    rounding away from the CPU's (and the JAX package's) quotient."""
    return x / torch.full_like(x, divisor)


def _col(x, k: int = 1):
    """A per-robot value [...] as [..., 1 (k times)], to broadcast
    against k trailing per-sample axes."""
    return x.reshape(x.shape + (1,) * k)


# ---------------------------------------------------------------------------
# grid and rollout
# ---------------------------------------------------------------------------


def _device_window(spec: SolverSpec, current_vel, limits, time_step):
    """On-device dynamic window (fleet mode), float32 with the JAX
    package's operation order: values ``lo + k * res`` and an inclusion
    mask with a small tolerance at the boundary.

    current_vel [..., 3], limits [..., 9] (per axis: max, acc, decel),
    time_step [...] -> ``VelocityWindow`` of [..., n] tensors."""
    vx0, vy0, w0 = (current_vel[..., i] for i in range(3))
    lim = [limits[..., i] for i in range(9)]
    dt = time_step
    device = current_vel.device

    def axis(v0, vmax, acc, dec, n):
        # clamp the reported velocity into the limit band first: a
        # non-omni robot of a mixed fleet carries zeroed vy limits
        v0 = torch.minimum(torch.maximum(v0, -vmax), vmax)
        hi = torch.minimum(vmax, v0 + acc * dt)
        lo = torch.maximum(-vmax, v0 - dec * dt)
        res = torch.clamp(_div(hi - lo, max(n - 1, 1)), min=0.001)
        vals = _col(lo) + torch.arange(n, dtype=torch.float32, device=device) * _col(res)
        mask = vals <= _col(hi + 1e-5 * torch.abs(hi) + 1e-7)
        return vals, mask

    vx_vals, vx_mask = axis(vx0, *lim[0:3], spec.n_vx)
    if spec.is_omni:
        vy_vals, vy_mask = axis(vy0, *lim[3:6], spec.n_vy)
    else:
        vy_vals = vx_vals.new_zeros(vx_vals.shape[:-1] + (spec.n_vy,))
        vy_mask = (torch.arange(spec.n_vy, device=device) == 0).expand(
            vy_vals.shape
        )
    w_vals, w_mask = axis(w0, *lim[6:9], spec.n_omega)
    return VelocityWindow(vx_vals, vx_mask, vy_vals, vy_mask, w_vals, w_mask)


def _each(x, k: int):
    """[..., n] -> [..., n * k], every element k times in a row (a view
    expand, so no device sync as repeat_interleave may need)."""
    return x.unsqueeze(-1).expand(x.shape + (k,)).reshape(x.shape[:-1] + (-1,))


def _tile(x, k: int):
    """[..., n] -> [..., k * n], the whole row k times."""
    lead, n = x.shape[:-1], x.shape[-1]
    return x.unsqueeze(-2).expand(lead + (k, n)).reshape(lead + (k * n,))


def _build_velocity_grid(spec: SolverSpec, window):
    """Per-sample velocities [..., S, 3] + validity [..., S] in the
    reference's sampling order (vx outer loop ascending; for omni the vy
    block precedes the omega block per vx)."""
    vx_vals, vx_mask, vy_vals, vy_mask, w_vals, w_mask = window
    if not spec.is_omni:
        vx = _each(vx_vals, spec.n_omega)
        w = _tile(w_vals, spec.n_vx)
        valid = (
            _each(vx_mask, spec.n_omega)
            & _tile(w_mask, spec.n_vx)
            & (vx.abs() >= MIN_VEL)
        )
        return torch.stack([vx, torch.zeros_like(vx), w], dim=-1), valid

    # omni: per vx, first the (vx, vy, 0) block then the (vx, 0, omega) block
    lead = vx_vals.shape[:-1]
    blk = spec.n_vy + spec.n_omega
    vx = _each(vx_vals, blk)
    vy = _tile(torch.cat([vy_vals, vy_vals.new_zeros(lead + (spec.n_omega,))], -1),
               spec.n_vx)
    w = _tile(torch.cat([w_vals.new_zeros(lead + (spec.n_vy,)), w_vals], -1),
              spec.n_vx)
    ones_w = w_mask.new_ones(lead + (spec.n_omega,))
    ones_vy = vy_mask.new_ones(lead + (spec.n_vy,))
    blk_valid = _tile(
        torch.cat([vy_mask, ones_w], -1) & torch.cat([ones_vy, w_mask], -1),
        spec.n_vx,
    )
    is_omega = _tile(torch.cat([~ones_vy, ones_w], -1), spec.n_vx)
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
    [..., S, T] rollout is an f32 prefix sum of rotated displacements."""
    dt = _col(params.time_step, 2)
    x0, y0, yaw0 = (_col(state[..., i], 2) for i in range(3))
    t = torch.arange(spec.max_points - 1, dtype=torch.float32, device=vels.device)
    vx, vy, w = vels[..., 0:1], vels[..., 1:2], vels[..., 2:3]
    yaw_t = yaw0 + w * t * dt  # [..., S, T-1] heading before each step
    c = torch.cos(yaw_t)
    s = torch.sin(yaw_t)
    dx = (vx * c - vy * s) * dt
    dy = (vx * s + vy * c) * dt
    start = vels.new_zeros(vels.shape[:-1] + (1,))
    px = torch.cat([start + x0, x0 + _prefix_sum(dx)], dim=-1)
    py = torch.cat([start + y0, y0 + _prefix_sum(dy)], dim=-1)
    return px, py  # each [..., S, T]


def _prefix_sum(d):
    """Sequential f32 prefix sum along the last axis. The scan runs along
    a leading axis of the transposed copy: PyTorch's CUDA kernel then
    adds in sequence per column, the CPU's order (so the card's rollout
    equals the CPU's bit for bit), and at [64, 2025, 29] it takes a
    fraction of the innermost-axis scan's 0.75 ms."""
    return torch.cumsum(d.transpose(-1, -2).contiguous(), dim=-2).transpose(-1, -2)


# ---------------------------------------------------------------------------
# admissibility
# ---------------------------------------------------------------------------


def _min_box_dist_sq(params, state, vels, px, py, obs_xy, active_points,
                     half_extents, obs_vel=None):
    """[..., S, T] min squared distance from the robot's oriented BOX body
    to any obstacle point: zero inside the footprint, +inf where t >=
    active_points. The body at pose t heads yaw0 + omega * t * dt.

    ``half_extents``: (half length, half width) as two floats (static
    ``collision_box``) or two [...] tensors (``dynamic_box``). With
    ``obs_vel`` the rows move as in the moving sweep. The headings' cos
    and sin are computed here; the sweep over the rows is K9
    (``kernels.box_min_dist_sq``: the card's kernel, or its plain version
    on the CPU), over the robots flattened to one axis."""
    lead = px.shape[:-2]
    S, T = px.shape[-2:]
    B = math.prod(lead)
    t = torch.arange(T, dtype=torch.float32, device=px.device)
    dt = _col(params.time_step, 2)
    yaw = _col(state[..., 2], 2) + vels[..., 2:3] * t * dt  # [..., S, T]
    hl, hw = half_extents
    if isinstance(hl, torch.Tensor):
        half = torch.stack([hl, hw], dim=-1).reshape(B, 2)
    else:
        half = torch.stack([px.new_full((B,), hl), px.new_full((B,), hw)], -1)

    def flat(x):
        return x.reshape((B,) + x.shape[len(lead):]).contiguous()

    moving = obs_vel is not None
    d2 = box_min_dist_sq(
        flat(px), flat(py), flat(torch.cos(yaw)), flat(torch.sin(yaw)),
        flat(obs_xy), flat(obs_vel) if moving else None,
        params.time_step.reshape(B).contiguous() if moving else None,
        half, active_points.reshape(B).contiguous(),
    )
    return d2.reshape(px.shape)


def _admissibility(spec, params, d2_obs, active_points, valid,
                   surface_distance=False):
    """Drop / truncate semantics of the reference sampler as masks.

    A sample collides at a checked pose t in [1, active_points - 1] when
    d2 < (radius + margin)^2. Drop mode rejects it; truncate mode keeps it
    when its last free pose lies past the control horizon. With
    ``surface_distance`` (BOX robots) d2 is measured from the body's
    surface, so only the margin counts, and at least 1e-6: inside the
    footprint (d2 == 0) always collides."""
    T = d2_obs.shape[-1]
    t_idx = torch.arange(T, device=d2_obs.device)
    ap = _col(active_points)
    check_mask = (t_idx >= 1) & (t_idx <= ap - 1)  # [..., T]
    if surface_distance:
        r = _col(torch.clamp(params.collision_margin, min=1e-6), 2)
    else:
        r = _col(params.robot_radius + params.collision_margin, 2)
    collide = (d2_obs < r * r) & check_mask.unsqueeze(-2)

    any_col = collide.any(dim=-1)
    first_hit = collide.to(torch.int32).argmax(dim=-1)  # first True
    first_bad_pose = torch.where(any_col, first_hit, T + 1)
    i_col = first_bad_pose - 1  # step index at which the loop broke
    last_free = torch.where(i_col > 0, i_col - 1, ap - 1)

    if spec.drop_samples:
        truncate_ok = torch.zeros_like(any_col)
    else:
        truncate_ok = (
            any_col
            & (last_free > spec.num_ctrl_points)
            & (last_free < ap - 1)
        )
    admissible = valid & (~any_col | truncate_ok)
    return admissible, truncate_ok, i_col, last_free


def _apply_truncation(px, py, vels, truncate_ok, i_col, last_free):
    """Zero the velocities from the collision step on and freeze the path
    at path[last_free] (the reference's exact fill point)."""
    T = px.shape[-1]
    t_idx = torch.arange(T, device=px.device)
    j_idx = torch.arange(T - 1, device=px.device)
    lf = last_free.unsqueeze(-1)
    freeze = truncate_ok.unsqueeze(-1) & (t_idx > i_col.unsqueeze(-1))
    px = torch.where(freeze, px.gather(-1, lf), px)
    py = torch.where(freeze, py.gather(-1, lf), py)
    zero_vel = truncate_ok.unsqueeze(-1) & (j_idx >= i_col.unsqueeze(-1))
    vel_traj = torch.where(zero_vel.unsqueeze(-1), 0.0, vels.unsqueeze(-2))
    return px, py, vel_traj, freeze  # vel_traj [..., S, T-1, 3]


# ---------------------------------------------------------------------------
# costs (contracts of the reference cost_evaluator.cpp:111-233)
# ---------------------------------------------------------------------------


def _trajectory_end_points(px, py, active_points):
    """[..., S] end-point coordinates at index active_points - 1."""
    idx = (active_points - 1).clamp(0, px.shape[-1] - 1).long()
    idx = _col(idx, 2).expand(px.shape[:-1] + (1,))
    return px.gather(-1, idx)[..., 0], py.gather(-1, idx)[..., 0]


def _path_cost(px, py, d2_seg, seg_last_xy, seg_total_len, active_points):
    """Average distance of the active rollout points to the tracked
    segment plus the normalised end-point distance, halved.

    ``d2_seg``: per-point min squared segment distance [..., S, T] from
    the fused sweep. A zero-length segment skips the normalised end term."""
    T = px.shape[-1]
    pt_mask = torch.arange(T, device=px.device) < _col(active_points)
    d = torch.sqrt(d2_seg)
    avg = torch.where(pt_mask.unsqueeze(-2), d, 0.0).sum(dim=-1) / _col(
        active_points.to(torch.float32)
    )
    end_x, end_y = _trajectory_end_points(px, py, active_points)
    ex = end_x - _col(seg_last_xy[0])
    ey = end_y - _col(seg_last_xy[1])
    seg_len = _col(seg_total_len)
    end_dist = torch.where(
        seg_len > 0.0,
        torch.sqrt(ex * ex + ey * ey) / torch.clamp(seg_len, min=1e-9),
        0.0,
    )
    return (avg + end_dist) / 2.0


def _goal_cost(px, py, seg_x, seg_y, seg_arc, ref_total_len, active_points):
    """Remaining arc length from the segment point nearest the end point,
    plus the normalised euclidean tie-breaker; first minimum wins."""
    end_x, end_y = _trajectory_end_points(px, py, active_points)
    dx = end_x.unsqueeze(-1) - seg_x.unsqueeze(-2)
    dy = end_y.unsqueeze(-1) - seg_y.unsqueeze(-2)
    d2 = dx * dx + dy * dy  # [..., S, G]; pad rows sit at 1e8
    j_star = torch.argmin(d2, dim=-1)
    min_d2 = torch.amin(d2, dim=-1)
    arc_at = seg_arc.gather(-1, j_star)
    ref = _col(ref_total_len)
    return (ref - arc_at) / ref + torch.sqrt(min_d2) / ref


def _obstacles_cost(d2_obs, max_obstacles_dist):
    """Linear decay 1 -> 0 over [0, max_obstacles_dist] of the rollout's
    minimum obstacle distance."""
    d = torch.sqrt(torch.amin(d2_obs, dim=-1))
    reach = _col(max_obstacles_dist)
    return torch.clamp(reach - d, min=0.0) / reach


def _smoothness_cost(vel_traj, active_points, acc_limits):
    """Squared velocity first differences over the acceleration limits,
    averaged over 3 * (active_points - 1)."""
    j = torch.arange(vel_traj.shape[-2], device=vel_traj.device)
    dm = ((j >= 1) & (j <= _col(active_points) - 2))[..., 1:]  # aligned with dv
    dv = vel_traj[..., 1:, :] - vel_traj[..., :-1, :]  # [..., S, T-2, 3]
    cost = vel_traj.new_zeros(vel_traj.shape[:-2])
    for c, acc in enumerate(acc_limits):
        dvc = dv[..., c]
        term = torch.where(dm.unsqueeze(-2), dvc * dvc, 0.0).sum(dim=-1) / _col(acc)
        cost = cost + torch.where(_col(acc) > 0, term, 0.0)
    return cost / _col(3.0 * (active_points - 1).to(torch.float32))


def _jerk_cost(vel_traj, active_points, acc_limits):
    """Squared velocity second differences, normalised like smoothness."""
    j = torch.arange(vel_traj.shape[-2], device=vel_traj.device)
    dm = ((j >= 2) & (j <= _col(active_points) - 2))[..., 2:]
    ddv = (vel_traj[..., 2:, :] - 2.0 * vel_traj[..., 1:-1, :]
           + vel_traj[..., :-2, :])
    cost = vel_traj.new_zeros(vel_traj.shape[:-2])
    for c, acc in enumerate(acc_limits):
        ddc = ddv[..., c]
        term = torch.where(dm.unsqueeze(-2), ddc * ddc, 0.0).sum(dim=-1) / _col(acc)
        cost = cost + torch.where(_col(acc) > 0, term, 0.0)
    return cost / _col(3.0 * (active_points - 1).to(torch.float32))


# ---------------------------------------------------------------------------
# full solve
# ---------------------------------------------------------------------------


def _sweeps(spec, obs_xy, obs_vel, time_step, seg_x, seg_y, active_points):
    """The tick's two sweeps as a function of the rollout points, returning
    (d2_obs, d2_seg). The kernel follows the JAX package's dispatch
    (``kompass_core_tpu/ops/solver.py:687-727``, and the truncate-mode
    re-sweep at ``:806-818``):

    - ``"xla"``: K1, the direct form (p - o)^2; with moving obstacles
      (``obs_vel`` given) K3, its moving form;
    - ``"pallas"``: K2, the expanded form; with moving obstacles K7, the
      7-feature dot of ``_fused_kernel_mxu_moving``;
    - ``"pallas_vpu"``: K6, the broadcast form; with moving obstacles K8,
      the 7-feature left fold of ``_fused_kernel_vpu_moving``;
    - ``"pallas_v1"``: K4, the expanded form as two single sweeps, the
      obstacle rows and then the segment rows; with moving obstacles K7
      (the JAX package routes it to the fused moving kernel).
    """
    obs_xy, seg_x, seg_y = (t.contiguous() for t in (obs_xy, seg_x, seg_y))
    active_points = active_points.contiguous()
    if obs_vel is not None:
        obs_vel, time_step = obs_vel.contiguous(), time_step.contiguous()
        kernel = {"xla": fused_min_dist_sq_moving,
                  "pallas_vpu": fused_min_dist_sq_moving_broadcast}.get(
            spec.backend, fused_min_dist_sq_moving_expanded)
        return lambda px, py: kernel(
            px, py, obs_xy, obs_vel, time_step, seg_x, seg_y, active_points
        )
    if spec.backend == "pallas_v1":
        seg_xy = torch.stack([seg_x, seg_y], dim=-1)
        return lambda px, py: (
            min_dist_sq_expanded(px, py, obs_xy, active_points),
            min_dist_sq_expanded(px, py, seg_xy, active_points),
        )
    kernel = {"pallas": fused_min_dist_sq_expanded,
              "pallas_vpu": fused_min_dist_sq_broadcast}.get(
        spec.backend, fused_min_dist_sq)
    return lambda px, py: kernel(px, py, obs_xy, seg_x, seg_y, active_points)


def _weighted_costs(params, px, py, vel_traj, d2_obs, d2_seg, obs_count,
                    seg_x, seg_y, seg_arc, seg_count, seg_total_len,
                    ref_total_len, active_points, velocity_costs,
                    custom_costs):
    """[..., S] weighted sum of the costs, in the JAX package's order:
    goal, path, obstacles (skipped when ``d2_obs`` is None), smoothness
    and jerk (when ``velocity_costs``), then each custom cost
    ``(weight, fn)`` as ``weight * fn(vel_traj, px, py, active_points)``."""
    acc_limits = (params.acc_limit_vx, params.acc_limit_vy, params.acc_limit_omega)
    total = px.new_zeros(px.shape[:-1])

    has_path = ref_total_len > 0.0
    last_i = _col(torch.clamp(seg_count - 1, min=0).long())
    seg_last_xy = (seg_x.gather(-1, last_i)[..., 0], seg_y.gather(-1, last_i)[..., 0])

    goal = _goal_cost(px, py, seg_x, seg_y, seg_arc, ref_total_len, active_points)
    total = total + torch.where(
        _col(has_path & (params.weight_goal > 0)), _col(params.weight_goal) * goal, 0.0
    )
    pathc = _path_cost(px, py, d2_seg, seg_last_xy, seg_total_len, active_points)
    total = total + torch.where(
        _col(has_path & (params.weight_path > 0)), _col(params.weight_path) * pathc, 0.0
    )
    if d2_obs is not None:
        obst = _obstacles_cost(d2_obs, params.max_obstacles_dist)
        total = total + torch.where(
            _col((obs_count > 0) & (params.weight_obstacles > 0)),
            _col(params.weight_obstacles) * obst,
            0.0,
        )
    if velocity_costs:
        smooth = _smoothness_cost(vel_traj, active_points, acc_limits)
        total = total + torch.where(
            _col(params.weight_smoothness > 0),
            _col(params.weight_smoothness) * smooth, 0.0,
        )
        jerk = _jerk_cost(vel_traj, active_points, acc_limits)
        total = total + torch.where(
            _col(params.weight_jerk > 0), _col(params.weight_jerk) * jerk, 0.0
        )
    for weight, fn in custom_costs:
        total = total + float(weight) * fn(vel_traj, px, py, active_points)
    return total


def _winner(costs, vel_traj, px, py):
    """(best index, its cost, velocities [..., T-1, 3], path [..., T, 2]):
    the first minimum, like the reference's ``<`` scan."""
    T = px.shape[-1]
    best = torch.argmin(costs, dim=-1)
    row = best.unsqueeze(-1)
    win_vel = vel_traj.gather(-3, _col(row, 2).expand(row.shape + (T - 1, 3)))
    win_x = px.gather(-2, _col(row).expand(row.shape + (T,)))
    win_y = py.gather(-2, _col(row).expand(row.shape + (T,)))
    return (best, costs.gather(-1, row)[..., 0], win_vel[..., 0, :, :],
            torch.stack([win_x[..., 0, :], win_y[..., 0, :]], dim=-1))


def dwa_solve(
    spec: SolverSpec,
    params: SolverParams,
    state,  # [..., 3] x, y, yaw (world)
    window,  # VelocityWindow of [..., n] tensors (padded)
    obs_xy,  # [..., R, 2] obstacle points, world frame, padded with 1e8
    obs_count,  # [...] int32: number of real obstacle points
    seg_x,  # [..., SEG] tracked segment x, padded with 1e8
    seg_y,  # [..., SEG]
    seg_arc,  # [..., SEG] absolute prefix arc length on the full path
    seg_count,  # [...] int32
    seg_total_len,  # [...] f32 (View.totalSegmentLength)
    ref_total_len,  # [...] f32 (full interpolated path length)
    active_points,  # [...] int32 <= spec.max_points (adaptive horizon)
    obs_vel=None,  # [..., R, 2] world obstacle velocities (moving mode)
    *,
    custom_costs: Sequence = (),
    collision_box_dyn=None,  # [..., 2] box half-extents (spec.dynamic_box)
    mover4=None,  # [..., M, 4] (x, y, vx, vy): the split mover sweep
    return_all_paths: bool = False,
):
    """One DWA tick per robot on the device of ``state``: the
    first-minimum trajectory over the dynamic window. Every tensor
    argument lies on that device and carries the same leading robot
    dimensions (none for one robot).

    ``custom_costs``: ``(weight, fn)`` pairs, ``fn(vel_traj [..., S, T-1,
    3], px [..., S, T], py [..., S, T], active_points [...]) -> [..., S]``
    (reference ``DWA::addCustomCost``). BOX robots (``spec.collision_box``,
    or ``spec.dynamic_box`` with ``collision_box_dyn``) decide
    admissibility on the body's surface distance; the obstacle cost keeps
    the point distance. ``return_all_paths``: return ``(result, (px,
    py))``, the paths the costs were computed on (truncated in truncate
    mode).

    ``mover4``: the split mover sweep (the fleet's ``split_mover_sweep``),
    a narrow set of moving rows (pads at 1e8 with zero velocity) swept in
    K3's direct moving form (K3s) whatever the backend, as the JAX package
    sweeps them, and min-combined with the main obstacle field: in drop
    mode at once; in truncate mode after the static freeze-patch, from the
    truncated positions (time still advances past a frozen pose). BOX
    robots meet the movers in the box field too."""
    T = spec.max_points
    vels, valid = _build_velocity_grid(spec, window)
    px, py = _rollout(spec, params, state, vels)

    # both O(S * T * rows) sweeps; the obstacle field serves collision and
    # the obstacle cost, the segment field the path cost
    moving = spec.moving_obstacles and obs_vel is not None
    sweep = _sweeps(spec, obs_xy, obs_vel if moving else None,
                    params.time_step, seg_x, seg_y, active_points)
    d2_obs, d2_seg = sweep(px, py)

    # the split movers: K3s, whatever the backend. Drop mode folds them in
    # at once; truncate mode keeps them apart until the freeze-patch below
    # has touched the static part alone
    d2_mov = mover_sweep = None
    if mover4 is not None:
        m_xy = mover4[..., 0:2].contiguous()
        m_vel = mover4[..., 2:4].contiguous()
        step = params.time_step.contiguous()
        ap = active_points.contiguous()

        def mover_sweep(px, py):
            return min_dist_sq_moving(px, py, m_xy, m_vel, step, ap)

        d2_mov = mover_sweep(px, py)
        if spec.drop_samples:
            d2_obs = torch.minimum(d2_obs, d2_mov)
            d2_mov = None
    d2_adm = d2_obs if d2_mov is None else torch.minimum(d2_obs, d2_mov)

    if spec.collision_box is not None or (
        spec.dynamic_box and collision_box_dyn is not None
    ):
        half = spec.collision_box
        if half is None:
            half = (collision_box_dyn[..., 0], collision_box_dyn[..., 1])
        d2_col = _min_box_dist_sq(params, state, vels, px, py, obs_xy,
                                  active_points, half,
                                  obs_vel if moving else None)
        if mover4 is not None:
            # the movers meet the box model too (their point field above
            # serves the obstacle cost)
            d2_col = torch.minimum(d2_col, _min_box_dist_sq(
                params, state, vels, px, py, m_xy, active_points, half, m_vel))
        admissible, truncate_ok, i_col, last_free = _admissibility(
            spec, params, d2_col, active_points, valid, surface_distance=True
        )
    else:
        admissible, truncate_ok, i_col, last_free = _admissibility(
            spec, params, d2_adm, active_points, valid
        )
    if spec.drop_samples:
        # drop mode never truncates: constant velocity along every row
        vel_traj = vels.unsqueeze(-2).expand(vels.shape[:-1] + (T - 1, 3))
    else:
        px, py, vel_traj, frozen = _apply_truncation(
            px, py, vels, truncate_ok, i_col, last_free
        )
        if moving:
            # a frozen point keeps its position while time still
            # advances, so the obstacle track keeps moving relative to
            # it: sweep again from the truncated positions, with the same
            # kernel, so the cost sees the field admissibility was
            # decided on
            d2_obs, d2_seg = sweep(px, py)
        else:
            # frozen points sit at path[last_free]: both fields take
            # their value there instead of a second sweep
            lf = last_free.unsqueeze(-1)
            d2_obs = torch.where(frozen, d2_obs.gather(-1, lf), d2_obs)
            d2_seg = torch.where(frozen, d2_seg.gather(-1, lf), d2_seg)
        if d2_mov is not None:
            # split movers: a frozen point keeps its position while the
            # movers advance, so they are swept again from the truncated
            # positions and combined
            d2_obs = torch.minimum(d2_obs, mover_sweep(px, py))

    # in drop mode every row keeps one velocity: smoothness and jerk are
    # exactly zero, so they are not computed
    total = _weighted_costs(
        params, px, py, vel_traj, d2_obs, d2_seg, obs_count, seg_x, seg_y,
        seg_arc, seg_count, seg_total_len, ref_total_len, active_points,
        not spec.drop_samples, custom_costs,
    )
    costs = torch.where(admissible, total, _INF)
    best, cost, velocities, path = _winner(costs, vel_traj, px, py)
    res = SolveResult(
        found=admissible.any(dim=-1),
        cost=cost,
        best_index=best,
        velocities=velocities,
        path=path,
        costs=costs,
        num_admissible=admissible.sum(dim=-1).to(torch.int32),
    )
    if return_all_paths:
        return res, (px, py)
    return res


def evaluate_trajectory_costs(
    params: SolverParams,
    px,  # [S, T] given rollout x ([B, S, T] for B robots)
    py,  # [S, T]
    vel_traj,  # [S, T-1, 3] given velocity profiles
    obs_xy,  # [O, 2] padded obstacle points (1e8 pads)
    obs_count,  # int32
    seg_x,  # [G] tracked segment, padded with 1e8
    seg_y,
    seg_arc,  # [G] absolute prefix arc lengths
    seg_count,
    seg_total_len,
    ref_total_len,
    active_points,
    custom_costs: Sequence = (),
    with_obstacles: bool = True,
) -> SolveResult:
    """Standalone cost evaluation of GIVEN trajectories (the reference's
    ``CostEvaluator::getMinTrajectoryCost``): every cost, smoothness and
    jerk included, and the first-minimum winner. Both sweeps run through
    K1's port, the segment field for the path cost; with
    ``with_obstacles=False`` the obstacle rows are one 1e8 pad row and
    the obstacle field is dropped (the reference skips its kernel without
    obstacle points). ``found`` is S > 0 and ``num_admissible`` is S."""
    S = px.shape[-2]
    lead = px.shape[:-2]
    if not with_obstacles:
        obs_xy = px.new_full(lead + (1, 2), _PAD)
    d2_obs, d2_seg = fused_min_dist_sq(
        px.contiguous(), py.contiguous(), obs_xy.contiguous(),
        seg_x.contiguous(), seg_y.contiguous(), active_points.contiguous(),
    )
    total = _weighted_costs(
        params, px, py, vel_traj, d2_obs if with_obstacles else None, d2_seg,
        obs_count, seg_x, seg_y, seg_arc, seg_count, seg_total_len,
        ref_total_len, active_points, True, custom_costs,
    )
    best, cost, velocities, path = _winner(total, vel_traj, px, py)
    return SolveResult(
        found=torch.full(lead, S > 0, dtype=torch.bool, device=px.device),
        cost=cost,
        best_index=best,
        velocities=velocities,
        path=path,
        costs=total,
        num_admissible=torch.full(lead, S, dtype=torch.int32, device=px.device),
    )


def _as_device(x, device):
    """Arguments for the solvers on ``device``: tensors and numpy arrays
    moved there (float64 to float32, int64 to int32, as the JAX package
    canonicalises them), Python floats as float32 and ints as int32,
    NamedTuples (``SolverParams``, ``VelocityWindow``) field by field."""
    if isinstance(x, tuple):
        parts = [_as_device(v, device) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    if x is None:
        return None
    if isinstance(x, bool):
        return torch.tensor(x, device=device)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int32, device=device)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float32, device=device)
    t = x if isinstance(x, torch.Tensor) else torch.tensor(x)  # a copy of numpy
    narrow = {torch.float64: torch.float32, torch.int64: torch.int32}
    return t.to(device=device, dtype=narrow.get(t.dtype, t.dtype))


@functools.lru_cache(maxsize=16)
def _cost_evaluator(device, with_obstacles):
    def evaluate(*args, **kw):
        # the first 13 are the tensors; a 14th would be custom_costs
        args = _as_device(args[:13], device) + args[13:]
        kw = {k: v if k == "custom_costs" else _as_device(v, device)
              for k, v in kw.items()}
        return evaluate_trajectory_costs(*args, with_obstacles=with_obstacles,
                                         **kw)

    return evaluate


def get_cost_evaluator(device, with_obstacles: bool = True):
    """Process-wide standalone cost evaluator on ``device``: takes
    ``evaluate_trajectory_costs``'s arguments (tensors, numpy arrays or
    Python numbers; moved to ``device``)."""
    return _cost_evaluator(torch.device(device), bool(with_obstacles))


def make_dwa_solver(spec: SolverSpec, device, custom_costs: Sequence = ()):
    """The solver for a fixed ``SolverSpec`` on ``device``: takes
    ``dwa_solve``'s dynamic arguments (tensors, numpy arrays or Python
    numbers; moved to ``device``) and its keywords but ``custom_costs``,
    which are bound here."""
    device = torch.device(device)
    custom_costs = tuple(custom_costs)

    def solve(*args, **kw):
        kw = {k: v if k == "return_all_paths" else _as_device(v, device)
              for k, v in kw.items()}
        return dwa_solve(spec, *_as_device(args, device),
                         custom_costs=custom_costs, **kw)

    return solve


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
        # trailing [vx | vy] obstacle-velocity block (moving mode only)
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
    the spec uses device-window mode. ``obs_vel_xy`` fills the trailing
    velocity block of a ``moving_obstacles`` spec (omitted: zeros, the
    static world)."""
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
    """Parse the packed layout from a float32 tensor [..., size], on its
    device (leading dimensions are robots). Returns (params, state,
    window, obs_xy, obs_count, seg_x, seg_y, seg_arc, seg_count,
    seg_total_len, ref_total_len, active_points, obs_vel), the arguments
    of ``dwa_solve``; obs_vel is None unless the spec is moving."""
    params = SolverParams(*buf[..., 8:20].unbind(-1))
    o = _HDR
    if spec.device_window:
        window = _device_window(
            spec, buf[..., o : o + 3], buf[..., o + 3 : o + 12], params.time_step
        )
        o += _window_block_size(spec)
    else:
        arrays = []
        for n in (spec.n_vx, spec.n_vy, spec.n_omega):
            arrays += [buf[..., o : o + n], buf[..., o + n : o + 2 * n] > 0.5]
            o += 2 * n
        window = VelocityWindow(*arrays)
    r = spec.scan_size
    obs_xy = torch.stack([buf[..., o : o + r], buf[..., o + r : o + 2 * r]], dim=-1)
    o += 2 * r
    g = spec.seg_size
    seg = [buf[..., o + k * g : o + (k + 1) * g] for k in range(3)]
    o += 3 * g
    obs_vel = None
    if spec.moving_obstacles:
        obs_vel = torch.stack(
            [buf[..., o : o + r], buf[..., o + r : o + 2 * r]], dim=-1
        )
    return (
        params,
        buf[..., 0:3],
        window,
        obs_xy,
        buf[..., 3].to(torch.int32),
        *seg,
        buf[..., 4].to(torch.int32),
        buf[..., 5],
        buf[..., 6],
        buf[..., 7].to(torch.int32),
        obs_vel,
    )


def _unpack_and_solve(spec: SolverSpec, buf, custom_costs=()):
    """Unpack on the device, solve and pack the output vector: buf
    [..., size] -> [..., 4 + 3 * (T-1) + 2 * T], the leading dimensions
    robots solved as one batch. Output layout: [found, cost, best_index,
    num_admissible, vx[T-1], vy[T-1], omega[T-1], px[T], py[T]]."""
    lead = buf.shape[:-1]
    rows = buf.reshape(-1, buf.shape[-1])
    res = dwa_solve(spec, *_unpack_inputs(spec, rows), custom_costs=custom_costs)
    head = torch.stack(
        [
            res.found.to(torch.float32),
            res.cost,
            res.best_index.to(torch.float32),
            res.num_admissible.to(torch.float32),
        ],
        dim=-1,
    )
    out = torch.cat(
        [
            head,
            res.velocities.transpose(-1, -2).flatten(-2),
            res.path.transpose(-1, -2).flatten(-2),
        ],
        dim=-1,
    )
    return out.reshape(lead + out.shape[-1:])


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


def _reject_dynamic_box(spec: SolverSpec, what: str) -> None:
    """The packed buffer carries no per-robot half-extents: a dynamic_box
    spec would silently fall back to the circle model with the radius
    counted twice (the JAX package's contract)."""
    if spec.dynamic_box:
        raise ValueError(
            f"dynamic_box specs are not supported by the packed {what}; "
            "use a static spec.collision_box"
        )


def make_packed_dwa_solver(spec: SolverSpec, device, custom_costs: Sequence = ()):
    """Single-buffer solver on ``device``: f32[packed_input_size] (numpy
    or tensor) -> f32[4 + 3*(T-1) + 2*T] tensor on ``device``. The input
    goes to the device in one copy; nothing in the solve waits for the
    device, so the caller's read of the output is the tick's one sync.
    ``custom_costs`` as for ``dwa_solve``."""
    _reject_dynamic_box(spec, "single-buffer interface")
    device = torch.device(device)
    custom_costs = tuple(custom_costs)

    def solve(buf):
        return _unpack_and_solve(spec, _packed_input(spec, buf, device), custom_costs)

    return solve


def _packed_input(spec: SolverSpec, buf, device):
    """One packed buffer (numpy or tensor) as a float32 [size] tensor on
    ``device``, in one copy; raises on another shape."""
    buf = torch.as_tensor(buf, dtype=torch.float32, device=device)
    size = packed_input_size(spec)
    if buf.shape != (size,):
        raise ValueError(f"packed input must be [{size}], got {list(buf.shape)}")
    return buf


@functools.lru_cache(maxsize=64)
def _packed_solver(spec, device):
    return make_packed_dwa_solver(spec, device)


def get_packed_dwa_solver(spec: SolverSpec, device):
    """Process-wide shared packed solver (no custom costs) for ``spec`` on
    ``device``: controllers with identical specs reuse one."""
    return _packed_solver(spec, torch.device(device))


def dwa_sample_debug(spec: SolverSpec, buf, custom_costs: Sequence = ()):
    """Every rollout with its cost and admissibility, from one packed
    buffer tensor [size] on its device (the reference's
    ``DWA::debugVelocitySearch`` + ``getDebuggingSamples``). Returns (px
    [S, T], py [S, T], costs [S], admissible [S]); in truncate mode the
    paths are the truncated ones the costs were computed on.
    ``custom_costs`` must be the production solver's, so the debug ranking
    agrees with the executed command."""
    _reject_dynamic_box(spec, "debug interface")
    res, (px, py) = dwa_solve(
        spec, *_unpack_inputs(spec, buf.unsqueeze(0)),
        custom_costs=custom_costs, return_all_paths=True,
    )
    return px[0], py[0], res.costs[0], torch.isfinite(res.costs[0])


@functools.lru_cache(maxsize=16)
def _debug_solver(spec, device, custom_costs):
    _reject_dynamic_box(spec, "debug interface")

    def debug(buf):
        return dwa_sample_debug(spec, _packed_input(spec, buf, device), custom_costs)

    return debug


def get_debug_dwa_solver(spec: SolverSpec, device, custom_costs: Sequence = ()):
    """Cached debug sampler for ``spec`` on ``device``: f32[size] (numpy
    or tensor) -> ``dwa_sample_debug``'s four tensors on ``device``."""
    return _debug_solver(spec, torch.device(device), tuple(custom_costs))


def check_states_feasibility(states_xy, obs_xy, radius, margin, *, device):
    """True if any of the given positions collides with the obstacle
    points (the reference's boolean convention: True = collision)."""
    states_xy = torch.as_tensor(states_xy, dtype=torch.float32, device=device)
    obs_xy = torch.as_tensor(obs_xy, dtype=torch.float32, device=device)
    dx = states_xy[:, 0:1] - obs_xy[None, :, 0]
    dy = states_xy[:, 1:2] - obs_xy[None, :, 1]
    r = radius + margin
    return bool(torch.any(torch.amin(dx * dx + dy * dy, dim=-1) < r * r))
