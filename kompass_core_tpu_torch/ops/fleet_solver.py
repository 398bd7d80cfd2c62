"""On-device fleet control: follower + solver for N robots per tick.

Counterpart of ``kompass_core_tpu/ops/fleet_solver.py``. The whole
per-tick pipeline runs on the device as one batched pass over the robot
axis:

    goal / losing-goal detection  (follower.cpp:109-142)
    sticky target determination   (follower.cpp:266-304, binary descent
                                   per follower.cpp:155-183, last-min tie)
    curvature-adaptive horizon    (dwa.cpp:157-206)
    scan -> world obstacle points, tracked movers in the tail slots
    tracked-segment windowing     (dwa.cpp:208-233)
    dynamic window + rollout + costs + argmin   (ops/solver.dwa_solve)
    rotate-in-place shortcut      (corrected sign, see PARITY.md #7)

with a small per-robot carry (closest index, segment index, goal
distance, reached flag). The JAX package ``vmap``s a one-robot step and
maps it over 64-row blocks, a TPU batch-layout rule; here every tensor
simply carries the robot axis first, and the fused sweep launches once
for the whole fleet with the robot as its grid's second dimension.

No host sync inside the tick: the data-dependent follower descent is a
statically unrolled loop of masked updates, every index is a device
tensor read through ``torch.gather``, and nothing calls ``.item()``.

Not ported yet (ROADMAP items 5b-5g; ``DeviceFleet`` raises
``NotImplementedError`` naming each): the k-tick loop, peers, the fused
safety gate, the split mover sweep, BOX fleets and the mesh.
"""

import dataclasses
import math
from typing import NamedTuple

import torch

from .solver import (
    SolverParams,
    SolverSpec,
    _device_window,
    _div,
    dwa_solve,
    spec_from_jax,
)

_PAD = 1e8


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to kompass_core_tpu_torch yet "
        f"(ROADMAP queue 1, item {item})"
    )


@dataclasses.dataclass(frozen=True, eq=True)
class FleetSpec:
    solver: SolverSpec
    path_capacity: int  # P: padded interpolated path points per robot
    max_segments: int  # NS: padded segment count per robot
    # M tracked moving objects per robot: the tick input matrix gains a
    # trailing [M, 4] (x, y, vx, vy) world-frame block per robot, and each
    # object enters the fused sweep at its constant-velocity predicted
    # position (pairs with SolverSpec.moving_obstacles)
    tracked_obstacles: int = 0
    split_mover_sweep: bool = False  # not ported (item 5e)


def fleet_spec_from_jax(jax_fleet_spec) -> FleetSpec:
    """The port's ``FleetSpec`` for a ``kompass_core_tpu`` one."""
    return FleetSpec(
        solver=spec_from_jax(jax_fleet_spec.solver),
        path_capacity=int(jax_fleet_spec.path_capacity),
        max_segments=int(jax_fleet_spec.max_segments),
        tracked_obstacles=int(jax_fleet_spec.tracked_obstacles),
        split_mover_sweep=bool(jax_fleet_spec.split_mover_sweep),
    )


class FleetPaths(NamedTuple):
    """Device-resident per-robot path data (uploaded once per set_paths)."""

    x: torch.Tensor  # [N, P] f32, padded with 1e8
    y: torch.Tensor  # [N, P]
    arc: torch.Tensor  # [N, P] prefix arc length
    curvature: torch.Tensor  # [N, P]
    n_points: torch.Tensor  # [N] i32
    seg_starts: torch.Tensor  # [N, NS] i32 (padded with n_points)
    n_segs: torch.Tensor  # [N] i32
    total_len: torch.Tensor  # [N] f32


class FleetCarry(NamedTuple):
    """Follower state carried across ticks (reference Follower members)."""

    closest_idx: torch.Tensor  # [N] i32
    seg_idx: torch.Tensor  # [N] i32
    pos_in_seg: torch.Tensor  # [N] f32 (reference segment_length, [0, 1])
    goal_dist: torch.Tensor  # [N] f32
    reached: torch.Tensor  # [N] bool


class FleetConfig(NamedTuple):
    """Per-robot dynamic configuration arrays."""

    params12: torch.Tensor  # [N, 12] SolverParams block (packed layout)
    limits9: torch.Tensor  # [N, 9] control limits
    sensor_pose: torch.Tensor  # [N, 3] sensor (x, y, yaw) in body
    rotate_in_place: torch.Tensor  # [N] bool
    goal_dist_tol: torch.Tensor  # [N]
    goal_ori_tol: torch.Tensor  # [N]
    losing_goal_dist: torch.Tensor  # [N]
    interp_dist: torch.Tensor  # [N]
    base_horizon_s: torch.Tensor  # [N] seconds
    curvature_tol: torch.Tensor  # [N]
    vx_max: torch.Tensor  # [N]
    max_segment_size: torch.Tensor  # [N] i32 (lookahead floor, points)


# ---------------------------------------------------------------------------
# device follower, batched over the robot axis
# ---------------------------------------------------------------------------


def _pick(rows, idx):
    """rows[n, idx[n]] for every robot n: rows [N, L], idx [N] -> [N]. The
    index is clamped into the row, as ``lax.dynamic_index_in_dim`` does."""
    idx = idx.long().clamp(0, rows.shape[-1] - 1)
    return rows.gather(-1, idx.unsqueeze(-1))[..., 0]


def _seg_end_index(paths: FleetPaths, seg_idx):
    """End index of a segment (reference path.cpp:383-398)."""
    ns = paths.n_segs
    nxt = _pick(paths.seg_starts, torch.minimum(seg_idx + 1, ns - 1))
    return torch.where(seg_idx + 1 < ns, nxt - 1, paths.n_points - 1)


def _binary_descent(paths: FleetPaths, px, py):
    """Closest-segment binary descent (follower.cpp:155-183) as a
    statically unrolled bounded loop of masked updates: the descent
    halves [left, right] each step, so ``ceil(log2(max_segments)) + 2``
    iterations settle every robot, and the ``done`` mask makes the extra
    ones no-ops. No data-dependent loop, so no host sync. The squared
    distance to every segment start is computed once, [N, NS], so each
    step only picks two of them."""
    starts = paths.seg_starts.long().clamp(0, paths.x.shape[-1] - 1)
    dx = px.unsqueeze(-1) - paths.x.gather(-1, starts)
    dy = py.unsqueeze(-1) - paths.y.gather(-1, starts)
    start_d2 = dx * dx + dy * dy

    def d2_of(seg):
        return _pick(start_d2, seg)

    left = torch.zeros_like(paths.n_segs)
    right = torch.clamp(paths.n_segs - 1, min=0)
    result = torch.zeros_like(left)
    done = right == left
    max_segments = paths.seg_starts.shape[-1]
    for _ in range(max(1, max_segments - 1).bit_length() + 2):
        mid = (left + right) // 2
        closer_left = d2_of(left) <= d2_of(right)
        at_edge = (mid == right) | (mid == left)
        chosen = torch.where(closer_left, left, right)
        result = torch.where(~done & at_edge, chosen, result)
        result = torch.where(~done & (left == right), left, result)
        done = done | at_edge | (left == right)
        new_right = torch.where(closer_left, mid, right)
        new_left = torch.where(closer_left, left, mid)
        left = torch.where(done, left, new_left)
        right = torch.where(done, right, new_right)
    return result


def _closest_on_segment(paths: FleetPaths, seg_idx, px, py):
    """Last-min closest point inside a segment (follower.cpp:199-264)."""
    start_i = _pick(paths.seg_starts, seg_idx)
    end_i = _seg_end_index(paths, seg_idx)
    j = torch.arange(paths.x.shape[-1], device=px.device)
    in_seg = (j >= start_i.unsqueeze(-1)) & (j <= end_i.unsqueeze(-1))
    dx = px.unsqueeze(-1) - paths.x
    dy = py.unsqueeze(-1) - paths.y
    d2 = torch.where(in_seg, dx * dx + dy * dy, math.inf)
    m = torch.amin(d2, dim=-1)
    # last index achieving the minimum (reference `<=` tie rule)
    cidx = torch.amax(
        torch.where(d2 <= m.unsqueeze(-1), j, -1), dim=-1
    ).to(torch.int32)
    seg_size = end_i - start_i + 1
    pos = torch.where(
        seg_size > 1,
        (cidx - start_i).to(torch.float32) / torch.clamp(seg_size - 1, min=1),
        1.0,
    )
    return cidx, pos, m, start_i, end_i


def _device_determine_target(paths: FleetPaths, closest_idx, seg_idx,
                             pos_in_seg, px, py):
    """Sticky target determination (follower.cpp:266-304)."""
    seg_end = _seg_end_index(paths, seg_idx)
    research = (
        (pos_in_seg <= 0.0) | (closest_idx >= seg_end) | (pos_in_seg >= 0.9)
    )
    new_seg = torch.where(
        research, _binary_descent(paths, px, py), seg_idx
    ).to(torch.int32)
    cidx, pos, min_d2, start_i, end_i = _closest_on_segment(
        paths, new_seg, px, py
    )
    # segment heading from segment start/end points
    sx, sy = _pick(paths.x, start_i), _pick(paths.y, start_i)
    ex, ey = _pick(paths.x, end_i), _pick(paths.y, end_i)
    heading = torch.atan2(ey - sy, ex - sx)
    return cidx, new_seg, pos, heading, torch.sqrt(min_d2)


def _scan_to_world_obs(spec: SolverSpec, ranges, angles, sensor_pose, x, y, yaw):
    """Egocentric scans [N, R] -> padded [N, scan_size, 2] world-frame
    obstacle points (collision_check.h:98-117 chain: sensor -> body ->
    world). Non-finite ranges go to the 1e8 pad."""
    r = torch.where(torch.isfinite(ranges), ranges, _PAD)
    pxs = r * torch.cos(angles)
    pys = r * torch.sin(angles)
    cs = torch.cos(sensor_pose[:, 2:3])
    ss = torch.sin(sensor_pose[:, 2:3])
    bx = cs * pxs - ss * pys + sensor_pose[:, 0:1]
    by = ss * pxs + cs * pys + sensor_pose[:, 1:2]
    cy = torch.cos(yaw).unsqueeze(-1)
    sy = torch.sin(yaw).unsqueeze(-1)
    obs = torch.stack(
        [cy * bx - sy * by + x.unsqueeze(-1), sy * bx + cy * by + y.unsqueeze(-1)],
        dim=-1,
    )
    N, R = ranges.shape
    if R > spec.scan_size:
        # silently dropping beams would blind the robot to obstacles only
        # those beams see
        raise ValueError(
            f"{R} scan rays > spec.scan_size {spec.scan_size} — size the "
            "scan bucket to hold every beam (DeviceFleet does this; "
            "direct composers must too)"
        )
    if R < spec.scan_size:
        obs = torch.cat([obs, obs.new_full((N, spec.scan_size - R, 2), _PAD)], 1)
    return obs, R


def _fleet_step(
    spec: SolverSpec,
    paths: FleetPaths,
    cfg: FleetConfig,
    carry: FleetCarry,
    states,  # [N, 4] x, y, yaw, speed
    vels,  # [N, 3]
    ranges,  # [N, R]
    angles,  # [N, R]
    seg_capacity: int,
    tracked=None,  # [N, M, 4] (x, y, vx, vy) tracked moving objects, world
):
    """Every robot's full control tick on the device: (carry', out [N, 10])
    with the columns of ``OUT_FIELDS``."""
    (params12, limits9, sensor_pose, rot_in_place, goal_tol, ori_tol,
     losing_tol, interp_dist, base_h, curv_tol, vx_max, max_seg_size) = cfg
    x, y, yaw = states[:, 0], states[:, 1], states[:, 2]
    L = paths.x.shape[-1]

    # --- goal / losing-goal (follower.cpp:109-142) ---
    goal_i = paths.n_points - 1
    gx, gy = _pick(paths.x, goal_i), _pick(paths.y, goal_i)
    d_goal = torch.sqrt((x - gx) * (x - gx) + (y - gy) * (y - gy))
    at_end = (carry.seg_idx + 1) >= (paths.n_segs - 1)
    improving = d_goal < carry.goal_dist
    new_goal_dist = torch.where(at_end & improving, d_goal, carry.goal_dist)
    losing = at_end & ~improving & (
        torch.abs(d_goal - carry.goal_dist) > losing_tol
    )
    now_reached = carry.reached | (d_goal <= goal_tol) | losing

    # --- target determination ---
    cidx, new_seg, pos, seg_heading, _nd = _device_determine_target(
        paths, carry.closest_idx, carry.seg_idx, carry.pos_in_seg, x, y
    )
    heading_error = torch.remainder(
        seg_heading - yaw + math.pi, 2 * math.pi
    ) - math.pi

    # --- adaptive horizon (dwa.cpp:157-206) ---
    dt = params12[:, 0]
    peek = torch.ceil(base_h * vx_max / interp_dist).to(torch.int32)
    j = torch.arange(L, device=states.device)
    start = torch.minimum(cidx, paths.n_points - 1)
    peek_end = torch.minimum(start + peek, paths.n_points - 1)
    in_peek = (j >= start.unsqueeze(-1)) & (j <= peek_end.unsqueeze(-1))
    kappa_max = torch.amax(
        torch.where(in_peek, torch.abs(paths.curvature), 0.0), dim=-1
    )
    cap = torch.sqrt(
        8.0 * curv_tol / torch.clamp(kappa_max, min=1e-9)
    ) / torch.clamp(vx_max, min=1e-3)
    adaptive = torch.where(
        kappa_max > curv_tol, torch.minimum(base_h, cap), base_h
    )
    horizon = torch.minimum(torch.maximum(adaptive, 2.0 * dt), base_h)
    active_points = torch.clamp(
        (horizon / dt).to(torch.int32), 2, spec.max_points
    )
    max_forward = adaptive * vx_max

    # --- obstacles: scan -> world, tracked movers in the tail slots ---
    obs, R = _scan_to_world_obs(
        spec, ranges, angles, sensor_pose, x, y, yaw
    )
    obs_count = torch.full_like(goal_i, min(R, spec.scan_size))
    scan_len = obs.shape[1]
    obs_vel = None
    if tracked is not None:
        # positions ride the scan bucket's guaranteed-pad TAIL slots (the
        # fleet sizes scan_size >= rays + M); velocities ride a per-row
        # block that is zero for every scan row. Pad slots sit at
        # x >= 1e7 with zero velocity and are not counted
        m_rows = tracked.shape[1]
        if R + m_rows > scan_len:
            raise ValueError(
                f"scan bucket {scan_len} cannot hold {R} rays + "
                f"{m_rows} tracked slots — size scan_size >= rays + M"
            )
        obs = torch.cat([obs[:, : scan_len - m_rows], tracked[:, :, 0:2]], 1)
        obs_count = obs_count + (tracked[:, :, 0] < 1e7).sum(-1).to(torch.int32)
        if spec.moving_obstacles:
            obs_vel = torch.cat(
                [obs.new_zeros(obs.shape[0], scan_len - m_rows, 2),
                 tracked[:, :, 2:4]], 1,
            )

    # --- tracked segment window (dwa.cpp:208-233) ---
    # path rows are seg_capacity wider than the path capacity (host pads),
    # so the window at `start` is always in bounds
    lookahead = torch.maximum(
        max_seg_size, torch.ceil(max_forward / interp_dist).to(torch.int32) + 1
    )
    end = torch.minimum(start + lookahead, paths.n_points - 1)
    seg_count = torch.clamp(end - start + 1, max=seg_capacity)
    k = torch.arange(seg_capacity, device=states.device)
    idx = start.long().clamp(0, L - seg_capacity).unsqueeze(-1) + k
    seg_x_raw = paths.x.gather(-1, idx)
    seg_y_raw = paths.y.gather(-1, idx)
    seg_arc = paths.arc.gather(-1, idx)
    in_window = k < seg_count.unsqueeze(-1)
    seg_x = torch.where(in_window, seg_x_raw, _PAD)
    seg_y = torch.where(in_window, seg_y_raw, _PAD)
    cdx = seg_x_raw[:, 1:] - seg_x_raw[:, :-1]
    cdy = seg_y_raw[:, 1:] - seg_y_raw[:, :-1]
    chords = torch.sqrt(cdx * cdx + cdy * cdy)
    seg_total_len = torch.where(in_window[:, 1:], chords, 0.0).sum(-1)

    # --- solve, all robots in one batch ---
    params = SolverParams(*params12.unbind(-1))
    window = _device_window(spec, vels, limits9, params.time_step)
    res = dwa_solve(
        spec, params, states[:, 0:3], window, obs, obs_count, seg_x, seg_y,
        seg_arc, seg_count, seg_total_len, paths.total_len, active_points,
        obs_vel=obs_vel,
    )

    # --- rotate-in-place / reached overrides ---
    rotate = rot_in_place & (torch.abs(heading_error) > ori_tol * 10.0)
    rot_omega = _div(heading_error * limits9[:, 6], math.pi)
    first = res.velocities[:, 0]
    cmd_vx = torch.where(rotate, 0.0, first[:, 0])
    cmd_vy = torch.where(rotate, 0.0, first[:, 1])
    cmd_w = torch.where(rotate, rot_omega, first[:, 2])
    # a not-found tick emits a ZERO command, not the inadmissible argmin
    # sample (all costs +inf -> argmin 0 = max reverse, max spin)
    go = (rotate | res.found) & ~now_reached
    cmd_vx = torch.where(go, cmd_vx, 0.0)
    cmd_vy = torch.where(go, cmd_vy, 0.0)
    cmd_w = torch.where(go, cmd_w, 0.0)

    new_carry = FleetCarry(cidx, new_seg, pos, new_goal_dist, now_reached)
    out = torch.stack(
        [
            go.to(torch.float32),
            now_reached.to(torch.float32),
            cmd_vx,
            cmd_vy,
            cmd_w,
            # host parity: a rotate-in-place result reports cost 0.0
            torch.where(rotate, 0.0, res.cost),
            heading_error,
            active_points.to(torch.float32),
            res.num_admissible.to(torch.float32),
            # 1.0: no safety gate (shape-stable output)
            torch.ones_like(cmd_vx),
        ],
        dim=-1,
    )
    return new_carry, out


OUT_FIELDS = (
    "found",
    "reached",
    "vx",
    "vy",
    "omega",
    "cost",
    "heading_error",
    "active_points",
    "num_admissible",
    "safety_factor",
)


def _check_tracked_spec(fleet_spec: FleetSpec) -> None:
    """Tracked-mover slots without the moving sweep would silently DROP
    the supplied velocities (movers frozen at their current positions)."""
    if (
        fleet_spec.tracked_obstacles
        and not fleet_spec.solver.moving_obstacles
        and not fleet_spec.split_mover_sweep
    ):
        raise ValueError(
            "FleetSpec.tracked_obstacles > 0 requires "
            "solver.moving_obstacles=True (tail-slot form) or "
            "split_mover_sweep=True — without either moving sweep "
            "the tracked velocities would be silently ignored"
        )


def _split_tick_inputs(fleet_spec: FleetSpec, inputs):
    """The packed tick input ``[N, 7 + R (+ 4M)]`` -> (states [N, 4],
    vels [N, 3], ranges [N, R], tracked [N, M, 4] or None)."""
    width = inputs.shape[1]
    M = fleet_spec.tracked_obstacles
    states = inputs[:, 0:4]
    vels = inputs[:, 4:7]
    if not M:
        return states, vels, inputs[:, 7:], None
    ranges = inputs[:, 7 : width - 4 * M]
    tracked = inputs[:, width - 4 * M :].reshape(inputs.shape[0], M, 4)
    return states, vels, ranges, tracked


def make_fleet_tick(fleet_spec: FleetSpec, device):
    """The fleet tick on ``device``:
    (paths, cfg, carry, angles [N, R], inputs [N, 7 + R (+ 4M)]) ->
    (carry', outputs [N, len(OUT_FIELDS)]), every tensor on ``device``.

    ``inputs`` is state | vel | ranges (| tracked): one host-to-device
    copy per tick when given as a host array, none when it already lies
    on the device. Nothing in the tick waits for the device, so the
    caller's read of the outputs is the tick's one sync. The JAX
    function's mesh, peer and safety arguments are not ported (ROADMAP
    items 5g, 5c, 5d)."""
    if fleet_spec.split_mover_sweep:
        _not_ported("split_mover_sweep", "5e")
    if fleet_spec.solver.dynamic_box or fleet_spec.solver.collision_box:
        _not_ported("BOX fleets (dynamic_box)", "5f")
    _check_tracked_spec(fleet_spec)
    spec = fleet_spec.solver
    device = torch.device(device)

    def tick(paths: FleetPaths, cfg: FleetConfig, carry: FleetCarry, angles,
             inputs):
        inputs = torch.as_tensor(inputs, dtype=torch.float32, device=device)
        states, vels, ranges, tracked = _split_tick_inputs(fleet_spec, inputs)
        return _fleet_step(
            spec, paths, cfg, carry, states, vels, ranges, angles,
            spec.seg_size, tracked,
        )

    return tick
