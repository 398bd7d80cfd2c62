"""On-device fleet control: follower + solver for N robots per tick.

Counterpart of ``kompass_core_tpu/ops/fleet_solver.py``. The whole
per-tick pipeline runs on the device as one batched pass over the robot
axis:

    goal / losing-goal detection  (follower.cpp:109-142)
    sticky target determination   (follower.cpp:266-304, binary descent
                                   per follower.cpp:155-183, last-min tie)
    curvature-adaptive horizon    (dwa.cpp:157-206)
    scan -> world obstacle points, tracked movers in the tail slots
                                  (or, split, in their own sweep)
    tracked-segment windowing     (dwa.cpp:208-233)
    dynamic window + rollout + costs + argmin   (ops/solver.dwa_solve)
    rotate-in-place shortcut      (corrected sign, see PARITY.md #7)
    peer avoidance                (every other robot as an obstacle disc)
    critical-zone safety gate     (critical_zone_check.cpp:87-119)

with a small per-robot carry (closest index, segment index, goal
distance, reached flag). The JAX package ``vmap``s a one-robot step and
maps it over 64-row blocks, a TPU batch-layout rule; here every tensor
simply carries the robot axis first, and the fused sweep launches once
for the whole fleet with the robot as its grid's second dimension.

No host sync inside the tick: the data-dependent follower descent is a
statically unrolled loop of masked updates, every index is a device
tensor read through ``torch.gather``, and nothing calls ``.item()`` or
builds a tensor from host data. So a tick, and the k-tick loop
(``make_fleet_ticks_on_device``), can be captured as a CUDA graph
(``parallel/fleet_v2.py``).

Peers ride the robot's sweep as extra obstacle rows after the scan
bucket (``_peer_model``); the safety gate is plain tensor code after the
solve (``FleetSafety``). With ``FleetSpec.split_mover_sweep`` the tracked
movers skip the scan bucket and run as the solver's narrow ``mover4``
sweep (K3s). A fleet with any BOX robot runs ``SolverSpec.dynamic_box``:
every robot's admissibility on its oriented box (K9), a circle robot as
a (0, 0) box with its radius in its margin (``FleetConfig.collision_box2``).

Over a ``FleetMesh`` (``parallel/multihost.py``) the tick and the k-tick
loop run this body per shard, on the shard's rows and device. Every
argument is then a list with one value per local shard
(``FleetMesh.split`` and ``place`` cut them from the fleet's rows). With
peers each tick gathers the fleet's [N, 7] state and velocity block with
exactly one ``FleetMesh.all_gather_rows``; every shard builds the whole
fleet's peer discs from it and masks its own robots' blocks by their
global row ids. Without peers the shards never communicate.
"""

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import tracing
from .kernels import _sqrt
from .solver import (
    SolverParams,
    SolverSpec,
    _device_window,
    _div,
    dwa_solve,
    spec_from_jax,
)

_PAD = 1e8


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
    # route the tracked movers through the solver's separate narrow
    # moving sweep (mover4, K3s), min-combined with the scan's field,
    # instead of the scan bucket's tail slots: the same commands bit for
    # bit (a min over the same rows), and the scan bucket stays at rays
    split_mover_sweep: bool = False


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
    # per-robot box half extents (spec.dynamic_box fleets): (0, 0) for
    # circle robots, whose radius is folded into params12[2] (the
    # collision margin); (l/2, w/2) for BOX robots
    collision_box2: torch.Tensor = None  # [N, 2] f32


class FleetSafety(NamedTuple):
    """Per-robot critical-zone data of the safety-gated fleet tick.

    The reference stack runs its ``CriticalZoneChecker`` as a separate
    per-tick call beside the controller; here the masked-min factor gates
    every command inside the tick, including every tick of the k-tick
    loop, which would otherwise run its k commands with no safety check.
    The beam trig and cone masks come from the same ``CriticalZoneSpec``
    the standalone checker uses; ``half_cone`` drives the world-point
    cone test of the k-tick loop, where the robot has moved off the
    tick-0 scan pose."""

    cos_a: torch.Tensor  # [N, R] f32, sensor-frame beam trig (host f64 cos)
    sin_a: torch.Tensor  # [N, R]
    fwd_mask: torch.Tensor  # [N, R] bool, forward critical cone
    bwd_mask: torch.Tensor  # [N, R] bool
    sensor_c: torch.Tensor  # [N] f32, cos / sin of the sensor yaw (host f64)
    sensor_s: torch.Tensor  # [N]
    radius: torch.Tensor  # [N] f32, robot surface radius
    crit: torch.Tensor  # [N] f32, critical (stop) distance
    slow: torch.Tensor  # [N] f32, slowdown distance
    half_cone: torch.Tensor  # [N] f32, wrapped half-cone angle (rad)


def build_fleet_safety(zone_specs, n_rows: int, scan_rays: int,
                       device) -> FleetSafety:
    """Stack per-robot ``CriticalZoneSpec``s into padded fleet tensors on
    ``device``. Rows past ``len(zone_specs)`` (fleet pads) get all-False
    masks: their factor is identically 1.0."""
    R = scan_rays
    cos_a = np.zeros((n_rows, R), np.float32)
    sin_a = np.zeros((n_rows, R), np.float32)
    fwd = np.zeros((n_rows, R), bool)
    bwd = np.zeros((n_rows, R), bool)
    sc = np.ones(n_rows, np.float32)
    ss = np.zeros(n_rows, np.float32)
    rad = np.zeros(n_rows, np.float32)
    crit = np.zeros(n_rows, np.float32)
    slow = np.ones(n_rows, np.float32)
    half = np.zeros(n_rows, np.float32)
    for i, z in enumerate(zone_specs):
        if len(z.cos_angles) != R:
            raise ValueError(
                f"zone spec {i} has {len(z.cos_angles)} beams; fleet scan "
                f"grid has {R} — build the zone with the fleet's angle grid"
            )
        cos_a[i] = z.cos_angles
        sin_a[i] = z.sin_angles
        fwd[i] = z.forward_mask
        bwd[i] = z.backward_mask
        sc[i] = np.cos(z.sensor_yaw)
        ss[i] = np.sin(z.sensor_yaw)
        rad[i] = z.robot_radius
        crit[i] = z.critical_distance
        slow[i] = z.slowdown_distance
        half[i] = z.half_cone
    return FleetSafety(*(torch.tensor(a, device=device) for a in
                         (cos_a, sin_a, fwd, bwd, sc, ss, rad, crit, slow, half)))


def _band_factor(safety: FleetSafety, dist):
    """clip((dist - crit) / (slow - crit), 0, 1) per robot row [N, R]: the
    band is a device tensor, so the card divides as the CPU does."""
    denom = safety.slow - safety.crit
    return torch.clamp((dist - safety.crit[:, None]) / denom[:, None], 0.0, 1.0)


def _safety_factor_scan(safety: FleetSafety, ranges, sensor_xy, forward):
    """Beam-mask slowdown factor [N] of scans [N, R] (sensor offset
    sensor_xy [N, 2], forward [N] bool): the JAX fleet's operations in its
    order, each rounded on its own, the root correctly."""
    x = ranges * safety.cos_a
    y = ranges * safety.sin_a
    c, s = safety.sensor_c[:, None], safety.sensor_s[:, None]
    bx = (c * x - s * y) + sensor_xy[:, 0:1]
    by = (s * x + c * y) + sensor_xy[:, 1:2]
    dist = _sqrt(bx * bx + by * by) - safety.radius[:, None]
    factor = _band_factor(safety, dist)
    mask = torch.where(forward[:, None], safety.fwd_mask, safety.bwd_mask)
    factor = torch.where(mask & torch.isfinite(ranges), factor, 1.0)
    return torch.amin(factor, dim=-1)


def _safety_factor_world(safety: FleetSafety, obs_world, x, y, yaw, forward):
    """World-point slowdown factor [N] for the k-tick loop: the robot has
    moved off the tick-0 scan pose, so the cone test runs on each frozen
    world obstacle point's bearing [N, O] in the CURRENT body frame (pad
    points at 1e8 are trivially clear). Equals the beam form at the
    tick-0 pose for a centered sensor; with a translated sensor the beam
    preset evaluates the cone on translated UNIT beam directions
    (reference preset quirk) while this form uses the true bearings."""
    dx = obs_world[..., 0] - x[:, None]
    dy = obs_world[..., 1] - y[:, None]
    bearing = torch.abs(torch.remainder(
        torch.atan2(dy, dx) - yaw[:, None] + math.pi, 2.0 * math.pi) - math.pi)
    half = safety.half_cone[:, None]
    in_cone = torch.where(forward[:, None], bearing <= half,
                          bearing >= math.pi - half)
    factor = _band_factor(safety, _sqrt(dx * dx + dy * dy) - safety.radius[:, None])
    return torch.amin(torch.where(in_cone, factor, 1.0), dim=-1)


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
    return cidx, new_seg, pos, heading, _sqrt(min_d2)


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
    obs_world=None,  # [N, scan_size, 2] world obstacles (the k-tick loop)
    peers=None,  # (rows [N, P, 2], velocities [N, P, 2] or None, count)
    safety: FleetSafety = None,  # the fused critical-zone gate
    split_movers: bool = False,  # tracked movers through mover4 (K3s)
):
    """Every robot's full control tick on the device: (carry', out [N, 10])
    with the columns of ``OUT_FIELDS``. ``obs_world``: the scan already
    converted to world obstacles (the k-tick loop converts it once, at
    the tick-0 pose); as in the JAX package, every slot of that bucket
    then counts as an obstacle point for the obstacle cost's gate.

    ``peers`` (fleet mutual avoidance, ``_peer_model``): every other robot
    as a disc of points, appended after the scan bucket in the same
    sweep (collision pruning and the obstacle cost both see them);
    ``count`` real peer points join the obstacle cost's gate. With
    velocities (peer prediction) the points move within the rollout.

    ``safety``: the emergency-stop gate (``FleetSafety``). The slowdown
    factor scales the linear command and a factor of 0 zeroes the whole
    twist; the cone follows the sign of the commanded vx (0 checks the
    forward cone). The single tick checks the scan by its beam masks,
    the k-tick loop the frozen world points against the current pose.
    Peers and tracked movers stay out of it: avoidance owns their
    spacing, and a stop against them would freeze the robot in their
    path.

    ``split_movers``: the tracked rows go to the solver's ``mover4``
    sweep instead of the scan bucket's tail (``obs_count`` still counts
    the real ones). A ``dynamic_box`` spec decides admissibility on each
    robot's box, ``cfg.collision_box2``."""
    with tracing.span("step.follow", states.device):
        (params12, limits9, sensor_pose, rot_in_place, goal_tol, ori_tol,
         losing_tol, interp_dist, base_h, curv_tol, vx_max, max_seg_size) = cfg[:12]
        x, y, yaw = states[:, 0], states[:, 1], states[:, 2]
        L = paths.x.shape[-1]

        # --- goal / losing-goal (follower.cpp:109-142) ---
        goal_i = paths.n_points - 1
        gx, gy = _pick(paths.x, goal_i), _pick(paths.y, goal_i)
        # square roots before a decision are correctly rounded (_sqrt), as
        # XLA's are: PyTorch's CPU float32 sqrt can miss by an ulp
        d_goal = _sqrt((x - gx) * (x - gx) + (y - gy) * (y - gy))
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
        cap = _sqrt(
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
        if obs_world is None:
            obs, R = _scan_to_world_obs(
                spec, ranges, angles, sensor_pose, x, y, yaw
            )
        else:
            obs, R = obs_world, obs_world.shape[1]
        obs_count = torch.full_like(goal_i, min(R, spec.scan_size))
        scan_len = obs.shape[1]
        m_rows = 0
        mover4 = None
        if tracked is not None and split_movers:
            # the split form: the movers never touch the scan bucket; they run
            # as the solver's narrow moving sweep, and count for the obstacle
            # cost's gate as in the tail-slot form
            mover4 = tracked
            obs_count = obs_count + (tracked[:, :, 0] < 1e7).sum(-1).to(torch.int32)
            tracked = None
        if tracked is not None:
            # positions ride the scan bucket's guaranteed-pad TAIL slots (the
            # fleet sizes scan_size >= rays + M); pad slots sit at x >= 1e7
            # with zero velocity and are not counted
            m_rows = tracked.shape[1]
            if ranges.shape[1] + m_rows > scan_len:
                raise ValueError(
                    f"scan bucket {scan_len} cannot hold {ranges.shape[1]} rays + "
                    f"{m_rows} tracked slots — size scan_size >= rays + M"
                )
            obs = torch.cat([obs[:, : scan_len - m_rows], tracked[:, :, 0:2]], 1)
            obs_count = obs_count + (tracked[:, :, 0] < 1e7).sum(-1).to(torch.int32)
        peer_vel = None
        if peers is not None:
            peer_rows, peer_vel, peer_count = peers
            obs = torch.cat([obs, peer_rows], 1)
            obs_count = obs_count + peer_count
        obs_vel = None
        if spec.moving_obstacles and (tracked is not None or peer_vel is not None):
            # per-row velocities in the rows' order: zero for the scan, the
            # tracked slots' own, then the peers' (zero on a robot's own
            # block, and without prediction)
            vel_parts = [obs.new_zeros(obs.shape[0], scan_len - m_rows, 2)]
            if tracked is not None:
                vel_parts.append(tracked[:, :, 2:4])
            if peers is not None:
                vel_parts.append(torch.zeros_like(peer_rows) if peer_vel is None
                                 else peer_vel)
            obs_vel = torch.cat(vel_parts, 1)

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
        collision_box_dyn=cfg.collision_box2 if spec.dynamic_box else None,
        mover4=mover4,
    )

    with tracing.span("step.gate", states.device):
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

        # --- fused critical-zone gate (critical_zone_check.cpp:87-119) ---
        if safety is None:
            safety_factor = torch.ones_like(cmd_vx)  # shape-stable output
        else:
            forward = cmd_vx >= 0.0
            if obs_world is None:
                # single tick: the scan is current, the beam form
                safety_factor = _safety_factor_scan(safety, ranges,
                                                    sensor_pose[:, 0:2], forward)
            else:
                # k-tick loop: the frozen world points against the current pose
                safety_factor = _safety_factor_world(safety, obs_world, x, y, yaw,
                                                     forward)
            cmd_vx = cmd_vx * safety_factor
            cmd_vy = cmd_vy * safety_factor
            cmd_w = torch.where(safety_factor <= 0.0, 0.0, cmd_w)

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
                safety_factor,
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


def _check_peer_cfg(fleet_spec: FleetSpec, peer_cfg) -> None:
    """peer_cfg['predict'] without the moving sweep would silently fall
    back to frozen live-position peers (prediction off, no error).
    DeviceFleet couples the flags; direct composers get this guard."""
    if (
        peer_cfg is not None
        and peer_cfg.get("predict")
        and not fleet_spec.solver.moving_obstacles
    ):
        raise ValueError(
            "peer_cfg['predict']=True requires "
            "solver.moving_obstacles=True — without the moving sweep "
            "the peer discs would be swept at frozen positions and "
            "prediction silently dropped"
        )


def _split_tick_inputs(fleet_spec: FleetSpec, inputs, safety: bool = False,
                       safety_arg=None, cfg=None):
    """The packed tick input ``[N, 7 + R (+ 4M)]`` -> (states [N, 4],
    vels [N, 3], ranges [N, R], tracked [N, M, 4] or None). A program
    built with ``safety`` refuses to run without its ``FleetSafety``: a
    silent factor of 1 would be unsafe. A ``dynamic_box`` program refuses
    a ``cfg`` without ``collision_box2``: the solver would fall back to the
    circle model with the radius counted twice (it is in the margin)."""
    if (fleet_spec.solver.dynamic_box and cfg is not None
            and cfg.collision_box2 is None):
        raise ValueError(
            "dynamic_box fleet spec requires FleetConfig.collision_box2"
        )
    if safety and safety_arg is None:
        raise ValueError(
            "tick program built with safety=True requires a FleetSafety arg"
        )
    width = inputs.shape[1]
    M = fleet_spec.tracked_obstacles
    states = inputs[:, 0:4]
    vels = inputs[:, 4:7]
    if not M:
        return states, vels, inputs[:, 7:], None
    ranges = inputs[:, 7 : width - 4 * M]
    tracked = inputs[:, width - 4 * M :].reshape(inputs.shape[0], M, 4)
    return states, vels, ranges, tracked


def _gather_peer_state(mesh, sv_loc):
    """The peer-state layout of both peer programs. One device: the [N, 7]
    state + velocity block -> ([N, 4] states, [N, 3] vels, N, row ids
    0..N-1), a split into views. A mesh: one [n_loc, 7] block per local
    shard -> per shard (the fleet's [N_glob, 4] states and [N_glob, 3]
    vels on the shard's device, N_glob, the shard's global row ids), from
    ONE ``all_gather_rows``. Row ids are host ranges: the peer tables are
    built from them once (``_peer_model``)."""
    if mesh is None:
        n = sv_loc.shape[0]
        return sv_loc[:, 0:4], sv_loc[:, 4:7], n, np.arange(n)
    n_loc = sv_loc[0].shape[0]
    gathered = mesh.all_gather_rows(sv_loc)
    n_glob = n_loc * mesh.size
    return [(sv[:, 0:4], sv[:, 4:7], n_glob, mesh.shard_index(d) * n_loc + np.arange(n_loc))
            for d, sv in enumerate(gathered)]


def _peer_points_builder(peer_cfg, n_rows: int, device):
    """The peer-avoidance point set of ``n_rows`` fleet rows on
    ``device``: (fn(states [N, 4]) -> [N * block, 2] world points,
    fn(states, vels [N, 3]) -> [N * block, 2] world velocities, block,
    count). Each robot is its center plus ``ring`` points on its
    circumscribed circle; rows past ``n_real`` (pads) sit at the 1e8 pad
    with zero velocity. ``count``: the real peer points one robot sees."""
    ring = int(peer_cfg["ring"])
    n_real = int(peer_cfg["n_real"])
    radii = torch.tensor(np.asarray(peer_cfg["radii"], np.float32)[:n_rows],
                         device=device)
    ang = np.linspace(0.0, 2.0 * np.pi, ring, endpoint=False)
    ring_dirs = torch.tensor(np.stack([np.cos(ang), np.sin(ang)], axis=1),
                             dtype=torch.float32, device=device)
    valid = (torch.arange(n_rows, device=device) < n_real)[:, None, None]

    def build(states):
        centers = states[:, None, 0:2]
        pts = torch.cat(
            [centers, centers + radii[:, None, None] * ring_dirs[None]], dim=1
        )
        return torch.where(valid, pts, _PAD).reshape(-1, 2)

    def build_vel(states, vels):
        """Every point of robot j's disc carries j's commanded velocity
        rotated into the world frame (a pad must not march)."""
        cy, sy = torch.cos(states[:, 2]), torch.sin(states[:, 2])
        vw = torch.stack([vels[:, 0] * cy - vels[:, 1] * sy,
                          vels[:, 0] * sy + vels[:, 1] * cy], dim=1)
        per_pt = vw[:, None, :].expand(n_rows, 1 + ring, 2)
        return torch.where(valid, per_pt, 0.0).reshape(-1, 2)

    block = 1 + ring
    return build, build_vel, block, max(n_real - 1, 0) * block


def _peer_tables(peer_cfg, n_glob: int, row_ids, device):
    """The peer set's constants for the robots ``row_ids`` (host ints) of
    an ``n_glob``-row fleet on ``device``: the point builders, the real
    peer point count and the [n, n_glob * block, 1] mask of each robot's
    own block."""
    build, build_vel, block, count = _peer_points_builder(peer_cfg, n_glob, device)
    slot = torch.arange(n_glob * block, device=device) // block
    rows = torch.as_tensor(np.asarray(row_ids, np.int64), device=device)
    own = slot[None, :, None] == rows[:, None, None]
    return build, build_vel, count, own


def _peer_model(spec: SolverSpec, peer_cfg, device, mesh=None):
    """fn(sv) -> ``_fleet_step``'s ``peers``: the fleet's peer points as
    every robot's own rows [n, N * block, 2], its own block masked to the
    pad, with their velocities when the fleet predicts peers. One device:
    sv is the [N, 7] state + velocity block. A mesh: sv is one [n_loc, 7]
    block per local shard, gathered once (``_gather_peer_state``), and the
    result one ``peers`` per shard. The constant tensors (copied from the
    host) are built here for N = len(radii), the fleet's rows, so a tick
    neither waits for a copy nor breaks a graph capture; on one device
    another N builds its own on its first call."""
    predict = bool(peer_cfg.get("predict") and spec.moving_obstacles)

    def rows_of(tables, s_g, v_g):
        build, build_vel, count, own = tables
        rows = torch.where(own, _PAD, build(s_g))
        vel = torch.where(own, 0.0, build_vel(s_g, v_g)) if predict else None
        return rows, vel, count

    n_fleet = len(peer_cfg["radii"])
    if mesh is not None:
        tables = [_peer_tables(peer_cfg, n_fleet, mesh.row_ids(d, n_fleet), dev)
                  for d, dev in enumerate(mesh.devices)]

        def sharded_peers(sv_loc):
            return [rows_of(t, s_g, v_g) for t, (s_g, v_g, _, _) in
                    zip(tables, _gather_peer_state(mesh, sv_loc))]

        return sharded_peers
    built = {n_fleet: _peer_tables(peer_cfg, n_fleet, np.arange(n_fleet), device)}

    def peers(sv):
        s_g, v_g, n, row_ids = _gather_peer_state(None, sv)
        if n not in built:
            built[n] = _peer_tables(peer_cfg, n, row_ids, device)
        return rows_of(built[n], s_g, v_g)

    return peers


def _shard_inputs(mesh, inputs):
    """The mesh programs' ``inputs``, one per local shard, as float32
    tensors on the shards' devices (a copy where one is on the host)."""
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x, dev in zip(inputs, mesh.devices)]


def _per_shard(mesh, safety_arg):
    """The mesh programs' optional safety argument, one per local shard."""
    return [None] * len(mesh.devices) if safety_arg is None else list(safety_arg)


def check_target(device, mesh, what: str) -> None:
    """Every fleet entry point runs on an explicit ``device`` or over a
    ``mesh``: one of them, never both."""
    if device is None and mesh is None:
        raise TypeError(f"{what} needs a device or a mesh")
    if device is not None and mesh is not None:
        raise ValueError(f"{what} takes a device or a mesh, not both")


def make_fleet_tick(fleet_spec: FleetSpec, device=None, mesh=None, peer_cfg=None,
                    safety: bool = False):
    """The fleet tick on ``device`` or over ``mesh`` (exactly one):
    (paths, cfg, carry, angles [N, R], inputs [N, 7 + R (+ 4M)]
    [, safety: FleetSafety, when built with safety=True]) ->
    (carry', outputs [N, len(OUT_FIELDS)]), every tensor on ``device``.

    ``inputs`` is state | vel | ranges (| tracked): one host-to-device
    copy per tick when given as a host array, none when it already lies
    on the device. Nothing in the tick waits for the device, so the
    caller's read of the outputs is the tick's one sync.

    ``peer_cfg``: fleet mutual avoidance, a dict with ``radii`` (host [N]
    f32, the circumscribed radius per fleet row, pads included),
    ``n_real`` (the real robot count), ``ring`` (circumference points per
    peer) and ``predict`` (peers move at their commanded velocities
    within the rollout). Each robot sees every other robot as a center
    point and ``ring`` points on its circle, from this tick's states: the
    sweep grows by N * (ring + 1) rows per robot. ``safety``: the
    emergency-stop gate (``FleetSafety``).

    Over a mesh every argument is a list of one value per local shard, N
    in ``peer_cfg`` the global padded count, and so is the result (one
    carry and one output per shard). With ``peer_cfg`` the tick makes exactly one
    ``all_gather_rows`` of the shards' [n_loc, 7] blocks; without, none."""
    check_target(device, mesh, "make_fleet_tick")
    _check_tracked_spec(fleet_spec)
    _check_peer_cfg(fleet_spec, peer_cfg)
    spec = fleet_spec.solver
    device = None if device is None else torch.device(device)
    peers = None if peer_cfg is None else _peer_model(spec, peer_cfg, device, mesh)

    def step(paths, cfg, carry, angles, split, safety_arg, peer_set):
        states, vels, ranges, tracked = split
        return _fleet_step(
            spec, paths, cfg, carry, states, vels, ranges, angles,
            spec.seg_size, tracked, peers=peer_set,
            safety=safety_arg if safety else None,
            split_movers=fleet_spec.split_mover_sweep,
        )

    def tick(paths: FleetPaths, cfg: FleetConfig, carry: FleetCarry, angles,
             inputs, safety_arg=None):
        inputs = torch.as_tensor(inputs, dtype=torch.float32, device=device)
        split = _split_tick_inputs(fleet_spec, inputs, safety, safety_arg, cfg)
        with tracing.stages(inputs.device):
            with tracing.span("step.follow", inputs.device):
                peer_set = None if peers is None else peers(inputs[:, 0:7])
            return step(paths, cfg, carry, angles, split, safety_arg, peer_set)

    def mesh_tick(paths, cfg, carry, angles, inputs, safety_arg=None):
        parts = _shard_inputs(mesh, inputs)
        safety_args = _per_shard(mesh, safety_arg)
        splits = [_split_tick_inputs(fleet_spec, x, safety, s, c)
                  for x, s, c in zip(parts, safety_args, cfg)]
        peer_sets = (peers([x[:, 0:7] for x in parts]) if peers is not None
                     else [None] * len(parts))
        results = [step(*args) for args in zip(paths, cfg, carry, angles, splits,
                                               safety_args, peer_sets)]
        return [r[0] for r in results], [r[1] for r in results]

    return tick if mesh is None else mesh_tick


def make_fleet_ticks_on_device(fleet_spec: FleetSpec, k: int, device=None,
                               mesh=None, peer_cfg=None, safety: bool = False):
    """K carry-chained control ticks of every robot on ``device`` or over
    ``mesh`` (exactly one).

    Returns ``(paths, cfg, carry, angles [N, R], inputs [N, 7 + R (+ 4M)]
    [, safety]) -> (carry', outs [N, k, len(OUT_FIELDS)], final_states
    [N, 4])``. The scan is converted to world obstacles once, at the
    tick-0 pose (the static-world assumption of a single solve's
    rollout); tracked movers advect between ticks, slot positions moved
    by v * (i * dt) at tick i (pad slots at x >= 1e7 stay put), and
    within each tick by the moving sweep; each tick applies its first
    command through the kinematic update of the rollout and feeds the
    next tick. The speed column of the state is sqrt(vx^2 + vy^2),
    correctly rounded (``kernels._sqrt``).

    The loop is fleet-synchronous: every tick solves the whole fleet at
    once. With ``peer_cfg`` (see ``make_fleet_tick``) each tick re-derives
    the peer discs from the fleet's current states (and, with
    prediction, the previous tick's commands), so only the scan world is
    frozen. With ``safety`` every tick is gated by the world form of the
    emergency stop against the current pose: a robot integrating toward
    an obstacle slows and stops inside the loop.

    Nothing in it waits for the device or builds a tensor from host
    data after its first call, so the loop can be captured as one CUDA
    graph (``DeviceFleet.run_ticks_on_device``); given host ``inputs`` it
    copies them to the device first. Over a mesh the arguments and
    results are per shard as in ``make_fleet_tick``; with peers every
    tick gathers the shards' live carried state once (k gathers per
    call), so peers on other shards move as they do on one device."""
    check_target(device, mesh, "make_fleet_ticks_on_device")
    _check_tracked_spec(fleet_spec)
    _check_peer_cfg(fleet_spec, peer_cfg)
    if int(k) < 1:
        raise ValueError(f"the k-tick loop needs k >= 1 ticks, got {k}")
    k = int(k)
    spec = fleet_spec.solver
    device = None if device is None else torch.device(device)
    peers = None if peer_cfg is None else _peer_model(spec, peer_cfg, device, mesh)

    def begin(cfg, angles, inputs, safety_arg):
        """One shard's loop state at tick 0: (states, vels, ranges,
        tracked, the frozen world obstacles, dt)."""
        states, vels, ranges, tracked = _split_tick_inputs(
            fleet_spec, inputs, safety, safety_arg, cfg)
        with tracing.span("step.follow", inputs.device):
            obs_world, _ = _scan_to_world_obs(
                spec, ranges, angles, cfg.sensor_pose, states[:, 0], states[:, 1],
                states[:, 2],
            )
        return states, vels, ranges, tracked, obs_world, cfg.params12[:, 0]

    def advance(i, paths, cfg, carry, angles, safety_arg, loop, peer_set):
        """Tick i of one shard: (carry', out, the next loop state)."""
        states, vels, ranges, tracked, obs_world, dt = loop
        trk = None
        with tracing.span("step.follow", states.device):
            if tracked is not None:
                shift = tracked[:, :, 2:4] * (float(i) * dt)[:, None, None]
                pos = torch.where(tracked[:, :, 0:1] < 1e7,
                                  tracked[:, :, 0:2] + shift, tracked[:, :, 0:2])
                trk = torch.cat([pos, tracked[:, :, 2:4]], dim=-1)
        carry, out = _fleet_step(
            spec, paths, cfg, carry, states, vels, ranges, angles,
            spec.seg_size, trk, obs_world=obs_world, peers=peer_set,
            safety=safety_arg if safety else None,
            split_movers=fleet_spec.split_mover_sweep,
        )
        with tracing.span("step.gate", states.device):
            vx, vy, om = out[:, 2], out[:, 3], out[:, 4]
            cy, sy = torch.cos(states[:, 2]), torch.sin(states[:, 2])
            states = torch.stack([
                states[:, 0] + dt * (vx * cy - vy * sy),
                states[:, 1] + dt * (vx * sy + vy * cy),
                states[:, 2] + dt * om,
                _sqrt(vx * vx + vy * vy),
            ], dim=-1)
        return carry, out, (states, out[:, 2:5], ranges, tracked, obs_world, dt)

    def ticks(paths: FleetPaths, cfg: FleetConfig, carry: FleetCarry, angles,
              inputs, safety_arg=None):
        inputs = torch.as_tensor(inputs, dtype=torch.float32, device=device)
        outs = []
        with tracing.stages(inputs.device):
            loop = begin(cfg, angles, inputs, safety_arg)
            for i in range(k):
                with tracing.span("step.follow", inputs.device):
                    peer_set = (None if peers is None
                                else peers(torch.cat([loop[0], loop[1]], dim=1)))
                carry, out, loop = advance(i, paths, cfg, carry, angles, safety_arg,
                                           loop, peer_set)
                outs.append(out)
        return carry, torch.stack(outs, dim=1), loop[0]

    def mesh_ticks(paths, cfg, carry, angles, inputs, safety_arg=None):
        parts = _shard_inputs(mesh, inputs)
        safety_args = _per_shard(mesh, safety_arg)
        loops = [begin(*args) for args in zip(cfg, angles, parts, safety_args)]
        carry = list(carry)
        outs = [[] for _ in parts]
        for i in range(k):
            peer_sets = (peers([torch.cat([lp[0], lp[1]], dim=1) for lp in loops])
                         if peers is not None else [None] * len(parts))
            for d in range(len(parts)):
                carry[d], out, loops[d] = advance(
                    i, paths[d], cfg[d], carry[d], angles[d], safety_args[d],
                    loops[d], peer_sets[d])
                outs[d].append(out)
        return carry, [torch.stack(o, dim=1) for o in outs], [lp[0] for lp in loops]

    return ticks if mesh is None else mesh_ticks
