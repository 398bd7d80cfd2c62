#!/usr/bin/env python3
"""Drive the PyTorch port of the DWA control tick, of the device fleet
tick and of the local occupancy mapper once on an NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with one
CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases (each one asserts; any failure exits non-zero with its traceback):

1. Environment: the card's name and power limit, torch and nvcc versions.
2. Build: compiles the kernels of ``kompass_core_tpu_torch/csrc/`` with
   nvcc for sm_90a into ``build/kompass_core_tpu_torch/`` and prints the
   build time and the compiler's register report.
3. Kernels vs plain versions on the card, bit-identical outputs
   (``torch.equal``): the static sweep (K1's port) at the flagship and
   edge shapes; the batched static sweep against per-robot launches; the
   moving sweep (K3's port) at the flagship and fleet shapes, at zero
   velocity against K1, with pad rows, ragged tiles and a ragged block.
4. The single-robot slice end to end: the flagship DWA (2025 samples x
   30 steps, 512-ray scan, 384 segment slots) through ``DWA.loop_step``
   on ``cuda`` for 60 closed-loop ticks in drop mode and 10 in truncate
   mode; every tick launches K1 exactly once and agrees with the same
   packed input solved by the port on the CPU.
5. The fleet slice end to end: ``DeviceFleet`` on ``cuda`` with 64
   diff-drive robots on their own corridors, the same solve shapes, 512
   rays and 8 tracked slots with one live mover per robot crossing its
   path, for 30 closed-loop ticks. Every tick launches the moving sweep
   exactly once, makes no host sync between its input copy and its
   output copy, and on 4 ticks the rows of 4 sampled robots agree with
   the port's CPU tick on those robots' inputs and carry.
6. The mapper's per-cell kernel (K5's port) against its plain version on
   the card, bit for bit, plain and Bayesian: 400 x 400 / 3600 with 0,
   NaN and +inf beams; a ragged 333 x 517 / 1000 grid with an offset,
   rotated laser; a batch of 64 robots against 64 one-robot launches.
7. The mapping slice end to end: a Bayesian 400 x 400 ``LocalMapper`` on
   ``cuda`` walking the S-curve for 30 updates from 3600-ray scans of the
   posts and corridor walls, one 100k-point cloud update, and one call of
   each 64-robot fleet mapper. Every update launches K5 exactly once; on
   4 updates, the cloud update and 4 fleet robots the port's CPU run of
   the same inputs gives the same layers, except cells that a beam whose
   table differs between the devices explains (their count is printed).
8. Times: the single-robot tick latency over 220 ticks; K1 and its plain
   version at the flagship shapes over 100 distinct inputs, in turns; the
   tracked and the static 64-robot fleet tick over 100 ticks each (host
   clock and CUDA events); K3 and its plain version at the fleet shapes
   over 10 distinct inputs, in turns; ``update_from_scan`` over 100
   updates, Bayesian and plain, and its host parts; K5 and its plain
   version at one and at 64 robots over 10 distinct inputs, in turns;
   the 64-robot Bayesian fleet mapper per call.

Launch counts: the counts are set to 0 before the mapping slice; the
kernels line reports K1 and K3 from phases 4 and 5 and K5 from phase 7.

Before the last line it prints the card's name and power limit and one
JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.
"""

import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

# flagship configuration: 45 x 45 samples, 30-step horizon, 512-ray scan;
# vx_max 1.2 m/s sizes the tracked segment at 384 slots
SAMPLES = 45
HORIZON = 30
CONTROL_HORIZON = 6
DT = 0.1
RAYS = 512
VX_MAX = 1.2
RANGE_MAX = 10.0
# (samples, steps, obstacle slots, segment slots) every slice tick solves
SLICE_SHAPE = (2025, 30, 512, 384)

SLICE_TICKS = 60
TRUNCATE_TICKS = 10
TIMED_TICKS = 220
TIMED_WARMUP = 10
KERNEL_INPUTS = 100

COST_REL = 1e-4  # CPU vs card, per tick (the port's solver parity tolerance)
TIE_REL = 1e-6  # two winners within this are a tie of sin/cos ulps

# the fleet slice: 64 robots at the solve shapes above, 8 tracked slots
# (the scan bucket holds 512 rays + 8 slots, rounded to 768)
FLEET_ROBOTS = 64
FLEET_TRACKED = 8
FLEET_SHAPE = (FLEET_ROBOTS, 2025, 30, 768, 384)
FLEET_TICKS = 30
FLEET_CPU_TICKS = (0, 10, 20, 29)
FLEET_CPU_ROBOTS = (0, 21, 42, 63)
FLEET_TIMED_TICKS = 100
FLEET_KERNEL_INPUTS = 10
LANE_SPACING = 10.0

KERNEL_SOURCE = "kompass_core_tpu_torch/csrc/fused_min_dist.cu"
KERNEL_REPLACES = "kompass_core_tpu/ops/pallas_kernels.py:89"
MOVING_REPLACES = "kompass_core_tpu/ops/pallas_kernels.py:171"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# --- the scene --------------------------------------------------------------


def reference_path():
    """A 40 m S-curve through a corridor, starting at the robot."""
    y = np.linspace(0.0, 40.0, 161)
    return np.stack([2.0 * np.sin(y / 3.0), y], axis=1)


def obstacle_circles():
    """(cx, cy, r): posts beside the path on alternating sides."""
    ys = np.arange(3.0, 40.0, 3.0)
    side = np.where(np.arange(len(ys)) % 2 == 0, 1.0, -1.0)
    return np.stack([2.0 * np.sin(ys / 3.0) + 1.3 * side, ys,
                     np.full(len(ys), 0.3)], axis=1)


CORRIDOR_X = 5.0


def cast_scan(state, circles, rays=RAYS):
    """A scan of ``rays`` rays (512 by default) from the robot's pose
    against the posts and the corridor walls (x = +-5); no hit within
    range gives +inf."""
    from kompass_core_tpu_torch.datatypes import LaserScanData

    angles = np.linspace(-np.pi, np.pi, rays, endpoint=False)
    th = state.yaw + angles
    dx, dy = np.cos(th), np.sin(th)
    best = np.full(rays, np.inf)
    for cx, cy, r in circles:
        ox, oy = cx - state.x, cy - state.y
        b = dx * ox + dy * oy
        disc = b * b - (ox * ox + oy * oy - r * r)
        t = b - np.sqrt(np.maximum(disc, 0.0))
        best = np.where((disc >= 0.0) & (t > 0.0) & (t < best), t, best)
    with np.errstate(divide="ignore", invalid="ignore"):
        for wall in (-CORRIDOR_X, CORRIDOR_X):
            t = (wall - state.x) / dx
            best = np.where((t > 0.0) & (t < best), t, best)
    ranges = np.where(best <= RANGE_MAX, best, np.inf)
    return LaserScanData(ranges=ranges, angles=angles, range_max=RANGE_MAX)


def make_robot():
    from kompass_core_tpu_torch.models import Robot, RobotGeometry, RobotType

    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.25, 0.4]),
    )
    robot.state.x, robot.state.y, robot.state.yaw = 0.0, 0.0, math.pi / 2
    return robot


def make_dwa(robot, device, drop_samples=True):
    from kompass_core_tpu_torch.control import DWA, DWAConfig
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, RobotCtrlLimits,
    )

    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=VX_MAX, max_acc=1.5, max_decel=2.5),
        omega_limits=AngularCtrlLimits(max_vel=1.5, max_acc=3.0, max_decel=3.0),
    )
    config = DWAConfig(
        max_linear_samples=SAMPLES, max_angular_samples=SAMPLES,
        prediction_horizon=HORIZON, control_horizon=CONTROL_HORIZON,
        control_time_step=DT, drop_samples=drop_samples,
    )
    dwa = DWA(robot=robot, ctrl_limits=limits, config=config, device=device)
    dwa.set_path(reference_path())
    return dwa


def apply_first_command(robot, dwa):
    """Integrate the first commanded velocity for one control step (a
    10 Hz controller applies the newest command every tick)."""
    robot.set_control(
        velocity_x=float(dwa.linear_x_control[0]),
        velocity_y=float(dwa.linear_y_control[0]),
        omega=float(dwa.angular_control[0]),
    )
    robot.get_state(dt=DT)


def goal_distance(robot):
    gx, gy = reference_path()[-1]
    return math.hypot(robot.state.x - gx, robot.state.y - gy)


# --- phases -------------------------------------------------------------------


def phase_environment(kernels):
    import torch

    log("card:", card_line())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    nvcc = kernels._nvcc()
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       check=True, timeout=60).stdout.strip().splitlines()[-1])


def phase_build(kernels):
    fresh = not kernels.library_path().exists()
    t0 = time.perf_counter()
    lib = kernels.build_library()
    log(f"build: {'compiled' if fresh else 'found'} {lib} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas:", line.strip())


def _sweep_case(gen, device, S, T, O, G, span=10.0):
    import torch

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * span).to(device)

    return u(S, T), u(S, T), u(O, 2).contiguous(), u(G), u(G)


def phase_kernel_vs_plain(kernels, device):
    """Kernel and plain version on the same card tensors must be equal."""
    import torch

    gen = torch.Generator().manual_seed(1)
    cases = []
    for active in (30, 17):
        cases.append((f"flagship active={active}",
                      _sweep_case(gen, device, 2025, 30, 512, 384), active))
    px, py, obs, sx, sy = _sweep_case(gen, device, 64, 30, 512, 384)
    obs[7] = torch.stack([px[3, 5], py[3, 5]])
    sx[11], sy[11] = px[9, 2], py[9, 2]
    cases.append(("point on an obstacle and on a segment row",
                  (px, py, obs, sx, sy), 30))
    px, py, obs, sx, sy = _sweep_case(gen, device, 2025, 30, 512, 384)
    cases.append(("all obstacle rows at the 1e8 pad",
                  (px, py, torch.full_like(obs, 1e8), sx, sy), 30))
    cases.append(("O=4096", _sweep_case(gen, device, 2025, 30, 4096, 384), 30))
    cases.append(("O=700, G=333 (ragged tiles)",
                  _sweep_case(gen, device, 2025, 30, 700, 333), 30))
    cases.append(("S*T=259 (ragged block)",
                  _sweep_case(gen, device, 37, 7, 512, 384), 5))
    max_err = 0.0
    for name, (px, py, obs, sx, sy), active in cases:
        ap = torch.tensor(active, dtype=torch.int32, device=device)
        got = kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)
        want = kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            both_inf = torch.isinf(g) & torch.isinf(w)
            err = float(torch.where(both_inf, 0.0, (g - w).abs()).max())
            max_err = max(max_err, err)
            assert torch.equal(g, w), f"{name}: kernel != plain (max abs {err})"
            assert bool((g[:, active:] == math.inf).all()), f"{name}: mask"
            assert bool((g[:, :active] >= 0).all()), f"{name}: negative d2"
        if name.startswith("point on"):
            assert float(got[0][3, 5]) == 0.0 and float(got[1][9, 2]) == 0.0
        log(f"kernel == plain: {name}")
    return max_err


def _cpu_check(spec, buf, out, cpu_ties):
    """The same packed input through the port on the CPU (plain sweep)."""
    import torch

    from kompass_core_tpu_torch.ops.solver import _unpack_inputs, dwa_solve

    res = dwa_solve(spec, *_unpack_inputs(spec, torch.from_numpy(buf.copy())))
    found, cost, best, n_adm = bool(out[0] > 0.5), float(out[1]), int(out[2]), int(out[3])
    assert found == bool(res.found), "found differs from the CPU"
    assert n_adm == int(res.num_admissible), "num_admissible differs from the CPU"
    if found:
        assert math.isclose(cost, float(res.cost), rel_tol=COST_REL), (
            f"cost {cost} vs CPU {float(res.cost)}")
    cbest = int(res.best_index)
    if best != cbest:
        costs = res.costs.numpy()
        assert abs(costs[best] - costs[cbest]) <= TIE_REL * abs(costs[cbest]), (
            f"winner {best} vs CPU {cbest} is not a tie")
        cpu_ties.append((best, cbest))


def run_slice(robot, dwa, ticks, kernels, cpu_ties):
    """Closed-loop ticks through DWA.loop_step, each checked against the
    CPU and counted as exactly one kernel launch."""
    circles = obstacle_circles()
    found = 0
    for i in range(ticks):
        before = kernels.fused_min_dist_sq.launches
        ok = dwa.loop_step(current_state=robot.state,
                           laser_scan=cast_scan(robot.state, circles))
        assert ok, f"tick {i}: loop_step returned False"
        assert kernels.fused_min_dist_sq.launches == before + 1, (
            f"tick {i}: {kernels.fused_min_dist_sq.launches - before} launches")
        spec, buf, out = dwa.last_solver_io
        shape = (spec.num_samples, spec.max_points, spec.scan_size, spec.seg_size)
        assert shape == SLICE_SHAPE, f"tick {i}: solved {shape}, not {SLICE_SHAPE}"
        _cpu_check(spec, buf, out, cpu_ties)
        found += dwa.has_result()
        apply_first_command(robot, dwa)
    return found


def check_no_sync_in_solve(dwa, robot):
    """The packed solve on a device-resident buffer makes no host sync."""
    import torch

    dwa.loop_step(current_state=robot.state,
                  laser_scan=cast_scan(robot.state, obstacle_circles()))
    spec, buf, _ = dwa.last_solver_io
    from kompass_core_tpu_torch.ops import make_packed_dwa_solver

    dev_buf = torch.from_numpy(buf.copy()).to(dwa.device)
    solve = make_packed_dwa_solver(spec, dwa.device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve(dev_buf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode warns "called a synchronizing CUDA operation" per sync
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    assert not syncs, f"host syncs inside the solve: {syncs}"
    torch.cuda.synchronize()


def phase_slice(kernels, device):
    cpu_ties = []
    robot = make_robot()
    dwa = make_dwa(robot, device)
    check_no_sync_in_solve(dwa, robot)
    robot = make_robot()
    dwa = make_dwa(robot, device)
    start = goal_distance(robot)
    kernels.fused_min_dist_sq.launches = 0
    found = run_slice(robot, dwa, SLICE_TICKS, kernels, cpu_ties)
    launches = kernels.fused_min_dist_sq.launches
    end = goal_distance(robot)
    log(f"slice (drop): {SLICE_TICKS} ticks, {found} found, {launches} launches, "
        f"goal distance {start:.3f} -> {end:.3f} m, CPU ties {len(cpu_ties)}")
    assert launches == SLICE_TICKS
    assert found == SLICE_TICKS, "the planner lost its way in an open corridor"
    assert end < start - 1.0, "the robot did not approach the goal"

    robot_t = make_robot()
    dwa_t = make_dwa(robot_t, device, drop_samples=False)
    found_t = run_slice(robot_t, dwa_t, TRUNCATE_TICKS, kernels, cpu_ties)
    log(f"slice (truncate): {TRUNCATE_TICKS} ticks, {found_t} found; "
        f"CPU ties in all: {len(cpu_ties)} {cpu_ties}")
    assert found_t == TRUNCATE_TICKS
    return launches


def phase_times(kernels, device, card):
    import torch

    robot = make_robot()
    dwa = make_dwa(robot, device)
    circles = obstacle_circles()
    lat = []
    for i in range(TIMED_WARMUP + TIMED_TICKS):
        scan = cast_scan(robot.state, circles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = dwa.loop_step(current_state=robot.state, laser_scan=scan)
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        assert ok, f"timed tick {i} failed"
        if i >= TIMED_WARMUP:
            lat.append(dt_ms)
        apply_first_command(robot, dwa)
    lat.sort()
    p50 = statistics.median(lat)
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    log(f"tick latency over {len(lat)} ticks ({card}): median {p50:.4f} ms, "
        f"p99 {p99:.4f} ms, min {lat[0]:.4f} ms, max {lat[-1]:.4f} ms")

    gen = torch.Generator().manual_seed(2)
    inputs = [_sweep_case(gen, device, 2025, 30, 512, 384)
              for _ in range(KERNEL_INPUTS)]
    ap = torch.tensor(30, dtype=torch.int32, device=device)

    def timed(fn):
        for px, py, obs, sx, sy in inputs[:5]:
            fn(px, py, obs, sx, sy, ap)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for px, py, obs, sx, sy in inputs:
            fn(px, py, obs, sx, sy, ap)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / len(inputs)

    runs = [("plain", timed(kernels.fused_min_dist_sq_reference)),
            ("kernel", timed(kernels.fused_min_dist_sq)),
            ("kernel", timed(kernels.fused_min_dist_sq)),
            ("plain", timed(kernels.fused_min_dist_sq_reference))]
    k_ms = statistics.mean(t for n, t in runs if n == "kernel")
    p_ms = statistics.mean(t for n, t in runs if n == "plain")
    log(f"fused_min_dist_sq at 2025x30 vs 512+384 rows ({card}), CUDA events "
        f"over {KERNEL_INPUTS} distinct inputs, in turns "
        f"{[f'{n} {t:.5f} ms' for n, t in runs]}: kernel {k_ms:.5f} ms, "
        f"plain {p_ms:.5f} ms")
    return k_ms, p_ms



def _check_equal(name, got, want, active=None):
    """torch.equal of each output pair; returns the max abs difference
    (0 where both are inf)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        both_inf = torch.isinf(g) & torch.isinf(w)
        err = max(err, float(torch.where(both_inf, 0.0, (g - w).abs()).max()))
        assert torch.equal(g, w), f"{name}: kernel != plain (max abs {err})"
        if active is not None:
            assert bool((g[..., active:] == math.inf).all()), f"{name}: mask"
            assert bool((g[..., :active] >= 0).all()), f"{name}: negative d2"
    return err


def phase_batched_k1(kernels, device):
    """The static sweep over a 64-robot batch at the fleet shapes equals
    64 one-robot launches and the plain version, bit for bit."""
    import torch

    B, S, T, O, G = FLEET_SHAPE
    gen = torch.Generator().manual_seed(3)
    cases = [_sweep_case(gen, device, S, T, O, G) for _ in range(B)]
    px, py, obs, sx, sy = (torch.stack(parts) for parts in zip(*cases))
    active = torch.randint(2, T + 1, (B,), generator=gen, dtype=torch.int32)
    ap = active.to(device)
    batch = kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)
    err = _check_equal("batched K1 vs plain", batch,
                       kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap))
    for b in range(B):
        one = kernels.fused_min_dist_sq(px[b], py[b], obs[b], sx[b], sy[b], ap[b])
        err = max(err, _check_equal(f"batched K1 robot {b}",
                                    tuple(f[b] for f in batch), one,
                                    int(active[b])))
    torch.cuda.synchronize()
    log(f"batched K1 == per-robot K1 == plain: B={B}, {S}x{T} points, "
        f"{O} + {G} rows")
    return err


def _moving_case(gen, device, B, S, T, O, G, span=10.0, vmax=1.5):
    import torch

    px, py, obs, sx, sy = (torch.stack(parts) for parts in zip(
        *[_sweep_case(gen, device, S, T, O, G, span) for _ in range(B)]))
    vel = ((torch.rand(B, O, 2, generator=gen) * 2 - 1) * vmax).to(device)
    dt = (0.05 + 0.1 * torch.rand(B, generator=gen)).to(device)
    return px, py, obs, vel, dt, sx, sy


def phase_moving_vs_plain(kernels, device):
    """The moving sweep (K3's port) against its plain version, and at
    zero velocity against K1, bit for bit."""
    import torch

    gen = torch.Generator().manual_seed(4)
    B, S, T, O, G = FLEET_SHAPE
    cases = []
    for active in (30, 17):
        cases.append((f"flagship moving active={active}",
                      _moving_case(gen, device, 1, 2025, 30, 512, 384), active))
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 1, 2025, 30, 512, 384)
    obs[:, 400:] = 1e8
    vel[:, 400:] = 0.0
    cases.append(("112 pad rows (1e8, zero velocity)",
                  (px, py, obs, vel, dt, sx, sy), 30))
    cases.append(("O=700, G=333 (ragged tiles)",
                  _moving_case(gen, device, 1, 2025, 30, 700, 333), 30))
    cases.append(("S*T=259 (ragged block), B=3",
                  _moving_case(gen, device, 3, 37, 7, 512, 384), 5))
    cases.append((f"fleet shapes B={B}, O={O}",
                  _moving_case(gen, device, B, S, T, O, G), None))
    max_err = 0.0
    for name, (px, py, obs, vel, dt, sx, sy), active in cases:
        if active is None:
            ap = torch.randint(2, T + 1, (px.shape[0],), generator=gen,
                               dtype=torch.int32).to(device)
        else:
            ap = torch.full((px.shape[0],), active, dtype=torch.int32,
                            device=device)
        got = kernels.fused_min_dist_sq_moving(px, py, obs, vel, dt, sx, sy, ap)
        want = kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap, vel, dt)
        torch.cuda.synchronize()
        max_err = max(max_err, _check_equal(name, got, want, active))
        log(f"moving kernel == plain: {name}")
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 4, 2025, 30, 512, 384)
    ap = torch.tensor([30, 17, 2, 30], dtype=torch.int32, device=device)
    got = kernels.fused_min_dist_sq_moving(px, py, obs, torch.zeros_like(vel),
                                           dt, sx, sy, ap)
    k1 = kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)
    torch.cuda.synchronize()
    max_err = max(max_err, _check_equal("zero velocity vs K1", got, k1))
    log("moving kernel at zero velocity == K1")
    return max_err


# --- the fleet slice ----------------------------------------------------------


def fleet_scene():
    """Per robot: its lane's x offset, its path (the S-curve, shifted to
    the lane) and its posts. Corridor walls sit at the lane's x +- 5."""
    lanes = LANE_SPACING * np.arange(FLEET_ROBOTS)
    path = reference_path()
    paths = [path + (x, 0.0) for x in lanes]
    circles = np.stack([obstacle_circles() + (x, 0.0, 0.0) for x in lanes])
    return lanes, paths, circles


def cast_fleet_scans(states, lanes, circles):
    """[N, 512] ranges per robot against its own posts and corridor
    walls (no hit within range gives +inf), vectorized over the fleet."""
    angles = np.linspace(-np.pi, np.pi, RAYS, endpoint=False)
    th = states[:, 2:3] + angles  # [N, R]
    dx, dy = np.cos(th)[..., None], np.sin(th)[..., None]
    ox = circles[:, None, :, 0] - states[:, 0, None, None]  # [N, 1, C]
    oy = circles[:, None, :, 1] - states[:, 1, None, None]
    r = circles[:, None, :, 2]
    b = dx * ox + dy * oy
    disc = b * b - (ox * ox + oy * oy - r * r)
    t = b - np.sqrt(np.maximum(disc, 0.0))
    best = np.where((disc >= 0.0) & (t > 0.0), t, np.inf).min(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        for side in (-CORRIDOR_X, CORRIDOR_X):
            t = ((lanes + side)[:, None] - states[:, 0:1]) / dx[..., 0]
            best = np.where((t > 0.0) & (t < best), t, best)
    return np.where(best <= RANGE_MAX, best, np.inf).astype(np.float32), angles


def make_fleet(device, tracked=FLEET_TRACKED):
    from kompass_core_tpu_torch.control import DWAConfig
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu_torch.parallel import DeviceFleet

    robots = [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                    geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.25, 0.4]))
              for _ in range(FLEET_ROBOTS)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=VX_MAX, max_acc=1.5, max_decel=2.5),
        omega_limits=AngularCtrlLimits(max_vel=1.5, max_acc=3.0, max_decel=3.0),
    )
    config = DWAConfig(
        max_linear_samples=SAMPLES, max_angular_samples=SAMPLES,
        prediction_horizon=HORIZON, control_horizon=CONTROL_HORIZON,
        control_time_step=DT,
    )
    fleet = DeviceFleet(robots, limits, config, RAYS, path_capacity=4608,
                        tracked_obstacles=tracked, device=device)
    lanes, paths, circles = fleet_scene()
    fleet.set_paths(paths)
    solver = fleet.spec.solver
    shape = (fleet._n, solver.num_samples, solver.max_points,
             solver.scan_size, solver.seg_size)
    assert shape == FLEET_SHAPE or tracked == 0, f"fleet shapes {shape}"
    return fleet, lanes, circles


class FleetDrive:
    """The closed loop around a fleet: robots start at their lanes' path
    starts facing +y; each tick casts their scans, gives each its live
    mover (slot 0; slots 1..7 NaN, i.e. empty), ticks, and integrates the
    found commands for one control step on the host."""

    def __init__(self, lanes, circles, tracked):
        self.lanes, self.circles, self.tracked = lanes, circles, tracked
        self.states = np.zeros((FLEET_ROBOTS, 4), np.float32)
        self.states[:, 0] = lanes
        self.states[:, 2] = math.pi / 2
        self.vels = np.zeros((FLEET_ROBOTS, 3), np.float32)
        # a mover 2.5 m ahead and 2 m to the side of each robot, walking
        # across its path at 0.8 m/s
        self.movers = np.stack([lanes + 2.0, np.full(FLEET_ROBOTS, 2.5)], 1)
        self.mover_vel = np.array([-0.8, 0.0])
        self.min_clearance = math.inf

    def inputs(self):
        ranges, angles = cast_fleet_scans(self.states, self.lanes, self.circles)
        tracked = None
        if self.tracked:
            tracked = np.full((FLEET_ROBOTS, self.tracked, 4), np.nan, np.float32)
            tracked[:, 0, 0:2] = self.movers
            tracked[:, 0, 2:4] = self.mover_vel
        return self.states, self.vels, ranges, angles, tracked

    def advance(self, out):
        go = out["found"]
        vx, om = np.where(go, out["vx"], 0.0), np.where(go, out["omega"], 0.0)
        s = self.states
        s[:, 0] += DT * vx * np.cos(s[:, 2])
        s[:, 1] += DT * vx * np.sin(s[:, 2])
        s[:, 2] += DT * om
        s[:, 3] = np.abs(vx)
        self.vels[:, 0], self.vels[:, 2] = vx, om
        self.movers += DT * self.mover_vel
        self.min_clearance = min(self.min_clearance, float(np.hypot(
            *(s[:, 0:2] - self.movers).T).min()))

    def goal_distance(self, paths_end):
        return np.hypot(*(self.states[:, 0:2] - paths_end).T)


def sync_guarded(fn):
    """``fn`` run under ``torch.cuda.set_sync_debug_mode("warn")``: it
    fails if anything inside synchronised the host with the card."""
    import torch

    def run(*args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        assert not syncs, f"host syncs inside the fleet tick: {syncs}"
        run.calls += 1
        return result

    run.calls = 0
    return run


def _fleet_cpu_check(fleet, carry_before, out, tick, ties):
    """The sampled robots' rows against the port's tick on the CPU, fed
    the same inputs, path rows, config rows and carry rows."""
    import torch

    from kompass_core_tpu_torch.ops.fleet_solver import (
        OUT_FIELDS, FleetCarry, FleetConfig, FleetPaths, make_fleet_tick,
    )

    idx = torch.tensor(FLEET_CPU_ROBOTS)
    rows = [FleetPaths(*(t.cpu()[idx] for t in fleet._paths)),
            FleetConfig(*(t.cpu()[idx] for t in fleet._cfg)),
            FleetCarry(*(t[idx] for t in carry_before)),
            fleet._angles.cpu()[idx],
            torch.from_numpy(fleet._inputs[list(FLEET_CPU_ROBOTS)].copy())]
    _, cpu = make_fleet_tick(fleet.spec, "cpu")(*rows)
    cpu = {k: cpu[:, i].numpy() for i, k in enumerate(OUT_FIELDS)}
    for j, r in enumerate(FLEET_CPU_ROBOTS):
        for key in ("num_admissible", "active_points", "reached"):
            assert float(out[key][r]) == cpu[key][j], (
                f"tick {tick} robot {r}: {key} {out[key][r]} vs CPU {cpu[key][j]}")
        assert bool(out["found"][r]) == (cpu["found"][j] > 0.5), f"tick {tick} found"
        assert math.isclose(out["cost"][r], cpu["cost"][j], rel_tol=COST_REL,
                            abs_tol=1e-6), (
            f"tick {tick} robot {r}: cost {out['cost'][r]} vs CPU {cpu['cost'][j]}")
        cmd = [out[k][r] for k in ("vx", "vy", "omega")]
        cmd_cpu = [cpu[k][j] for k in ("vx", "vy", "omega")]
        if cmd != cmd_cpu:
            assert abs(out["cost"][r] - cpu["cost"][j]) <= TIE_REL * abs(cpu["cost"][j]), (
                f"tick {tick} robot {r}: command {cmd} vs CPU {cmd_cpu} is not a tie")
            ties.append((tick, r))


def phase_fleet(kernels, device):
    """The fleet slice: 64 robots, tracked movers, closed loop on cuda."""
    import torch

    fleet, lanes, circles = make_fleet(device)
    drive = FleetDrive(lanes, circles, FLEET_TRACKED)
    fleet._tick_fn = sync_guarded(fleet._tick_fn)
    ends = np.stack([p[-1] for p in fleet_scene()[1]])
    start = drive.goal_distance(ends)
    ties, found = [], 0
    kernels.fused_min_dist_sq.launches = 0
    kernels.fused_min_dist_sq_moving.launches = 0
    for tick in range(FLEET_TICKS):
        before = kernels.fused_min_dist_sq_moving.launches
        carry = [t.cpu() for t in fleet._carry]
        out = fleet.tick(*drive.inputs())
        assert kernels.fused_min_dist_sq_moving.launches == before + 1, (
            f"fleet tick {tick}: "
            f"{kernels.fused_min_dist_sq_moving.launches - before} moving launches")
        for key, col in out.items():
            assert col.shape == (FLEET_ROBOTS,) and np.isfinite(col).all(), key
        if tick in FLEET_CPU_TICKS:
            _fleet_cpu_check(fleet, carry, out, tick, ties)
        found += int(out["found"].sum())
        drive.advance(out)
    k3 = kernels.fused_min_dist_sq_moving.launches
    k1 = kernels.fused_min_dist_sq.launches
    torch.cuda.synchronize()
    end = drive.goal_distance(ends)
    log(f"fleet slice: {FLEET_ROBOTS} robots x {FLEET_TICKS} ticks, "
        f"{FLEET_TRACKED} tracked slots; moving-sweep launches {k3}, static "
        f"{k1}; sync-checked ticks {fleet._tick_fn.calls}; found "
        f"{found}/{FLEET_ROBOTS * FLEET_TICKS}; mean goal distance "
        f"{start.mean():.3f} -> {end.mean():.3f} m; min robot-mover distance "
        f"{drive.min_clearance:.3f} m; CPU-checked rows "
        f"{len(FLEET_CPU_TICKS) * len(FLEET_CPU_ROBOTS)}, ties {ties}")
    assert k3 == FLEET_TICKS and k1 == 0
    assert fleet._tick_fn.calls == FLEET_TICKS
    assert found >= 0.9 * FLEET_ROBOTS * FLEET_TICKS, "the fleet lost its way"
    assert end.mean() < start.mean() - 1.0, "the fleet did not approach its goals"
    return k3


def _time_fleet(device, tracked, card):
    """Host clock and CUDA events over FLEET_TIMED_TICKS closed-loop
    ticks after 10 warm-up ticks."""
    import torch

    fleet, lanes, circles = make_fleet(device, tracked)
    drive = FleetDrive(lanes, circles, tracked)
    events = []
    inner = fleet._tick_fn

    def evented(*args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        result = inner(*args)
        stop.record()
        events.append((start, stop))
        return result

    fleet._tick_fn = evented
    lat = []
    for i in range(TIMED_WARMUP + FLEET_TIMED_TICKS):
        inputs = drive.inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fleet.tick(*inputs)  # ends in the output copy, a sync
        dt_ms = (time.perf_counter() - t0) * 1e3
        if i >= TIMED_WARMUP:
            lat.append(dt_ms)
        drive.advance(out)
    torch.cuda.synchronize()
    dev = sorted(s.elapsed_time(e) for s, e in events[TIMED_WARMUP:])
    lat.sort()
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    name = f"fleet tick, {FLEET_ROBOTS} robots, tracked_obstacles={tracked}"
    log(f"{name} ({card}): host clock over {len(lat)} ticks median "
        f"{statistics.median(lat):.4f} ms, p99 {p99:.4f} ms, min {lat[0]:.4f}, "
        f"max {lat[-1]:.4f}; {1e3 / statistics.median(lat):.2f} ticks/s, "
        f"{FLEET_ROBOTS * 1e3 / statistics.median(lat):.1f} robot-ticks/s; "
        f"CUDA events over the device part median {statistics.median(dev):.4f} ms")
    return statistics.median(lat), p99


def phase_fleet_times(kernels, device, card):
    import torch

    _time_fleet(device, FLEET_TRACKED, card)
    _time_fleet(device, 0, card)

    B, S, T, O, G = FLEET_SHAPE
    gen = torch.Generator().manual_seed(5)
    inputs = [_moving_case(gen, device, B, S, T, O, G)
              for _ in range(FLEET_KERNEL_INPUTS)]
    ap = torch.full((B,), T, dtype=torch.int32, device=device)

    def timed(fn):
        for px, py, obs, vel, dt, sx, sy in inputs[:2]:
            fn(px, py, obs, sx, sy, ap, vel, dt)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for px, py, obs, vel, dt, sx, sy in inputs:
            fn(px, py, obs, sx, sy, ap, vel, dt)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / len(inputs)

    def kernel(px, py, obs, sx, sy, ap, vel, dt):
        return kernels.fused_min_dist_sq_moving(px, py, obs, vel, dt, sx, sy, ap)

    runs = [("plain", timed(kernels.fused_min_dist_sq_reference)),
            ("kernel", timed(kernel)), ("kernel", timed(kernel)),
            ("plain", timed(kernels.fused_min_dist_sq_reference))]
    k_ms = statistics.mean(t for n, t in runs if n == "kernel")
    p_ms = statistics.mean(t for n, t in runs if n == "plain")
    log(f"fused_min_dist_sq_moving at B={B}, {S}x{T} vs {O}+{G} rows ({card}), "
        f"CUDA events over {FLEET_KERNEL_INPUTS} distinct inputs, in turns "
        f"{[f'{n} {t:.5f} ms' for n, t in runs]}: kernel {k_ms:.5f} ms, "
        f"plain {p_ms:.5f} ms")
    return k_ms, p_ms


# --- the mapping slice --------------------------------------------------------

# Mapper_Dense_400x400 (kompass_core_tpu/benchmark/runner.py): 3600 rays
# into a 400 x 400 grid at 0.05 m; the Bayesian form uses the reference
# benchmark's sensor model (p_prior, p_empty, p_occupied, range_sure,
# range_max, wall_size)
MAP_SPEC = (400, 400, 3600, 0.05)
MAP_RAGGED = (333, 517, 1000, 0.05, 0.13, -0.21, 0.4)
MAP_RAYS = 3600
BAYES_SCALARS = (0.6, 0.1, 0.9, 0.1, 20.0, 0.2)
MAP_ROBOTS = 64
MAP_UPDATES = 30
MAP_CPU_UPDATES = (0, 10, 20, 29)
MAP_CPU_ROBOTS = (0, 21, 42, 63)
CLOUD_POINTS = 100_000
MAP_TIMED = 100
MAP_KERNEL_INPUTS = 10
MAP_FLEET_TIMED = 20

MAP_SOURCE = "kompass_core_tpu_torch/csrc/scan_to_grid.cu"
MAP_REPLACES = "kompass_core_tpu/ops/mapping.py:244"


class Pose2D:
    def __init__(self, x, y, yaw):
        self.x, self.y, self.yaw = x, y, yaw

    def pose_data(self):
        from kompass_core_tpu_torch.datatypes import PoseData

        pose = PoseData()
        pose.set_position(x=self.x, y=self.y, z=0.0)
        pose.set_yaw(self.yaw)
        return pose


def mapping_poses(n, stride=2):
    """Poses walking the S-curve, facing along it."""
    path = reference_path()
    poses = []
    for k in range(n):
        i = (stride * k) % (len(path) - 1)
        (x0, y0), (x1, y1) = path[i], path[i + 1]
        poses.append(Pose2D(x0, y0, math.atan2(y1 - y0, x1 - x0)))
    return poses


def scan_model(**overrides):
    from kompass_core_tpu_torch.datatypes import ScanModelConfig

    p_prior, _, p_occupied, range_sure, range_max, wall_size = BAYES_SCALARS
    kw = dict(p_prior=p_prior, p_occupied=p_occupied, range_sure=range_sure,
              range_max=range_max, wall_size=wall_size)
    kw.update(overrides)
    return ScanModelConfig(**kw)  # p_empty = 1 - p_occupied = 0.1


def cloud_points(seed):
    """Mapper_PointCloud_100k's cloud: ranges 0.5-9.9 m, z in +-0.5 m."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 9.9, CLOUD_POINTS)
    a = rng.uniform(0, 2 * np.pi, CLOUD_POINTS)
    return np.stack([r * np.cos(a), r * np.sin(a),
                     rng.uniform(-0.5, 0.5, CLOUD_POINTS)], 1).astype(np.float32)


def _map_ranges(spec, robots, seed):
    """[robots, B] ranges of 0.5-9.9 m with 0, NaN and +inf beams."""
    import torch

    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 9.9, (robots, spec.num_bins)).astype(np.float32)
    r[:, ::97] = 0.0
    r[:, 7::211], r[:, 13::307] = np.nan, np.inf
    return torch.from_numpy(r)


def _map_inputs(spec, ranges, device, seed):
    """The per-cell pass's inputs as the mapper builds them."""
    import torch

    from kompass_core_tpu_torch.ops import mapping

    geo = mapping._geometry_for(spec, 0.0, device)
    tables, endpoint = mapping._beam_side(spec, geo, ranges.to(device))
    rng = np.random.default_rng(seed)
    prev = torch.from_numpy(rng.uniform(
        0.05, 0.95, (ranges.shape[0], spec.grid_height, spec.grid_width)
    ).astype(np.float32)).to(device)
    return geo, tables, endpoint, prev, mapping._params(device, *BAYES_SCALARS)


def _check_grids_equal(name, got, want):
    """torch.equal of each output pair; returns the max abs difference."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        err = max(err, float((g.double() - w.double()).abs().max()))
        assert torch.equal(g, w), f"{name}: kernel != plain (max abs {err})"
    return err


def phase_mapper_kernel_vs_plain(kernels, device):
    """K5 and its plain version on the same card tensors must be equal,
    in the plain and the Bayesian form."""
    from kompass_core_tpu_torch.ops.mapping import MapperSpec

    full, ragged = MapperSpec(*MAP_SPEC), MapperSpec(*MAP_RAGGED)

    def shape(spec):
        return f"{spec.grid_height}x{spec.grid_width}/{spec.num_bins}"

    cases = [
        (f"{shape(full)} with 0, NaN and +inf beams", full, 1),
        (f"{shape(ragged)}, offset rotated laser", ragged, 1),
        (f"{shape(full)}, a batch of {MAP_ROBOTS} robots", full, MAP_ROBOTS),
    ]
    max_err = 0.0
    for seed, (name, spec, robots) in enumerate(cases):
        geo, tables, endpoint, prev, params = _map_inputs(
            spec, _map_ranges(spec, robots, seed), device, seed)
        for bayes in (False, True):
            extra = (prev, params) if bayes else ()
            form = "Bayesian" if bayes else "plain"
            got = kernels.scan_to_grid_cells(geo.base, geo.dist_m, tables,
                                             endpoint, spec.start_cell, *extra)
            want = kernels.scan_to_grid_cells_reference(
                geo.base, geo.dist_m, tables, endpoint, spec.start_cell, *extra)
            got, want = (x if bayes else (x,) for x in (got, want))
            max_err = max(max_err, _check_grids_equal(f"{name} {form}", got, want))
            occ = got[0]
            codes = set(occ.unique().tolist())
            assert codes == {-1, 0, 100}, f"{name}: codes {codes}"
            if bayes:
                prob = got[1]
                assert bool(((prob > 0) & (prob < 1)).all()), f"{name}: prob range"
            for b in range(robots if robots > 1 else 0):
                one = kernels.scan_to_grid_cells(
                    geo.base, geo.dist_m, tables[b:b + 1].contiguous(),
                    endpoint[b:b + 1].contiguous(), spec.start_cell,
                    *((prev[b:b + 1].contiguous(), params) if bayes else ()))
                one = one if bayes else (one,)
                max_err = max(max_err, _check_grids_equal(
                    f"{name} {form} robot {b}", [g[b] for g in got],
                    [o[0] for o in one]))
            log(f"K5 == plain ({form}): {name}"
                + (f"; batch == {robots} one-robot launches" if robots > 1 else ""))
    return max_err


def _mapper_state(mapper):
    prev = None if mapper._prev_prob is None else mapper._prev_prob.cpu()
    return (mapper._spec, prev, mapper._pose_robot_in_world, mapper.processed,
            mapper.is_pointcloud)


def _device_ranges(mapper, scan, device):
    """The uniform ranges ``mapper`` computes from ``scan`` on ``device``."""
    import torch

    from kompass_core_tpu_torch.datatypes import PointCloudData
    from kompass_core_tpu_torch.ops import mapping

    if isinstance(scan, PointCloudData):
        m = mapper.scan_model
        return mapping.get_pointcloud_to_scan(mapper._spec.num_bins, device)(
            scan.points, m.range_max, m.min_height, m.max_height)
    return torch.from_numpy(mapper._uniform_ranges(scan)).to(device)


def _explained_cells(spec, ranges_gpu, ranges_cpu):
    """(number of beams whose table row differs between the devices, the
    cells such a beam can change: those reading it as a candidate and the
    endpoint cells that differ)."""
    import torch

    from kompass_core_tpu_torch.ops import kernels, mapping

    cpu = torch.device("cpu")
    geo = mapping._geometry_for(spec, 0.0, cpu)
    t_gpu, e_gpu = mapping._beam_side(spec, geo, ranges_gpu.cpu().reshape(1, -1))
    t_cpu, e_cpu = mapping._beam_side(spec, geo, ranges_cpu.reshape(1, -1))
    t_dev, e_dev = mapping._beam_side(
        spec, mapping._geometry_for(spec, 0.0, ranges_gpu.device),
        ranges_gpu.reshape(1, -1))
    assert torch.equal(t_dev.cpu(), t_gpu) and torch.equal(e_dev.cpu(), e_gpu), (
        "the card's beam side differs from the CPU's on the same ranges")
    differs = (t_gpu != t_cpu).any(dim=-1)[0]  # [B]
    k = torch.arange(kernels.CANDIDATES) - kernels.CANDIDATES // 2
    bins = torch.remainder(geo.base.long()[..., None] + k, spec.num_bins)
    explained = differs[bins].any(dim=-1) | (e_gpu != e_cpu)[0]
    return int(differs.sum()), explained


def _mapper_cpu_check(mapper, state, pose, scan, what):
    """The same update run by the port on the CPU from the card mapper's
    state before it: beam tables first, then every layer. Returns the
    number of beams whose table differs between the devices."""
    import torch

    from kompass_core_tpu_torch.mapping import LocalMapper

    cpu = LocalMapper(mapper.config, mapper.scan_model,
                      mapper.pose_laserscanner_in_robot, device="cpu")
    spec, prev, pose_before, processed, is_pointcloud = state
    if processed:
        cpu._spec, cpu._prev_prob = spec, prev
        cpu._pose_robot_in_world, cpu.processed = pose_before, True
        cpu.is_pointcloud = is_pointcloud
    cpu.update_from_scan(pose, scan)
    n_diff, explained = _explained_cells(
        mapper._spec, _device_ranges(mapper, scan, mapper.device),
        _device_ranges(cpu, scan, torch.device("cpu")))
    explained = explained.numpy()
    layers = [("occupancy", mapper.occupancy, cpu.occupancy),
              ("probabilistic occupancy", mapper.probabilistic_occupancy,
               cpu.probabilistic_occupancy)]
    if mapper.config.baysian_update:
        layers.append(("probability", mapper._prev_prob.cpu().numpy(),
                       cpu._prev_prob.numpy()))
        warped = mapper.previous_grid_prob_transformed
        assert np.array_equal(warped, cpu.previous_grid_prob_transformed), (
            f"{what}: the warped grid differs from the CPU")
    for name, g, c in layers:
        bad = (g != c) & ~explained
        assert not bad.any(), (
            f"{what}: {int(bad.sum())} {name} cells differ from the CPU that no "
            f"differing beam explains ({n_diff} beams differ)")
    return n_diff


def _assert_grid(mapper, what):
    occ = mapper.occupancy
    assert occ.shape == (MAP_SPEC[0], MAP_SPEC[1]) and occ.dtype == np.int32, what
    assert set(np.unique(occ).tolist()) <= {-1, 0, 100}, what
    assert (occ == 100).any() and (occ == 0).any(), f"{what}: no hits or no free cells"
    if mapper.config.baysian_update:
        prob = mapper._prev_prob  # repeated evidence saturates at 0 or 1
        assert bool(((prob >= 0) & (prob <= 1)).all()), f"{what}: probabilities"


def phase_mapping(kernels, device):
    """The mapping slice: a Bayesian 400 x 400 LocalMapper walking the
    S-curve for 30 updates, one 100k-point cloud update, and one call of
    each 64-robot fleet mapper, on cuda, held against the CPU."""
    import torch

    from kompass_core_tpu_torch.datatypes import PointCloudData
    from kompass_core_tpu_torch.mapping import LocalMapper, MapConfig
    from kompass_core_tpu_torch.ops import mapping

    height, width, bins, res = MAP_SPEC
    mapper = LocalMapper(MapConfig(width=width * res, height=height * res,
                                   resolution=res, baysian_update=True),
                         scan_model(), device=device)
    circles = obstacle_circles()
    beam_diffs = []
    for k, pose in enumerate(mapping_poses(MAP_UPDATES)):
        scan = cast_scan(pose, circles, MAP_RAYS)
        state = _mapper_state(mapper) if k in MAP_CPU_UPDATES else None
        before = kernels.scan_to_grid_cells.launches
        mapper.update_from_scan(pose.pose_data(), scan)
        assert kernels.scan_to_grid_cells.launches == before + 1, (
            f"update {k}: {kernels.scan_to_grid_cells.launches - before} K5 launches")
        _assert_grid(mapper, f"update {k}")
        if state is not None:
            beam_diffs.append(_mapper_cpu_check(mapper, state, pose.pose_data(),
                                                scan, f"update {k}"))
    assert mapper._spec == mapping.MapperSpec(height, width, bins, res)
    log(f"mapping slice: {MAP_UPDATES} Bayesian updates of {height}x{width} from "
        f"{MAP_RAYS} rays; CPU-checked updates {list(MAP_CPU_UPDATES)}, beams "
        f"whose table differs between card and CPU {beam_diffs}")

    cloud = LocalMapper(MapConfig(width=width * res, height=height * res,
                                  resolution=res),
                        scan_model(angle_step=2 * np.pi / bins, range_max=10.0,
                                   min_height=-1.0, max_height=1.0),
                        device=device)
    scan = PointCloudData(points=cloud_points(7))
    before = kernels.scan_to_grid_cells.launches
    cloud.update_from_scan(Pose2D(0.0, 0.0, 0.0).pose_data(), scan)
    assert kernels.scan_to_grid_cells.launches == before + 1
    _assert_grid(cloud, "cloud update")
    cloud_diffs = _mapper_cpu_check(cloud, _mapper_state(cloud), Pose2D(
        0.0, 0.0, 0.0).pose_data(), scan, "cloud update")
    log(f"cloud update: {CLOUD_POINTS} points into {height}x{width}/{bins}; "
        f"beams whose table differs between card and CPU {cloud_diffs}")

    spec = mapping.MapperSpec(*MAP_SPEC)
    ranges = _map_ranges(spec, MAP_ROBOTS, 11)
    prev = torch.from_numpy(np.random.default_rng(12).uniform(
        0.05, 0.95, (MAP_ROBOTS, height, width)).astype(np.float32))
    rows = list(MAP_CPU_ROBOTS)
    fleet_diffs = []
    for bayes in (False, True):
        before = kernels.scan_to_grid_cells.launches
        if bayes:
            out = mapping.get_scan_to_grid_bayesian_fleet(spec, device)(
                ranges, prev, *BAYES_SCALARS)
        else:
            out = (mapping.get_scan_to_grid_fleet(spec, device)(ranges),)
        assert kernels.scan_to_grid_cells.launches == before + 1
        if bayes:
            cpu = mapping.get_scan_to_grid_bayesian_fleet(spec, "cpu")(
                ranges[rows], prev[rows], *BAYES_SCALARS)
        else:
            cpu = (mapping.get_scan_to_grid_fleet(spec, "cpu")(ranges[rows]),)
        assert out[0].shape == (MAP_ROBOTS, height, width)
        for j, r in enumerate(rows):
            n_diff, explained = _explained_cells(spec, ranges[r].to(device), ranges[r])
            fleet_diffs.append(n_diff)
            for g, c in zip(out, cpu):
                bad = (g[r].cpu() != c[j]) & ~explained
                assert not bad.any(), f"fleet robot {r}: {int(bad.sum())} cells differ"
    log(f"fleet mappers: {MAP_ROBOTS} robots x {height}x{width}/{bins}, plain and "
        f"Bayesian, one launch each; robots {rows} equal the CPU (beams whose "
        f"table differs: {fleet_diffs})")


def _percentiles(lat):
    lat = sorted(lat)
    return statistics.median(lat), lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]


def phase_mapping_times(kernels, device, card):
    """update_from_scan latency, its host parts, K5 against its plain
    version, and the 64-robot fleet mapper."""
    import torch

    from kompass_core_tpu_torch.mapping import LocalMapper, MapConfig
    from kompass_core_tpu_torch.ops import mapping

    height, width, bins, res = MAP_SPEC
    circles = obstacle_circles()
    poses = mapping_poses(TIMED_WARMUP + MAP_TIMED, stride=1)
    scans = [cast_scan(p, circles, MAP_RAYS) for p in poses]
    for bayes in (True, False):
        mapper = LocalMapper(MapConfig(width=width * res, height=height * res,
                                       resolution=res, baysian_update=bayes),
                             scan_model(), device=device)
        lat = []
        for i, (pose, scan) in enumerate(zip(poses, scans)):
            pose = pose.pose_data()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mapper.update_from_scan(pose, scan)
            torch.cuda.synchronize()
            if i >= TIMED_WARMUP:
                lat.append((time.perf_counter() - t0) * 1e3)
        p50, p99 = _percentiles(lat)
        log(f"update_from_scan ({'Bayesian' if bayes else 'plain'}, {height}x{width}"
            f"/{bins}, {card}): host clock over {len(lat)} updates median "
            f"{p50:.4f} ms, p99 {p99:.4f} ms, min {min(lat):.4f}, max {max(lat):.4f}")

    # the host parts of one update
    def host_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    scan, limit = scans[0], mapper.config.filter_limit
    filtered = np.minimum(limit, np.maximum(0.0, scan.ranges))
    r_host = mapping.resample_scan_uniform(scan.angles, filtered, bins, limit)
    grid = torch.zeros((2, height, width), dtype=torch.int32, device=device)
    parts = {
        "resample_scan_uniform": host_ms(lambda: mapping.resample_scan_uniform(
            scan.angles, filtered, bins, limit)),
        "H2D ranges (14.4 KB)": host_ms(lambda: torch.from_numpy(r_host).to(device)),
        "D2H two int32 grids (1.28 MB)": host_ms(lambda: grid.cpu().numpy()),
    }
    log(f"update_from_scan host parts ({card}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))

    spec = mapping.MapperSpec(*MAP_SPEC)
    results = {}
    for robots in (1, MAP_ROBOTS):
        inputs = [_map_inputs(spec, _map_ranges(spec, robots, 20 + i), device, i)
                  for i in range(MAP_KERNEL_INPUTS)]

        def timed(fn):
            for geo, tables, endpoint, prev, params in inputs[:2]:
                fn(geo.base, geo.dist_m, tables, endpoint, spec.start_cell, prev, params)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for geo, tables, endpoint, prev, params in inputs:
                fn(geo.base, geo.dist_m, tables, endpoint, spec.start_cell, prev, params)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / len(inputs)

        runs = [("plain", timed(kernels.scan_to_grid_cells_reference)),
                ("kernel", timed(kernels.scan_to_grid_cells)),
                ("kernel", timed(kernels.scan_to_grid_cells)),
                ("plain", timed(kernels.scan_to_grid_cells_reference))]
        k_ms = statistics.mean(t for n, t in runs if n == "kernel")
        p_ms = statistics.mean(t for n, t in runs if n == "plain")
        results[robots] = (k_ms, p_ms)
        log(f"scan_to_grid_cells (Bayesian) at {robots} x {height}x{width}/{bins} "
            f"({card}), CUDA events over {MAP_KERNEL_INPUTS} distinct inputs, in "
            f"turns {[f'{n} {t:.5f} ms' for n, t in runs]}: kernel {k_ms:.5f} ms, "
            f"plain {p_ms:.5f} ms")

    ranges = _map_ranges(spec, MAP_ROBOTS, 30).to(device)
    prev = torch.full((MAP_ROBOTS, height, width), 0.6, device=device)
    fleet = mapping.get_scan_to_grid_bayesian_fleet(spec, device)
    lat = []
    for i in range(3 + MAP_FLEET_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        occ, prob = fleet(ranges, prev, *BAYES_SCALARS)
        torch.cuda.synchronize()
        if i >= 3:
            lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = _percentiles(lat)
    log(f"Bayesian fleet mapper, {MAP_ROBOTS} robots x {height}x{width}/{bins}, "
        f"device-resident inputs ({card}): host clock over {len(lat)} calls median "
        f"{p50:.4f} ms, p99 {p99:.4f} ms")
    return results[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs only on a GPU",
              file=sys.stderr)
        return 2
    from kompass_core_tpu_torch.ops import kernels

    device = torch.device("cuda")
    phase_environment(kernels)
    card = card_line()
    phase_build(kernels)
    k1_err = max(phase_kernel_vs_plain(kernels, device),
                 phase_batched_k1(kernels, device))
    k3_err = phase_moving_vs_plain(kernels, device)
    k1_launches = phase_slice(kernels, device)
    k3_launches = phase_fleet(kernels, device)
    k5_err = phase_mapper_kernel_vs_plain(kernels, device)
    kernels.fused_min_dist_sq.launches = 0
    kernels.fused_min_dist_sq_moving.launches = 0
    kernels.scan_to_grid_cells.launches = 0
    phase_mapping(kernels, device)
    k5_launches = kernels.scan_to_grid_cells.launches
    assert kernels.fused_min_dist_sq.launches == 0
    assert kernels.fused_min_dist_sq_moving.launches == 0
    k1_ms, k1_plain_ms = phase_times(kernels, device, card)
    k3_ms, k3_plain_ms = phase_fleet_times(kernels, device, card)
    k5_ms, k5_plain_ms = phase_mapping_times(kernels, device, card)
    assert "jax" not in sys.modules, "the port loaded jax"

    log(card)
    log(json.dumps({"kernels": [
        {"name": "fused_min_dist_sq", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": k1_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fused_min_dist_sq_moving", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": MOVING_REPLACES,
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms},
        {"name": "scan_to_grid_cells", "route": "cuda", "source": MAP_SOURCE,
         "replaces": MAP_REPLACES, "launches": k5_launches,
         "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
