#!/usr/bin/env python3
"""Drive the PyTorch port of the DWA control tick and of the device fleet
tick once on an NVIDIA GPU.

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
6. Times: the single-robot tick latency over 220 ticks; K1 and its plain
   version at the flagship shapes over 100 distinct inputs, in turns; the
   tracked and the static 64-robot fleet tick over 100 ticks each (host
   clock and CUDA events); K3 and its plain version at the fleet shapes
   over 10 distinct inputs, in turns.

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


def cast_scan(state, circles):
    """A 512-ray scan from the robot's pose against the posts and the
    corridor walls (x = +-5); no hit within range gives +inf."""
    from kompass_core_tpu_torch.datatypes import LaserScanData

    angles = np.linspace(-np.pi, np.pi, RAYS, endpoint=False)
    th = state.yaw + angles
    dx, dy = np.cos(th), np.sin(th)
    best = np.full(RAYS, np.inf)
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
    k1_ms, k1_plain_ms = phase_times(kernels, device, card)
    k3_ms, k3_plain_ms = phase_fleet_times(kernels, device, card)
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
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
