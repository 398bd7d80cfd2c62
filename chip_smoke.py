#!/usr/bin/env python3
"""Drive the PyTorch port of the DWA control tick once on an NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with one
CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases (each one asserts; any failure exits non-zero with its traceback):

1. Environment: the card's name and power limit, torch and nvcc versions.
2. Build: compiles the kernels of ``kompass_core_tpu_torch/csrc/`` with
   nvcc for sm_90a into ``build/kompass_core_tpu_torch/`` and prints the
   build time and the compiler's register report.
3. Kernel vs plain version on the card: bit-identical outputs at the
   flagship shapes and at edge shapes.
4. The slice end to end: the flagship DWA (2025 samples x 30 steps,
   512-ray scan, 384 segment slots) through ``DWA.loop_step`` on
   ``cuda`` for 60 closed-loop ticks in drop mode and 10 in truncate mode;
   every tick launches the kernel exactly once and agrees with the same
   packed input solved by the port on the CPU.
5. Times: tick latency over 220 ticks, kernel and plain-version time at
   the flagship shapes over 100 distinct inputs, in turns.

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

KERNEL_SOURCE = "kompass_core_tpu_torch/csrc/fused_min_dist.cu"
KERNEL_REPLACES = "kompass_core_tpu/ops/pallas_kernels.py:89"


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
    max_err = phase_kernel_vs_plain(kernels, device)
    launches = phase_slice(kernels, device)
    k_ms, p_ms = phase_times(kernels, device, card)
    assert "jax" not in sys.modules, "the port loaded jax"

    log(card)
    log(json.dumps({"kernels": [{
        "name": "fused_min_dist_sq", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
