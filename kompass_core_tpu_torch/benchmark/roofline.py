"""Roofline / limit analysis of the named reference workloads on the H100.

Counterpart of ``kompass_core_tpu/benchmark/roofline.py``: the same
function names and the same ``build(measured)`` schema, each workload's
floor stated so that its measured time carries ``pct_of_roofline``. The
constants are the H100's (NVIDIA's data sheet, SXM part, at 700 W):

* FP32 outside the tensor cores: 67e12 FLOP/s counts an FMA as two
  operations; the port's kernels round every operation on its own (no
  FMA), so each operation is one instruction, at half that rate.
* HBM3: 3.35e12 B/s.

The counts are the port's own implementation's, not the JAX package's:
the mapper's floor is K5's per-cell pass (``csrc/scan_to_grid.cu``,
``cells_bound``), where the JAX package counts its MXU one-hot lookup;
the point-cloud binning is a scatter-min of each point once
(``ops/mapping._bin_min``), where the JAX package counts a dense
(point, bin) pass. A floor is the larger of the operations at
``FP32_OPS_PER_S`` and each input's and output's bytes, once, at
``HBM_BYTES_PER_S``; pct_of_roofline = floor / measured.

``bound``, ``sweep_bound``, ``cells_bound``, ``form_bound`` and
``goal_bound`` are the
floors ``chip_smoke.py`` sets beside every kernel's time: they give every
``bound_ms`` of its kernels line, so an edit to them or to the peaks
changes that yardstick and is reviewed as such
(``tests/test_torch_benchmark.py`` pins the peaks and two bounds).

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.roofline
--device cuda`` (it measures the workloads with ``runner.py``,
``device_loop.py`` and ``kernel_bench.py`` and prints the JSON; it writes
no file).
"""

from __future__ import annotations

import json

import torch

# the card's peaks: FP32 operations/s outside the tensor cores, one
# instruction per operation, and HBM bytes/s
FP32_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12

# FP32 operations per point of ``ops/mapping.pointcloud_to_scan`` (a
# transcendental counted as one): the radius, the z and origin filters,
# the angle and its bin, the distance and the bin's min
CLOUD_OPS_PER_POINT = 20
# FP32 operations per beam of ``ops/critical_zone.critical_zone_check``:
# the beam in the body frame, its distance, the slowdown factor, the
# cone and finite masks and the min
ZONE_OPS_PER_BEAM = 20


def bound(ops, nbytes):
    """(the least ms the card could take, what bounds it): the larger of
    ops at FP32_OPS_PER_S and bytes at HBM_BYTES_PER_S."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sweep_bound(px, rows, active, segments=0, moving=False):
    """The bound of a direct-form sweep (K1, K3) of [B, S, T] points
    (``px``) against ``rows`` obstacle rows and ``segments`` segment rows
    per robot, active steps [B] (``active``): 6 FP32 operations per active
    (point, row) pair (2 sub, 2 mul, add, min), and in the moving sweep 4
    per (robot, active step, obstacle row) to move the row; bytes: points,
    rows (and velocities), two outputs per point, once each."""
    B, S, T = (1, *px.shape) if px.dim() == 2 else px.shape
    steps = float(active.clamp(max=T).sum()) if active.dim() else float(min(int(active), T))
    pairs = steps * S * (rows + segments)
    ops = 6.0 * pairs + (4.0 * steps * rows if moving else 0.0)
    nbytes = 4.0 * (2 * B * S * T + B * (2 * rows * (2 if moving else 1) + 2 * segments)
                    + 2 * B * S * T)
    return bound(ops, nbytes)


# FP32 operations per (sample, segment point) pair of the goal cost's
# search (K10): 2 sub, 2 mul and an add for the squared distance, the min
# and the select of its index
GOAL_PAIR_OPS = 7


def goal_bound(robots, samples, segments):
    """The bound of K10, the goal cost's nearest-segment search of
    ``robots`` robots' ``samples`` end points against ``segments`` points
    each: GOAL_PAIR_OPS per (sample, point) pair; bytes: the end points
    and segment points read once, each sample's min (4 bytes) and index
    (8) written once."""
    ops = GOAL_PAIR_OPS * robots * samples * segments
    return bound(ops, robots * (8.0 * samples + 8.0 * segments + 12.0 * samples))


def cells_bound(robots, height, width, bins, bayes=True):
    """The bound of the mapper's per-cell pass: bytes per robot and cell
    (endpoint flag, occupancy, and in the Bayesian form the previous and
    new probability), per cell (nearest bin, distance) and per beam (its
    16-byte table row; the bounds are the call's own scratch); operations:
    the 5 line tests (4 mul, 2 add, 3 compares each) per robot and cell."""
    cells = height * width
    nbytes = robots * cells * (1 + 4 + (8 if bayes else 0)) + cells * 8 + robots * bins * 16
    return bound(45.0 * robots * cells, nbytes)


def form_bound(px, rows, active, segments, pair_ops, seg_ops, row_ops=0.0,
               moving=False, fields=2):
    """The bound of a sweep of [B, S, T] points against ``rows`` obstacle
    and ``segments`` segment rows per robot, active steps [B]: FP32
    instructions per active (point, obstacle row) pair (``pair_ops``), per
    (point, segment row) pair (``seg_ops``) and per (robot, active step,
    obstacle row) (``row_ops``: the moving forms' prefix), an FMA one
    instruction; bytes as ``sweep_bound``, with ``fields`` outputs per
    point (K4 one)."""
    B, S, T = px.shape
    steps = float(active.clamp(max=T).sum())
    ops = steps * S * (pair_ops * rows + seg_ops * segments) + row_ops * steps * rows
    nbytes = 4.0 * (2 * B * S * T + B * (2 * rows * (2 if moving else 1) + 2 * segments)
                    + fields * B * S * T)
    return bound(ops, nbytes)


def _points(*shape):
    """A [.., S, T] point tensor's shape, for the bounds (no storage)."""
    return torch.empty(shape, device="meta")


def _pct(floor_ms, measured_ms):
    return 100.0 * floor_ms / measured_ms


def cost_evaluator_5k(measured_ms: float) -> dict:
    """CostEvaluator_5k_Trajs (benchmark_runner.cpp:150-185): 5001 GIVEN
    trajectories x 1000 points, 4 costs, straight 10 m path @ 1 cm
    (segment padded to 1024). Dominant work: K1's two sweeps, the
    segment field against 1024 rows and the obstacle field against its
    one pad row (``ops/solver.evaluate_trajectory_costs``), 6 operations
    per pair; the costs after it are O(S*T)."""
    S, T, G = 5001, 1000, 1024
    floor_ms, by = sweep_bound(_points(S, T), 1, torch.tensor(T), segments=G)
    return {
        "name": "CostEvaluator_5k_Trajs",
        "measured_ms": measured_ms,
        "bound": f"FP32 {by} (K1: 5.13e9 point-row pairs)",
        "sweep_ops": 6.0 * S * T * (G + 1),
        "compute_floor_ms": 6.0 * S * T * (G + 1) / FP32_OPS_PER_S * 1e3,
        "memory_floor_ms": 4.0 * (4 * S * T + 2 + 2 * G) / HBM_BYTES_PER_S * 1e3,
        "pct_of_roofline": _pct(floor_ms, measured_ms),
        "verdict": "the floor counts K1's pairs; every other pass is O(S*T)",
    }


def _mapper(name, measured_ms, bayes):
    floor_ms, by = cells_bound(1, 400, 400, 3600, bayes=bayes)
    cells = 400 * 400
    return {
        "name": name,
        "measured_ms": measured_ms,
        "bound": (f"{by}: K5's per-cell pass over 1.6e5 cells (5 line"
                  " tests each), the beam side O(3600)"),
        "compute_floor_ms": 45.0 * cells / FP32_OPS_PER_S * 1e3,
        "memory_floor_ms": bound(0, cells * (1 + 4 + (8 if bayes else 0))
                                 + cells * 8 + 3600 * 16)[0],
        "pct_of_roofline": _pct(floor_ms, measured_ms),
        "verdict": ("the floor counts K5's per-cell pass; the beam side"
                    " before it is O(3600)"),
    }


def mapper_dense(measured_ms: float) -> dict:
    """Mapper_Dense_400x400 (benchmark_runner.cpp:187-218): 3600-ray scan
    -> 400x400 grid @ 0.05 m. The floor is K5's per-cell pass
    (``cells_bound``, plain form), where the JAX package counts its
    one-hot lookup on the MXU."""
    return _mapper("Mapper_Dense_400x400", measured_ms, bayes=False)


def mapper_bayesian(measured_ms: float) -> dict:
    """Mapper_Bayesian_400x400: the same per-cell pass with the Bayes
    update, which reads the previous and writes the new probability per
    cell (``cells_bound``, Bayesian form)."""
    return _mapper("Mapper_Bayesian_400x400", measured_ms, bayes=True)


def _bin_min_floor_ms(n_points: int, num_bins: int) -> float:
    """``ops/mapping.pointcloud_to_scan``: each point's 12 bytes read once
    and its CLOUD_OPS_PER_POINT operations, the bin-min a scatter-min of
    each point into its bin (no (point, bin) pass), the bins written."""
    return bound(CLOUD_OPS_PER_POINT * n_points, 12 * n_points + 4 * num_bins)[0]


def critical_zone_100k(measured_ms: float) -> dict:
    """CriticalZone_100k_Cloud (benchmark_runner.cpp:267-311): 100k-point
    cloud -> 3600-bin min ranges -> masked slowdown-factor min. The floor
    is the binning's (``_bin_min_floor_ms``) plus the scan check's."""
    N, B = 100_000, 3600
    binning_floor_ms = _bin_min_floor_ms(N, B)
    check_floor_ms = bound(ZONE_OPS_PER_BEAM * B, 13 * B + 4)[0]
    floor_ms = binning_floor_ms + check_floor_ms
    return {
        "name": "CriticalZone_100k_Cloud",
        "measured_ms": measured_ms,
        "bound": "bytes: the cloud read once, binned by a scatter-min",
        "binning_floor_ms": binning_floor_ms,
        "memory_floor_ms": bound(0, 12 * N + 4 * B)[0],
        "pct_of_roofline": _pct(floor_ms, measured_ms),
        "verdict": ("the floor counts the cloud's bytes, binned by one"
                    " scatter-min per point, and the 3600-beam check"),
    }


def mapper_pointcloud(measured_ms: float) -> dict:
    """Mapper_PointCloud_100k (benchmark_runner.cpp:227-265): 100k cloud
    -> 3600-bin scan -> Mapper_Dense grid update. The floor is the sum of
    the two stages' floors (they share no work)."""
    N, B = 100_000, 3600
    binning_floor_ms = _bin_min_floor_ms(N, B)
    dense_floor_ms = cells_bound(1, 400, 400, B, bayes=False)[0]
    return {
        "name": "Mapper_PointCloud_100k",
        "measured_ms": measured_ms,
        "bound": "the binning's bytes + K5's per-cell pass, sequential stages",
        "binning_floor_ms": binning_floor_ms,
        "grid_stage_floor_ms": dense_floor_ms,
        "pct_of_roofline": _pct(binning_floor_ms + dense_floor_ms, measured_ms),
        "verdict": "the stages are data-dependent, so they cannot overlap",
    }


def critical_zone_dense(measured_device_us: float,
                        measured_dispatch_ms: float) -> dict:
    """CriticalZone_Dense_Scan (benchmark_runner.cpp:313-376): 3600 rays
    in the slowdown band. ZONE_OPS_PER_BEAM operations per beam and each
    beam's range, trig and cone mask read once: a few nanoseconds of
    work, far under a launch. pct_of_roofline is against the device time
    per check from the device loop (``measured_device_us``), beside the
    per-dispatch time (``measured_dispatch_ms``)."""
    R = 3600
    compute_floor_us = 1e6 * ZONE_OPS_PER_BEAM * R / FP32_OPS_PER_S
    memory_floor_us = 1e6 * (13 * R + 4) / HBM_BYTES_PER_S
    return {
        "name": "CriticalZone_Dense_Scan",
        "measured_device_us": measured_device_us,
        "measured_dispatch_ms": measured_dispatch_ms,
        "bound": "bytes (0.014 us) over FP32 (0.002 us)",
        "compute_floor_us": compute_floor_us,
        "memory_floor_us": memory_floor_us,
        "pct_of_roofline": 100.0 * max(compute_floor_us, memory_floor_us)
        / measured_device_us,
        "verdict": ("the floor is nanoseconds: the device time per check"
                    " is what surrounds the work (its launches), not the"
                    " work; the fleet tick's safety gate runs it inside a"
                    " larger program"),
    }


def dwa_sweep(measured_ms_per_batch: float) -> dict:
    """K1 at the fleet solver's shape: 64 robots x 2025 x 30 points
    against 512 obstacle and 384 segment rows (``sweep_bound``)."""
    B, S, T = 64, 2025, 30
    floor_ms, by = sweep_bound(_points(B, S, T), 512, torch.full((B,), T), segments=384)
    return {
        "name": "DWA_sweep_batch64",
        "measured_ms": measured_ms_per_batch,
        "bound": f"FP32 {by} (K1: obstacle + segment sweeps)",
        "sweep_ops": 6.0 * B * S * T * (512 + 384),
        "compute_floor_ms": floor_ms,
        "memory_floor_ms": bound(0, 4.0 * (4 * B * S * T + B * 2 * (512 + 384)))[0],
        "pct_of_roofline": _pct(floor_ms, measured_ms_per_batch),
        "verdict": "the floor counts K1's pairs at 6 operations each",
    }


def build(measured: dict) -> dict:
    return {
        "assumptions": {
            "fp32_ops_s": FP32_OPS_PER_S,
            "hbm_bytes_s": HBM_BYTES_PER_S,
            "note": (
                "NVIDIA H100 SXM data sheet at 700 W; floors are the"
                " port's own implementation's (operations it must execute,"
                " bytes it must move once), so pct_of_roofline ~100 means"
                " no headroom without an algorithm change"
            ),
        },
        "workloads": [
            cost_evaluator_5k(measured["CostEvaluator_5k_Trajs"]),
            mapper_dense(measured["Mapper_Dense_400x400"]),
            mapper_bayesian(measured["Mapper_Bayesian_400x400"]),
            mapper_pointcloud(measured["Mapper_PointCloud_100k"]),
            critical_zone_100k(measured["CriticalZone_100k_Cloud"]),
            critical_zone_dense(
                measured["CriticalZone_Dense_device_us"],
                measured["CriticalZone_Dense_dispatch_ms"],
            ),
            dwa_sweep(measured["DWA_sweep_batch64"]),
        ],
    }


def measure(device) -> dict:
    """The measured inputs of ``build`` on ``device``: the runner's slope
    medians, the dense check's device time per iteration from the device
    loop, K1's time at 64 robots from ``kernel_bench``."""
    from .device_loop import (
        dense_zone_variants,
        make_critical_zone_device_loop,
        measure_device_loop,
    )
    from .kernel_bench import bench_sweeps
    from .runner import BenchmarkRunner

    runner = BenchmarkRunner(device)
    runner.run_all()
    measured = {r["name"]: r["p50_ms"] for r in runner.results}
    zone, variants = dense_zone_variants(8, device)
    loop = measure_device_loop(
        "CriticalZone_Dense_device_loop",
        lambda k: make_critical_zone_device_loop(zone, k, device),
        variants, ks=(16, 1024), repeats=3)
    measured["CriticalZone_Dense_device_us"] = 1e3 * loop["p50_ms"]
    measured["CriticalZone_Dense_dispatch_ms"] = measured["CriticalZone_Dense_Scan"]
    measured["DWA_sweep_batch64"] = bench_sweeps(device)["xla_two_sweeps_ms"]
    return measured


def main(device):
    out = build(measure(device))
    out["device"] = str(device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    main(parse_device_args(argparse.ArgumentParser(description=__doc__))[0])
