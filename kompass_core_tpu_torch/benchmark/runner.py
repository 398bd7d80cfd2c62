"""Benchmark runner with reference-schema JSON output.

Counterpart of ``kompass_core_tpu/benchmark/runner.py`` (role of the
reference's ``benchmarks/benchmark_common.h`` ``measure_performance`` +
``benchmark_runner.cpp`` workloads + ``plot_benchmarks.py``): timed
workloads emitting machine-readable JSON per benchmark and platform, on
an explicit ``torch.device``. Workloads mirror the reference's named
benchmarks at the same sizes:

  * CostEvaluator_5k_Trajs  — 5001 trajectories x 1000 points, 4 costs
  * Mapper_Dense_400x400    — 3600-ray scan -> 400x400 grid @ 0.05 m
  * Mapper_PointCloud_100k  — 100k-point cloud -> scan -> grid
  * CriticalZone_100k_Cloud — safety factor over a 100k cloud
  * CriticalZone_Dense_Scan — 3600 rays in the slowdown band
  * DWA_2025x30             — full solve, BASELINE workload
  * DWA_LargeBatch_65k      — 255 x 255 samples x 30 steps (BASELINE 4)
  * DWA_Fleet_64            — 64 scenarios per ``make_fleet_solver`` call

Every workload is slope-timed as in the JAX package: chains of
dispatches, one distinct device-resident input each, the chain ended by
a ``.item()`` of its last output (which waits for the card). Every
variant is made on the host from the JAX runner's numpy seed and copied
to the device once, and the device is synchronised, before anything is
timed. On the card the DWA workloads and the evaluator launch K1 once
per dispatch and the mappers K5.

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.runner
--device cuda [--out PATH] [--repeats N]``: it prints the JSON payload
and writes it to PATH only when given one.
"""

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def measure_performance(
    name: str,
    workload: Callable[[], None],
    warmup: int = 2,
    runs: int = 10,
) -> Dict:
    """Time a workload (role of ``benchmark_common.h`` measure_performance).

    The workload must block until device completion.
    """
    for _ in range(warmup):
        workload()
    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        workload()
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    return {
        "name": name,
        "runs": runs,
        "mean_ms": statistics.fmean(samples),
        "min_ms": samples[0],
        "p50_ms": samples[len(samples) // 2],
        "p99_ms": samples[min(len(samples) - 1, int(len(samples) * 0.99))],
    }


def slope_variants_needed(n_lo: int = 10, n_hi: int = 30) -> int:
    """Distinct inputs measure_throughput_slope consumes: one per
    dispatch across warmup (1), the cache-settling chain (min(5, n_lo)),
    and both timed chains (n_lo + n_hi)."""
    return 1 + min(5, n_lo) + n_lo + n_hi


def measure_throughput_slope(
    name: str,
    dispatch: Callable,
    variants: List,
    fetch: Callable,
    n_lo: int = 10,
    n_hi: int = 30,
    sync: Optional[Callable[[], None]] = None,
) -> Dict:
    """Marginal time per dispatch from chains of DISTINCT inputs.

    Times a chain of ``n_lo`` and one of ``n_hi`` dispatches and reports
    the slope, so the fixed cost of a chain (the final fetch, the first
    enqueue) cancels. EVERY dispatch — warmup and both timed chains —
    consumes its own variant via one running iterator. ``variants``: >=
    ``slope_variants_needed(n_lo, n_hi)`` distinct device-resident
    inputs. ``dispatch(v) -> out``; ``fetch(out)`` must pull a value to
    host; ``sync``, when given, runs before each chain's clock starts
    (the card idle at every start).
    """
    needed = slope_variants_needed(n_lo, n_hi)
    assert len(variants) >= needed, (
        f"need {needed} distinct inputs (one per dispatch across warmup"
        f" + both chains), got {len(variants)}"
    )
    it = iter(variants)
    fetch(dispatch(next(it)))  # warm

    def chain(n):
        vs = [next(it) for _ in range(n)]
        if sync is not None:
            sync()
        t0 = time.perf_counter()
        outs = [dispatch(v) for v in vs]
        fetch(outs[-1])
        return time.perf_counter() - t0

    chain(min(5, n_lo))
    t_lo, t_hi = chain(n_lo), chain(n_hi)
    ms = max((t_hi - t_lo) / (n_hi - n_lo) * 1e3, 1e-9)
    return {
        "name": name,
        "runs": n_hi - n_lo,
        "mean_ms": ms,
        "min_ms": ms,
        "p50_ms": ms,
        "p99_ms": ms,
        "method": "slope",
    }


def platform_name(device) -> str:
    """The device's type and name, e.g. ``cuda_NVIDIA_H100_80GB_HBM3``."""
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    return f"{device.type}_{kind}".replace(" ", "_")


def resident(tensors, device):
    """Wait until every tensor copied to ``device`` is there."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return tensors


def heavy_samples(S, T, dt=0.01, v1=1.0, max_fluct=0.5):
    """CostEvaluator_5k_Trajs's sample set (``benchmark_runner.cpp:36-148``):
    a straight centre trajectory and pairs with a sinusoidal linear or
    angular fluctuation, as numpy (px [S, T], py [S, T], vels [S, T-1, 3])."""
    i = np.arange(T, dtype=np.float32)
    fl = np.sin(2.0 * np.pi * i / T).astype(np.float32)
    k = np.arange(S)
    amp = max_fluct / max((S - 1) // 2, 1)
    a = (((k + 1) // 2) * amp).astype(np.float32)[:, None]
    odd = (k % 2 == 1)[:, None]  # linear-fluctuation samples
    ang = ((k % 2 == 0) & (k > 0))[:, None]  # angular-fluctuation samples
    px = np.broadcast_to(np.float32(dt * v1) * i, (S, T)).copy()
    py = np.where(odd, np.float32(dt) * (a * fl) * i, 0.0).astype(np.float32)
    vx = np.full((S, T - 1), v1, np.float32)
    vy = np.where(odd, a * fl[:-1], 0.0).astype(np.float32)
    w = np.where(ang, a * fl[:-1], 0.0).astype(np.float32)
    return px, py, np.stack([vx, vy, w], axis=-1)


def evaluator_inputs(device, S=5001, T=1000):
    """(params on ``device``, the evaluator's 12 array arguments as numpy)
    of CostEvaluator_5k_Trajs (``benchmark_runner.cpp:150-185``): S given
    trajectories x T points at dt 0.01 (``heavy_samples``), a straight
    10 m path at 1 cm padded to 1024 slots, 4 costs {path, goal,
    smoothness, jerk} at weight 1, no obstacles (one 128-row pad block,
    count 0)."""
    from ..ops.solver import SolverParams

    G = 1024
    s = 0.01 * np.arange(1001, dtype=np.float32)
    seg_x = np.full(G, 1e8, np.float32)
    seg_y = np.full(G, 1e8, np.float32)
    seg_arc = np.zeros(G, np.float32)
    seg_x[:1001], seg_y[:1001], seg_arc[:1001] = s, 0.0, s
    params = SolverParams.create(
        time_step=0.01,
        robot_radius=0.3,
        collision_margin=0.05,
        weights={
            "reference_path_distance_weight": 1.0,
            "goal_distance_weight": 1.0,
            "obstacles_distance_weight": 0.0,
            "smoothness_weight": 1.0,
            "jerk_weight": 1.0,
        },
        acc_limits=(3.0, 3.0, 3.0),
        max_obstacles_dist=10.0 / 3,
        device=device,
    )
    obs = np.full((128, 2), 1e8, np.float32)
    return params, [*heavy_samples(S, T), obs, np.int32(0), seg_x, seg_y, seg_arc,
                    np.int32(1001), np.float32(10.0), np.float32(10.0), np.int32(T)]


def zone_spec():
    """The reference benchmark's critical zone (``benchmark_runner.cpp:
    267-376``): cylinder r = 0.51, 160 degree cone, 0.3 / 0.6 m zones over
    3600 beams starting at 0."""
    from ..ops.critical_zone import build_critical_zone

    angles = np.arange(0.0, 2 * np.pi, 2 * np.pi / 3600)
    return build_critical_zone(
        "CYLINDER", [0.51, 1.0], (0, 0, 0), (0, 0, 0, 1),
        160.0, 0.3, 0.6, angles,
    )


def zone_cloud(rng, n=100_000):
    """The critical-zone benchmark's 100k cloud at 0.9-9.9 m."""
    r = rng.uniform(0.9, 9.9, n)
    a = rng.uniform(0, 2 * np.pi, n)
    return np.stack(
        [r * np.cos(a), r * np.sin(a), rng.uniform(-0.4, 0.4, n)], axis=1
    ).astype(np.float32)


def mapper_spec():
    """The reference benchmark's grid: 400 x 400 @ 0.05 m from 3600 rays."""
    from ..ops.mapping import MapperSpec

    return MapperSpec(grid_height=400, grid_width=400, num_bins=3600,
                      resolution=0.05)


def dwa_spec(n_vx, n_omega, max_points, scan, seg):
    """The spec of the runner's DWA workloads: n_vx x n_omega samples,
    ``max_points`` steps, ``scan`` rays, ``seg`` segment slots."""
    from ..ops.solver import SolverSpec

    return SolverSpec(
        is_omni=False,
        n_vx=n_vx,
        n_vy=1,
        n_omega=n_omega,
        max_points=max_points,
        # control horizon matches the BASELINE flagship spec
        # (benchmark/baseline.py num_ctrl_points=6)
        num_ctrl_points=6,
        scan_size=scan,
        seg_size=seg,
        drop_samples=True,
    )


def dwa_variants(spec, n):
    """``n`` packed buffers of the runner's DWA scenario for ``spec``
    (the JAX runner's, from ``default_rng(0)``), variant k with the
    robot's x moved by 1e-4 k."""
    from ..models import AngularCtrlLimits, LinearCtrlLimits, RobotCtrlLimits
    from ..ops.solver import pack_solver_input, packed_input_size
    from ..ops.window import sample_velocity_window

    scan, seg, max_points = spec.scan_size, spec.seg_size, spec.max_points
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0),
    ).to_array()
    limits[3:6] = 0.0
    rng = np.random.default_rng(0)
    n_seg = seg - 8
    s = np.linspace(0, 10.0, n_seg).astype(np.float32)
    seg_x = np.full(seg, 1e8, np.float32)
    seg_y = np.full(seg, 1e8, np.float32)
    seg_arc = np.zeros(seg, np.float32)
    seg_x[:n_seg] = s
    seg_arc[:n_seg] = s
    seg_y[:n_seg] = 0.0
    ranges = rng.uniform(2.0, 9.0, scan)
    ang = np.linspace(-np.pi, np.pi, scan, endpoint=False)
    obs = np.stack(
        [ranges * np.cos(ang), ranges * np.sin(ang)], axis=1
    ).astype(np.float32)
    window = sample_velocity_window(
        (0.5, 0.0, 0.0), limits, 0.1, spec.n_vx, spec.n_vy, spec.n_omega,
        False,
    )
    params = np.array(
        [0.1, 0.3, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0, 3.0, 10 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec), np.float32)
    pack_solver_input(
        spec, buf, params, (0.0, 0.0, 0.0), window, obs, scan,
        seg_x, seg_y, seg_arc, n_seg, float(s[-1]), 10.0, max_points,
    )
    variants = []
    for k in range(n):
        v = buf.copy()
        v[0] += 1e-4 * k
        variants.append(v)
    return variants


class BenchmarkRunner:
    """Builds and runs the reference-equivalent workload suite on
    ``device``; ``platform`` defaults to the device's type and name."""

    def __init__(self, device, platform: Optional[str] = None):
        self.device = torch.device(device)
        self.platform = platform or platform_name(self.device)
        self.results: List[Dict] = []

    def _to_device(self, arrays):
        return resident([torch.as_tensor(a).to(self.device) for a in arrays],
                        self.device)

    def _sync(self):
        resident((), self.device)

    def _slope(self, name, dispatch, variants, fetch):
        return measure_throughput_slope(name, dispatch, variants, fetch,
                                        sync=self._sync)

    # --- workload builders ---

    def _dwa_workload(self, n_vx, n_omega, max_points, scan, seg, label):
        """(packed solver on the device, its distinct resident variants):
        the JAX runner's scenario, variant k with the robot's x moved by
        1e-4 k."""
        from ..ops.solver import get_packed_dwa_solver

        spec = dwa_spec(n_vx, n_omega, max_points, scan, seg)
        solver = get_packed_dwa_solver(spec, self.device)
        return solver, self._to_device(
            dwa_variants(spec, slope_variants_needed())
        )

    def bench_cost_evaluator_5k(self):
        """The reference's exact CostEvaluator_5k_Trajs workload
        (``benchmark_runner.cpp:36-185``, ``evaluator_inputs``): 5001
        GIVEN trajectories x 1000 points (center path + sinusoidal
        linear/angular fluctuation pairs), straight 10 m path interpolated
        at 1 cm, 4 active costs {path, goal, smoothness, jerk} = 1.0, NO
        obstacles — evaluated by the standalone evaluator
        (``get_cost_evaluator``); variant k's ref_total_len is 10 + 1e-4 k."""
        from ..ops.solver import get_cost_evaluator

        params, arrays = evaluator_inputs(self.device)
        ev = get_cost_evaluator(self.device, with_obstacles=False)
        args = self._to_device(arrays)
        variants = self._to_device([
            np.float32(10.0 + 1e-4 * k) for k in range(slope_variants_needed())
        ])
        self.results.append(
            self._slope(
                "CostEvaluator_5k_Trajs",
                lambda rtl: ev(params, *args[:10], rtl, args[11]),
                variants,
                lambda res: res.cost.item(),
            )
        )

    def bench_dwa_baseline(self):
        solver, variants = self._dwa_workload(
            45, 45, 30, 512, 384, "baseline"
        )
        self.results.append(
            self._slope("DWA_2025x30", solver, variants, lambda o: o[1].item())
        )

    def bench_dwa_large_batch(self):
        """BASELINE config 4: large-batch sampling, 65,025 trajectories
        (255 x 255 velocity grid) x 30 steps with on-device cost
        reduction + argmin."""
        solver, variants = self._dwa_workload(
            255, 255, 30, 512, 384, "large"
        )
        self.results.append(
            self._slope("DWA_LargeBatch_65k", solver, variants,
                        lambda o: o[1].item())
        )

    def bench_fleet(self, batch=64):
        """``batch`` BASELINE scenarios (``baseline.build_scenario``) per
        ``make_fleet_solver`` call; variant k moves every robot's x by
        1e-4 k."""
        from ..parallel.fleet import make_fleet_solver
        from .baseline import build_scenario, build_spec

        spec = build_spec()
        rng = np.random.default_rng(0)
        solver = make_fleet_solver(spec, self.device)
        base = np.stack([build_scenario(spec, rng, i) for i in range(batch)])
        variants = []
        for k in range(slope_variants_needed()):
            v = base.copy()
            v[:, 0] += 1e-4 * k
            variants.append(v)
        r = self._slope(
            f"DWA_Fleet_{batch}",
            solver,
            self._to_device(variants),
            lambda o: o[0, 1].item(),
        )
        r["solves_per_s"] = batch / (r["mean_ms"] / 1e3)
        self.results.append(r)

    def bench_mapper_dense(self):
        """3600 rays -> 400x400 grid @ 0.05 m
        (reference ``benchmark_runner.cpp:187-218``)."""
        from ..ops.mapping import get_scan_to_grid

        rng = np.random.default_rng(0)
        fn = get_scan_to_grid(mapper_spec(), self.device)
        variants = self._to_device([
            rng.uniform(0.5, 9.9, 3600).astype(np.float32)
            for _ in range(slope_variants_needed())
        ])
        self.results.append(
            self._slope("Mapper_Dense_400x400", fn, variants,
                        lambda o: int(o[0, 0].item()))
        )

    def bench_mapper_pointcloud(self):
        """100k-point cloud -> laserscan -> grid
        (reference ``benchmark_runner.cpp:227-265``); variant k is the
        cloud shifted by 1e-5 k, one add on the device before timing."""
        from ..ops.mapping import get_pointcloud_to_scan, get_scan_to_grid

        spec = mapper_spec()
        rng = np.random.default_rng(0)
        n = 100_000
        r = rng.uniform(0.5, 9.9, n)
        a = rng.uniform(0, 2 * np.pi, n)
        pts = np.stack(
            [r * np.cos(a), r * np.sin(a), rng.uniform(-0.5, 0.5, n)], axis=1
        ).astype(np.float32)
        to_scan = get_pointcloud_to_scan(spec.num_bins, self.device)
        to_grid = get_scan_to_grid(spec, self.device)
        (pts_dev,) = self._to_device([pts])
        variants = resident(
            [pts_dev + float(np.float32(1e-5 * k)) for k in range(slope_variants_needed())],
            self.device,
        )
        self.results.append(
            self._slope(
                "Mapper_PointCloud_100k",
                lambda p: to_grid(to_scan(p, 10.0, -1.0, 1.0)),
                variants,
                lambda o: int(o[0, 0].item()),
            )
        )

    def bench_mapper_bayesian(self):
        """Bayesian 400x400 update (reference CPU-side
        ``Mapper_Dense_400x400`` variant: Bayesian,
        ``benchmark_runner.cpp:187-218``) — inverse sensor model +
        previous-grid fusion, same 3600-ray scan."""
        from ..ops.mapping import get_scan_to_grid_bayesian
        from .device_loop import BAYES_BENCH_SCALARS

        rng = np.random.default_rng(0)
        fn = get_scan_to_grid_bayesian(mapper_spec(), self.device)
        (prev,) = self._to_device([np.full((400, 400), 0.5, np.float32)])
        scalars = tuple(np.float32(v) for v in BAYES_BENCH_SCALARS)
        variants = self._to_device([
            rng.uniform(0.5, 9.9, 3600).astype(np.float32)
            for _ in range(slope_variants_needed())
        ])
        self.results.append(
            self._slope(
                "Mapper_Bayesian_400x400",
                lambda r: fn(r, prev, *scalars),
                variants,
                lambda o: o[1][0, 0].item(),
            )
        )

    def bench_critical_zone_cloud(self):
        """100k cloud safety factor (reference
        ``benchmark_runner.cpp:267-311``): cylinder r=0.51, 160 deg cone,
        0.3/0.6 m zones; variant k is the cloud shifted by 1e-5 k."""
        from ..ops.critical_zone import get_critical_zone_checker_cloud

        fn = get_critical_zone_checker_cloud(zone_spec(), self.device)
        (pts_dev,) = self._to_device([zone_cloud(np.random.default_rng(0))])
        variants = resident(
            [pts_dev + float(np.float32(1e-5 * k)) for k in range(slope_variants_needed())],
            self.device,
        )
        self.results.append(
            self._slope(
                "CriticalZone_100k_Cloud",
                lambda p: fn(p, True, 20.0, -1.0, 1.0),
                variants,
                lambda o: o.item(),
            )
        )

    def bench_critical_zone_dense(self):
        """3600 rays forced into the slowdown band 0.81-1.11 m (reference
        ``benchmark_runner.cpp:313-376`` worst case)."""
        from ..ops.critical_zone import get_critical_zone_checker

        rng = np.random.default_rng(0)
        fn = get_critical_zone_checker(zone_spec(), self.device)
        variants = self._to_device([
            rng.uniform(0.81, 1.11, 3600).astype(np.float32)
            for _ in range(slope_variants_needed())
        ])
        self.results.append(
            self._slope(
                "CriticalZone_Dense_Scan",
                lambda r: fn(r, True),
                variants,
                lambda o: o.item(),
            )
        )

    # --- suite ---

    def run_all(self):
        self.bench_dwa_baseline()
        self.bench_dwa_large_batch()
        self.bench_fleet()
        self.bench_cost_evaluator_5k()
        self.bench_mapper_dense()
        self.bench_mapper_bayesian()
        self.bench_mapper_pointcloud()
        self.bench_critical_zone_cloud()
        self.bench_critical_zone_dense()
        return self.results

    def run_repeated(self, repeats: int = 5):
        """Run the suite ``repeats`` times and keep, per workload, the
        MEDIAN slope estimate (plus every raw estimate under
        ``estimates_ms``). A slope estimate's noise is two-sided:
        interference in the long chain inflates it, in the short chain
        deflates it; the median is robust to both."""
        all_runs: List[List[Dict]] = []
        for _ in range(max(1, repeats)):
            self.results = []
            self.run_all()
            all_runs.append(self.results)
        merged = []
        for i in range(len(all_runs[0])):
            names = {run[i]["name"] for run in all_runs}
            assert len(names) == 1, (
                f"pass results diverged at index {i}: {sorted(names)} — "
                "workloads must be identical across repeats"
            )
            ests = sorted(run[i]["p50_ms"] for run in all_runs)
            med = ests[len(ests) // 2] if len(ests) % 2 else statistics.median(ests)
            rec = dict(min(
                (run[i] for run in all_runs),
                key=lambda r: abs(r["p50_ms"] - med),
            ))
            rec["p50_ms"] = rec["mean_ms"] = med
            rec["estimates_ms"] = [run[i]["p50_ms"] for run in all_runs]
            rec["method"] = f"slope_median_of_{len(all_runs)}"
            merged.append(rec)
        self.results = merged
        return self.results

    def export(self, file_path: Optional[str] = None):
        """The payload {platform, benchmarks}; written to ``file_path``
        when given one."""
        payload = {"platform": self.platform, "benchmarks": self.results}
        if file_path is not None:
            with open(file_path, "w") as f:
                json.dump(payload, f, indent=2)
        return payload


def plot_benchmarks(result_files: List[str], save_path: str = "benchmarks.png"):
    """Grouped log-scale latency chart across platforms (role of
    ``plot_benchmarks.py``); None where matplotlib is missing, as in the
    JAX package."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    data = []
    for path in result_files:
        with open(path) as f:
            data.append(json.load(f))
    names = [b["name"] for b in data[0]["benchmarks"]]
    width = 0.8 / len(data)
    fig, ax = plt.subplots(figsize=(10, 5))
    for i, d in enumerate(data):
        vals = [b["mean_ms"] for b in d["benchmarks"]]
        ax.bar(
            np.arange(len(names)) + i * width, vals, width,
            label=d["platform"],
        )
    ax.set_yscale("log")
    ax.set_ylabel("mean latency [ms]")
    ax.set_xticks(np.arange(len(names)) + 0.4)
    ax.set_xticklabels(names, rotation=30, ha="right")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def parse_device_args(parser, argv=None):
    """(device, arguments) of a benchmark's command line, ``parser`` given
    a ``--device`` (default ``cuda``); exits with code 2 when it names a
    CUDA device and there is none: a benchmark never falls back to the
    CPU."""
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{parser.prog}: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    return device, args


def main(device, out_path=None, repeats=1):
    """Run the suite on ``device`` (``repeats`` > 1: the median of that
    many passes), print the payload and write it to ``out_path`` when
    given one."""
    runner = BenchmarkRunner(device)
    if repeats > 1:
        runner.run_repeated(repeats)
    else:
        runner.run_all()
    out = runner.export(out_path)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--out", default=None)
    _parser.add_argument("--repeats", type=int, default=1)
    _device, _args = parse_device_args(_parser)
    main(_device, _args.out, _args.repeats)
