"""The port's benchmark layer (``kompass_core_tpu_torch/benchmark/``)
against the JAX package's, on the CPU: the BASELINE spec and the scenario
builder that the benches share, the runner's DWA variants and one solve
of each, the device loop's carry-chained cost, the bounds that
``chip_smoke.py`` sets beside each kernel, and that no benchmark entry
point writes a file unless it is given a path.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kompass_core_tpu.benchmark import baseline as jbaseline
from kompass_core_tpu.benchmark import device_loop as jdevice_loop
from kompass_core_tpu.benchmark.runner import BenchmarkRunner as JaxRunner
from kompass_core_tpu.ops.solver import SolverSpec as JaxSpec
from kompass_core_tpu_torch.benchmark import (
    baseline,
    device_loop,
    kernel_bench,
    moving_bench,
    peer_bench,
    planner_bench,
    roofline,
    runner,
    scaling,
)
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.parallel import FleetMesh

from test_torch_solver import _jax_solve, _port_solve, assert_tick_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import bench  # noqa: E402  (the JAX package's root benchmark)

torch.set_num_threads(2)
CPU = torch.device("cpu")
REL_TOL = 1e-4
# the runner's DWA workload at a small spec: 5 x 5 samples, 10 steps, 64
# scan and 64 segment slots
SMALL = (5, 5, 10, 64, 64)


def test_baseline_solver_spec_equals_jax():
    assert baseline.baseline_solver_spec() == tsolver.spec_from_jax(
        jbaseline.baseline_solver_spec())
    assert baseline.build_spec() == tsolver.spec_from_jax(bench.build_spec())


@pytest.mark.parametrize("omega_shard", [None, (1, 4)])
def test_build_scenario_bit_equal_bench(omega_shard):
    """Robots 0-3 from one default_rng(0) each, the flagship spec; with an
    omega shard the window keeps every fourth omega sample from the 2nd,
    as the JAX fleet tests split it."""
    jspec = jbaseline.baseline_solver_spec()
    tspec = tsolver.spec_from_jax(jspec)
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(4):
        want = bench.build_scenario(jspec, jrng, i)
        got = baseline.build_scenario(tspec, trng, i, omega_shard)
        if omega_shard is None:
            np.testing.assert_array_equal(got, want)
        else:
            differ = np.flatnonzero(got != want)
            assert differ.size and np.all(got[differ] == 0.0)


def _small_spec():
    n_vx, n_omega, T, scan, seg = SMALL
    return JaxSpec(is_omni=False, n_vx=n_vx, n_vy=1, n_omega=n_omega,
                   max_points=T, num_ctrl_points=6, scan_size=scan,
                   seg_size=seg, drop_samples=True)


@pytest.fixture(scope="module")
def small_variants():
    """(JAX variants as numpy, port variants) of the runner's DWA
    workload at SMALL."""
    _, jvars = JaxRunner()._dwa_workload(*SMALL, "small")
    _, tvars = runner.BenchmarkRunner(CPU)._dwa_workload(*SMALL, "small")
    return [np.asarray(v) for v in jvars], tvars


def test_dwa_workload_variants_bit_equal_jax(small_variants):
    jvars, tvars = small_variants
    assert len(tvars) == len(jvars) == runner.slope_variants_needed()
    for j, t in zip(jvars, tvars):
        assert t.device == CPU and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), j)
    assert len({v.tobytes() for v in jvars}) == len(jvars)


def test_dwa_workload_solves_agree_with_jax(small_variants):
    """One solve of each variant: the same found and argmin (or a tie),
    costs within rel 1e-4; the runner's solver is the packed solver."""
    jspec = _small_spec()
    jvars, tvars = small_variants
    solver, _ = runner.BenchmarkRunner(CPU)._dwa_workload(*SMALL, "small")
    for j, t in zip(jvars, tvars):
        jres, jout = _jax_solve(jspec, j)
        tres, tout = _port_solve(jspec, j)
        assert_tick_parity(jres, jout, tres, tout)
        np.testing.assert_array_equal(solver(t).numpy(), tout)


def test_device_loop_cost_matches_jax(small_variants):
    jspec = _small_spec()
    jvars, tvars = small_variants
    want = float(jdevice_loop.make_dwa_device_loop(jspec, 4)(jnp.asarray(jvars[0])))
    loop = device_loop.make_dwa_device_loop(tsolver.spec_from_jax(jspec), 4, CPU)
    got = loop(tvars[0])
    assert got.shape == () and got.device == CPU
    assert got.item() == pytest.approx(want, rel=REL_TOL)
    # the chain leaves its input as it was
    np.testing.assert_array_equal(tvars[0].numpy(), jvars[0])


def test_bounds_give_perf_md_figures():
    """K5 at 64 Bayesian 400 x 400 grids from 3600 beams is bytes-bound at
    0.04122 ms; K3 at the fleet's 64 x 2025 x 30 points against 768
    moving and 384 segment rows is operations-bound at 0.80238 ms."""
    ms, by = roofline.cells_bound(64, 400, 400, 3600)
    assert by == "bytes" and ms == pytest.approx(0.04122, abs=5e-6)
    px = torch.empty((64, 2025, 30), device="meta")
    ms, by = roofline.sweep_bound(px, 768, torch.full((64,), 30), 384, moving=True)
    assert by == "operations" and ms == pytest.approx(0.80238, abs=5e-6)
    assert roofline.form_bound(px, 768, torch.full((64,), 30), 384, 6, 6, 4,
                               moving=True) == (ms, by)


@pytest.mark.parametrize("B,S,G,ms", [(1024, 2025, 320, 0.13865), (256, 2025, 320, 0.03466),
                                      (64, 2025, 384, 0.01040)])
def test_goal_bound_counts_seven_operations_a_pair(B, S, G, ms):
    """K10 at the benchmark cells' widths is operations-bound: 7 per
    (sample, segment point) pair at 33.5e12 a second."""
    assert roofline.goal_bound(B, S, G) == (pytest.approx(ms, abs=5e-6), "operations")


def test_goal_inputs_hold_pads_past_the_path():
    """K10's timed inputs: distinct draws, the last sixteenth of each
    robot's segment points at the 1e8 pad."""
    inputs = kernel_bench.goal_inputs(CPU, 2, 3, 40, 32)
    assert [t.shape for t in inputs[0]] == [(3, 40), (3, 40), (3, 32), (3, 32)]
    assert (inputs[0][2][:, 30:] == 1e8).all() and (inputs[0][2][:, :30].abs() <= 10).all()
    assert not torch.equal(inputs[0][0], inputs[1][0])


def test_roofline_peaks_are_the_h100s():
    """The peaks behind every ``bound_ms`` of ``chip_smoke.py``'s kernels
    line: FP32 at 67e12 / 2 instructions/s (no FMA), HBM3 at 3.35e12 B/s;
    ``bound`` takes the larger of the two times."""
    assert roofline.FP32_OPS_PER_S == 67e12 / 2
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.bound(67e9 / 2, 0.0) == (pytest.approx(1.0), "operations")
    assert roofline.bound(0.0, 3.35e9) == (pytest.approx(1.0), "bytes")
    assert roofline.bound(67e9 / 2, 2 * 3.35e9) == (pytest.approx(2.0), "bytes")


def _files():
    """The benchmark package's and the planning problem's directories,
    the places a benchmark names by its own path (other tests may write
    at the repository's root meanwhile; a path relative to the working
    directory lands in the test's empty one)."""
    dirs = (os.path.dirname(runner.__file__), planner_bench.RESOURCES)
    return {os.path.join(d, f) for d in dirs for f in os.listdir(d)}


@pytest.fixture
def no_new_files(tmp_path, monkeypatch):
    """Each benchmark entry point, run from an empty directory: it may
    create no file there or beside its own sources."""
    monkeypatch.chdir(tmp_path)
    before = _files()
    yield tmp_path
    assert list(tmp_path.iterdir()) == []
    assert _files() - before == set()


def _record(name="W", ms=1.0):
    return {"name": name, "runs": 1, "mean_ms": ms, "min_ms": ms,
            "p50_ms": ms, "p99_ms": ms, "method": "slope"}


def test_benchmark_mains_write_no_file_without_a_path(no_new_files, monkeypatch,
                                                      capsys):
    """The measurements are stubbed where they would run the full sizes on
    the CPU; planner_bench runs PRM for real, scaling two CPU shards."""
    monkeypatch.setattr(runner.BenchmarkRunner, "run_all", lambda self: (
        self.bench_critical_zone_dense(), self.results)[1])
    payload = runner.main(CPU)
    assert payload["platform"] == "cpu_cpu"
    assert [b["name"] for b in payload["benchmarks"]] == ["CriticalZone_Dense_Scan"]

    monkeypatch.setattr(device_loop, "measure_device_loop",
                        lambda name, make_loop, variants, ks, repeats: _record(name))
    assert len(device_loop.main(CPU, repeats=1)) == 7

    monkeypatch.setattr(roofline, "measure", lambda device: {
        **{k: 1.0 for k in ("CostEvaluator_5k_Trajs", "Mapper_Dense_400x400",
                            "Mapper_Bayesian_400x400", "Mapper_PointCloud_100k",
                            "CriticalZone_100k_Cloud", "DWA_sweep_batch64",
                            "CriticalZone_Dense_dispatch_ms")},
        "CriticalZone_Dense_device_us": 1.0})
    assert len(roofline.main(CPU)["workloads"]) == 7

    monkeypatch.setattr(kernel_bench, "bench_sweeps", lambda device: {"xla_two_sweeps_ms": 1.0})
    monkeypatch.setattr(kernel_bench, "bench_goal", lambda device: {})
    monkeypatch.setattr(kernel_bench, "bench_full_solve", lambda device: {"solve_xla_us": 1.0})
    assert kernel_bench.main(CPU)["platform"] == "cpu_cpu"

    monkeypatch.setattr(moving_bench, "_measure", lambda spec, label, device, **kw: {
        "ms_per_batch64": 1.0, "us_per_solve": 1.0})
    assert moving_bench.main(CPU)["moving_over_static"] == 1.0
    monkeypatch.setattr(runner, "measure_throughput_slope",
                        lambda name, dispatch, variants, fetch, **kw: _record(name))
    assert len(moving_bench.fleet_main(CPU, n=2, rays=64, tracked=2)) == 3
    assert len(peer_bench.main(CPU, n=2, rays=64)) == 3

    summary = planner_bench.main(CPU, planner_ids=("PRM",))
    assert summary["planners_solved"] == 1 and summary["device"] == "cpu"

    capsys.readouterr()


def test_runner_and_planner_write_only_the_given_path(tmp_path, monkeypatch):
    monkeypatch.setattr(runner.BenchmarkRunner, "run_all", lambda self: (
        self.bench_critical_zone_dense(), self.results)[1])
    out = tmp_path / "bench.json"
    runner.main(CPU, str(out))
    assert out.exists()
    out = tmp_path / "planners.json"
    planner_bench.main(CPU, str(out), planner_ids=("PRM",))
    assert out.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bench.json", "planners.json"]


def test_mesh_collective_cost_counts_one_gather_per_peer_tick():
    out = peer_bench.mesh_collective_cost(FleetMesh([CPU, CPU]), n=4, rays=64, reps=2)
    assert out["peer_mesh2_collectives_per_tick"] == {"all_gather": 1.0, "all_reduce": 0.0}
    assert out["nopeer_mesh2_collectives_per_tick"] == {"all_gather": 0.0, "all_reduce": 0.0}
    assert out["gather_ms"] > 0.0 and out["peer_single_device"] > 0.0


def test_fleet_scaling_over_cpu_shards():
    spec = tsolver.spec_from_jax(_small_spec())
    rows = scaling.measure_fleet_scaling([CPU, CPU], robots_per_device=2, reps=1,
                                         spec=spec)
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["solves_per_s"] > 0 for r in rows)


def test_device_from_the_command_line_never_falls_back(monkeypatch):
    import argparse

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        runner.parse_device_args(argparse.ArgumentParser(), [])
    assert exit_.value.code == 2
    device, _ = runner.parse_device_args(argparse.ArgumentParser(), ["--device", "cpu"])
    assert device == CPU
