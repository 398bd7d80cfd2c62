"""The port's five benchmark tools (``kompass_core_tpu_torch/benchmark/``:
``batch_cliff``, ``chunk_unroll_bench``, ``mapper_split``,
``fleet_fingerprint``, ``scaling_proof``) against the JAX package's, on
the CPU at small sizes. Tolerances: bit for bit unless a test states
rel 1e-4 (the port's solver parity tolerance against JAX)."""

import numpy as np
import pytest
import torch

from kompass_core_tpu.benchmark import batch_cliff as jbatch_cliff
from kompass_core_tpu.benchmark import chunk_unroll_bench as jchunk
from kompass_core_tpu.ops.solver import SolverSpec as JaxSpec
from kompass_core_tpu_torch.benchmark import (
    batch_cliff,
    chunk_unroll_bench,
    fleet_fingerprint,
    mapper_split,
    scaling_proof,
)
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.ops.mapping import MapperSpec, scan_to_grid
from kompass_core_tpu_torch.parallel import FleetMesh

from test_torch_benchmark import no_new_files  # noqa: F401  (a fixture)

torch.set_num_threads(2)
CPU = torch.device("cpu")
REL_TOL = 1e-4
REPO = str(__import__("pathlib").Path(__file__).resolve().parent.parent)
# the runner's DWA workload at a small spec: 5 x 5 samples, 10 steps, 64
# scan and 64 segment slots
JSPEC = JaxSpec(is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=10,
                num_ctrl_points=6, scan_size=64, seg_size=64, drop_samples=True)
SPEC = tsolver.spec_from_jax(JSPEC)
MAP_SPEC = MapperSpec(grid_height=60, grid_width=60, num_bins=360, resolution=0.3)
# the chunk bench's fleet at 8 robots, 5 x 5 samples, 10 steps, 64 rays
SMALL_FLEET = dict(samples=(5, 5), horizon=10)


def test_flagship_spec_is_the_jax_modules():
    assert batch_cliff._flagship_spec() == tsolver.spec_from_jax(
        jbatch_cliff._flagship_spec())


@pytest.mark.parametrize("batch, salt", [(3, 0.0), (5, 2e-3)])
def test_scenario_matrix_bit_equal_jax(batch, salt):
    want = jbatch_cliff._scenario_matrix(JSPEC, batch, salt)
    got = batch_cliff._scenario_matrix(SPEC, batch, salt)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_batched_chain_is_k_sequential_solves_and_agrees_with_jax():
    """The eager chain == K batched solves with the carry applied by hand,
    bit for bit; its final cost == the JAX device loop's within rel 1e-4."""
    k, batch = 3, 4
    mat = torch.from_numpy(batch_cliff._scenario_matrix(SPEC, batch, 1e-3))
    before = mat.clone()
    got = batch_cliff.make_batched_device_loop(SPEC, batch, k, CPU)(mat)
    assert got.shape == () and torch.equal(mat, before)
    m = mat.clone()
    for _ in range(k):
        out = tsolver._unpack_and_solve(SPEC, m)
        m[:, 0] += 1e-6 + 1e-9 * out[:, 1]
    assert torch.equal(got, out[0, 1])
    want = float(jbatch_cliff.make_batched_device_loop(JSPEC, batch, k)(mat.numpy()))
    assert got.item() == pytest.approx(want, rel=REL_TOL)


def test_sweep_keeps_the_jax_record_keys():
    (rec,) = batch_cliff.sweep(CPU, batches=(2,), ks=(1, 2), repeats=1, spec=SPEC)
    assert set(rec) == {"batch", "us_per_solve", "estimates_us", "spread_us",
                        "compile_s"}
    assert rec["batch"] == 2 and len(rec["estimates_us"]) == 1


def test_launch_stats_record():
    """On the CPU the profile is one eager call's operators: K1's operator
    among them once, its share of the host time in (0, 1)."""
    rec = batch_cliff.launch_stats(4, CPU, spec=SPEC)
    assert set(rec) == {"batch", "timer", "launches", "kernels", "total_ms", "k1_ms",
                        "k1_share", "ms_by_kernel", "launches_by_kernel"}
    assert rec["batch"] == 4 and rec["timer"] == "host"
    assert rec["launches_by_kernel"]["kompass_torch::fused_min_dist_sq"] == 1
    assert rec["launches"] == sum(rec["launches_by_kernel"].values())
    assert rec["kernels"] == len(rec["ms_by_kernel"])
    assert 0.0 < rec["k1_ms"] < rec["total_ms"] and 0.0 < rec["k1_share"] < 1.0


def test_chunk_bench_fleet_is_the_jax_benchs():
    """The same robots, limits, config, paths and angles: the fleet specs,
    snapshots and config tables equal at 8 robots."""
    import jax

    jf = jchunk._setup_fleet(8, 512)
    tf = chunk_unroll_bench._setup_fleet(8, 512, device=CPU)
    assert tf.spec.solver == tsolver.spec_from_jax(jf.spec.solver)
    a, b = jf.state_dict(), tf.state_dict()
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key])
    cfg = [t.numpy() for t in tf._cfg if t is not None]
    for j, t in zip(jax.tree_util.tree_leaves(jf._cfg), cfg, strict=True):
        np.testing.assert_array_equal(np.asarray(j), t)


def test_chunk_bench_inputs_follow_the_jax_protocol():
    fleet = chunk_unroll_bench._setup_fleet(8, 64, device=CPU, **SMALL_FLEET)
    inputs = chunk_unroll_bench.tick_inputs(fleet, 3)
    rng = np.random.default_rng(7)
    for k, inp in enumerate(inputs):
        assert inp.shape == (8, 7 + 64) and inp.dtype == np.float32
        np.testing.assert_array_equal(inp[:, 0], np.float32(0.1 * np.arange(8) + 1e-4 * k))
        np.testing.assert_array_equal(inp[:, 7:], rng.uniform(2.5, 9.0, (8, 64)).astype(np.float32))
        assert not inp[:, 1:7].any()


def test_blocked_tick_equals_whole_tick_bit_for_bit():
    """The bench's blocked tick (2-row blocks here, 64 on the card) == the
    whole tick bit for bit, outputs and carry; rows 0, 3 and 7 == a 3-robot
    fleet of those robots (``check``)."""
    fleet = chunk_unroll_bench._setup_fleet(8, 64, device=CPU, **SMALL_FLEET)
    (inp,) = (torch.from_numpy(v) for v in chunk_unroll_bench.tick_inputs(fleet, 1))
    whole = chunk_unroll_bench.tick_fn(fleet)(inp)
    blocked = chunk_unroll_bench.tick_fn(fleet, 2)(inp)
    for a, b in zip((*whole[0], whole[1]), (*blocked[0], blocked[1])):
        assert torch.equal(a, b)
    assert whole[1].shape == (8, 10) and bool(whole[1][:, 0].all())
    res = chunk_unroll_bench.check(fleet, inp, 2, rows=(0, 3, 7), whole=whole)
    assert res == {"rows": [0, 3, 7], "ties": [], "equal": True}


def test_chunk_bench_compare_rows_rule():
    """The card-vs-CPU rule: a different command passes only as a tie."""
    row = np.array([[1, 0, 0.5, 0, 0.3, 2.0, 0, 10, 25, 1]], np.float32)
    assert chunk_unroll_bench._compare_rows(row, row, (0,)) == []
    other = row.copy()
    other[0, 4] = 0.2
    tie = other.copy()
    tie[0, 5] = 2.0 * (1 + 5e-7)
    assert chunk_unroll_bench._compare_rows(tie, row, (0,)) == [0]
    with pytest.raises(AssertionError, match="not a tie"):
        far = other.copy()
        far[0, 5] = 2.0 * (1 + 5e-5)
        chunk_unroll_bench._compare_rows(far, row, (0,))


def test_measure_case_record():
    fleet = chunk_unroll_bench._setup_fleet(4, 64, device=CPU, **SMALL_FLEET)
    variants = [torch.from_numpy(v) for v in chunk_unroll_bench.tick_inputs(fleet, 46)]
    rec = chunk_unroll_bench.measure_case(fleet, variants, 2, False, CPU)
    assert set(rec) == {"block", "mode", "ms_per_tick", "us_per_robot", "compile_s",
                        "max_memory_allocated_mb"}
    assert rec["block"] == 2 and rec["mode"] == "eager" and rec["ms_per_tick"] > 0
    assert rec["us_per_robot"] == pytest.approx(1e3 * rec["ms_per_tick"] / 4)


def test_mapper_split_parts_make_scan_to_grid():
    """The beam side and then the cell pass == ``scan_to_grid`` bit for
    bit, on valid, zero, NaN and inf beams."""
    rng = np.random.default_rng(0)
    ranges = rng.uniform(0.5, 9.5, 360).astype(np.float32)
    ranges[[3, 50, 51, 200]] = [0.0, np.nan, np.inf, -1.0]
    ranges = torch.from_numpy(ranges)
    beam_side, cells, full = mapper_split.split_fns(MAP_SPEC, CPU)
    tables, endpoint = beam_side(ranges)
    assert tables.shape == (1, 360, 4) and endpoint.shape == (1, 60, 60)
    occ = cells((tables, endpoint))
    assert torch.equal(occ[0], scan_to_grid(MAP_SPEC, ranges))
    assert torch.equal(full(ranges), occ[0])


def test_mapper_split_main_record():
    out = mapper_split.main(CPU, spec=MAP_SPEC, repeats=1, ks=(1, 2))
    for key in ("beam_side_ms", "cells_ms", "full_update_ms"):
        assert out[key] > 0
    assert out["rest_ms"] == out["full_update_ms"] - out["cells_ms"]
    assert set(out["device_loop_ms"]) == {"beam_side", "cells", "full_update", "rest",
                                          "cells_share"}


def test_shootout_checksum_rule(monkeypatch):
    """The forms must agree on one input: K5 and its plain version do; a
    plain form one cell off fails."""
    out = mapper_split.shootout(CPU, spec=MAP_SPEC)
    assert set(out) == {"k5", "plain", "checksum"} and out["checksum"] > 0
    plain = mapper_split.plain_update

    def off_by_one(spec, device):
        run = plain(spec, device)
        return lambda r: run(r) + (torch.arange(run(r).numel()).view(run(r).shape) == 7)

    monkeypatch.setattr(mapper_split, "plain_update", off_by_one)
    with pytest.raises(AssertionError, match="plain output differs from k5"):
        mapper_split.shootout(CPU, spec=MAP_SPEC)


def test_fingerprint_is_stable_across_processes():
    first = fleet_fingerprint.fingerprint(REPO, 4)
    assert fleet_fingerprint.fingerprint(REPO, 4) == first
    lines, sha = first
    assert lines > 100 and len(sha) == 64


def test_fingerprint_sees_the_horizon_and_names_k1():
    text = fleet_fingerprint.trace_text(4, 30, "cpu")
    assert "torch.ops.kompass_torch.fused_min_dist_sq.default" in text
    assert "# File:" not in text and ".py" not in text
    assert fleet_fingerprint.trace_text(4, 20, "cpu") != text


def test_fingerprint_normalises_sources():
    text = ('    # File: /home/a/kompass_core_tpu_torch/ops/solver.py:12 in f\n'
            '    x = f(y)   \n'
            '    # see /tmp/x/kompass.py:7 here')
    assert fleet_fingerprint.normalise(text) == "    x = f(y)\n    # see <source> here"


def test_build_proof_on_two_cpu_shards():
    proof = scaling_proof.build_proof(FleetMesh([CPU, CPU]))
    assert proof["mesh_devices"] == 2 and proof["platform"] == "cpu"
    counts = {k: v["collective_counts"] for k, v in proof["programs"].items()}
    assert counts == {**{k: {} for k in scaling_proof.STEADY_STATE},
                      "fleet_v2_tick_peers_mesh": {"all-gather": 1},
                      "sample_parallel_solver": {"all-reduce": 3}}


def test_new_mains_write_no_file_without_a_path(no_new_files, monkeypatch,  # noqa: F811
                                                capsys):
    """The five modules' entries on the CPU, at small sizes where they
    would run the full ones: none writes a file."""
    scaling_proof.main([CPU, CPU])
    monkeypatch.setattr(batch_cliff, "_flagship_spec", lambda: SPEC)
    monkeypatch.setattr(batch_cliff, "sweep", lambda device: [{"batch": 2}])
    assert batch_cliff.main(CPU) == [{"batch": 2}]
    assert len(batch_cliff.main(CPU, "launches")) == 4
    monkeypatch.setattr(mapper_split, "_spec", lambda spec: MAP_SPEC)
    assert mapper_split.main(CPU, repeats=1, ks=(1, 2))["cells_ms"] > 0
    assert mapper_split.shootout(CPU)["checksum"] > 0
    monkeypatch.setattr(chunk_unroll_bench, "measure_case",
                        lambda fleet, variants, block, graph, device: {
                            "mode": "graph" if graph else "eager"})
    monkeypatch.setattr(chunk_unroll_bench, "check", lambda *a, **kw: {"equal": True})
    out = chunk_unroll_bench.main(CPU, n=4, rays=64, blocks=(2,))
    assert list(out["cases"]) == ["whole_eager", "whole_graph", "blocks_2_eager",
                                  "blocks_2_graph", "whole_control_eager",
                                  "whole_control_graph"]
    monkeypatch.setattr(fleet_fingerprint, "fingerprint",
                        lambda root, n, device: (815, "0" * 64))
    assert fleet_fingerprint.main(REPO, 2, "cpu") == (815, "0" * 64)
    assert f"torch_export_sha256={'0' * 64}" in capsys.readouterr().out
