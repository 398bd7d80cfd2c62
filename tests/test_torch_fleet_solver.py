"""The port's scenario-batched fleet solver (``parallel/fleet.py``)
against the JAX package's ``make_fleet_solver(mesh=None)`` and
``FleetPlanner``, on the CPU.

Eight randomized oracle-style scenarios, packed once by the JAX package,
feed both. Per row: the same ``found`` and ``num_admissible``, the cost
within rel 1e-4, and the same winning sample or a tie (costs within rel
1e-6), as ``tests/test_torch_solver.py`` holds one solve. The JAX side
runs its Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kompass_core_tpu.ops import pallas_kernels as jpallas
from kompass_core_tpu.ops import solver as jsolver
from kompass_core_tpu.parallel import fleet as jfleet
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.parallel import FleetPlanner, make_fleet_solver

from test_oracle_parity import _scenario_inputs
from test_torch_solver import _jax_spec, _pack

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 8


def _fleet_inputs(jspec, seed, n=N):
    rng = np.random.default_rng(seed)
    return np.stack([_pack(jspec, _scenario_inputs(rng, False,
                                                   int(rng.integers(4, 13))))
                     for _ in range(n)])


def assert_rows_agree(tspec, tout, jout):
    assert tout.shape == jout.shape
    for r, (t, j) in enumerate(zip(tout, jout)):
        tf, tc, tb, tn, *_ = tsolver.unpack_solver_output(tspec, t)
        jf, jc, jb, jn, *_ = tsolver.unpack_solver_output(tspec, j)
        assert (tf, tn) == (jf, jn), f"row {r}"
        if not jf:
            continue
        assert tc == pytest.approx(jc, rel=1e-4), f"row {r}"
        if tb != jb:
            assert abs(tc - jc) <= 1e-6 * abs(jc), f"row {r}: {tb} vs {jb}"
        else:
            np.testing.assert_allclose(t[4:], j[4:], rtol=1e-5, atol=1e-5)


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    fused, single = jpallas.fused_min_dist_sq, jpallas.min_obstacle_dist_sq_mxu
    monkeypatch.setattr(jpallas, "fused_min_dist_sq",
                        lambda *a, **k: fused(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jpallas, "min_obstacle_dist_sq_mxu",
                        lambda *a, **k: single(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("backend,drop", [("xla", True), ("pallas", False),
                                          ("pallas_v1", True)])
def test_fleet_solver_matches_jax(jax_pallas_interpret, backend, drop):
    jspec = dataclasses.replace(_jax_spec(False, drop), backend=backend)
    tspec = tsolver.spec_from_jax(jspec)
    bufs = _fleet_inputs(jspec, 40 + drop)
    jout = np.asarray(jfleet.make_fleet_solver(jspec, chunk_size=None)(bufs))
    tout = make_fleet_solver(tspec, CPU, chunk_size=None)(bufs)
    assert tout.device == CPU and tout.dtype == torch.float32
    assert_rows_agree(tspec, tout.numpy(), jout)


def test_chunked_call_pads_its_tail():
    """10 rows in chunks of 4 (the tail padded by 2 zero rows): the same
    rows as one dispatch, and as JAX's chunked solver."""
    jspec = _jax_spec(False, False)
    tspec = tsolver.spec_from_jax(jspec)
    bufs = _fleet_inputs(jspec, 50, n=10)
    chunked = make_fleet_solver(tspec, CPU, chunk_size=4)(bufs)
    whole = make_fleet_solver(tspec, CPU, chunk_size=None)(bufs)
    assert chunked.shape == (10, whole.shape[1])
    assert torch.equal(chunked, whole)
    jout = np.asarray(jfleet.make_fleet_solver(jspec, chunk_size=4)(bufs))
    assert_rows_agree(tspec, chunked.numpy(), jout)


def test_rows_solve_as_one_robot_each():
    """A row's output in the batch is its own packed solve, bit for bit."""
    jspec = _jax_spec(True, True)
    tspec = tsolver.spec_from_jax(jspec)
    bufs = _fleet_inputs(jspec, 51, n=3)
    out = make_fleet_solver(tspec, CPU)(torch.from_numpy(bufs))
    one = tsolver.make_packed_dwa_solver(tspec, CPU)
    for r in range(3):
        assert torch.equal(out[r], one(bufs[r]))


@pytest.mark.parametrize("device_window", [False, True])
def test_zero_pad_rows_solve_to_not_found(device_window):
    jspec = dataclasses.replace(_jax_spec(False, True), device_window=device_window)
    tspec = tsolver.spec_from_jax(jspec)
    bufs = np.zeros((3, tsolver.packed_input_size(tspec)), np.float32)
    out = make_fleet_solver(tspec, CPU)(bufs).numpy()
    jout = np.asarray(jfleet.make_fleet_solver(jspec)(bufs))
    for t, j in zip(out, jout):
        found, _cost, _best, n_adm, *_ = tsolver.unpack_solver_output(tspec, t)
        assert not found and n_adm == 0
        assert not tsolver.unpack_solver_output(tspec, j)[0]


def test_fleet_solver_with_custom_costs_matches_jax():
    def jcost(vel, px, py, ap):
        return jnp.mean(vel[..., 2] ** 2, axis=-1) + jnp.abs(py[..., -1])

    def tcost(vel, px, py, ap):
        return (vel[..., 2] ** 2).mean(-1) + torch.abs(py[..., -1])

    jspec = _jax_spec(False, True)
    tspec = tsolver.spec_from_jax(jspec)
    bufs = _fleet_inputs(jspec, 52)
    jout = np.asarray(jfleet.make_fleet_solver(
        jspec, custom_costs=((2.0, jcost),))(bufs))
    tout = make_fleet_solver(tspec, CPU, custom_costs=((2.0, tcost),))(bufs)
    assert_rows_agree(tspec, tout.numpy(), jout)
    plain = make_fleet_solver(tspec, CPU)(bufs)
    assert not torch.equal(plain[:, 1], tout[:, 1])


def test_fleet_planner_matches_jax():
    """``set_scenario`` and ``step`` as in JAX; an index outside the
    fleet raises ``IndexError`` (after ``tests/test_fleet.py:176``)."""
    jspec = _jax_spec(False, True, scan=64, seg=128)
    tspec = tsolver.spec_from_jax(jspec)
    rng = np.random.default_rng(53)
    tplan = FleetPlanner(tspec, 5, CPU)
    jplan = jfleet.FleetPlanner(jspec, 5)
    for i in range(5):
        sc = _scenario_inputs(rng, False, int(rng.integers(4, 13)))
        row = _pack(jspec, sc)
        tplan.inputs[i] = row
        jplan.inputs[i] = row
    out = tplan.step()
    assert isinstance(out, np.ndarray) and out.shape[0] == 5
    assert_rows_agree(tspec, out, jplan.step())
    for bad in (5, -1):
        with pytest.raises(IndexError, match="out of range"):
            tplan.set_scenario(bad)


def test_set_scenario_packs_like_pack_solver_input():
    jspec = _jax_spec(False, True)
    tspec = tsolver.spec_from_jax(jspec)
    plan = FleetPlanner(tspec, 2, CPU)
    sc = _scenario_inputs(np.random.default_rng(54), False, 8)
    row = _pack(jspec, sc)
    limits = sc["limits"].copy()
    limits[3:6] = 0.0
    from kompass_core_tpu.ops.window import sample_velocity_window

    window = sample_velocity_window(sc["current_vel"], limits, 0.1, jspec.n_vx,
                                    jspec.n_vy, jspec.n_omega, False)
    obs = np.full((jspec.scan_size, 2), 1e8, np.float32)
    obs[: len(sc["obs"])] = sc["obs"]
    seg = [np.full(jspec.seg_size, 1e8, np.float32) for _ in range(2)]
    arc = np.zeros(jspec.seg_size, np.float32)
    n = len(sc["seg_x"])
    seg[0][:n], seg[1][:n], arc[:n] = sc["seg_x"], sc["seg_y"], sc["seg_arc"]
    w = sc["weights"]
    params = np.array(
        [0.1, sc["radius"], sc["margin"], w["reference_path_distance_weight"],
         w["goal_distance_weight"], w["obstacles_distance_weight"],
         w["smoothness_weight"], w["jerk_weight"], sc["limits"][1],
         sc["limits"][4], sc["limits"][7], sc["max_obs_dist"]], np.float32)
    plan.set_scenario(
        1, params_vec=params, state=sc["start_pose"], window=window, obs_xy=obs,
        obs_count=len(sc["obs"]), seg_x=seg[0], seg_y=seg[1], seg_arc=arc,
        seg_count=n, seg_total_len=sc["seg_total"], ref_total_len=sc["ref_total"],
        active_points=sc["active_points"],
    )
    assert plan.inputs[1].tobytes() == row.tobytes()
    assert not plan.inputs[0].any()


def test_fleet_interfaces_reject_dynamic_box():
    spec = tsolver.spec_from_jax(dataclasses.replace(_jax_spec(False, True),
                                                     dynamic_box=True))
    with pytest.raises(ValueError, match="dynamic_box"):
        make_fleet_solver(spec, CPU)
    with pytest.raises(ValueError, match="dynamic_box"):
        FleetPlanner(spec, 4, CPU)


def test_fleet_solver_rejects_a_wrong_width():
    tspec = tsolver.spec_from_jax(_jax_spec(False, True))
    solve = make_fleet_solver(tspec, CPU)
    with pytest.raises(ValueError, match="fleet input"):
        solve(np.zeros((2, tsolver.packed_input_size(tspec) - 1), np.float32))
