"""The fleet of mixed drives (``systems/fleet_kin.py``, the cell
``omniack256.k8``) on the CPU at a small size: the port's ``DeviceFleet``
against the plain reference ``reference/fleet_kin.py`` (the omni grid's
order and dead slots, the vy rollout and state integration, no rotation
in place for an Ackermann robot), the check's faults, the scene's seeds
and the ``dead_sample_pct`` reader."""

import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from kompass_core_tpu_torch.ops.solver import _build_velocity_grid, _device_window
from kompass_core_tpu_torch.utils import tracing
from portbench.control import readings
from portbench.harness import main as M
from portbench.harness.trace import Trace
from portbench.metrics import dead_sample_pct
from portbench.reference.fleet_kin import KinLayout, KinReference
from portbench.systems import fleet_kin

CELL = "omniack256.k8"
SEED = 2**31 + 2525
DIFF = {"drive": "DIFFERENTIAL_DRIVE", "geometry": "CYLINDER", "params": [0.3, 0.4],
        "limits": {"vx": [1.0, 5.0, 10.0], "omega": [2.0, 3.0, 3.0]}}


def tiny(k=8, robots=6, diff=True):
    """(cfg, traffic, limits) of the cell at a small size: 12 linear and 5
    angular samples (a 9 x (3 + 5) omni grid), 6 steps, 32 rays; with
    ``diff`` a diff-drive kind beside the omni and Ackermann ones."""
    _, _, cfg, traffic, limits = M.load_cell(CELL)
    cfg = copy.deepcopy(cfg)
    cfg["dwa"].update(max_linear_samples=12, max_angular_samples=5, prediction_horizon=6,
                      control_horizon=2)
    cfg["scan_rays"] = 32
    if diff:
        cfg["robot"]["kinds"].append(DIFF)
    traffic = dict(traffic, robots=robots, k=k, warm_calls=2, check_calls=3,
                   check_robots=4, trace_calls=2, arc_rays=4)
    if k == 1:
        limits = {n: v for n, v in limits.items() if n != "state_err_m"}
    return cfg, traffic, limits


def passes(numbers, limits):
    return all(numbers[k] <= limits[k] for k in limits)


def drive(k, calls, turn=(), patch=None, robots=6):
    """A small fleet's system after ``calls`` calls of k ticks, judged on
    every robot and call; ``turn`` robots start 1.5 rad off their path's
    heading; ``patch(system)`` breaks the program first."""
    cfg, traffic, _ = tiny(k, robots)
    traffic = dict(traffic, check_robots=robots, check_calls=calls)
    scene = M.make_scene(traffic, cfg, SEED)
    scene.start[list(turn), 2] += 1.5
    scene._restart()
    system = fleet_kin.System(cfg, traffic, scene, SEED, torch.device("cpu"))
    if patch is not None:
        patch(system)
    for _ in range(calls):
        inputs = scene.inputs()
        out = system.call(inputs)
        system.record(inputs, out)
        scene.advance(out)
    return system, system.check(0)


@pytest.mark.parametrize("k, calls", [(1, 5), (4, 2)])
def test_port_agrees_with_the_reference_on_a_mixed_fleet(k, calls):
    """Omni, Ackermann and diff-drive robots, two of them 1.5 rad off
    their paths: every answer of every call matches the reference
    exactly, the omni robots strafe, the turned diff-drive robot rotates
    in place and the turned Ackermann robot does not."""
    system, numbers = drive(k, calls, turn=(1, 2))
    assert numbers["judged_rows"] == 6 * calls * k
    assert numbers["cost_gap"] == 0.0 and numbers["unmatched"] == 0
    assert numbers.get("state_err_m", 0.0) == 0.0
    outs = [c["out"] for c in system.rec.calls]
    vy = np.stack([o["vy"] for o in outs])  # [calls, robots(, k)]
    assert np.abs(vy[:, [0, 3]]).max() > 0.05  # the omni rows strafe
    assert not vy[:, [1, 2, 4, 5]].any()
    first = {f: np.asarray(outs[0][f]).reshape(6, -1)[:, 0] for f in ("vx", "omega", "cost")}
    # robot 2 (diff drive, turned) rotates in place: no forward speed,
    # cost 0; robot 1 (Ackermann, turned) drives a sample
    assert first["vx"][2] == 0.0 and first["cost"][2] == 0.0 and first["omega"][2] != 0.0
    assert first["vx"][1] != 0.0 and first["cost"][1] > 0.0


def test_grid_order_window_and_dead_slots_equal_the_reference():
    """The port's on-device window and grid against the reference's at
    random velocities: the same values in the same order; a non-omni row
    keeps one vy value per vx, so n_vx x (n_vy - 1) of its samples are
    dead."""
    cfg, traffic, _ = tiny(robots=3)
    fleet = fleet_kin.build_fleet(cfg, 3, "cpu")
    spec = fleet.spec.solver
    layout = KinLayout(cfg, 3)
    assert spec.is_omni and (spec.n_vx, spec.n_vy, spec.n_omega) == (9, 3, 5)
    assert (layout.n_vx, layout.n_vy, layout.n_omega, layout.S) == (9, 3, 5, spec.num_samples)
    np.testing.assert_array_equal(fleet._cfg.limits9.numpy(), layout.limits9)
    np.testing.assert_array_equal(fleet._cfg.params12.numpy(), layout.params12)
    np.testing.assert_array_equal(fleet._cfg.rotate_in_place.numpy(), [True, False, True])
    ref = KinReference(layout, np.arange(3), np.zeros(32, np.float32),
                       [np.array([[0.0, 0.0], [5.0, 0.0]])] * 3, "cpu")
    rng = np.random.default_rng(4)
    for _ in range(4):
        vels = torch.tensor(rng.uniform(-1.2, 1.2, (3, 3)), dtype=torch.float32)
        grid, valid = _build_velocity_grid(spec, _device_window(
            spec, vels, fleet._cfg.limits9, fleet._cfg.params12[:, 0]))
        want, want_ok = ref.grid(vels, torch.float32)
        assert torch.equal(grid, want) and torch.equal(valid, want_ok)
        blk = spec.n_vy + spec.n_omega
        vy_slot = torch.arange(spec.num_samples) % blk
        lateral = (vy_slot >= 1) & (vy_slot < spec.n_vy)
        for row in (1, 2):  # Ackermann, diff drive
            assert not valid[row, lateral].any()
            assert int(lateral.sum()) == spec.n_vx * (spec.n_vy - 1)


def _rotate_everyone(system):
    cfg = system.fleet._cfg
    system.fleet._cfg = cfg._replace(rotate_in_place=torch.ones_like(cfg.rotate_in_place))


def _alter_vy(system):
    call = system._call

    def altered(*args):
        out = dict(call(*args))
        out["vy"] = out["vy"] + np.float32(0.05)
        return out

    system._call = altered


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("fault", [_rotate_everyone, _alter_vy])
def test_the_check_flags_each_fault(k, fault):
    """An Ackermann robot turned in place, or an altered vy command, is
    unmatched: the run is not correct."""
    _, limits = tiny(k)[1:]
    _, numbers = drive(k, 2, turn=(1, 2), patch=fault)
    assert numbers["unmatched"] > 0
    assert not passes(numbers, limits)


@pytest.mark.parametrize("k", [1, 8])
def test_the_control_fails_the_check(k):
    cfg, traffic, limits = tiny(k)
    for seed, prog, ctrl in readings(CELL, [SEED, SEED + 1, SEED + 2], 0.3,
                                     torch.device("cpu"), cfg, traffic):
        assert passes(prog, limits), (seed, prog)
        assert not passes(ctrl, limits), (seed, ctrl)


def test_a_whole_run_is_correct_and_reads_the_dead_share(capsys):
    """``run`` of the cell at the small size (untraced, the program's
    spans on: the profiler's trace needs the card): correct, and
    ``dead_sample_pct`` on the program's counters after it is the
    non-omni rows' dead slots over the grid."""
    cfg, traffic, limits = tiny(diff=False)
    bench, cell, *_ = M.load_cell(CELL)
    args = type("A", (), dict(seconds=0.3, trace=0, seed=SEED, workload=CELL))()
    tracing.reset()
    try:
        with tracing.enable():
            assert M.run(args, bench, cell, cfg, traffic, limits, torch.device("cpu"),
                         0.0) == 0
        share = dead_sample_pct.read(Trace())
    finally:
        tracing.reset()
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"solves_per_s", "call_p95_ms", "setup_s"}
    # 3 of 6 robots Ackermann, 9 x 2 dead of 72 samples each
    assert share == pytest.approx(100.0 * 3 * 18 / (6 * 72))


def test_the_cell_grid_is_1978_and_its_dead_share_15_2():
    _, _, cfg, traffic, _ = M.load_cell(CELL)
    layout = KinLayout(cfg, traffic["robots"])
    assert (layout.n_vx, layout.n_vy, layout.n_omega, layout.S) == (43, 15, 31, 1978)
    fleet = fleet_kin.build_fleet(cfg, 2, "cpu")
    assert fleet.spec.solver.num_samples == 1978
    assert (fleet._samples_per_tick, fleet._dead_per_tick) == (2 * 1978, 43 * 14)
    dead = (layout.drive != "OMNI").sum() * 43 * 14
    assert 100.0 * dead / (traffic["robots"] * 1978) == pytest.approx(15.2, abs=0.05)


def _paths(seed):
    cfg, traffic, _ = tiny(diff=False)
    return M.make_scene(traffic, cfg, seed)


def test_the_scenes_seeds_change_offsets_not_sizes():
    a, b = _paths(2**31 + 1), _paths(2**31 + 2)
    assert [p.shape for p in a.paths] == [p.shape for p in b.paths]
    assert a.pool.shape == b.pool.shape and a.start.shape == b.start.shape
    assert not all(np.array_equal(p, q) for p, q in zip(a.paths, b.paths))
    for scene in (a, b, _paths(2**31 + 1)):
        for i, path in enumerate(scene.paths):
            d = path[1] - path[0]
            off = np.angle(np.exp(1j * (np.arctan2(d[1], d[0]) - scene.start[i, 2])))
            if i % 2 == 0:  # omni: off its heading by 0.5-0.9 rad
                assert 0.5 - 1e-6 <= abs(off) <= 0.9 + 1e-6
            else:  # Ackermann: aligned
                assert abs(off) < 1e-6
    assert all(np.array_equal(p, q) for p, q in zip(a.paths, _paths(2**31 + 1).paths))


def _entry(count):
    return dict(count=count, host_s=0.0, self_s=0.0, device_s=0.0, device_n=0)


def test_the_dead_share_reader(monkeypatch):
    snap = {"fleet.samples": _entry(256 * 1978 * 8), "fleet.dead_samples": _entry(128 * 602 * 8)}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    assert dead_sample_pct.read(Trace()) == pytest.approx(15.21739, abs=1e-5)
    monkeypatch.setattr(tracing, "snapshot", lambda: {"fleet.samples": _entry(10),
                                                      "fleet.dead_samples": _entry(0)})
    assert dead_sample_pct.read(Trace()) == 0.0
    monkeypatch.setattr(tracing, "snapshot", lambda: {})
    assert dead_sample_pct.read(Trace()) is None


def test_the_dead_share_reader_without_the_tracing_module(monkeypatch):
    import kompass_core_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "kompass_core_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(utils, "tracing")
    assert dead_sample_pct.read(Trace()) is None


def test_the_new_files_load_no_jax():
    probe = ("import sys; sys.path.insert(0, {root!r}); "
             "import portbench.harness.main as M, portbench.systems.fleet_kin, "
             "portbench.scenes.omniack, portbench.metrics.dead_sample_pct; "
             "print(M.forbidden_modules())").format(root=str(M.ROOT))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, cwd=str(M.ROOT)).stdout
    assert out.strip().splitlines()[-1] == "[]"
