"""The port's spans and counters (``utils/tracing.py``) and where the
fleet opens them (``parallel/fleet_v2.py``, ``ops/fleet_solver.py``,
``ops/solver.py``).

On the CPU: the off path, the registry's totals, self times, nesting,
call ids and counters, the spans following a running ``torch.profiler``,
the stage runs' shared boundaries (with stand-in timing events), fleet
outputs bit-identical with tracing on and off, and a served export with
no profiler operator. Marked ``cuda`` (each skips inside the test on a
host without a CUDA device): the stage intervals of an eager tick and of
a k = 8 replay, replays bit-identical with tracing on and off, and the
graphs' capture and replay counts. Run those on a GPU host with
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``.
"""

import json
import time

import numpy as np
import pytest
import torch

from kompass_core_tpu_torch.serving.export import trace_fleet_tick
from kompass_core_tpu_torch.control import DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu_torch.models import (
    AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits, RobotGeometry,
    RobotType,
)
from kompass_core_tpu_torch.parallel import DeviceFleet
from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig
from kompass_core_tpu_torch.utils import tracing

STAGES = ("step.follow", "solve.rollout", "solve.sweep", "solve.costs", "step.gate")
HOST = ("fleet.call", "fleet.pack", "fleet.enqueue", "fleet.fetch")


@pytest.fixture(autouse=True)
def clean_registry():
    assert not tracing.is_on()
    tracing.reset()
    yield
    while tracing._enabled:
        tracing.disable()
    tracing.reset()


def _fleet(device, n=4, rays=32, samples=5, steps=6, peers=False):
    """``n`` diff-drive robots on bent 6 m lanes; with ``peers`` every
    fourth a BOX, ring-4 predicted peers, 2 tracked slots and the safety
    gate (the benchmark's peer fleet in small)."""
    robots = [
        Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
              geometry_type=RobotGeometry.Type.BOX,
              geometry_params=np.array([0.5, 0.3, 0.4]))
        if peers and i % 4 == 0 else
        Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
              geometry_type=RobotGeometry.Type.CYLINDER,
              geometry_params=np.array([0.25, 0.4]))
        for i in range(n)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.2, max_acc=1.5, max_decel=2.5),
        omega_limits=AngularCtrlLimits(max_vel=1.5, max_acc=3.0, max_decel=3.0,
                                       max_steer=np.pi))
    config = DWAConfig(
        max_linear_samples=samples, max_angular_samples=samples,
        prediction_horizon=steps, control_horizon=2, control_time_step=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=3.0,
            obstacles_distance_weight=1.0))
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=rays, path_capacity=1024, max_segments=16,
        peer_avoidance=peers, peer_ring_points=4, peer_prediction=peers,
        safety_config=FleetSafetyConfig() if peers else None,
        tracked_obstacles=2 if peers else 0, device=device)
    fleet.set_paths([np.array([[0.0, 3.0 * i], [3.0, 3.0 * i], [6.0, 3.0 * i + 1.0]])
                     for i in range(n)])
    fleet.set_scan_angles(np.linspace(-np.pi, np.pi, rays, endpoint=False))
    return fleet


def _inputs(n, rays, seed, peers=False):
    rng = np.random.default_rng(seed)
    states = np.zeros((n, 4), np.float32)
    states[:, 1] = 3.0 * np.arange(n) + rng.uniform(-0.1, 0.1, n)
    states[:, 2] = rng.uniform(-0.2, 0.2, n)
    vels = np.zeros((n, 3), np.float32)
    vels[:, 0] = rng.uniform(0.0, 0.5, n)
    ranges = rng.uniform(1.0, 8.0, (n, rays)).astype(np.float32)
    tracked = None
    if peers:
        tracked = np.full((n, 2, 4), np.nan, np.float32)
        tracked[:, 0] = np.stack([states[:, 0] + 2.0, states[:, 1], -np.full(n, 0.3),
                                  np.zeros(n)], 1)
    return states, vels, ranges, tracked


def _calls(fleet, k, calls, seed, peers=False):
    """``calls`` entry calls of ``fleet`` (``tick`` for k = None, else
    ``run_ticks_on_device(k)``) on seeded inputs: their outputs."""
    n = fleet.num_robots
    angles = fleet._angles_src
    outs = []
    for c in range(calls):
        states, vels, ranges, tracked = _inputs(n, fleet._scan_rays, seed + c, peers)
        if k is None:
            outs.append(fleet.tick(states, vels, ranges, angles, tracked=tracked))
        else:
            outs.append(fleet.run_ticks_on_device(k, states, vels, ranges, angles,
                                                  tracked=tracked))
    return outs


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for key in x:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


# --- the registry ------------------------------------------------------------


def test_off_span_is_the_shared_noop_and_touches_no_torch(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the off path called it")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.compiler, "is_compiling", boom)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", boom)
    monkeypatch.setattr(tracing.time, "perf_counter_ns", boom)
    noop = tracing.span("fleet.pack")
    assert tracing.span("step.follow", torch.device("cpu")) is noop
    assert tracing.stages(torch.device("cpu")) is noop
    with noop, tracing.span("fleet.call"):
        pass
    tracing.replayed([object()])
    monkeypatch.undo()
    assert tracing.snapshot() == {} and tracing.records() == []


def test_on_totals_self_time_nesting_call_ids_and_counters():
    tracing.count("fleet.graph_replays")  # counters count while off too
    with tracing.enable():
        assert tracing.is_on()
        for _ in range(2):
            with tracing.span("fleet.call"):
                with tracing.span("fleet.pack"):
                    time.sleep(0.002)
                with tracing.span("fleet.enqueue"):
                    with tracing.span("step.follow", torch.device("cpu")):
                        time.sleep(0.002)
                time.sleep(0.001)
        tracing.count("fleet.graph_replays", 2)
    assert not tracing.is_on()
    with tracing.span("fleet.call"):
        pass  # off again: not recorded
    snap = tracing.snapshot()
    assert snap["fleet.graph_replays"]["count"] == 3
    assert {n: snap[n]["count"] for n in HOST[:3]} == {
        "fleet.call": 2, "fleet.pack": 2, "fleet.enqueue": 2}
    assert snap["step.follow"]["count"] == 2
    for name in ("fleet.pack", "step.follow"):
        assert snap[name]["self_s"] == snap[name]["host_s"] >= 0.004
    enq, call = snap["fleet.enqueue"], snap["fleet.call"]
    assert enq["self_s"] == pytest.approx(enq["host_s"] - snap["step.follow"]["host_s"])
    assert call["self_s"] == pytest.approx(
        call["host_s"] - snap["fleet.pack"]["host_s"] - enq["host_s"])
    assert 0.002 <= call["self_s"] < call["host_s"]
    assert all(v["device_s"] == 0.0 and v["device_n"] == 0 for v in snap.values())

    recs = tracing.records()
    assert [(r[0], r[2]) for r in recs[:4]] == [
        ("fleet.pack", "fleet.call"), ("step.follow", "fleet.enqueue"),
        ("fleet.enqueue", "fleet.call"), ("fleet.call", None)]
    first, second = {r[1] for r in recs[:4]}, {r[1] for r in recs[4:]}
    assert len(first) == len(second) == 1 and first != second
    for name, _, parent, t0, t1 in recs:
        assert t0 <= t1
    root = recs[3]
    assert all(root[3] <= r[3] and r[4] <= root[4] for r in recs[:3])
    tracing.reset()
    assert tracing.snapshot() == {}


class _Event:
    """A stand-in CUDA timing event: its record time is a step counter."""

    clock = 0
    made = 0

    def __init__(self, **kw):
        type(self).made += 1

    def record(self, stream=None):
        type(self).clock += 1
        self.t = type(self).clock

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    """Stage spans on the CPU record stand-in events, as on a card."""
    _Event.clock = _Event.made = 0
    monkeypatch.setattr(tracing, "_stage_device",
                        lambda device, on: device if (device is not None and on) else None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    tracing._pool.clear()
    yield _Event
    tracing._pool.clear()


def test_a_stage_run_shares_its_boundaries(fake_card):
    dev = torch.device("cpu")
    with tracing.enable():
        with tracing.span("fleet.call"):
            with tracing.stages(dev):
                with tracing.span("step.follow", dev):
                    pass
                with tracing.span("step.follow", dev):  # continues the stage
                    pass
                assert tracing.stages(dev) is tracing._NOOP  # joins the run
                for name in ("solve.rollout", "solve.costs"):
                    with tracing.span(name, dev):
                        pass
            with tracing.span("step.gate", dev):  # outside a run: two events
                pass
    assert fake_card.made == 4 + 2  # 3 stages + 1, and the bare stage's 2
    snap = tracing.snapshot()
    assert {n: (snap[n]["device_n"], snap[n]["device_s"]) for n in
            ("step.follow", "solve.rollout", "solve.costs", "step.gate")} == {
        "step.follow": (1, 1e-3), "solve.rollout": (1, 1e-3),
        "solve.costs": (1, 1e-3), "step.gate": (1, 1e-3)}
    assert snap["step.follow"]["count"] == 2
    # read events go back to the pool: a second call makes none
    with tracing.enable(), tracing.span("fleet.call"), tracing.stages(dev):
        with tracing.span("solve.rollout", dev), tracing.span("solve.costs", dev):
            pass
    assert fake_card.made == 6 and tracing.snapshot()["solve.rollout"]["device_n"] == 2


@pytest.mark.parametrize("k", [None, 3])
def test_a_tick_and_a_k_tick_loop_record_one_interval_per_stage_and_tick(fake_card, k):
    fleet = _fleet(torch.device("cpu"), peers=True)
    with tracing.enable():
        _calls(fleet, k, 1, 7, peers=True)
    ticks = k or 1
    assert fake_card.made == len(STAGES) * ticks + 1
    snap = tracing.snapshot()
    assert {n: snap[n]["device_n"] for n in STAGES} == {n: ticks for n in STAGES}
    assert snap["fleet.call"]["count"] == 1 and snap["fleet.call"]["device_n"] == 0


# --- the fleet under a profiler, and on against off ----------------------------


def test_spans_follow_a_running_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    fleet = _fleet(torch.device("cpu"))
    _calls(fleet, None, 1, 3)
    assert tracing.snapshot() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.is_on()  # PyTorch's own flag turns the spans on
        _calls(fleet, None, 2, 3)
    assert not tracing.is_on()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(("fleet.", "step.", "solve."))]
    calls = [e for e in spans if e["name"] == "fleet.call"]
    assert len(calls) == 2
    for name in ("fleet.pack", "fleet.enqueue", "fleet.fetch"):
        inner = [e for e in spans if e["name"] == name]
        assert len(inner) == 2
        for e in inner:
            assert any(c["ts"] <= e["ts"] and e["ts"] + e["dur"] <= c["ts"] + c["dur"]
                       for c in calls)
    assert {e["name"] for e in spans} >= set(STAGES)
    assert tracing.snapshot()["fleet.call"]["count"] == 2
    _calls(fleet, None, 1, 5)  # the profiler stopped: nothing more
    assert tracing.snapshot()["fleet.call"]["count"] == 2


@pytest.mark.parametrize("peers", [False, True])
@pytest.mark.parametrize("k", [None, 3])
def test_cpu_outputs_are_bit_identical_with_tracing_on_and_off(k, peers):
    device = torch.device("cpu")
    off = _calls(_fleet(device, peers=peers), k, 3, 11, peers)
    with tracing.enable():
        on = _calls(_fleet(device, peers=peers), k, 3, 11, peers)
    _assert_same(off, on)
    snap = tracing.snapshot()
    assert all(snap[n]["count"] == 3 for n in HOST)
    assert all(snap[n]["count"] >= 3 for n in STAGES)


def test_the_served_fleet_tick_holds_no_profiler_operator():
    from torch.profiler import ProfilerActivity, profile

    fleet = _fleet(torch.device("cpu"), peers=True)
    with tracing.enable(), profile(activities=[ProfilerActivity.CPU]):
        program = trace_fleet_tick(fleet, device="cpu")
    targets = [str(node.target) for node in program.graph.nodes
               if node.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record" in t]
    assert tracing.snapshot() == {}


# --- the sample counters --------------------------------------------------------

MIXED = (RobotType.OMNI, RobotType.ACKERMANN, RobotType.DIFFERENTIAL_DRIVE,
         RobotType.OMNI)


def _kin_fleet(device, kinds, rays=32, samples=8, steps=6):
    """Robots of the drives ``kinds`` on the bent lanes of ``_fleet``; an
    omni robot has vy limits, the others the default zero ones."""
    robots = [Robot(robot_type=kind, geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.25, 0.4])) for kind in kinds]
    lin = LinearCtrlLimits(max_vel=1.2, max_acc=1.5, max_decel=2.5)
    ang = AngularCtrlLimits(max_vel=1.5, max_acc=3.0, max_decel=3.0, max_steer=np.pi)
    limits = [RobotCtrlLimits(vx_limits=lin, omega_limits=ang,
                              vy_limits=LinearCtrlLimits(max_vel=0.6, max_acc=1.0,
                                                         max_decel=2.0))
              if kind == RobotType.OMNI else RobotCtrlLimits(vx_limits=lin, omega_limits=ang)
              for kind in kinds]
    config = DWAConfig(max_linear_samples=samples, max_angular_samples=samples,
                       prediction_horizon=steps, control_horizon=2, control_time_step=0.1)
    n = len(kinds)
    fleet = DeviceFleet(robots, limits, config, scan_rays=rays, path_capacity=1024,
                        max_segments=16, device=device)
    fleet.set_paths([np.array([[0.0, 3.0 * i], [3.0, 3.0 * i], [6.0, 3.0 * i + 1.0]])
                     for i in range(n)])
    fleet.set_scan_angles(np.linspace(-np.pi, np.pi, rays, endpoint=False))
    return fleet


@pytest.mark.parametrize("kinds, dead_rows", [
    ((RobotType.DIFFERENTIAL_DRIVE,) * 4, 0),
    ((RobotType.ACKERMANN, RobotType.DIFFERENTIAL_DRIVE) * 2, 0),
    (MIXED, 2),  # the Ackermann and the diff-drive robot
    ((RobotType.OMNI,) * 3, 0),
])
@pytest.mark.parametrize("k", [None, 3])
def test_sample_counters_count_every_row_and_the_dead_slots(k, kinds, dead_rows):
    """While spans are on, ``fleet.samples`` is n·S·k a call and
    ``fleet.dead_samples`` n_vx × (n_vy − 1) per non-omni row of an
    omni-shaped grid and tick; a fleet without an omni robot has none
    dead. Off, they count nothing."""
    fleet = _kin_fleet(torch.device("cpu"), kinds)
    spec = fleet.spec.solver
    assert spec.is_omni == (RobotType.OMNI in kinds)
    _calls(fleet, k, 1, 5)
    assert tracing.snapshot() == {}
    calls = 2
    with tracing.enable():
        _calls(fleet, k, calls, 7)
    ticks = calls * (k or 1)
    snap = tracing.snapshot()
    assert snap["fleet.samples"]["count"] == len(kinds) * spec.num_samples * ticks
    dead = dead_rows * spec.n_vx * (spec.n_vy - 1) * ticks
    assert snap["fleet.dead_samples"]["count"] == dead
    if dead_rows:
        assert (spec.n_vx, spec.n_vy, spec.n_omega) == (7, 3, 9)
        assert dead == 2 * 14 * ticks


@pytest.mark.parametrize("k", [None, 3])
def test_mixed_fleet_cpu_outputs_are_bit_identical_with_tracing_on_and_off(k):
    device = torch.device("cpu")
    off = _calls(_kin_fleet(device, MIXED), k, 3, 11)
    with tracing.enable():
        on = _calls(_kin_fleet(device, MIXED), k, 3, 11)
    _assert_same(off, on)
    snap = tracing.snapshot()
    assert all(snap[n]["count"] == 3 for n in HOST)
    # the omni robots strafe: the vy branch ran
    assert any(np.abs(o["vy"]).max() > 0 for o in on)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (stage events and graphs are the card's)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("peers", [False, True])
def test_stage_intervals_of_an_eager_tick_and_a_k8_replay(cuda, peers):
    n = 16 if peers else 64
    fleet = _fleet(cuda, n=n, rays=128, samples=20, steps=20, peers=peers)
    _calls(fleet, None, 1, 3, peers)
    _calls(fleet, 8, 1, 3, peers)  # the capture, with tracing off
    with tracing.enable():
        _calls(fleet, None, 1, 5, peers)
    snap = tracing.snapshot()
    assert {s: snap[s]["device_n"] for s in STAGES} == {s: 1 for s in STAGES}
    assert all(snap[s]["device_s"] > 0 for s in STAGES)
    tracing.reset()
    with tracing.enable():
        _calls(fleet, 8, 2, 5, peers)
    snap = tracing.snapshot()
    assert {s: snap[s]["device_n"] for s in STAGES} == {s: 16 for s in STAGES}
    assert all(snap[s]["device_s"] > 0 for s in STAGES)
    assert snap["fleet.graph_replays"]["count"] == 2
    assert "fleet.capture" not in snap
    assert len(fleet.tick_graphs[8].stages) == 1  # one run of 8 * 5 + 1 events
    assert len(fleet.tick_graphs[8].stages[0].events) == 8 * len(STAGES) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("peers", [False, True])
@pytest.mark.parametrize("k", [None, 8])
def test_card_outputs_are_bit_identical_with_tracing_on_and_off(cuda, k, peers):
    n = 16 if peers else 64
    make = lambda: _fleet(cuda, n=n, rays=128, samples=20, steps=20, peers=peers)  # noqa: E731
    off = _calls(make(), k, 4, 21, peers)
    with tracing.enable():
        on = _calls(make(), k, 4, 21, peers)
    _assert_same(off, on)
    # the first call's capture warms up with one eager run of the tick or
    # the loop, timed as the replays are
    calls = 4 + 1
    assert tracing.snapshot()["solve.costs"]["device_n"] == calls * (k or 1)


@pytest.mark.cuda
def test_one_capture_and_a_replay_per_call_and_set_paths_recaptures(cuda):
    from kompass_core_tpu_torch.ops import kernels

    fleet = _fleet(cuda, n=64, rays=128, samples=20, steps=20)
    before = kernels.launch_counts()
    _calls(fleet, 8, 5, 31)
    snap = tracing.snapshot()
    assert snap["fleet.graph_captures"]["count"] == 1
    assert snap["fleet.graph_replays"]["count"] == 5
    graph = fleet.tick_graphs[8]
    # K1 and K10 (the goal cost's nearest-segment search) launch once a tick
    assert graph.launches == {"K1": 8, "K10": 8} and graph.replays == 5
    # the wrappers ran for the warm-up and the capture, never for a replay
    assert kernels.launch_counts()["K1"] - before["K1"] == 16
    fleet.set_paths([np.array([[0.0, 3.0 * i], [5.0, 3.0 * i]]) for i in range(64)])
    _calls(fleet, 8, 2, 41)
    snap = tracing.snapshot()
    assert snap["fleet.graph_captures"]["count"] == 2
    assert snap["fleet.graph_replays"]["count"] == 7
    assert fleet.tick_graphs[8] is not graph and fleet.tick_graphs[8].replays == 2
