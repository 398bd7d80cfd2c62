"""The end-to-end metrics take all the window's work and every call; the
roofline's counts and peaks are pinned."""

import json

import numpy as np
import pytest

from portbench import roofline
from portbench.harness.main import BENCH, p95
from portbench.harness.trace import Trace, _union
from portbench.metrics import (
    copy_ms_per_call, device_idle_pct, launch_calls_per_tick, plain_ops_ms_per_tick,
    step_mfu, sweep_ms_per_tick, sweep_roofline_pct,
)
from portbench.reference.fleet import Layout
from portbench.tests.tiny import session


def test_window_counts_every_call_and_all_its_solves():
    s = session("disc256.k8", 7)
    s.warm()
    win, _ = s.measure(0.5)
    calls = s.calls - s.first_call
    assert len(s.system.rec.calls) == s.calls
    assert len(win.latencies) == calls > 0
    assert win.solves == calls * s.scene.n * s.scene.k
    assert win.seconds >= 0.5 and win.seconds >= sum(win.latencies)


def test_p95_is_over_every_call():
    lat = [0.010] * 95 + [0.100] * 5
    assert p95(lat) == pytest.approx(np.percentile(lat, 95))
    # not a median of chunks: the tail of the whole list counts
    assert p95([0.01] * 90 + [1.0] * 10) > 0.5


def test_roofline_counts_and_peaks_are_pinned():
    assert roofline.FP32_PEAK == 67e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.PAIR_OPS == {"direct": 6, "box": 16}
    assert roofline.MOVING_ROW_STEP_OPS == 4
    ops, nbytes = roofline.sweep_work("direct", samples=2025, steps=30, active_steps=30,
                                      robots=1, rows=512, seg_rows=302)
    assert ops == 6 * 2025 * 30 * 814
    assert nbytes == 2 * 2025 * 30 * 4 + 2 * 4 * 814 + 4 + 2 * 2025 * 30 * 4
    ops, nbytes = roofline.sweep_work("box", samples=2025, steps=30, active_steps=30,
                                      robots=1, rows=1087, moving_rows=575)
    assert ops == 16 * 2025 * 30 * 1087 + 4 * 30 * 575
    assert nbytes == (4 * 2025 * 30 * 4 + 2 * 4 * 1087 + 2 * 4 * 575 + 4 * 4
                      + 2025 * 30 * 4)


@pytest.mark.parametrize("config, robots, shape", [
    # 512 rays, the path window's 301 lookahead points + 1 (1 m/s over 3 s
    # at 0.01 m), no movers: not the program's 512-row bucket and 320
    ("fleet_disc_2025x30", 1024,
     dict(samples=2025, steps=30, rows=512, moving_rows=0, seg_rows=302, box=False)),
    ("fleet_disc_2025x30", 256,
     dict(samples=2025, steps=30, rows=512, moving_rows=0, seg_rows=302, box=False)),
    # 512 rays + 8 tracked slots + 63 other robots' 9-point discs; 361 + 1
    # segment points (1.2 m/s): not the program's 768 + 576 rows and 384
    ("fleet_boxpeer_2025x30", 64,
     dict(samples=2025, steps=30, rows=1087, moving_rows=575, seg_rows=362, box=True)),
])
def test_the_sweeps_rows_are_the_functions(config, robots, shape):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    assert roofline.sweep_shape(Layout(cfg, robots)) == shape


def trace_of(kernels, copies, launches, window_s, busy_s):
    tr = Trace(work=dict(samples=10, steps=5, rows=8, moving_rows=0, seg_rows=4, box=False),
               window_s=window_s, busy_s=busy_s)
    tr.add_call({"ticks": 2, "robot_ticks": 4, "active_steps": 20})
    tr.add_call({"ticks": 2, "robot_ticks": 4, "active_steps": 20})
    tr.kernels, tr.copies, tr.launches = kernels, copies, launches
    return tr


def test_readers():
    tr = trace_of([("void static_min_dist_kernel<0, 8, true>(float*)", 0, 1000.0),
                   ("void at::native::elementwise_kernel<...>()", 0, 3000.0)],
                  [("Memcpy HtoD (Pageable -> Device)", 0, 200.0),
                   ("Memcpy DtoD (Device -> Device)", 0, 50.0)], 20, 0.01, 0.004)
    assert tr.calls == 2 and tr.counts["ticks"] == 4
    assert launch_calls_per_tick.read(tr) == 5.0
    assert copy_ms_per_call.read(tr) == pytest.approx(0.1)
    assert plain_ops_ms_per_tick.read(tr) == pytest.approx(0.75)
    assert sweep_ms_per_tick.read(tr) == pytest.approx(0.25)
    assert device_idle_pct.read(tr) == pytest.approx(60.0)
    ops, nbytes = roofline.sweep_work("direct", samples=10, steps=5, active_steps=40,
                                      robots=8, rows=8, seg_rows=4)
    least = max(ops / 67e12, nbytes / 3.35e12)
    assert sweep_roofline_pct.read(tr) == pytest.approx(100 * least / 1e-3)
    assert step_mfu.read(tr) == pytest.approx(100 * ops / (0.004 * 67e12))


def test_readers_give_nothing_without_a_trace():
    tr = trace_of([], [], 0, 0.0, 0.0)
    for reader in (launch_calls_per_tick, copy_ms_per_call, plain_ops_ms_per_tick,
                   sweep_ms_per_tick, sweep_roofline_pct, device_idle_pct, step_mfu):
        assert reader.read(tr) is None


def test_busy_time_is_the_union_of_intervals():
    assert _union([(0, 10), (5, 15), (20, 25)]) == 20
