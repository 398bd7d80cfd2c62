"""The readers of the program's spans (``program_spans.py`` and the six
``program_span`` metrics) on a stand-in registry: the right value per
call or per tick, and None where the program recorded nothing or has no
tracing module."""

import sys

import pytest

from kompass_core_tpu_torch.utils import tracing
from portbench.harness.trace import Trace
from portbench.metrics import (
    costs_ms_per_tick, enqueue_ms_per_tick, fetch_ms_per_call, follow_ms_per_tick,
    pack_ms_per_call, rollout_ms_per_tick,
)

READERS = (pack_ms_per_call, enqueue_ms_per_tick, fetch_ms_per_call,
           follow_ms_per_tick, rollout_ms_per_tick, costs_ms_per_tick)


def _entry(count=0, host_s=0.0, self_s=0.0, device_s=0.0, device_n=0):
    return dict(count=count, host_s=host_s, self_s=self_s, device_s=device_s,
                device_n=device_n)


SNAPSHOT = {
    "fleet.call": _entry(4, 0.400, 0.004),
    "fleet.pack": _entry(4, 0.012, 0.008),
    "fleet.enqueue": _entry(4, 0.064, 0.064),
    "fleet.fetch": _entry(4, 0.200, 0.200),
    "step.follow": _entry(64, 0.010, 0.010, 0.016, 32),
    "step.gate": _entry(64, 0.010, 0.010, 0.008, 32),
    "solve.rollout": _entry(32, 0.010, 0.010, 0.048, 32),
    "solve.sweep": _entry(32, 0.010, 0.010, 0.100, 32),
    "solve.costs": _entry(32, 0.010, 0.010, 0.064, 32),
    "fleet.graph_replays": _entry(4),
}


def _trace(ticks=32):
    tr = Trace()
    for _ in range(4):
        tr.add_call({"ticks": ticks // 4})
    return tr


@pytest.mark.parametrize("reader, value", [
    (pack_ms_per_call, 2.0),  # self time 8 ms over 4 calls
    (enqueue_ms_per_tick, 2.0),  # 64 ms over 32 ticks
    (fetch_ms_per_call, 50.0),
    (follow_ms_per_tick, 0.75),  # follow and gate, 24 ms over 32 ticks
    (rollout_ms_per_tick, 1.5),
    (costs_ms_per_tick, 2.0),
])
def test_each_reader_takes_its_span_per_call_or_tick(monkeypatch, reader, value):
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAPSHOT)
    assert reader.read(_trace()) == pytest.approx(value)


@pytest.mark.parametrize("reader", READERS)
def test_an_empty_registry_reads_none(monkeypatch, reader):
    monkeypatch.setattr(tracing, "snapshot", lambda: {})
    assert reader.read(_trace()) is None
    # spans without device time (a CPU run), or a run of no ticks
    host_only = {k: dict(v, device_s=0.0) for k, v in SNAPSHOT.items()}
    monkeypatch.setattr(tracing, "snapshot", lambda: host_only)
    if reader in (follow_ms_per_tick, rollout_ms_per_tick, costs_ms_per_tick):
        assert reader.read(_trace()) is None
    if reader in (enqueue_ms_per_tick, follow_ms_per_tick, rollout_ms_per_tick,
                  costs_ms_per_tick):
        assert reader.read(Trace()) is None


@pytest.mark.parametrize("reader", READERS)
def test_a_program_without_the_tracing_module_reads_none(monkeypatch, reader):
    import kompass_core_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "kompass_core_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(utils, "tracing")
    assert reader.read(_trace()) is None
