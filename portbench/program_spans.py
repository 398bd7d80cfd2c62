"""The program's own spans and counters (``kompass_core_tpu_torch``'s
``utils/tracing.py``), as the readers of the ``program_span`` metrics
take them: the program records them while the traced run's profiler
records, so after the traced calls its registry holds those calls alone.

A program without the tracing module, or one that recorded nothing under
a name, gives nothing to read: the readers then return None."""


def totals() -> dict:
    """The program's totals per span and counter name, or {} where the
    program has no tracing module."""
    try:
        from kompass_core_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.snapshot()


def per_call(name: str, key: str):
    """ms per entry call (``fleet.call``) of ``key`` of span ``name``."""
    t = totals()
    calls = t.get("fleet.call", {}).get("count", 0)
    value = t.get(name, {}).get(key, 0.0)
    if not calls or not value:
        return None
    return 1e3 * value / calls


def per_tick(tr, names, key: str):
    """ms per control tick of the traced calls (``tr.counts["ticks"]``) of
    ``key`` summed over the spans ``names``."""
    t = totals()
    ticks = tr.counts.get("ticks", 0)
    value = sum(t.get(name, {}).get(key, 0.0) for name in names)
    if not ticks or not value:
        return None
    return 1e3 * value / ticks
