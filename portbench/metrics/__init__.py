"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric. Each has ``read(trace)``: the value
from a ``harness.trace.Trace``, or None where the trace holds nothing to
read (the harness then leaves the metric out of the line)."""
