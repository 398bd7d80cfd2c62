"""The closed loop: every call is sent when the previous one returned.

``drive`` runs calls, times each from handing the inputs to the system's
entry point until its outputs are on the host, hands each call to the
system's record, and counts the solves.
"""

import time
from contextlib import nullcontext


class Window:
    """What a window measured: per-call latencies, solves, its seconds."""

    def __init__(self):
        self.latencies = []
        self.solves = 0
        self.seconds = 0.0


def drive(scene, system, *, calls=None, seconds=None, window: Window = None,
          annotate=None, on_call=None):
    """Run calls until ``calls`` calls or ``seconds`` seconds have passed.
    ``annotate(name)`` gives a context for the benchmark's spans (scene
    work, the call); ``on_call(out)`` sees each call's outputs."""
    span = annotate or (lambda name: nullcontext())
    start = time.perf_counter()
    i = 0
    while True:
        if calls is not None and i >= calls:
            break
        if seconds is not None and time.perf_counter() - start >= seconds:
            break
        with span("portbench.scene"):
            inputs = scene.inputs()
        t0 = time.perf_counter()
        with span("portbench.call"):
            out = system.call(inputs)
        t1 = time.perf_counter()
        with span("portbench.scene"):
            system.record(inputs, out)
            scene.advance(out)
        if window is not None:
            window.latencies.append(t1 - t0)
            window.solves += system.solves(out)
        if on_call is not None:
            on_call(out)
        i += 1
    if window is not None:
        window.seconds = time.perf_counter() - start
    return i
