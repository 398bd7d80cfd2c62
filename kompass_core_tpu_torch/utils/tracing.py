"""Spans and counters of the port: where a call's host and device time go.

``span(name, device=None)`` marks one stretch of the program. A host span
(``device`` None) times the host; a stage span (``device`` the torch
device the stage's tensors live on) also times the card with CUDA events.
``count(name, n)`` adds to a counter. Totals are kept per name in this
module's one registry: ``snapshot()`` returns them, ``reset()`` clears
them, ``records()`` gives the latest finished spans one by one.

Spans are on while ``enable()`` is in force or while a ``torch.profiler``
is recording (PyTorch's own flag). Under a profiler every span is also a
``record_function`` range, so the profiler's trace holds the program's
spans on its own clock, beside the card's activity. Off, ``span`` checks
two flags and returns one shared no-op object: it calls no torch function
and reads no clock. While ``torch.compile`` or ``torch.export`` traces,
spans do nothing, so a traced program holds no profiler operator.
Counters always count.

An open span records its host start and end (``time.perf_counter_ns``),
its parent, and its call id: a span opened with no span open (a root,
such as ``fleet.call``) takes the next id, and its children inherit it.
Per name the registry keeps ``count``, ``host_s``, ``self_s`` (host time
less that of the children) and ``device_s`` with ``device_n``, the number
of device intervals read into it.

Device time. The stages of one stage run (``stages(device)``, opened by
the tick programs) share their boundary events: a run of s stages records
s + 1 events, a stage that follows one of its own name continues it, and
device work between two stages counts to the earlier one. A stage span
outside any run records its own two events. The events are read when a
root span ends and they are complete, which for a fleet call is after its
outputs reached the host, so reading them adds no synchronisation;
``snapshot()`` waits for any left.

CUDA graphs. Inside ``capture_log()`` a stage run that is being captured
records ``torch.cuda.Event(enable_timing=True, external=True)`` nodes,
whether spans are on or not, and hands the run to the log. Its caller
owns the runs and, after a replay's outputs reached the host, passes them
to ``replayed`` while spans are on. Every other capture records no event.
"""

import collections
import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

RECORDS = 10000  # finished spans kept for ``records()``

_lock = threading.Lock()
_enabled = 0  # enable() in force
_forced = 0  # enable() in force plus open capture logs: the off path's flag
_totals = {}  # name -> [count, host_ns, self_ns, device_ms, device_n]
_records = collections.deque(maxlen=RECORDS)
_pending = []  # stage runs whose events are not read yet
_pool = {}  # device -> timing events free for reuse
_calls = itertools.count(1)


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # open host spans
        self.run = None  # the open stage run
        self.logs = []  # open capture logs


_local = _Local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Enabled:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        disable()
        return False


def enable():
    """Turn spans on until the matching ``disable()``; also a context
    manager (``with tracing.enable(): ...``) that disables on exit."""
    global _enabled, _forced
    with _lock:
        _enabled += 1
        _forced += 1
    return _Enabled()


def disable():
    global _enabled, _forced
    with _lock:
        if _enabled:
            _enabled -= 1
            _forced -= 1


def is_on() -> bool:
    """Whether spans record: ``enable()`` is in force or a profiler is."""
    return bool(_enabled or _profiler._is_profiler_enabled)


def _entry(name):
    t = _totals.get(name)
    if t is None:
        t = _totals[name] = [0, 0, 0, 0.0, 0]
    return t


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always, on or off)."""
    with _lock:
        _entry(name)[0] += n


def _stage_device(device, on):
    """The CUDA device a stage records events on, or None: eagerly while
    spans are on, in a capture only inside ``capture_log()``."""
    if device is None or device.type != "cuda":
        return None
    if torch.cuda.is_current_stream_capturing():
        return device if _local.logs else None
    return device if on else None


def _take(device):
    free = _pool.get(device)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


class _Run:
    """One stage run on one device: its stage names and the s + 1 events
    around them. As a context manager it is the thread's open run."""

    __slots__ = ("device", "names", "events", "graph", "prev")

    def __init__(self, device):
        self.device = device
        self.names = []
        self.events = []
        self.graph = torch.cuda.is_current_stream_capturing()

    def _record(self):
        if self.graph:
            ev = torch.cuda.Event(enable_timing=True, external=True)
        else:
            ev = _take(self.device)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def stage(self, name):
        if not self.names or self.names[-1] != name:
            self.events.append(self._record())
            self.names.append(name)

    def close(self):
        if not self.names:
            return
        self.events.append(self._record())
        if self.graph:
            _local.logs[-1].append(self)
        else:
            with _lock:
                _pending.append(self)

    def __enter__(self):
        self.prev = _local.run
        _local.run = self
        return self

    def __exit__(self, *exc):
        _local.run = self.prev
        self.close()
        return False


class _Span:
    __slots__ = ("name", "host", "device", "parent", "call", "t0", "child_ns",
                 "rf", "bare")

    def __init__(self, name, host, device):
        self.name, self.host, self.device = name, host, device
        self.rf = self.bare = None

    def __enter__(self):
        if self.host:
            stack = _local.stack
            self.parent = stack[-1] if stack else None
            self.call = next(_calls) if self.parent is None else self.parent.call
            self.child_ns = 0
            if _profiler._is_profiler_enabled:
                self.rf = torch.profiler.record_function(self.name)
                self.rf.__enter__()
            stack.append(self)
            self.t0 = time.perf_counter_ns()
        if self.device is not None:
            run = _local.run
            if run is None or run.device != self.device:
                run = self.bare = _Run(self.device)
            run.stage(self.name)
        return self

    def __exit__(self, *exc):
        if self.bare is not None:
            self.bare.close()
        if not self.host:
            return False
        t1 = time.perf_counter_ns()
        dur = t1 - self.t0
        _local.stack.pop()
        parent = self.parent
        with _lock:
            t = _entry(self.name)
            t[0] += 1
            t[1] += dur
            t[2] += dur - self.child_ns
            _records.append((self.name, self.call,
                             None if parent is None else parent.name, self.t0, t1))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if parent is None:
            _resolve(block=False)
        else:
            parent.child_ns += dur
        return False


def span(name: str, device=None):
    """A context manager over one stretch of the program: a host span, or
    with ``device`` (a ``torch.device``) a stage span that also times the
    card there. Off, the shared no-op."""
    if not _forced and not _profiler._is_profiler_enabled:
        return _NOOP
    if torch.compiler.is_compiling():
        return _NOOP
    on = is_on()
    dev = _stage_device(device, on)
    if not on and dev is None:
        return _NOOP
    return _Span(name, on, dev)


def stages(device):
    """A stage run on ``device``: the stage spans inside it share their
    boundary events. Inside an open run on the same device it joins that
    run; off, the shared no-op."""
    if not _forced and not _profiler._is_profiler_enabled:
        return _NOOP
    if torch.compiler.is_compiling():
        return _NOOP
    dev = _stage_device(device, is_on())
    if dev is None or (_local.run is not None and _local.run.device == dev):
        return _NOOP
    return _Run(dev)


@contextlib.contextmanager
def capture_log():
    """Collect the stage runs captured into a CUDA graph while open: yields
    the list they are appended to."""
    global _forced
    log = []
    with _lock:
        _forced += 1
    _local.logs.append(log)
    try:
        yield log
    finally:
        _local.logs.pop()
        with _lock:
            _forced -= 1


def replayed(runs) -> None:
    """Add one replay's intervals of the captured ``runs`` (after the
    replay's outputs reached the host), while spans are on."""
    if runs and is_on():
        with _lock:
            _pending.extend(runs)


def _resolve(block: bool) -> None:
    """Read the pending runs' intervals into the registry: every run when
    ``block`` (waiting for the card), else those whose events are done."""
    with _lock:
        runs = _pending[:]
        _pending.clear()
    keep = []
    for run in runs:
        last = run.events[-1]
        if not block and not last.query():
            keep.append(run)
            continue
        last.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(run.events, run.events[1:])]
        with _lock:
            for name, t in zip(run.names, ms):
                e = _entry(name)
                e[3] += t
                e[4] += 1
            if not run.graph:
                _pool.setdefault(run.device, []).extend(run.events)
    if keep:
        with _lock:
            _pending[:0] = keep


def snapshot() -> dict:
    """Totals per span and counter name: ``count``, ``host_s``, ``self_s``,
    ``device_s`` and ``device_n``, after reading every pending interval."""
    _resolve(block=True)
    with _lock:
        return {name: {"count": c, "host_s": h * 1e-9, "self_s": s * 1e-9,
                       "device_s": d * 1e-3, "device_n": n}
                for name, (c, h, s, d, n) in _totals.items()}


def records() -> list:
    """The latest finished host spans, oldest first: (name, call id,
    parent name or None, start ns, end ns)."""
    with _lock:
        return list(_records)


def reset() -> None:
    """Clear the totals, counters, records and unread intervals."""
    with _lock:
        _totals.clear()
        _records.clear()
        _pending.clear()
