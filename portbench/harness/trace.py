"""The traced run: ``torch.profiler`` over a stretch of the window, read
back from its Chrome trace into a ``Trace`` the per-layer readers use.

The benchmark's own spans (``portbench.call`` around each entry call,
``portbench.scene`` around the scene work between calls) are
``record_function`` ranges in the same trace. The traced window runs from
the first traced span's start to the last one's end; device time is the
union of kernel, copy and set intervals inside it.
"""

import bisect
import collections
import json
import os
import tempfile
import warnings
from dataclasses import dataclass, field

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaLaunchCooperativeKernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """One traced stretch of a cell's window."""

    work: dict = field(default_factory=dict)  # the system's static sizes
    calls: int = 0  # entry calls traced
    counts: dict = field(default_factory=collections.Counter)  # the system's counters
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: list = field(default_factory=list)  # (name, start_us, dur_us)
    copies: list = field(default_factory=list)  # (name, start_us, dur_us)
    launches: int = 0
    idle_by_host: dict = field(default_factory=dict)  # host activity -> idle s

    def add_call(self, counts: dict):
        self.calls += 1
        self.counts.update(counts)


def _union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def read_chrome_trace(path: str, tr: Trace):
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in ("portbench.call", "portbench.scene")]
    if not spans:
        return tr
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    tr.window_s = (t1 - t0) * 1e-6

    def inside(e):
        return "dur" in e and e["ts"] >= t0 and e["ts"] + e["dur"] <= t1

    device = []
    host = []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS and inside(e):
            item = (e["name"], e["ts"], e["dur"])
            (tr.kernels if cat == "kernel" else tr.copies).append(item)
            device.append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and inside(e):
            if e["name"] in LAUNCH_CALLS:
                tr.launches += 1
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in ("cpu_op", "user_annotation") and inside(e):
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    tr.busy_s = _union(device) * 1e-6
    tr.idle_by_host = _idle_by_host(device, host, t0, t1)
    return tr


def _idle_by_host(device, host, t0, t1):
    """Idle seconds of the device, each gap named by the innermost host
    activity open at its middle (a runtime call, an operator, or the
    benchmark's span)."""
    gaps = []
    end = t0
    for s, e in sorted(device):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    host = sorted(host)
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("portbench.")]
    out = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = next((n for s, e, n in spans if s <= mid <= e), "no host activity")
        # the innermost open activity: the latest start still open at mid
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, e, n = host[j]
            if e >= mid:
                name = n
                break
        out[name] += (b - a) * 1e-6
    return dict(out)


def profile_calls(run_calls, trace: Trace):
    """Run ``run_calls(annotate)`` under ``torch.profiler`` (CPU and CUDA
    activities) and read its trace into ``trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with warnings.catch_warnings():
        # one profiling cycle: nothing to accumulate across cycles
        warnings.filterwarnings("ignore", message=".*clears events at the end of each cycle")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_calls(record_function)
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, trace)
    finally:
        os.remove(path)
