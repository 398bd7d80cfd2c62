"""One run of one cell: set-up, the measured window, the output check and
the result line.

Everything of a cell is found by name: the cell in ``BENCHMARK.json``,
its configuration file (the entry's ``file``), the configuration's
system ``portbench/systems/<system>.py``, its traffic file
``portbench/traffic/<traffic>.json``, the traffic's scene
``portbench/scenes/<scene>.py``, its limits
``portbench/limits/<cell>.json`` and each per-layer metric's reader
``portbench/metrics/<metric>.py``.
"""

import argparse
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .loop import Window, drive
from .trace import Trace, profile_calls

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kompass_core_tpu")


def load_cell(name: str, root: Path = ROOT):
    """(benchmark, cell, configuration dict, traffic dict, limits dict)
    of the cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return bench, cell, cfg, traffic, limits


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metrics this cell reports: its end-to-end metrics, or with a
    trace its per-layer metrics."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or cell in m["workloads"]:
            out.append(m)
    return out


def forbidden_modules():
    """Top-level names in ``sys.modules`` of JAX or the JAX package,
    compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def p95(values):
    return float(np.percentile(np.asarray(values, np.float64), 95))


class PowerSampler:
    """``nvidia-smi`` sampling the card's power draw and SM clock once a
    second beside the window, as a child process that is stopped and
    waited for."""

    def __init__(self):
        self.proc = None

    def start(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=power.draw,clocks.sm",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self):
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            text, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            text, _ = self.proc.communicate()
        draw, clock = [], []
        for line in text.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                draw.append(float(parts[0]))
                clock.append(float(parts[1]))
            except (ValueError, IndexError):
                continue
        return {"power_draw_w": draw, "clocks_sm_mhz": clock}


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench, cell, cfg, traffic, limits = load_cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run(args, bench, cell, cfg, traffic, limits, torch.device("cuda", 0), t_start)


def make_scene(traffic: dict, cfg: dict, seed: int):
    """The traffic's scene, ``portbench/scenes/<scene>.py``."""
    return importlib.import_module(f"portbench.scenes.{traffic['scene']}").Scene(
        traffic, cfg, seed)


def system_module(cfg: dict):
    """The configuration's system, ``portbench/systems/<system>.py``."""
    return importlib.import_module(f"portbench.systems.{cfg['system']}")


class Session:
    """One cell's system and scene on ``device``, from set-up to the check."""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.on_card = device.type == "cuda"
        self.scene = make_scene(traffic, cfg, seed)
        self.system = system_module(cfg).System(cfg, traffic, self.scene, seed, device)
        self.calls = 0
        self.first_call = 0

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def _drive(self, **kw):
        self.calls += drive(self.scene, self.system, **kw)

    def warm(self):
        """The cell's own shapes once: the first call builds the kernels;
        a k-tick cell's first call captures its graph."""
        self._drive(calls=int(self.traffic["warm_calls"]))
        self.sync()

    def measure(self, seconds, trace=False):
        """The window: (Window, Trace or None). With ``trace`` the first
        ``trace_calls`` calls run under the profiler."""
        win = Window()
        self.first_call = self.calls
        tr = None
        t0 = time.perf_counter()
        if trace:
            tr = Trace(work=self.system.work)
            profile_calls(lambda annotate: self._drive(
                calls=int(self.traffic["trace_calls"]), window=win, annotate=annotate,
                on_call=lambda out: tr.add_call(self.system.counts(out))), tr)
        rest = Window()
        self._drive(seconds=max(0.0, seconds - (time.perf_counter() - t0)), window=rest)
        win.latencies += rest.latencies
        win.solves += rest.solves
        win.seconds = time.perf_counter() - t0
        self.sync()
        return win, tr

    def release(self):
        """Free the program's state before the reference runs."""
        self.system.release()
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def check(self, control=False):
        return self.system.check(self.first_call, control=control)


def run(args, bench, cell, cfg, traffic, limits, device, t_start) -> int:
    s = Session(cfg, traffic, args.seed, device)
    s.warm()
    setup_s = time.perf_counter() - t_start
    limit_w = power_limit() if s.on_card else None

    sampler = PowerSampler()
    if s.on_card:
        sampler.start()
    try:
        win, tr = s.measure(args.seconds, bool(args.trace))
    finally:
        power = sampler.stop()
    peak = int(torch.cuda.max_memory_allocated(device)) if s.on_card else 0
    bad = forbidden_modules()
    if bad:
        print("portbench: modules of JAX or the JAX package are loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    s.release()
    numbers = s.check()
    correct = all(numbers[k] <= limits[k] for k in limits)
    checks = {k: {"value": plain(numbers[k]), "limit": limits[k]} for k in limits}

    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        if args.trace:
            value = importlib.import_module(f"portbench.metrics.{m['name']}").read(tr)
        else:
            value = {
                "solves_per_s": win.solves / win.seconds,
                "call_p95_ms": 1e3 * p95(win.latencies),
                "setup_s": setup_s,
            }.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if s.on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if s.on_card else device.type,
           "count": int(cell["chips"]), "memory_peak_bytes": peak,
           "power_limit_w": limit_w}
    result = {"correct": bool(correct), "attempted": len(win.latencies), "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
    result["judged_rows"] = numbers["judged_rows"]
    result["checks"] = checks
    print(json.dumps({"window": {"calls": len(win.latencies), "seconds": win.seconds,
                                 "call_median_ms": 1e3 * float(np.median(win.latencies))},
                      **power}))
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


def plain(value):
    """A number for the JSON line: an infinite or undefined reading as
    the string ``"inf"`` or ``"nan"``, which strict parsers take."""
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


def breakdown(tr):
    """The traced window's device operations that took most time and its
    longest idle time by what the host was doing, ten of each."""
    by_op = {}
    for name, _, d in tr.kernels + tr.copies:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + d * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def short_name(kernel: str) -> str:
    """A kernel's name without its trailing parameter list, at most 120
    characters."""
    name = kernel.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]
