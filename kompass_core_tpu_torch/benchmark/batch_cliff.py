"""The flagship DWA's time per solve against the dispatch batch size.

Counterpart of ``kompass_core_tpu/benchmark/batch_cliff.py``. On the TPU
the per-solve time of the vmapped flagship solve jumped from batch 64 to
80, a tiling cliff that made ``make_fleet_solver`` chunk fleets at 64
rows (``parallel/fleet.py``'s ``chunk_size``). Here the robot axis is one
batch dimension of every tensor, and this harness asks the card the same
question:

1. ``sweep`` times one batched solve per batch size by the device loop:
   K carry-chained batched solves captured once as a CUDA graph
   (``make_batched_device_loop``, through ``device_loop._device_loop`` and
   ``utils/cuda_graph.capture``), the time per batch from the K-delta of
   two single replays, so the dispatch and the fetch cancel; µs per solve
   is that over the batch. ``compile_s`` is the capture and warm-up
   seconds of both K.
2. ``launch_stats`` stands in for the JAX module's ``hlo_stats`` (the
   optimized HLO's fusion counts and shapes): one replay of a captured
   batched solve under ``torch.profiler``, its kernel launches, the
   device time per kernel name, and K1's own time and share.

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.batch_cliff
--device cuda`` (the sweep), ``... --device cuda launches`` (the profile at
48, 64, 72 and 128); each prints the JSON and writes no file.
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Sequence

import numpy as np
import torch

# K1's CUDA kernel (csrc/fused_min_dist.cu) and, on the CPU, its operator
K1_NAMES = ("static_min_dist_kernel", "kompass_torch::fused_min_dist_sq")


def _flagship_spec():
    """The JAX module's spec: 45 x 45 samples, 30 steps, 6 control
    points, 512 scan and 384 segment slots, drop mode."""
    from .runner import dwa_spec

    return dwa_spec(45, 45, 30, 512, 384)


_BASE_ROW_CACHE: dict = {}


def _scenario_matrix(spec, batch: int, salt: float = 0.0) -> np.ndarray:
    """[batch, L] distinct packed scenarios: the runner's DWA variant 0
    (built once per spec) tiled over the batch, row i's robot x moved by
    1e-4 i + ``salt``."""
    from .runner import dwa_variants

    if spec not in _BASE_ROW_CACHE:
        _BASE_ROW_CACHE[spec] = dwa_variants(spec, 1)[0]
    mat = np.tile(_BASE_ROW_CACHE[spec], (batch, 1))
    mat[:, 0] += 1e-4 * np.arange(batch) + salt
    return mat


def batched_chain(spec, k: int):
    """K carry-chained batched solves of a [batch, L] matrix: each adds
    1e-6 + 1e-9 * its row's cost to every row's robot x (a data dependency
    on every row, so the solves run one after another and every row stays
    live). Returns row 0's cost of the last solve, a 0-d tensor; the
    input is left as it was."""
    from ..ops.solver import _unpack_and_solve

    def chain(mat):
        m = mat.clone()
        out = None
        for _ in range(k):
            out = _unpack_and_solve(spec, m)
            m[:, 0] += 1e-6 + 1e-9 * out[:, 1]
        return out[0, 1]

    return chain


def make_batched_device_loop(spec, batch: int, k: int, device):
    """One dispatch of K chained batched solves of a [``batch``, L] matrix
    on ``device``: one CUDA graph on the card, the eager chain on the
    CPU."""
    from .device_loop import _device_loop

    del batch  # the shape comes with the first input, as in the JAX program
    return _device_loop(batched_chain(spec, k), device)


def sweep(
    device,
    batches: Sequence[int] = (32, 48, 64, 72, 80, 96, 128),
    ks=(4, 20),
    repeats: int = 5,
    spec=None,
) -> list:
    """µs per solve per dispatch batch size, device-loop timed: the
    median over ``repeats`` of the K-delta of two single dispatches, one
    distinct resident input each."""
    from .runner import resident

    spec = spec or _flagship_spec()
    results = []
    for b in batches:
        f1 = make_batched_device_loop(spec, b, ks[0], device)
        f2 = make_batched_device_loop(spec, b, ks[1], device)
        variants = resident([
            torch.from_numpy(_scenario_matrix(spec, b, salt=1e-3 * i)).to(device)
            for i in range(2 * repeats + 2)
        ], device)
        it = iter(variants)
        t0 = time.time()
        f1(next(it)).item()
        f2(next(it)).item()
        compile_s = time.time() - t0
        ests = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            f1(next(it)).item()
            t1 = time.perf_counter()
            f2(next(it)).item()
            t2 = time.perf_counter()
            per_batch = ((t2 - t1) - (t1 - t0)) / (ks[1] - ks[0])
            ests.append(per_batch / b * 1e6)
        rec = {
            "batch": b,
            "us_per_solve": statistics.median(ests),
            "estimates_us": ests,
            "spread_us": max(ests) - min(ests),
            "compile_s": compile_s,
        }
        print(json.dumps(rec), flush=True)
        results.append(rec)
    return results


def _self_us(event, cuda: bool) -> float:
    """An averaged profiler event's own time in µs: on the device for a
    card's kernel, on the host for a CPU operator."""
    if cuda:
        return getattr(event, "self_device_time_total", 0.0)
    return event.self_cpu_time_total


def launch_stats(batch: int, device, spec=None) -> dict:
    """One batched solve of ``batch`` rows under ``torch.profiler``: on the
    card one replay of its captured graph (``device_loop`` at K = 1), its
    kernels by name with their launches and device ms; on the CPU one
    eager call, its operators by name with their own host ms. ``k1_ms``
    and ``k1_share`` are K1's (``K1_NAMES``)."""
    from torch.profiler import ProfilerActivity, profile

    from .runner import resident

    spec = spec or _flagship_spec()
    device = torch.device(device)
    cuda = device.type == "cuda"
    loop = make_batched_device_loop(spec, batch, 1, device)
    (mat,) = resident([torch.from_numpy(_scenario_matrix(spec, batch)).to(device)],
                      device)
    loop(mat).item()  # on the card: the capture
    run = loop.state["graph"].replay if cuda else (lambda: loop(mat))
    run()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        run()
        resident((), device)
    timed = [e for e in prof.key_averages() if _self_us(e, cuda) > 0]
    if not timed:
        raise RuntimeError(f"torch.profiler recorded no time for batch {batch}")
    total = sum(_self_us(e, cuda) for e in timed)
    k1 = sum(_self_us(e, cuda) for e in timed if any(n in e.key for n in K1_NAMES))
    by_name = sorted(timed, key=lambda e: _self_us(e, cuda), reverse=True)
    return {
        "batch": batch,
        "timer": "device" if cuda else "host",
        "launches": sum(e.count for e in timed),
        "kernels": len(timed),
        "total_ms": total / 1e3,
        "k1_ms": k1 / 1e3,
        "k1_share": k1 / total,
        "ms_by_kernel": {e.key[:160]: _self_us(e, cuda) / 1e3 for e in by_name},
        "launches_by_kernel": {e.key[:160]: e.count for e in by_name},
    }


def main(device, what: str = "sweep"):
    if what == "launches":
        out = [launch_stats(b, device) for b in (48, 64, 72, 128)]
    else:
        out = sweep(device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("what", nargs="?", default="sweep",
                         choices=("sweep", "launches"))
    _device, _args = parse_device_args(_parser)
    main(_device, _args.what)
