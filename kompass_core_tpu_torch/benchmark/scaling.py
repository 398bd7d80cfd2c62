"""Scaling efficiency: fleet solver throughput against the shard count.

Counterpart of ``kompass_core_tpu/benchmark/scaling.py``: the fleet
solver (``make_fleet_solver(mesh=...)``) over a ``FleetMesh`` of the
first n of the devices given, ``robots_per_device`` BASELINE-shaped
scenarios per shard, slope-timed over distinct inputs, and efficiency =
throughput(n) / (n * throughput per device of the first mesh).

The devices are explicit: ``[cuda] * n`` on a machine with one card,
``[cpu] * n`` in the tests, one per card where there are several. On
shards that share one card the solves run one after another on it, so
the efficiency measures the host's enqueue of each shard's launches, not
communication (the solver makes no collective).

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.scaling
--device cuda [--shards 4]`` (prints the JSON; writes no file).
"""

import json
import time
from typing import List, Optional, Sequence

import numpy as np
import torch


def measure_fleet_scaling(
    devices: Sequence,
    device_counts: Optional[List[int]] = None,
    robots_per_device: int = 32,
    reps: int = 10,
    spec=None,
):
    """Returns [{devices, robots, solves_per_s, efficiency}]."""
    from ..ops.solver import SolverSpec
    from ..parallel.fleet import make_fleet_solver
    from ..parallel.multihost import FleetMesh
    from .baseline import build_scenario

    devices = [torch.device(d) for d in devices]
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    if spec is None:
        # the JAX harness's small spec; pass spec=baseline_solver_spec()
        # for the flagship's
        spec = SolverSpec(
            is_omni=False,
            n_vx=15,
            n_vy=1,
            n_omega=15,
            max_points=15,
            num_ctrl_points=4,
            scan_size=256,
            seg_size=128,
            drop_samples=True,
        )

    def sync():
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    rng = np.random.default_rng(0)
    results = []
    base = None
    for n in device_counts:
        mesh = FleetMesh(devices[:n])
        solver = make_fleet_solver(spec, mesh=mesh)
        batch = robots_per_device * n
        stacked = np.stack(
            [build_scenario(spec, rng, i) for i in range(batch)]
        )
        # one distinct input per dispatch; the solver copies each
        # shard's rows to its device
        variants = []
        for k in range(3 + reps + 3 * reps):
            v = stacked.copy()
            v[:, 0] += 1e-4 * k
            variants.append(torch.from_numpy(v))
        next_v = iter(variants)

        def chain(m):
            vs = [next(next_v) for _ in range(m)]
            sync()
            t0 = time.perf_counter()
            outs = [solver(v) for v in vs]
            outs[-1][-1][0, 1].item()
            sync()
            return time.perf_counter() - t0

        chain(3)  # warm
        t_lo, t_hi = chain(reps), chain(3 * reps)
        dt = max((t_hi - t_lo) / (2 * reps), 1e-9)
        sps = batch / dt
        if base is None:
            # per-DEVICE baseline: correct even when device_counts does
            # not start at 1
            base = sps / n
        results.append(
            {
                "devices": n,
                "robots": batch,
                "solves_per_s": sps,
                "efficiency": sps / (base * n),
            }
        )
    return results


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--shards", type=int, default=4)
    _device, _args = parse_device_args(_parser)
    print(json.dumps(measure_fleet_scaling([_device] * _args.shards), indent=2))
