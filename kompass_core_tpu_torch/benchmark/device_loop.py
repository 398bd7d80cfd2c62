"""Device-loop timing: a cross-check of the slope method that takes the
host out of the measured region.

Counterpart of ``kompass_core_tpu/benchmark/device_loop.py``. ONE
dispatch runs the workload K times, carry-chained: each iteration's
input is derived from the previous iteration's output (a data
dependency, so the iterations run one after another). In the JAX package
that dispatch is one jitted ``lax.scan``; here, on a CUDA device, the K
chained iterations are captured once into a CUDA graph
(``utils/cuda_graph.capture``, as ``parallel/fleet_v2.TickGraph`` does)
and each dispatch copies its own input into the graph's static input and
replays it. On the CPU the same chain runs eagerly. Wall time for a
K-iteration dispatch is

    T(K) = overhead + K * t_workload

so ``t = (T(K2) - T(K1)) / (K2 - K1)`` cancels the dispatch overhead and
the output fetch. Each timed dispatch gets a DISTINCT resident input.

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.device_loop
--device cuda [--repeats N]`` (prints the JSON; writes no file).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Callable, List, Sequence

import numpy as np
import torch

# Reference benchmark_runner.cpp:187-218 constructs the Bayesian mapper
# with these exact sensor-model values (p_prior, p_empty, p_occupied,
# range_sure, range_max, wall_size).
BAYES_BENCH_SCALARS = (0.6, 0.1, 0.9, 0.1, 20.0, 0.2)


def _device_loop(chain: Callable, device):
    """``chain`` (a function of one tensor, or of a tuple of tensors, that
    never writes its input) as one dispatch on ``device``: on CUDA
    captured as a graph at the first call, each call copying its input
    into the graph's static input and replaying; on the CPU ``chain``
    itself."""
    from ..utils.cuda_graph import capture

    device = torch.device(device)
    if device.type != "cuda":
        return chain
    state = {}

    def loop(x):
        xs = x if isinstance(x, tuple) else (x,)
        if not state:
            static = tuple(t.clone() for t in xs)
            arg = static if isinstance(x, tuple) else static[0]
            graph, out = capture(lambda: chain(arg), device)
            state.update(graph=graph, static=static, out=out)
        for s, t in zip(state["static"], xs):
            s.copy_(t)
        state["graph"].replay()
        return state["out"].clone()

    return loop


def dwa_chain(spec, k: int):
    """K carry-chained DWA solves of one packed buffer: each perturbs the
    robot's x by 1e-6 + 1e-9 * cost of the previous solve (a data
    dependency that keeps the scenario physically valid). Returns the
    final cost, a 0-d tensor."""
    from ..ops.solver import _unpack_and_solve

    def chain(buf):
        b = buf.clone()
        cost = None
        for _ in range(k):
            cost = _unpack_and_solve(spec, b)[1]
            b[:1] += 1e-6 + 1e-9 * cost
        return cost

    return chain


def make_dwa_device_loop(spec, k: int, device):
    """One dispatch of K carry-chained DWA solves on a packed buffer
    (``dwa_chain``) on ``device``; returns the final cost."""
    return _device_loop(dwa_chain(spec, k), device)


def measure_device_loop(
    name: str,
    make_loop: Callable[[int], Callable],
    variants: Sequence,
    ks: Sequence[int] = (8, 40),
    repeats: int = 3,
) -> dict:
    """Per-iteration device time from the K-delta of single dispatches.

    ``variants`` must hold >= ``2 * repeats + 2`` DISTINCT
    device-resident inputs: two warmup dispatches (one per K, the
    capture's) plus two per timed repeat. Returns the median across
    repeats plus every raw estimate and the spread (max - min).
    """
    k1, k2 = ks
    assert len(variants) >= 2 * repeats + 2, (
        f"need >= {2 * repeats + 2} distinct variants "
        f"(2 warmup + 2 per repeat), got {len(variants)}"
    )
    f1, f2 = make_loop(k1), make_loop(k2)
    it = iter(variants)
    f1(next(it)).item()
    f2(next(it)).item()
    ests: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        f1(next(it)).item()
        t1 = time.perf_counter()
        f2(next(it)).item()
        t2 = time.perf_counter()
        ests.append(((t2 - t1) - (t1 - t0)) / (k2 - k1) * 1e3)
    med = statistics.median(ests)
    return {
        "name": name,
        "method": f"device_loop_k{k1}_k{k2}",
        "p50_ms": med,
        "mean_ms": med,
        "estimates_ms": ests,
        "spread_ms": max(ests) - min(ests),
        "repeats": repeats,
    }


def make_critical_zone_device_loop(spec, k: int, device):
    """K carry-chained critical-zone checks in one dispatch. The carry
    perturbs each range by 1e-6 * previous factor + 1e-7 (factor in [0,
    1], so the ranges stay inside the slowdown band)."""
    from ..ops.critical_zone import get_critical_zone_checker

    check = get_critical_zone_checker(spec, device)

    def chain(ranges):
        for _ in range(k):
            f = check(ranges, True)
            ranges = ranges + (1e-6 * f + 1e-7)
        return f

    return _device_loop(chain, device)


def _occupancy(grid):
    return grid.sum().to(torch.float32)


def make_mapper_device_loop(spec, k: int, device):
    """K carry-chained dense scan->grid updates in one dispatch. The
    carry perturbs the ranges by a value derived from the occupancy sum
    (data dependency on the previous grid)."""
    from ..ops.mapping import get_scan_to_grid

    to_grid = get_scan_to_grid(spec, device)

    def chain(ranges):
        for _ in range(k):
            occ = _occupancy(to_grid(ranges))
            ranges = ranges + (1e-9 * occ + 1e-7)
        return occ

    return _device_loop(chain, device)


def make_critical_zone_cloud_device_loop(spec, k: int, device):
    """K carry-chained 100k-point cloud safety checks in one dispatch.
    The carry perturbs the whole cloud by 1e-6 * previous factor."""
    from ..ops.critical_zone import get_critical_zone_checker_cloud

    check = get_critical_zone_checker_cloud(spec, device)

    def chain(pts):
        for _ in range(k):
            f = check(pts, True, 20.0, -1.0, 1.0)
            pts = pts + (1e-6 * f + 1e-7)
        return f

    return _device_loop(chain, device)


def make_mapper_bayesian_device_loop(spec, k: int, device):
    """K carry-chained Bayesian grid updates in one dispatch. The carry
    is (ranges, prob_grid): each iteration fuses into the PREVIOUS
    iteration's posterior — the real temporal-fusion recurrence, which
    is also the data dependency that forces serial execution."""
    from ..ops.mapping import get_scan_to_grid_bayesian

    fn = get_scan_to_grid_bayesian(spec, device)
    scalars = tuple(np.float32(v) for v in BAYES_BENCH_SCALARS)

    def chain(carry):
        ranges, prob = carry
        for _ in range(k):
            occ, prob = fn(ranges, prob, *scalars)
            out = _occupancy(occ)
            ranges = ranges + (1e-9 * out + 1e-7)
        return out

    return _device_loop(chain, device)


def make_mapper_pointcloud_device_loop(spec, k: int, device):
    """K carry-chained (100k cloud -> laserscan -> grid) updates in one
    dispatch; the carry perturbs the cloud by a value derived from the
    occupancy sum."""
    from ..ops.mapping import get_pointcloud_to_scan, get_scan_to_grid

    to_scan = get_pointcloud_to_scan(spec.num_bins, device)
    to_grid = get_scan_to_grid(spec, device)

    def chain(pts):
        for _ in range(k):
            occ = _occupancy(to_grid(to_scan(pts, 10.0, -1.0, 1.0)))
            pts = pts + (1e-9 * occ + 1e-7)
        return occ

    return _device_loop(chain, device)


def _dwa_baseline_buffers(n_variants: int, device):
    """The runner's DWA_2025x30 workload as (spec, ``n_variants``
    distinct variants resident on ``device``): the runner's own spec and
    scenario builders, so that the program under test is the same solve
    the slope suite times."""
    from .runner import dwa_spec, dwa_variants

    spec = dwa_spec(45, 45, 30, 512, 384)
    return spec, _on(device, dwa_variants(spec, n_variants))


def _resident(bufs):
    """Wait until every tensor of ``bufs`` (tensors or tuples of them) is
    on its device."""
    for v in bufs:
        for t in v if isinstance(v, tuple) else (v,):
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
    return bufs


def _on(device, arrays):
    return _resident([torch.from_numpy(a).to(device) for a in arrays])


def dense_zone_variants(n: int, device, rng=None):
    """(the benchmark's critical zone, ``n`` distinct 3600-ray scans in
    its slowdown band, resident on ``device``)."""
    from .runner import zone_spec

    rng = rng or np.random.default_rng(0)
    return zone_spec(), _on(device, [
        rng.uniform(0.81, 1.11, 3600).astype(np.float32) for _ in range(n)
    ])


def main(device, repeats: int = 10):
    from ..ops.solver import packed_input_size
    from .runner import mapper_spec, platform_name, zone_cloud

    n_var = 2 * repeats + 2
    results = []

    spec, variants = _dwa_baseline_buffers(n_var, device)
    results.append(measure_device_loop(
        "DWA_2025x30_device_loop",
        lambda k: make_dwa_device_loop(spec, k, device),
        variants, ks=(8, 264), repeats=repeats,
    ))

    # the moving-obstacle form of the same workload
    mov_spec = dataclasses.replace(spec, moving_obstacles=True)
    rng_m = np.random.default_rng(5)
    mov_variants = []
    for v in variants:
        b = v.cpu().numpy()
        mb = np.zeros(packed_input_size(mov_spec), np.float32)
        mb[: b.shape[0]] = b
        mb[b.shape[0]:] = rng_m.uniform(
            -1.5, 1.5, packed_input_size(mov_spec) - b.shape[0]
        ).astype(np.float32)
        mov_variants.append(mb)
    results.append(measure_device_loop(
        "DWA_2025x30_moving_device_loop",
        lambda k: make_dwa_device_loop(mov_spec, k, device),
        _on(device, mov_variants), ks=(8, 264), repeats=repeats,
    ))

    rng = np.random.default_rng(0)
    cz, cz_variants = dense_zone_variants(n_var, device, rng)
    # the dense check is a few microseconds of device work: the K-span
    # puts the K-delta well above the host clock's jitter
    results.append(measure_device_loop(
        "CriticalZone_Dense_device_loop",
        lambda k: make_critical_zone_device_loop(cz, k, device),
        cz_variants, ks=(16, 8192), repeats=repeats,
    ))

    (cloud,) = _on(device, [zone_cloud(rng)])
    cloud_variants = _resident(
        [cloud + float(np.float32(1e-5 * k)) for k in range(n_var)])
    results.append(measure_device_loop(
        "CriticalZone_100k_device_loop",
        lambda k: make_critical_zone_cloud_device_loop(cz, k, device),
        cloud_variants, ks=(8, 512), repeats=repeats,
    ))

    mspec = mapper_spec()
    m_variants = _on(device, [
        rng.uniform(0.5, 9.9, 3600).astype(np.float32) for _ in range(n_var)
    ])
    results.append(measure_device_loop(
        "Mapper_Dense_device_loop",
        lambda k: make_mapper_device_loop(mspec, k, device),
        m_variants, ks=(8, 56), repeats=repeats,
    ))

    prev = np.full((400, 400), 0.5, np.float32)
    bay_variants = _resident([
        tuple(_on(device, [rng.uniform(0.5, 9.9, 3600).astype(np.float32),
                           prev + np.float32(1e-6 * k)]))
        for k in range(n_var)
    ])
    results.append(measure_device_loop(
        "Mapper_Bayesian_device_loop",
        lambda k: make_mapper_bayesian_device_loop(mspec, k, device),
        bay_variants, ks=(8, 56), repeats=repeats,
    ))

    pc_variants = _resident(
        [cloud + float(np.float32(2e-5 * k + 1e-6)) for k in range(n_var)])
    results.append(measure_device_loop(
        "Mapper_PointCloud_device_loop",
        lambda k: make_mapper_pointcloud_device_loop(mspec, k, device),
        pc_variants, ks=(8, 40), repeats=repeats,
    ))

    artifact = {
        "method": (
            "K carry-chained iterations inside ONE dispatch (a CUDA graph"
            " replay on the card), per-iteration time from the K-delta of"
            " two single dispatches; cancels the dispatch overhead and the"
            f" fetch. Median of {repeats} repeats, one distinct"
            " device-resident input per dispatch."
        ),
        "date": time.strftime("%Y-%m-%d"),
        "platform": platform_name(device),
        "results": results,
    }
    print(json.dumps(artifact, indent=1))
    return results


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--repeats", type=int, default=10)
    _device, _args = parse_device_args(_parser)
    main(_device, _args.repeats)
