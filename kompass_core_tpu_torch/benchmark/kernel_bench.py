"""The solver's min-distance sweeps on the card, kernel by kernel.

Counterpart of ``kompass_core_tpu/benchmark/kernel_bench.py``, which
shoots the XLA sweep out against the Pallas kernel's MXU and VPU forms.
Here each form is its hand-written CUDA kernel (``ops/kernels.py``):

  1. the isolated sweeps at the BASELINE point and row shapes: K1
     (``xla``, the direct form), K2 (``mxu``, the expanded form) and K6
     (``vpu``, the broadcast form), each held against its plain PyTorch
     version (rtol 2e-4, atol 1e-4) before anything is timed, then timed
     against it by CUDA events over distinct device-resident inputs, in
     turns plain, kernel, kernel, plain;
  2. the full batch-64 DWA solve per backend (``make_fleet_solver``),
     slope-timed over distinct batches — the decisive number;
  3. K10, the goal cost's nearest-segment search (``goal_nearest``), at
     the benchmark cells' widths, one robot's DWA and the cost
     evaluator's, held bit for bit against its plain version in every
     layout and timed against it by events in turns and by graph replay,
     each layout by replay.

The event timers ``_events_ms``, ``_in_turns`` and ``_graph_ms`` are the
ones ``chip_smoke.py`` times every kernel with: they give every ``ms``
and ``plain_ms`` of its kernels line, so an edit to them changes that
yardstick and is reviewed as such. Run on the card:
``python -m kompass_core_tpu_torch.benchmark.kernel_bench --device cuda``
(prints the JSON; writes no file).
"""

import dataclasses
import functools
import json
import statistics
import sys

import numpy as np
import torch


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _events_ms(fn, inputs, warm=2):
    """CUDA-event ms per call of ``fn`` over ``inputs`` (argument tuples),
    back to back after ``warm`` warm-up calls."""
    for args in inputs[:warm]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in inputs:
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(inputs)


def _in_turns(kernel, plain, inputs, warm=2):
    """CUDA-event ms per call of ``plain`` and ``kernel`` over ``inputs``
    (argument tuples), in turns plain, kernel, kernel, plain. Returns
    (kernel ms, plain ms, the four runs)."""

    def timed(fn):
        return _events_ms(fn, inputs, warm)

    runs = [("plain", timed(plain)), ("kernel", timed(kernel)),
            ("kernel", timed(kernel)), ("plain", timed(plain))]
    return (statistics.mean(t for n, t in runs if n == "kernel"),
            statistics.mean(t for n, t in runs if n == "plain"),
            [f"{n} {t:.5f} ms" for n, t in runs])


def _graph_ms(fn, inputs, replays=2):
    """CUDA-event ms per call of ``fn`` over ``inputs`` (argument tuples),
    the calls captured once into a CUDA graph and replayed ``replays``
    times: the device's time, without the host's enqueue between calls
    (a one-robot sweep takes less time on the card than its wrapper on
    the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in inputs[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in inputs:
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (replays * len(inputs))


# the three static forms: (JAX backend name, wrapper, plain version)
SWEEP_FORMS = (
    ("xla", "fused_min_dist_sq", "fused_min_dist_sq_reference"),
    ("pallas_mxu", "fused_min_dist_sq_expanded",
     "fused_min_dist_sq_expanded_reference"),
    ("pallas_vpu", "fused_min_dist_sq_broadcast",
     "fused_min_dist_sq_broadcast_reference"),
)


def sweep_inputs(device, count, B, S, T, O, G, seed=0):
    """``count`` distinct sweep argument tuples (px, py [B, S, T] in
    [-5, 5), obstacle rows [B, O, 2] in [-8, 8), segment rows [B, G] in
    [-5, 5), every step active) made on ``device`` from ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)

    def u(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    active = torch.full((B,), T, dtype=torch.int32, device=device)
    return [(u((B, S, T), -5, 5), u((B, S, T), -5, 5), u((B, O, 2), -8, 8),
             u((B, G), -5, 5), u((B, G), -5, 5), active) for _ in range(count)]


def bench_sweeps(device, B=64, S=2025, T=30, O=512, G=384, count=10):
    """Each static form against its plain version at [B, S, T] points vs
    O + G rows: checked on the first input, then timed in turns over
    ``count`` distinct inputs (CUDA events). Returns ms per call of each
    kernel and of its plain version, and the kernels' bound."""
    from ..ops import kernels
    from .roofline import form_bound, sweep_bound

    inputs = sweep_inputs(device, count, B, S, T, O, G)
    torch.cuda.synchronize(device)
    px, active = inputs[0][0], inputs[0][5]
    results = {"shape": [B, S, T, O, G],
               "bound_ms": {"xla": sweep_bound(px, O, active, G)[0],
                            "pallas_mxu": form_bound(px, O, active, G, 5, 5)[0],
                            "pallas_vpu": form_bound(px, O, active, G, 5, 5)[0]}}
    for name, wrapper, reference in SWEEP_FORMS:
        kernel, plain = getattr(kernels, wrapper), getattr(kernels, reference)
        for got, want in zip(kernel(*inputs[0]), plain(*inputs[0])):
            torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-4)
        ms, plain_ms, turns = _in_turns(kernel, plain, inputs)
        results[f"{name}_two_sweeps_ms"] = ms
        results[f"{name}_plain_ms"] = plain_ms
        log(f"{wrapper}: {ms:.5f} ms, plain {plain_ms:.5f} ms ({', '.join(turns)})")
    return results


# K10's widths: (robots, samples, segment points) of disc1024.tick,
# disc256.k8 and boxpeer64.k8, then one robot's DWA and the cost evaluator
# (CostEvaluator_5k_Trajs), where goal_layout splits G across a warp
GOAL_SHAPES = ((1024, 2025, 320), (256, 2025, 320), (64, 2025, 384),
               (1, 2025, 320), (1, 5001, 1024))


def goal_inputs(device, count, B, S, G, seed=0):
    """``count`` distinct K10 argument tuples made on ``device`` from
    ``seed``: end points [B, S] in [-12, 12) m and [B, G] segment points in
    [-10, 10) m, the last sixteenth of them pads at 1e8."""
    gen = torch.Generator(device).manual_seed(seed)

    def u(shape, span):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * span

    out = []
    for _ in range(count):
        seg_x, seg_y = u((B, G), 10.0), u((B, G), 10.0)
        seg_x[:, G - G // 16:], seg_y[:, G - G // 16:] = 1e8, 1e8
        out.append((u((B, S), 12.0), u((B, S), 12.0), seg_x, seg_y))
    return out


def bench_goal(device, shapes=GOAL_SHAPES, count=4):
    """K10 against its plain version at each (B, S, G) of ``shapes``: both
    outputs bit for bit on every input, in ``goal_layout``'s layout and in
    each of ``GOAL_LAYOUTS``; then ms per call by CUDA events in turns
    (plain, kernel, kernel, plain) and by graph replay, beside
    ``goal_bound``, and each layout's ms by graph replay. Returns
    {"B x S x G": {...}}; ``max_abs_err`` is the largest |kernel - plain|
    of the squared distances over every input and layout."""
    from ..ops import kernels
    from .roofline import goal_bound

    layouts = range(len(kernels.GOAL_LAYOUTS))
    results = {}
    for B, S, G in shapes:
        inputs = goal_inputs(device, count, B, S, G)
        err = 0.0
        for args in inputs:
            want = kernels.goal_nearest_reference(*args)
            for layout in (None, *layouts):
                got = kernels.goal_nearest(*args, _layout=layout)
                err = max(err, float((got[0] - want[0]).abs().max()))
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"goal_nearest (layout {layout}) != its plain "
                                         f"version at {B} x {S} x {G}")
        ms, plain_ms, turns = _in_turns(kernels.goal_nearest,
                                        kernels.goal_nearest_reference, inputs)
        bound_ms, bound_by = goal_bound(B, S, G)
        chosen = kernels.goal_layout(B, S, kernels._sm_count(torch.device(device)))
        results[f"{B}x{S}x{G}"] = {
            "layout": kernels.GOAL_LAYOUTS[chosen], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "replay_ms": _graph_ms(kernels.goal_nearest, inputs),
            "plain_replay_ms": _graph_ms(kernels.goal_nearest_reference, inputs),
            "layout_replay_ms": [
                [*kernels.GOAL_LAYOUTS[i], _graph_ms(
                    functools.partial(kernels.goal_nearest, _layout=i), inputs)]
                for i in layouts],
            "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"goal_nearest {B} x {S} x {G}: {json.dumps(results[f'{B}x{S}x{G}'])} "
            f"({', '.join(turns)})")
    return results


def bench_full_solve(device, backends=("xla", "pallas", "pallas_vpu"), B=64):
    """The batch-B BASELINE solve per backend (``make_fleet_solver``),
    slope-timed over distinct device-resident batches; us per solve."""
    from ..parallel.fleet import make_fleet_solver
    from .baseline import build_scenario, build_spec
    from .runner import measure_throughput_slope, resident, slope_variants_needed

    rng = np.random.default_rng(0)
    spec0 = build_spec()
    base = np.stack([build_scenario(spec0, rng, i) for i in range(B)])
    variants_np = []
    for k in range(1 + slope_variants_needed(10, 40)):  # the check + the slope's
        v = base.copy()
        v[:, 0] += 1e-4 * k
        variants_np.append(v)

    results = {}
    for backend in backends:
        spec = dataclasses.replace(spec0, backend=backend)
        solver = make_fleet_solver(spec, device)
        variants = resident([torch.from_numpy(v).to(device) for v in variants_np],
                            device)
        row = solver(variants[0])[0].cpu().numpy()
        log(f"{backend}: found={row[0] > 0.5} cost={row[1]:.4f} adm={int(row[3])}")
        r = measure_throughput_slope(
            backend, solver, variants[1:], lambda o: o[0, 1].item(),
            n_lo=10, n_hi=40, sync=lambda: resident((), device))
        per_batch = r["p50_ms"] / 1e3
        results[f"solve_{backend}_us"] = per_batch / B * 1e6
        log(f"{backend}: {per_batch / B * 1e6:.2f} us/solve ({B / per_batch:,.0f}/s)")
    return results


def main(device):
    from .runner import platform_name

    log(f"device: {platform_name(device)}")
    out = {"platform": platform_name(device)}
    out.update(bench_sweeps(device))
    out["goal_nearest"] = bench_goal(device)
    out.update(bench_full_solve(device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    main(parse_device_args(argparse.ArgumentParser(description=__doc__))[0])
