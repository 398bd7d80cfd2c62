"""The 1024-robot fleet tick with its robot axis whole against the same
tick run on blocks of rows.

Counterpart of ``kompass_core_tpu/benchmark/chunk_unroll_bench.py``. The
JAX tick runs its robot axis as an in-program loop over 64-row blocks (a
TPU batch-layout rule, ``lax.map``), and that bench asked whether
unrolling the loop pays. The port has no such loop: the robot axis is one
batch dimension of every tensor, and one tick launches its sweep once for
the whole fleet. So the question here is whether the JAX block is worth
having on the card: the tick with the axis whole (``whole``) against the
same tick function (``DeviceFleet._tick_fn``, ``make_fleet_tick``) run on
consecutive 64-row slices of the fleet's row tensors, the JAX block
(``blocks_64``), and on 128- and 256-row slices. The slicing lives here;
the package has no chunk knob.

Each case is timed eagerly and as one captured CUDA graph
(``utils/cuda_graph.capture``) with the JAX protocol: the slope over
distinct resident inputs (``runner.measure_throughput_slope``; the inputs
made from ``np.random.default_rng(7)`` as the JAX bench makes them), and
the whole axis measured again last as the drift control. Each record
gives ``ms_per_tick``, ``us_per_robot``, ``compile_s`` (the first eager
call's seconds, or the capture's with its warm-up) and the peak of
``torch.cuda.max_memory_allocated`` in the case.

``check`` holds the blocked tick equal to the whole tick bit for bit,
and rows 0, 511 and 1023 of the fleet's outputs against a 3-robot fleet
of those robots on the CPU (rows are independent without peers): the
same flags and counts, the cost within rel 1e-4, the command equal or a
tie within rel 1e-6 of the cost.

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.chunk_unroll_bench
--device cuda`` (prints the JSON, writes no file).
"""

from __future__ import annotations

import json
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

COST_REL = 1e-4  # the port's solver parity tolerance, card against CPU
TIE_REL = 1e-6  # two winners within this of the cost are a tie
CPU_ROWS = (0, 511, 1023)


def _setup_fleet(n_robots=1024, scan_rays=512, *, device, robots=None,
                 samples=(45, 44), horizon=30):
    """The JAX bench's fleet: diff-drive robots of radius 0.3, 45 x 44
    samples, 30 steps, straight 4 m paths 0.1 m apart, ``scan_rays`` rays
    over the circle, on ``device``. ``robots``: the fleet's robot ids (a
    fleet of those robots' paths; default ``range(n_robots)``);
    ``samples`` and ``horizon`` shrink it for the tests."""
    from ..control import DWAConfig, TrajectoryCostsWeights
    from ..models import (
        AngularCtrlLimits,
        LinearCtrlLimits,
        Robot,
        RobotCtrlLimits,
        RobotGeometry,
        RobotType,
    )
    from ..parallel.fleet_v2 import DeviceFleet

    ids = list(range(n_robots) if robots is None else robots)
    fleet_robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.3, 0.4]),
        )
        for _ in ids
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0),
    )
    config = DWAConfig(
        max_linear_samples=samples[0],
        max_angular_samples=samples[1],
        prediction_horizon=horizon,
        control_horizon=6,
        control_time_step=0.1,
        max_point_interpolation_distance=0.01,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=1.0,
            smoothness_weight=0.1,
            jerk_weight=0.05,
        ),
    )
    fleet = DeviceFleet(
        fleet_robots, limits, config, scan_rays=scan_rays, path_capacity=1024,
        max_segments=16, device=device,
    )
    fleet.set_paths([np.array([[0.1 * i, 0.0], [0.1 * i + 4.0, 0.5]]) for i in ids])
    fleet.set_scan_angles(np.linspace(-np.pi, np.pi, scan_rays, endpoint=False))
    return fleet


def tick_inputs(fleet, count: int, seed: int = 7) -> list:
    """``count`` distinct packed tick inputs [n, 7 + R] (numpy), as the JAX
    bench makes them: input k has robot i at x = 0.1 i + 1e-4 k and
    uniform 2.5-9 m ranges from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n, R = fleet._n, fleet._scan_rays
    out = []
    for k in range(count):
        inp = np.zeros((n, 4 + 3 + R), np.float32)
        inp[:, 0] = 0.1 * np.arange(n) + 1e-4 * k
        inp[:, 7:] = rng.uniform(2.5, 9.0, (n, R))
        out.append(inp)
    return out


def _rows(tree, rows: slice):
    """A fleet table's (a tensor's, or a NamedTuple of tensors') ``rows``."""
    if isinstance(tree, tuple):
        return type(tree)(*(None if t is None else t[rows] for t in tree))
    return tree[rows]


def tick_fn(fleet, block: Optional[int] = None):
    """fn(inputs [n, 7 + R] on the fleet's device) -> (carry', out [n, F]):
    the fleet's tick from its current carry, the robot axis whole
    (``block`` None) or run on consecutive ``block``-row slices of every
    row tensor and joined. The fleet's carry is not advanced."""
    from ..ops.fleet_solver import FleetCarry

    tables = (fleet._paths, fleet._cfg, fleet._carry, fleet._angles)
    if block is None:
        return lambda inputs: fleet._tick_fn(*tables, inputs)
    n = fleet._n

    def blocked(inputs):
        parts = [fleet._tick_fn(*(_rows(t, slice(s, s + block)) for t in tables),
                                inputs[s:s + block])
                 for s in range(0, n, block)]
        carry = FleetCarry(*(torch.cat(f) for f in zip(*(c for c, _ in parts))))
        return carry, torch.cat([o for _, o in parts])

    return blocked


def graphed(fn, example, device):
    """``fn`` of one input tensor captured once as a CUDA graph on
    ``device`` (``utils/cuda_graph.capture``): run(x) copies x into the
    graph's static input, replays and returns the graph's outputs."""
    from ..utils.cuda_graph import capture

    static = example.clone()
    graph, outs = capture(lambda: fn(static), device)

    def run(x):
        static.copy_(x)
        graph.replay()
        return outs

    run.graph = graph
    return run


def measure_case(fleet, variants, block, graph: bool, device) -> dict:
    """One case's record: the slope over ``variants`` (resident inputs,
    at least ``slope_variants_needed()``), eager or replayed."""
    from .runner import measure_throughput_slope, resident

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    fn = tick_fn(fleet, block)
    t0 = time.perf_counter()
    if graph:
        fn = graphed(fn, variants[0], device)
    resident(fn(variants[0]), device)
    compile_s = time.perf_counter() - t0
    r = measure_throughput_slope(
        "tick", lambda v: fn(v)[1], variants, lambda o: o[0, 5].item(),
        sync=lambda: resident((), device),
    )
    n = fleet.num_robots
    return {
        "block": block or fleet._n,
        "mode": "graph" if graph else "eager",
        "ms_per_tick": r["mean_ms"],
        "us_per_robot": 1e3 * r["mean_ms"] / n,
        "compile_s": compile_s,
        "max_memory_allocated_mb": (torch.cuda.max_memory_allocated(device) / 2**20
                                    if cuda else None),
    }


def _compare_rows(card, cpu, rows) -> list:
    """Card output rows ``rows`` [len(rows), F] against the CPU's: equal
    flags and counts, the cost within COST_REL, the command equal or a
    tie within TIE_REL of the cost. Returns the tied rows."""
    from ..ops.fleet_solver import OUT_FIELDS

    col = {k: i for i, k in enumerate(OUT_FIELDS)}
    ties = []
    for j, r in enumerate(rows):
        got, want = card[j], cpu[j]
        for key in ("found", "reached", "num_admissible", "active_points"):
            assert got[col[key]] == want[col[key]], (
                f"robot {r}: {key} {got[col[key]]} on the card vs {want[col[key]]}")
        c_got, c_want = float(got[col["cost"]]), float(want[col["cost"]])
        assert math.isclose(c_got, c_want, rel_tol=COST_REL, abs_tol=1e-6), (
            f"robot {r}: cost {c_got} on the card vs {c_want}")
        cmd = [float(got[col[k]]) for k in ("vx", "vy", "omega")]
        cmd_cpu = [float(want[col[k]]) for k in ("vx", "vy", "omega")]
        if cmd != cmd_cpu:
            assert abs(c_got - c_want) <= TIE_REL * abs(c_want), (
                f"robot {r}: command {cmd} on the card vs {cmd_cpu} is not a tie")
            ties.append(r)
    return ties


def check(fleet, inputs, block: int = 64, rows: Sequence[int] = CPU_ROWS,
          whole=None, blocked=None) -> dict:
    """The blocked tick == the whole tick bit for bit (outputs and carry),
    and ``rows`` of the whole tick against a fleet of those robots on the
    CPU. ``inputs``: one input matrix on the fleet's device; ``whole`` and
    ``blocked``: the two ticks' (carry, out) on it, computed when not
    given. Returns {"rows", "ties", "equal"}."""
    if whole is None:
        whole = tick_fn(fleet)(inputs)
    if blocked is None:
        blocked = tick_fn(fleet, block)(inputs)
    for a, b in zip((*whole[0], whole[1]), (*blocked[0], blocked[1])):
        assert torch.equal(a, b), "the blocked tick differs from the whole tick"
    n_robots = fleet.num_robots
    cpu_fleet = _setup_fleet(n_robots, fleet._scan_rays, device="cpu", robots=rows,
                             samples=(fleet.config.max_linear_samples,
                                      fleet.config.max_angular_samples),
                             horizon=fleet.config.prediction_horizon)
    idx = torch.tensor(list(rows))
    _, cpu_out = tick_fn(cpu_fleet)(inputs.cpu()[idx])
    ties = _compare_rows(whole[1].cpu()[idx].numpy(), cpu_out.numpy(), rows)
    return {"rows": list(rows), "ties": ties, "equal": True}


def main(device, n: int = 1024, rays: int = 512, blocks=(64, 128, 256)):
    from .runner import platform_name, resident, slope_variants_needed

    device = torch.device(device)
    fleet = _setup_fleet(n, rays, device=device)
    variants = resident([torch.from_numpy(v).to(device)
                         for v in tick_inputs(fleet, slope_variants_needed())], device)
    out = {"platform": platform_name(device), "robots": n, "rays": rays,
           "cases": {}}
    # the whole axis measured again LAST: the drift control within one run
    cases = [("whole", None)] + [(f"blocks_{b}", b) for b in blocks] + [
        ("whole_control", None)]
    for tag, block in cases:
        for graph in (False, True):
            rec = measure_case(fleet, variants, block, graph, device)
            key = f"{tag}_{rec['mode']}"
            out["cases"][key] = rec
            print(key, json.dumps(rec), flush=True)
    out["check"] = check(fleet, variants[0], blocks[0])
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--robots", type=int, default=1024)
    _device, _args = parse_device_args(_parser)
    main(_device, _args.robots)
