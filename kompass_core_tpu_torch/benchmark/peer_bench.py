"""Measured cost of fleet mutual avoidance.

Counterpart of ``kompass_core_tpu/benchmark/peer_bench.py``. ``main``
slope-times the 64-robot fleet tick without peers (K1), with
``peer_avoidance=True`` (the sweep widens by each robot's peer rows; K1)
and with ``peer_prediction=True`` on top (K3), at BASELINE solve shapes
(2025 samples x 30 steps, 512-ray scans). ``mesh_collective_cost`` times
the peer tick on one device and on a ``FleetMesh``, with and without
peers, and counts the mesh's collectives per tick (one state all-gather
with peers, none without) and times that gather alone.

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.peer_bench
--device cuda [--mesh]`` (``--mesh``: two shards on the one card,
``[cuda, cuda]``; prints the JSON, writes no file).
"""

import json
import time

import numpy as np
import torch


def main(device, n: int = 64, rays: int = 512):
    from .moving_bench import fleet_robots, state_variants
    from .runner import measure_throughput_slope, resident, slope_variants_needed

    out = {}
    for peer, predict in ((False, False), (True, False), (True, True)):
        fleet, states = fleet_robots(n, rays, peer_avoidance=peer,
                                     peer_prediction=predict, device=device)
        angles = np.linspace(0, 2 * np.pi, rays, endpoint=False)
        variants = state_variants(states, slope_variants_needed())
        vels = np.zeros((n, 3), np.float32)
        ranges = np.full((n, rays), 10.0, np.float32)
        name = f"fleet{n}_peer_{peer}" + ("_predict" if predict else "")
        r = measure_throughput_slope(
            name,
            lambda s: fleet.tick(s, vels, ranges, angles),
            variants,
            lambda o: float(o["cost"][0]),
            sync=lambda: resident((), device),
        )
        out[name] = {
            "ms_per_tick": r["mean_ms"],
            "us_per_robot": 1e3 * r["mean_ms"] / n,
        }
        print(name, round(r["mean_ms"], 3), "ms/tick", flush=True)
    print(json.dumps(out))
    return out


def _sync(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def mesh_collective_cost(mesh, n: int = 16, rays: int = 128, reps: int = 10):
    """Per-tick cost of the peer all-gather on ``mesh`` (a
    ``parallel/multihost.FleetMesh``): the peer tick (10 x 10 samples, 10
    steps) on the mesh's first device alone, on the mesh with peers and on
    the mesh without, ``reps`` ticks each after one warm-up (host clock,
    the devices synchronised), the mesh's collectives per tick, and one
    gather of the fleet's [n, 7] state blocks timed alone. On shards that
    share one card this measures the host's enqueue, not communication."""
    from ..parallel.multihost import FleetMesh
    from .moving_bench import fleet_config, fleet_robots

    config = fleet_config(samples=10, horizon=10, smooth_jerk=False)
    states = np.array([[2.0 * i, 0.0, np.pi / 2, 0.0] for i in range(n)], np.float32)
    vels = np.zeros((n, 3), np.float32)
    ranges = np.full((n, rays), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, rays, endpoint=False)

    out = {}
    shards = len(mesh.devices)
    for name, peer, on_mesh in (
        ("peer_single_device", True, False),
        (f"peer_mesh{shards}", True, True),
        (f"nopeer_mesh{shards}", False, True),
    ):
        target = {"mesh": FleetMesh(mesh.devices, mesh.group)} if on_mesh else {
            "device": mesh.devices[0]}
        fleet, _ = fleet_robots(n, rays, config=config, peer_avoidance=peer, **target)
        fleet.tick(states, vels, ranges, angles)  # warm-up
        before = dict(target["mesh"].collectives) if on_mesh else {}
        _sync(mesh.devices)
        t0 = time.perf_counter()
        for _ in range(reps):
            fleet.tick(states, vels, ranges, angles)
        _sync(mesh.devices)
        ms = 1e3 * (time.perf_counter() - t0) / reps
        out[name] = ms
        if on_mesh:
            out[f"{name}_collectives_per_tick"] = {
                k: (v - before[k]) / reps for k, v in target["mesh"].collectives.items()}
        print(name, round(ms, 3), "ms/tick", flush=True)

    gather = FleetMesh(mesh.devices, mesh.group)
    blocks = [torch.zeros((n // gather.size, 7), device=d) for d in gather.devices]
    gather.all_gather_rows(blocks)  # warm-up
    _sync(gather.devices)
    t0 = time.perf_counter()
    for _ in range(reps):
        gather.all_gather_rows(blocks)
    _sync(gather.devices)
    out["gather_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    out["note"] = (f"{shards} shards on {sorted({str(d) for d in mesh.devices})};"
                   f" gathered peer block is n*28 bytes/tick")
    out["n_robots"] = n
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import argparse

    from ..parallel.multihost import FleetMesh
    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--mesh", action="store_true")
    _device, _args = parse_device_args(_parser)
    if _args.mesh:
        mesh_collective_cost(FleetMesh([_device, _device]))
    else:
        main(_device)
