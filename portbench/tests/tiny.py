"""Small versions of the benchmark's cells for the CPU tests: 5 x 5
samples, 5 steps, 32 rays, a few robots; everything else as the cell."""

import copy

import torch

from portbench.harness.main import Session, load_cell

ROBOTS = {"disc": 4, "peer": 8}


# (cell, ticks per call): every cell, and the peer fleet's eager tick,
# which no cell times (PERF.md) but the harness and the reference serve
VARIANTS = (("disc1024.tick", 1), ("disc256.k8", 8), ("boxpeer64.k8", 8),
            ("boxpeer64.k8", 1))


def tiny_cell(name, k=None):
    """(cfg, traffic, limits) of cell ``name`` at the small size; ``k``
    overrides its ticks per call."""
    _, _, cfg, traffic, limits = load_cell(name)
    if k is not None and k != traffic.get("k", 1):
        traffic = dict(traffic, k=k)
        limits = {n: v for n, v in limits.items() if k > 1 or n != "state_err_m"}
    cfg = copy.deepcopy(cfg)
    cfg["dwa"].update(max_linear_samples=5, max_angular_samples=5, prediction_horizon=5,
                      control_horizon=2)
    cfg["scan_rays"] = 32
    if cfg["tracked_obstacles"]:
        cfg["tracked_obstacles"] = 2
    traffic = dict(traffic, robots=ROBOTS[traffic["scene"]], warm_calls=2, check_calls=3,
                   check_robots=3, trace_calls=2)
    if "arc_rays" in traffic:
        traffic["arc_rays"] = 4
    return cfg, traffic, limits


def session(name, seed, k=None):
    cfg, traffic, _ = tiny_cell(name, k)
    return Session(cfg, traffic, seed, torch.device("cpu"))
