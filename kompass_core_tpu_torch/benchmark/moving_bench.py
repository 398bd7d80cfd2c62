"""Measured device cost of moving-obstacle prediction.

Counterpart of ``kompass_core_tpu/benchmark/moving_bench.py``.
``main`` slope-times the batch-64 packed solver (``make_fleet_solver``)
at BASELINE shapes (2025 samples x 30 steps, 512-ray scan) with
``moving_obstacles`` off and on (K1 against K3 on the card), one distinct
device-resident batch per dispatch, the static control measured again
last with shifted inputs to catch drift within the run. ``fleet_main``
slope-times the 64-robot ``DeviceFleet`` tick with no tracked slots,
with 8 tracked slots in the scan bucket's tail (K3), and with the movers
split into their own narrow sweep (K1 + K3s).

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.moving_bench
--device cuda [--fleet]`` (prints the JSON; writes no file).
"""

import dataclasses
import json

import numpy as np
import torch


def _scenario_buffer(spec, robot_index=0, rng=None):
    """BASELINE-shaped packed scenario: a straight 3 m segment at 1 cm,
    ``spec.scan_size`` obstacles at 2-9 m, with ``moving_obstacles``
    pedestrian-speed velocities on every obstacle point. Only the spec's
    shapes must agree with the other harnesses' builders: each measures
    deltas against its own control."""
    from ..models import AngularCtrlLimits, LinearCtrlLimits, RobotCtrlLimits
    from ..ops.solver import pack_solver_input, packed_input_size
    from ..ops.window import sample_velocity_window

    rng = rng or np.random.default_rng(robot_index)
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0,
                                       max_decel=3.0),
    ).to_array()
    limits[3:6] = 0.0
    dt = 0.1
    n_seg = min(301, spec.seg_size)
    s = 0.01 * np.arange(n_seg, dtype=np.float32)
    seg_x = np.full(spec.seg_size, 1e8, np.float32)
    seg_y = np.full(spec.seg_size, 1e8, np.float32)
    seg_arc = np.zeros(spec.seg_size, np.float32)
    seg_x[:n_seg] = s
    seg_y[:n_seg] = 0.0
    seg_arc[:n_seg] = s
    n_rays = spec.scan_size
    ranges = rng.uniform(2.0, 9.0, n_rays)
    angles = np.linspace(-np.pi, np.pi, n_rays, endpoint=False)
    obs = np.stack(
        [ranges * np.cos(angles), ranges * np.sin(angles)], axis=1
    ).astype(np.float32)
    window = sample_velocity_window(
        (0.5, 0.0, 0.0), limits, dt, spec.n_vx, spec.n_vy, spec.n_omega,
        spec.is_omni,
    )
    params = np.array(
        [dt, 0.3, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0, 3.0, 10.0 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec), np.float32)
    kw = {}
    if spec.moving_obstacles:
        kw["obs_vel_xy"] = rng.uniform(-1.5, 1.5, (n_rays, 2)).astype(
            np.float32
        )
    pack_solver_input(
        spec, buf,
        params_vec=params,
        state=(0.1 * robot_index, 0.0, 0.0),
        window=window, obs_xy=obs, obs_count=n_rays,
        seg_x=seg_x, seg_y=seg_y, seg_arc=seg_arc, seg_count=n_seg,
        seg_total_len=float(s[-1]), ref_total_len=10.0,
        active_points=spec.max_points, **kw,
    )
    return buf


def _measure(spec, label, device, B=64, value_shift=0.0):
    """The batch-B packed solve of ``spec`` on ``device``, slope-timed
    over chains of 10 and 40 distinct resident batches. ``value_shift``
    offsets every variant's robot x so that a control measured again
    never replays the same inputs."""
    from ..parallel.fleet import make_fleet_solver
    from .runner import measure_throughput_slope, resident, slope_variants_needed

    rng = np.random.default_rng(7)
    solver = make_fleet_solver(spec, device)
    base = np.stack([_scenario_buffer(spec, i, rng) for i in range(B)])
    variants = []
    for k in range(slope_variants_needed(10, 40)):
        v = base.copy()
        v[:, 0] += np.float32(value_shift) + 1e-4 * k  # distinct states
        variants.append(torch.from_numpy(v).to(device))
    r = measure_throughput_slope(
        label, solver, resident(variants, device), lambda o: o[0, 1].item(),
        n_lo=10, n_hi=40, sync=lambda: resident((), device))
    per_batch_ms = r["p50_ms"]
    print(f"{label}: {per_batch_ms:.3f} ms/batch{B} "
          f"({per_batch_ms / B * 1e3:.2f} us/solve)", flush=True)
    return {"ms_per_batch64": per_batch_ms, "us_per_solve": per_batch_ms / B * 1e3}


def fleet_config(samples=45, horizon=30, smooth_jerk=True):
    """The fleet benches' ``DWAConfig``: ``samples`` x ``samples``
    velocities, ``horizon`` steps at 0.1 s, path 3, goal 1, obstacles 2
    (and smoothness and jerk 1 with ``smooth_jerk``)."""
    from ..control import DWAConfig, TrajectoryCostsWeights

    extra = dict(smoothness_weight=1.0, jerk_weight=1.0) if smooth_jerk else {}
    return DWAConfig(
        max_linear_samples=samples,
        max_angular_samples=samples,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=2.0,
            **extra,
        ),
        prediction_horizon=horizon,
        control_horizon=2,
        control_time_step=0.1,
    )


def fleet_robots(n, rays, config=None, **fleet_kw):
    """(a ``DeviceFleet`` of ``n`` diff-drive robots on lanes 2 m apart,
    each with a 5 m path, their states): the fleet benches' scene, with
    ``fleet_config()`` unless ``config`` is given."""
    from ..models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from ..parallel.fleet_v2 import DeviceFleet

    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.3, 0.4]),
        )
        for _ in range(n)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    fleet = DeviceFleet(robots, limits, config or fleet_config(), scan_rays=rays,
                        path_capacity=512, max_segments=16, **fleet_kw)
    fleet.set_paths([np.array([[2.0 * i, 0.0], [2.0 * i, 5.0]]) for i in range(n)])
    states = np.array([[2.0 * i, 0.0, np.pi / 2, 0.0] for i in range(n)], np.float32)
    return fleet, states


def state_variants(states, count, seed=0):
    """``count`` distinct copies of ``states``, each moved by 1e-4 m of
    normal noise."""
    rng = np.random.default_rng(seed)
    return [states + np.float32(1e-4)
            * rng.standard_normal(states.shape).astype(np.float32)
            for _ in range(count)]


def fleet_main(device, n: int = 64, rays: int = 512, tracked: int = 8):
    """Measured cost of the TRACKED fleet tick at BASELINE shapes on
    ``device``: no slots (K1), ``tracked`` slots in the scan bucket's tail
    (the bucket grows from ``rays`` to rays + M rounded up to 256; K3),
    and the split form (the bucket stays at ``rays``, the movers in a
    narrow moving sweep; K1 + K3s). Each slope-timed over distinct
    host states."""
    from .runner import measure_throughput_slope, resident, slope_variants_needed

    out = {}
    for m_slots, split in ((0, False), (tracked, False), (tracked, True)):
        fleet, states = fleet_robots(n, rays, tracked_obstacles=m_slots,
                                     split_mover_sweep=split, device=device)
        angles = np.linspace(0, 2 * np.pi, rays, endpoint=False)
        variants = state_variants(states, slope_variants_needed())
        vels = np.zeros((n, 3), np.float32)
        ranges = np.full((n, rays), 10.0, np.float32)
        if m_slots:
            trk = [np.array([[2.0 * i + 1.0, 2.0, 0.0, -0.5]], np.float32)
                   for i in range(n)]

            def dispatch(s):
                return fleet.tick(s, vels, ranges, angles, tracked=trk)
        else:
            def dispatch(s):
                return fleet.tick(s, vels, ranges, angles)
        name = f"fleet{n}_tracked_{m_slots}" + ("_split" if split else "")
        r = measure_throughput_slope(
            name, dispatch, variants, lambda o: float(o["cost"][0]),
            sync=lambda: resident((), device),
        )
        out[name] = {
            "ms_per_tick": r["mean_ms"],
            "us_per_robot": 1e3 * r["mean_ms"] / n,
        }
        print(name, round(r["mean_ms"], 3), "ms/tick", flush=True)
    print(json.dumps(out))
    return out


def main(device):
    from .baseline import baseline_solver_spec

    spec = baseline_solver_spec()
    m_spec = dataclasses.replace(spec, moving_obstacles=True)
    out = {
        "workload": "BASELINE 2025x30, 512-ray scan, batch 64, slope 10->40",
        "static": _measure(spec, "static", device),
        "moving": _measure(m_spec, "moving", device),
        # same-run drift control: static again, last, with shifted input
        # values (never the same inputs as the first static run)
        "static_control": _measure(spec, "static_control", device,
                                   value_shift=0.05),
    }
    # conservative ratio: divide by the SMALLER static estimate — the
    # control detects drift, it must not shrink the reported overhead
    out["moving_over_static"] = (
        out["moving"]["us_per_solve"]
        / min(out["static"]["us_per_solve"],
              out["static_control"]["us_per_solve"])
    )
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--fleet", action="store_true")
    _device, _args = parse_device_args(_parser)
    if _args.fleet:
        fleet_main(_device)
    else:
        main(_device)
