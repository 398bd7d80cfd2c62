"""Single source of truth for the BASELINE flagship workload spec and the
benchmark's scenario builder.

Counterpart of ``kompass_core_tpu/benchmark/baseline.py``: 2025 velocity
samples (45x45 grid, the closest odd-bumped grid to the 2000-sample
BASELINE config) x 30-step horizon, 512-ray scan, 384-point
tracked-segment capacity. ``build_spec`` and ``build_scenario`` are the
port's copies of the root ``bench.py``'s (the JAX package's benchmark
imports them from there), built on the port's functions.
"""

import numpy as np

from ..models import AngularCtrlLimits, LinearCtrlLimits, RobotCtrlLimits
from ..ops.solver import SolverSpec, pack_solver_input, packed_input_size
from ..ops.window import sample_velocity_window


def baseline_solver_spec() -> SolverSpec:
    return SolverSpec(
        is_omni=False,
        n_vx=45,
        n_vy=1,
        n_omega=45,
        max_points=30,
        num_ctrl_points=6,
        scan_size=512,
        seg_size=384,
        drop_samples=True,
    )


def build_spec() -> SolverSpec:
    """The flagship spec, as ``bench.py``'s ``build_spec`` gives it."""
    return baseline_solver_spec()


def build_scenario(spec: SolverSpec, rng, robot_index: int = 0, omega_shard=None):
    """One realistic robot scenario as its packed buffer: robot i at x =
    0.1 i with yaw 0.05 i, a gentle 3 m arc of tracked segment at 1 cm,
    ``spec.scan_size`` obstacles scattered at 2.5-9 m around it. With
    ``omega_shard`` (c, shards) the velocity window keeps the omega
    samples c, c + shards, ... alone (the sample-parallel solve's split
    of the sample axis)."""
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0),
    ).to_array()
    limits[3:6] = 0.0

    dt = 0.1
    x0 = 0.1 * robot_index
    yaw0 = 0.05 * robot_index

    # tracked segment: gentle arc ahead of the robot, up to 3 m @ 1 cm
    n_seg = min(301, spec.seg_size)
    s = 0.01 * np.arange(n_seg, dtype=np.float32)
    curv = 0.2
    seg_x = np.full(spec.seg_size, 1e8, np.float32)
    seg_y = np.full(spec.seg_size, 1e8, np.float32)
    seg_arc = np.zeros(spec.seg_size, np.float32)
    seg_x[:n_seg] = x0 + s * np.cos(yaw0)
    seg_y[:n_seg] = s * np.sin(yaw0) + 0.5 * curv * s**2
    seg_arc[:n_seg] = s

    # scan: obstacles scattered at 2.5-9 m
    n_rays = spec.scan_size
    ranges = rng.uniform(2.5, 9.0, n_rays)
    angles = np.linspace(-np.pi, np.pi, n_rays, endpoint=False)
    ox = ranges * np.cos(angles + yaw0) + x0
    oy = ranges * np.sin(angles + yaw0)
    obs = np.stack([ox, oy], axis=1).astype(np.float32)

    vel = (0.5, 0.0, 0.1)
    window = sample_velocity_window(
        vel, limits, dt, spec.n_vx, spec.n_vy, spec.n_omega, spec.is_omni
    )
    if omega_shard is not None:
        c, shards = omega_shard
        mask = np.zeros_like(window.omega_mask)
        mask[c::shards] = window.omega_mask[c::shards]
        window = window._replace(omega_mask=mask)
    params = np.array(
        [dt, 0.3, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0, 3.0, 10.0 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec), np.float32)
    pack_solver_input(
        spec,
        buf,
        params_vec=params,
        state=(x0, 0.0, yaw0),
        window=window,
        obs_xy=obs,
        obs_count=n_rays,
        seg_x=seg_x,
        seg_y=seg_y,
        seg_arc=seg_arc,
        seg_count=n_seg,
        seg_total_len=float(s[-1]),
        ref_total_len=10.0,
        active_points=spec.max_points,
    )
    return buf
