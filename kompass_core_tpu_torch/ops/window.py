"""Dynamic-window velocity sampling (host side).

Replicates the reference's reachable-velocity-window computation and grid
walk (``trajectory_sampler.cpp:328-372`` UpdateReachableVelocityRange and the
sampling loops at ``trajectory_sampler.cpp:181-275``) in float64 on the host,
including the exact ``for (v = min; v <= max; v += res)`` accumulation
semantics. The window depends only on the current velocity and the control
limits — host scalars — so computing it here removes any grid-placement
drift between this engine and the reference while keeping the rollout + cost
evaluation fully on device.

Returns fixed-size padded arrays + validity masks (static shapes for jit).
"""

from typing import NamedTuple

import numpy as np

# Minimum velocity magnitude considered drivable
# (reference ``utils/trajectory_sampler.h:14``).
MIN_VEL = 0.01


class VelocityWindow(NamedTuple):
    vx_vals: np.ndarray  # [n_vx] float32
    vx_mask: np.ndarray  # [n_vx] bool
    vy_vals: np.ndarray  # [n_vy]
    vy_mask: np.ndarray
    omega_vals: np.ndarray  # [n_omega]
    omega_mask: np.ndarray


def _walk(min_v: float, max_v: float, res: float, slots: int):
    """Exact replication of ``for (v = min_v; v <= max_v; v += res)``."""
    vals = np.zeros(slots, dtype=np.float32)
    mask = np.zeros(slots, dtype=bool)
    v = float(min_v)
    i = 0
    while v <= max_v and i < slots:
        vals[i] = v
        mask[i] = True
        v += res
        i += 1
    return vals, mask


def sample_velocity_window(
    current_vel,
    limits,
    time_step: float,
    n_vx: int,
    n_vy: int,
    n_omega: int,
    is_omni: bool,
) -> VelocityWindow:
    """Compute the dynamic window and the velocity grid values.

    ``current_vel``: (vx, vy, omega). ``limits``: flat array per
    ``RobotCtrlLimits.to_array`` layout.
    """
    vx0, vy0, w0 = (float(v) for v in current_vel)
    (vx_max_l, vx_acc, vx_dec, vy_max_l, vy_acc, vy_dec, w_max_l, w_acc, w_dec) = (
        float(v) for v in limits
    )
    dt = float(time_step)

    # NO clamp of the current velocity into the limit band — reference
    # parity (trajectory_sampler.cpp:328-372 + the `vx <= max_vx` sample
    # walk): a robot reported FASTER than max_vel + dec*dt yields
    # min > max and therefore ZERO valid samples, exactly like the
    # reference's empty for-loop. The device-window fleet path
    # (ops/solver._device_window) deliberately diverges by clamping v0
    # so over-speed fleet robots keep receiving braking commands.
    max_vx = min(vx_max_l, vx0 + vx_acc * dt)
    min_vx = max(-vx_max_l, vx0 - vx_dec * dt)
    if is_omni:
        max_vy = min(vy_max_l, vy0 + vy_acc * dt)
        min_vy = max(-vy_max_l, vy0 - vy_dec * dt)
    else:
        max_vy = 0.0
        min_vy = 0.0

    res_x = max((max_vx - min_vx) / (n_vx - 1), 0.001) if n_vx > 1 else 0.001
    res_y = max((max_vy - min_vy) / (n_vy - 1), 0.001) if n_vy > 1 else 0.001

    max_w = min(w_max_l, w0 + w_acc * dt)
    min_w = max(-w_max_l, w0 - w_dec * dt)
    res_w = max((max_w - min_w) / (n_omega - 1), 0.001) if n_omega > 1 else 0.001

    vx_vals, vx_mask = _walk(min_vx, max_vx, res_x, n_vx)
    if is_omni:
        vy_vals, vy_mask = _walk(min_vy, max_vy, res_y, n_vy)
    else:
        vy_vals = np.zeros(n_vy, dtype=np.float32)
        vy_mask = np.zeros(n_vy, dtype=bool)
        vy_mask[0] = True  # single vy=0 slot
    w_vals, w_mask = _walk(min_w, max_w, res_w, n_omega)

    return VelocityWindow(vx_vals, vx_mask, vy_vals, vy_mask, w_vals, w_mask)


def compute_linear_sample_split(is_omni: bool, max_linear_samples: int):
    """75/25 vx/vy split for omni, bumped odd (reference
    ``datatypes/trajectory.h:19-29``)."""

    def make_odd(n):
        return n + 1 if n % 2 == 0 else n

    if is_omni:
        return (
            make_odd(max(3, max_linear_samples * 3 // 4)),
            make_odd(max(3, max_linear_samples * 1 // 4)),
        )
    return make_odd(max(3, max_linear_samples)), 1


def num_angular_slots(max_angular_samples: int) -> int:
    """Bump even angular sample counts odd so the symmetric window straddles
    zero (reference ``trajectory_sampler.cpp:48``)."""
    return max_angular_samples + 1 - (max_angular_samples % 2)
