"""Shared planning-space geometry: occupancy field + validity checks.

Counterpart of ``kompass_core_tpu/planning/geometry.py``. Obstacle points
are rasterized on the host into an occupancy grid, inflated by the
robot's circumscribed radius with a disc dilation on the planner's
device, and state and edge validity are dense lookups against it.

The arithmetic is the JAX package's in float32: world to cell is a true
division by the resolution (a device tensor: PyTorch's CUDA division by
a host scalar is a reciprocal multiply, which moves ``floor`` at cell
edges), and a segment's check points sit at ``jnp.linspace``'s
parameters as XLA computes them (``linspace_params``).
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def build_inflated_grid(
    obstacle_points: np.ndarray,
    origin_xy,
    width: int,
    height: int,
    resolution: float,
    inflation_radius: float,
    *,
    device,
):
    """Rasterize obstacle points and inflate by the robot radius.

    Returns a bool grid [H, W] on ``device`` where True = blocked. The
    inflation is the disc dilation of the JAX package's convolution (a
    cell is blocked when an occupied cell lies within ``r_cells`` of it),
    done exactly: per disc row dy, a max over the row's half-width
    ``isqrt(r^2 - dy^2)`` of the grid shifted by dy."""
    pts = np.asarray(obstacle_points, np.float64)
    pts = pts.reshape(-1, pts.shape[-1])
    # floor, not int-truncation: truncation would pull points up to one
    # cell left/below the origin into row/column 0 (point_free floors too)
    gx = np.floor((pts[:, 0] - origin_xy[0]) / resolution).astype(np.int64)
    gy = np.floor((pts[:, 1] - origin_xy[1]) / resolution).astype(np.int64)
    ok = (gx >= 0) & (gx < width) & (gy >= 0) & (gy < height)
    occ = np.zeros((height, width), dtype=bool)
    occ[gy[ok], gx[ok]] = True
    occ_t = torch.as_tensor(occ, device=device)

    r_cells = int(math.ceil(inflation_radius / resolution))
    if r_cells == 0:
        return occ_t

    occ_f = F.pad(occ_t.to(torch.float32)[None, None],
                  (r_cells, r_cells, r_cells, r_cells))[0]  # [1, H + 2r, W + 2r]
    blocked = torch.zeros((height, width), dtype=torch.bool, device=device)
    for dy in range(-r_cells, r_cells + 1):
        w = math.isqrt(r_cells * r_cells - dy * dy)
        rows = occ_f[:, r_cells + dy: r_cells + dy + height, :]
        wide = F.max_pool1d(rows, kernel_size=2 * w + 1, stride=1)[0]  # [H, W + 2r - 2w]
        blocked |= wide[:, r_cells - w: r_cells - w + width] > 0.5
    return blocked


def point_free(blocked, origin_xy, resolution, xy):
    """True if the world point lies in free, in-bounds space.

    ``origin_xy`` [2] and ``resolution`` (0-d) are float32 tensors on the
    grid's device."""
    fx, fy = torch.floor((xy - origin_xy) / resolution).unbind(-1)
    H, W = blocked.shape
    gx = torch.clamp(fx, 0, W - 1)
    gy = torch.clamp(fy, 0, H - 1)
    # a whole cell index is in bounds exactly when the clamp keeps it
    # (NaN and infinities are not)
    in_bounds = (gx == fx) & (gy == fy)
    cell = gy.to(torch.int64) * W + gx.to(torch.int64)
    return in_bounds & ~torch.take(blocked, cell)


@lru_cache(maxsize=64)
def _params_host(num_check: int) -> np.ndarray:
    if num_check == 1:
        return np.zeros(1, np.float32)
    step = np.float32(1.0) / np.float32(num_check - 1)
    t = np.arange(num_check - 1, dtype=np.float32) * step
    return np.concatenate([t, np.ones(1, np.float32)])


def linspace_params(num_check: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, num_check)`` bit for bit: its ``i / (n - 1)``
    becomes ``i * (1 / (n - 1))`` in XLA (a division by a constant is a
    multiply by its float32 reciprocal), then 1 at the end; neither the
    true quotient nor ``torch.linspace``'s formula is, at some points."""
    return torch.from_numpy(_params_host(int(num_check))).to(device)


def segment_free(blocked, origin_xy, resolution, a, b, num_check: int, t=None):
    """All ``num_check`` interpolation points of segment a->b free.
    a, b: [..., 2]. ``t``: the parameters, if the caller holds them."""
    if t is None:
        t = linspace_params(num_check, blocked.device)
    pts = a[..., None, :] + t[:, None] * (b[..., None, :] - a[..., None, :])
    return torch.all(point_free(blocked, origin_xy, resolution, pts), dim=-1)
