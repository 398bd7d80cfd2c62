"""Occupancy-grid mapping: laserscan / pointcloud -> egocentric grid.

Port of ``kompass_core_tpu/ops/mapping.py``. Every grid is computed per
cell: each cell looks at the 5 beams angularly nearest to it, tests
whether it lies on each beam's rasterized line (the diamond super-cover
test) and combines OCCUPIED > EMPTY > UNEXPLORED; the Bayesian form
applies the inverse sensor model of the nearest covering beam to the
previous probability grid.

The work splits in two:

- the beam side, per scan, in plain PyTorch: beam validity, endpoint
  cells, the per-beam table the cells read, and the endpoint scatter
  (``_beam_side``);
- the cell side, one pass over every cell: ``kernels.scan_to_grid_cells``,
  a CUDA kernel on the card (the port of TPU kernel K5) and its plain
  version on the CPU.

What only depends on the spec (each cell's nearest bin, its distance to
the sensor, the beam directions) is computed once per ``(spec,
angle_offset, device)`` on the CPU and copied to the device
(``_geometry``), so the card and the CPU read the same nearest bins.

Rounding follows the JAX package as XLA runs it jitted on the CPU:

- XLA turns a division by a compile-time constant into a multiplication
  by the constant's float32 reciprocal; the port multiplies by the same
  reciprocal (``_recip``), which also keeps the card equal to the CPU
  (PyTorch's CUDA division by a host scalar is a reciprocal multiply
  too, but not the CPU's);
- XLA's CPU backend contracts some ``a * b + c`` into FMAs; the port
  computes those as ``a * b + c`` in float64 rounded to float32
  (``_fma``), which is the FMA unless the float64 sum is inexact and
  falls on a float32 midpoint;
- square roots are taken in float64 and rounded (``_sqrt``): PyTorch's
  CPU float32 sqrt is not correctly rounded;
- the beam angles' cosines and sines and the warp's are taken in
  float64 and rounded, so the card and the CPU agree on them; the cloud
  points' atan2 stays float32 (PyTorch's CPU atan2 agrees with XLA's on
  points that lie on bin edges, where a float64 one does not), so a
  cloud point within an ulp of a bin edge may fall in another bin on
  the card than on the CPU.
"""

import dataclasses
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .kernels import (  # noqa: F401
    EMPTY,
    OCCUPIED,
    UNEXPLORED,
    _fma,
    _sqrt,
    scan_to_grid_cells,
)

_BIAS = 1 << 14  # the JAX table's 15-bit cell indices are biased by 2^14


@dataclasses.dataclass(frozen=True, eq=True)
class MapperSpec:
    """Static geometry of a mapper (the JAX package's ``MapperSpec``)."""

    grid_height: int
    grid_width: int
    num_bins: int  # uniform angular bins in the scan
    resolution: float
    # sensor mounting, fixed per mapper
    laserscan_position_x: float = 0.0
    laserscan_position_y: float = 0.0
    laserscan_orientation: float = 0.0

    @property
    def central_point(self):
        # round(H/2) - 1 per local_mapper.h:26-27
        return (
            int(round(self.grid_height / 2)) - 1,
            int(round(self.grid_width / 2)) - 1,
        )

    @property
    def start_cell(self):
        # localToGrid(laserscan position): central + trunc(pos/res)
        ci, cj = self.central_point
        return (
            ci + int(self.laserscan_position_x / self.resolution),
            cj + int(self.laserscan_position_y / self.resolution),
        )


def mapper_spec_from_jax(spec) -> MapperSpec:
    """The port's ``MapperSpec`` with the field values of a JAX package
    ``MapperSpec`` (read by name; nothing of JAX is imported)."""
    return MapperSpec(**{f.name: getattr(spec, f.name)
                         for f in dataclasses.fields(MapperSpec)})


def _f32(x) -> float:
    return float(np.float32(x))


def _recip(x) -> float:
    """The float32 reciprocal XLA multiplies by where the JAX package
    divides by the constant ``x``."""
    return float(np.float32(1.0) / np.float32(x))


def _scalar(value, device) -> torch.Tensor:
    return torch.full((), _f32(value), dtype=torch.float32, device=device)


class _Geometry(NamedTuple):
    """Per-spec tensors on one device."""

    base: torch.Tensor  # [H, W] int32, each cell's angularly nearest bin
    dist_m: torch.Tensor  # [H, W] f32, cell distance to the sensor cell, m
    cos: torch.Tensor  # [B] f32, beam directions
    sin: torch.Tensor
    pos_x: torch.Tensor  # 0-d f32, sensor position in the robot frame
    pos_y: torch.Tensor
    recip_res: torch.Tensor  # 0-d f32, 1 / resolution


@lru_cache(maxsize=32)
def _geometry(spec: MapperSpec, angle_offset: float, device: torch.device):
    """Computed on the CPU in float32, then copied to ``device``."""
    H, W, B = spec.grid_height, spec.grid_width, spec.num_bins
    si, sj = spec.start_cell
    di = torch.arange(H, dtype=torch.float32)[:, None] - si
    dj = torch.arange(W, dtype=torch.float32)[None, :] - sj
    d = _sqrt(di * di + dj * dj)
    theta = torch.atan2(dj.expand(H, W), di.expand(H, W))
    rel = (theta - _scalar(spec.laserscan_orientation, "cpu")
           - _scalar(angle_offset, "cpu"))
    base = torch.round(rel * _scalar(_recip(2.0 * math.pi / B), "cpu"))
    base = torch.remainder(base.to(torch.int32), B)
    ang = (_scalar(spec.laserscan_orientation + angle_offset, "cpu")
           + torch.arange(B, dtype=torch.float32)
           * _scalar(2.0 * math.pi / B, "cpu")).double()
    cpu = _Geometry(
        base=base,
        dist_m=d * _scalar(spec.resolution, "cpu"),
        cos=torch.cos(ang).float(),
        sin=torch.sin(ang).float(),
        pos_x=_scalar(spec.laserscan_position_x, "cpu"),
        pos_y=_scalar(spec.laserscan_position_y, "cpu"),
        recip_res=_scalar(_recip(spec.resolution), "cpu"),
    )
    return _Geometry(*(t.contiguous().to(device) for t in cpu))


def _geometry_for(spec, angle_offset, device) -> _Geometry:
    return _geometry(spec, float(angle_offset), torch.device(device))


@lru_cache(maxsize=64)
def _model_params(values, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32).to(device)


def _params(device, p_prior, p_empty, p_occupied, range_sure, range_max,
            wall_size) -> torch.Tensor:
    """The inverse sensor model's scalars and the odds update's constant
    (1 - p_prior) / p_prior (a float32 division) as a [7] f32 tensor on
    the device, cached per value."""
    values = tuple(np.float32(v) for v in (p_prior, p_empty, p_occupied,
                                           range_sure, range_max, wall_size))
    odds_k = (np.float32(1.0) - values[0]) / values[0]
    return _model_params(tuple(map(float, values + (odds_k,))),
                         torch.device(device))


def _sanitize_beams(ranges):
    """A beam is real when its range is finite and > 0; the others get
    range 0 and contribute nothing (the JAX package's convention)."""
    valid = torch.isfinite(ranges) & (ranges > 0.0)
    return torch.where(valid, ranges, torch.zeros_like(ranges)), valid


def _to_cell(x):
    return torch.trunc(x).clamp(-(2.0**30), 2.0**30).to(torch.int32)


def _beam_endpoint_cells(spec: MapperSpec, geo: _Geometry, ranges):
    """Endpoint grid cell per beam, truncated toward zero (reference
    ``localToGrid``); ranges [..., B] already sanitized."""
    ci, cj = spec.central_point
    ex = _fma(ranges, geo.cos, geo.pos_x)
    ey = _fma(ranges, geo.sin, geo.pos_y)
    return ci + _to_cell(ex * geo.recip_res), cj + _to_cell(ey * geo.recip_res)


def _beam_side(spec: MapperSpec, geo: _Geometry, ranges):
    """Per-beam work for ranges [R, B]: returns (tables [R, B, 4] int32,
    endpoint [R, H, W] bool).

    A table row is what the JAX package's lookup delivers for that beam:
    the endpoint cell (i, j) clipped as its 15-bit split clips it, the
    range as its bf16 hi/lo split delivers it (``r_hi + bf16(r - r_hi)``,
    ``r_hi = bf16(r)``; bit pattern), and validity. ``endpoint`` marks the
    in-grid endpoint cells of valid beams (the exact OCCUPIED layer)."""
    ranges, valid = _sanitize_beams(ranges)
    e_i, e_j = _beam_endpoint_cells(spec, geo, ranges)

    def clip(e):
        return torch.clamp(e + _BIAS, 0, (1 << 15) - 1) - _BIAS

    r_hi = ranges.to(torch.bfloat16).to(torch.float32)
    r = r_hi + (ranges - r_hi).to(torch.bfloat16).to(torch.float32)
    tables = torch.stack(
        [clip(e_i), clip(e_j), r.view(torch.int32), valid.to(torch.int32)],
        dim=-1,
    ).to(torch.int32)

    H, W = spec.grid_height, spec.grid_width
    in_grid = (e_i >= 0) & (e_i < H) & (e_j >= 0) & (e_j < W) & valid
    flat = torch.where(in_grid, e_i.long() * W + e_j.long(), H * W)
    counts = torch.zeros(ranges.shape[0], H * W + 1, dtype=torch.int32,
                         device=ranges.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    endpoint = (counts[:, : H * W] > 0).view(-1, H, W)
    return tables.contiguous(), endpoint


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _cells(spec, ranges, angle_offset, prev=None, params=None):
    """Beam side then the per-cell pass over ranges [..., B]."""
    B = spec.num_bins
    lead = ranges.shape[:-1]
    if ranges.shape[-1] != B:
        raise ValueError(f"ranges must be [..., {B}], got {tuple(ranges.shape)}")
    geo = _geometry_for(spec, angle_offset, ranges.device)
    tables, endpoint = _beam_side(spec, geo, ranges.reshape(-1, B))
    shape = (-1, spec.grid_height, spec.grid_width)
    if prev is not None:
        prev = prev.reshape(shape).contiguous()
    out = scan_to_grid_cells(geo.base, geo.dist_m, tables, endpoint,
                             spec.start_cell, prev, params)
    grid = lead + (spec.grid_height, spec.grid_width)
    if prev is None:
        return out.reshape(grid)
    return out[0].reshape(grid), out[1].reshape(grid)


def scan_to_grid(spec: MapperSpec, ranges, angle_offset=0.0):
    """Non-Bayesian occupancy grid from a uniform scan.

    ``ranges``: [..., num_bins] f32 tensor (leading robot dimensions
    optional). Returns int32 [..., H, W] of {UNEXPLORED, EMPTY, OCCUPIED}
    on the ranges' device (reference ``scanToGrid``)."""
    return _cells(spec, ranges, angle_offset)


def scan_to_grid_bayesian(spec: MapperSpec, ranges, previous_prob_grid,
                          p_prior, p_empty, p_occupied, range_sure,
                          range_max, wall_size, angle_offset=0.0):
    """Bayesian occupancy update (reference ``scanToGridBaysian``):
    returns (occupancy int32 [..., H, W], probability f32 [..., H, W]).

    Covered cells take the inverse sensor model of their angularly
    nearest covering beam, Bayes-fused with ``previous_prob_grid``
    (already re-projected to the current pose); uncovered cells hold
    p_prior."""
    params = _params(ranges.device, p_prior, p_empty, p_occupied,
                     range_sure, range_max, wall_size)
    prev = _as_f32(previous_prob_grid, ranges.device)
    return _cells(spec, ranges, angle_offset, prev, params)


def warp_previous_grid(spec: MapperSpec, prob_grid, shift_xy, shift_yaw,
                       p_prior):
    """Re-project the previous probability grid into the current
    egocentric pose, bilinear, p_prior outside (the JAX package's
    corrected form of ``getPreviousGridInCurrentPose``).

    prob_grid [..., H, W] f32 tensor; shift_xy [..., 2] (m) and shift_yaw
    [...] (rad): the current pose in the previous one. A new cell at
    offset p samples the old grid at R(yaw) p + shift."""
    device = prob_grid.device
    H, W = spec.grid_height, spec.grid_width
    ci, cj = spec.central_point
    geo = _geometry_for(spec, 0.0, device)
    shift_xy = _as_f32(shift_xy, device)
    yaw = _as_f32(shift_yaw, device).double()
    dx = (shift_xy[..., 0] * geo.recip_res)[..., None, None]
    dy = (shift_xy[..., 1] * geo.recip_res)[..., None, None]
    c = torch.cos(yaw).float()[..., None, None]
    s = torch.sin(yaw).float()[..., None, None]
    pi = torch.arange(H, dtype=torch.float32, device=device)[:, None] - ci
    pj = torch.arange(W, dtype=torch.float32, device=device)[None, :] - cj
    # the rotation and the bilinear blend with XLA's FMAs (module note)
    src_i = ci + (_fma(-s, pj, c * pi) + dx)
    src_j = cj + (_fma(c, pj, s * pi) + dy)
    valid = (src_i >= 0) & (src_i < H - 1) & (src_j >= 0) & (src_j < W - 1)
    i0 = torch.clamp(torch.floor(src_i).to(torch.int32), 0, H - 2)
    j0 = torch.clamp(torch.floor(src_j).to(torch.int32), 0, W - 2)
    wi = src_i - i0
    wj = src_j - j0
    lead = torch.broadcast_shapes(prob_grid.shape[:-2], src_i.shape[:-2])
    flat = prob_grid.expand(lead + (H, W)).reshape(-1, H * W)
    idx = (i0.long() * W + j0.long()).expand(lead + (H, W)).reshape(-1, H * W)

    def at(offset):
        return torch.gather(flat, 1, idx + offset).reshape(lead + (H, W))

    top = _fma(1 - wj, at(0), wj * at(1))
    bottom = _fma(1 - wj, at(W), wj * at(W + 1))
    val = _fma(1 - wi, top, wi * bottom)
    return torch.where(valid, val, _scalar(p_prior, device))


def scan_to_grid_bayesian_warped(spec: MapperSpec, ranges, previous_prob_grid,
                                 shift_xy, shift_yaw, p_prior, p_empty,
                                 p_occupied, range_sure, range_max, wall_size,
                                 angle_offset=0.0):
    """Warp the previous grid by the robot's motion, then fuse the scan.
    Returns (occ [..., H, W] int32, prob [..., H, W] f32, warped)."""
    prev = _as_f32(previous_prob_grid, ranges.device)
    warped = warp_previous_grid(spec, prev, shift_xy, shift_yaw, p_prior)
    occ, prob = scan_to_grid_bayesian(
        spec, ranges, warped, p_prior, p_empty, p_occupied, range_sure,
        range_max, wall_size, angle_offset,
    )
    return occ, prob, warped


def pointcloud_to_scan(points, num_bins, range_max, min_z, max_z):
    """Bin a [..., N, 3] cloud into a uniform laserscan [..., num_bins]:
    per-bin min range (port of ``pointCloudToLaserScanFromRaw``): z
    filter, origin filter, atan2 binning with bin width 2 pi / num_bins,
    bin-min combine, clipped to range_max (empty bins read range_max).

    Reference quirk kept (``pointcloud.h:159``): a NEGATIVE ``max_z``
    disables the upper-z filter (``max_z >= 0 && z > max_z``); it is a
    sentinel, not a usable negative ceiling."""
    pts = points.to(torch.float32)
    device = pts.device
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r2 = _fma(x, x, y * y)
    min_z, max_z = _scalar(min_z, device), _scalar(max_z, device)
    ok = (r2 >= 1e-6) & (z >= min_z) & ((max_z < 0.0) | (z <= max_z))
    ang = torch.atan2(y, x)
    ang = torch.where(ang < 0, ang + _scalar(2 * math.pi, device), ang)
    scaled = ang * _scalar(_recip(2.0 * math.pi / num_bins), device)
    bins = torch.clamp(scaled.to(torch.int32), 0, num_bins - 1)
    dist = torch.where(ok, _sqrt(r2), torch.full_like(r2, math.inf))
    ranges = _bin_min(dist, bins, num_bins)
    return torch.minimum(ranges, _scalar(range_max, device))


def _bin_min(dist, bins, num_bins: int):
    """Per-bin min of ``dist`` [..., N] grouped by ``bins``; +inf where
    a bin is empty."""
    lead = dist.shape[:-1]
    n = dist.shape[-1]
    out = torch.full((math.prod(lead), num_bins), math.inf,
                     dtype=torch.float32, device=dist.device)
    out.scatter_reduce_(1, bins.reshape(-1, n).long(), dist.reshape(-1, n),
                        "amin", include_self=True)
    return out.reshape(lead + (num_bins,))


def resample_scan_uniform(angles, ranges, num_bins, range_max):
    """Host: bin-min resample an arbitrary scan onto the uniform grid the
    gather kernels assume. Uniform input scans map 1:1."""
    angles = np.mod(np.asarray(angles, np.float64), 2 * np.pi)
    ranges = np.asarray(ranges, np.float64)
    step = 2 * np.pi / num_bins
    bins = np.minimum((angles / step).astype(np.int64), num_bins - 1)
    # real no-echo beams (+inf) clip to range_max (reference semantics);
    # NaN DROPOUT beams contribute nothing — converting a dropout into a
    # valid max-range beam would stamp EMPTY along terrain the sensor
    # never observed (round-5 review; upstream clips propagate NaN
    # through min/max, so dropouts reach this resampler). Bins NO real
    # beam maps into (a partial-FOV lidar's blind sector, or all-dropout
    # bins) stay 0.0 = invalid under the kernels' beam-validity
    # convention.
    valid = ~np.isnan(ranges)
    out = np.full(num_bins, np.inf)
    np.minimum.at(
        out, bins[valid],
        np.where(np.isinf(ranges[valid]), range_max, ranges[valid]),
    )
    out = np.where(np.isfinite(out), out, 0.0)
    return out.astype(np.float32)


def pad_cloud_to_bucket(points, bucket: int = 4096):
    """Pad an [N, 3] cloud with zero rows to the next multiple of
    ``bucket`` (host side). Zero rows are origin points, which every
    cloud consumer filters (r^2 < 1e-6), so padding changes no result."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    pad = (-points.shape[0]) % bucket
    if pad == 0 and points.shape[0] > 0:
        return points
    return np.concatenate(
        [points, np.zeros((max(pad, bucket if points.shape[0] == 0 else pad), 3), np.float32)],
        axis=0,
    )


# --- callables bound to (spec, device); inputs may be numpy or tensors ------


def _bound(factory):
    cached = lru_cache(maxsize=32)(factory)

    def get(key, device):
        return cached(key, torch.device(device))

    get.__doc__ = factory.__doc__
    get.__name__ = factory.__name__
    return get


@_bound
def get_scan_to_grid(spec: MapperSpec, device):
    """``scan_to_grid`` on ``device``: ranges [..., B] -> int32 grids."""
    def run(ranges, angle_offset=0.0):
        return scan_to_grid(spec, _as_f32(ranges, device), angle_offset)
    return run


@_bound
def get_scan_to_grid_bayesian(spec: MapperSpec, device):
    """``scan_to_grid_bayesian`` on ``device``."""
    def run(ranges, previous_prob_grid, *model, angle_offset=0.0):
        return scan_to_grid_bayesian(
            spec, _as_f32(ranges, device), previous_prob_grid, *model,
            angle_offset=angle_offset)
    return run


@_bound
def get_warp_previous_grid(spec: MapperSpec, device):
    """``warp_previous_grid`` on ``device``."""
    def run(prob_grid, shift_xy, shift_yaw, p_prior):
        return warp_previous_grid(spec, _as_f32(prob_grid, device), shift_xy,
                                  shift_yaw, p_prior)
    return run


@_bound
def get_scan_to_grid_bayesian_warped(spec: MapperSpec, device):
    """``scan_to_grid_bayesian_warped`` on ``device``."""
    def run(ranges, previous_prob_grid, shift_xy, shift_yaw, *model,
            angle_offset=0.0):
        return scan_to_grid_bayesian_warped(
            spec, _as_f32(ranges, device), previous_prob_grid, shift_xy,
            shift_yaw, *model, angle_offset=angle_offset)
    return run


@_bound
def get_pointcloud_to_scan(num_bins: int, device):
    """``pointcloud_to_scan`` on ``device`` for ``num_bins`` bins."""
    def run(points, range_max, min_z, max_z):
        return pointcloud_to_scan(_as_f32(points, device), num_bins,
                                  range_max, min_z, max_z)
    return run


def get_scan_to_grid_fleet(spec: MapperSpec, device):
    """Batched occupancy mapping: ranges [N, num_bins] -> grids [N, H, W]
    in one launch of the per-cell kernel."""
    return get_scan_to_grid(spec, device)


def get_scan_to_grid_bayesian_fleet(spec: MapperSpec, device):
    """Batched Bayesian mapping: (ranges [N, B], prev_prob [N, H, W], the
    six model scalars shared by the fleet) -> (occ [N, H, W], prob
    [N, H, W]) in one launch of the per-cell kernel."""
    return get_scan_to_grid_bayesian(spec, device)
