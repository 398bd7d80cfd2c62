"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
their loader.

The DWA tick's two sweeps, the obstacle min-distance field and the
tracked-segment min-distance field, run in one pass over the rollout
points, for one robot or a batch of robots (leading axis B):

- ``fused_min_dist_sq`` is the port of the TPU kernel
  ``kompass_core_tpu/ops/pallas_kernels.py::_fused_kernel_vpu`` (K1,
  reached there through ``fused_min_dist_sq`` with
  ``backend="pallas_vpu"``): static obstacle rows.
- ``fused_min_dist_sq_moving`` is the port of
  ``_fused_kernel_vpu_moving`` / ``_fused_kernel_mxu_moving`` (K3, reached
  through ``fused_min_dist_sq_moving_pallas``): every obstacle row moves
  at constant velocity, o + v * t * dt at rollout step t. The segment
  rows stay static.

The occupancy mapper's per-cell pass is one kernel:

- ``scan_to_grid_cells`` is the port of
  ``kompass_core_tpu/ops/mapping.py::_banded_lookup_dot_pallas`` (K5, the
  candidate-beam lookup of ``_candidate_lookup``), fused with what the
  JAX package does with the candidates: the diamond line test, the
  OCCUPIED / EMPTY / UNEXPLORED combine and, in the Bayesian form, the
  inverse sensor model of the nearest covering beam.

The kernel sources are ``csrc/*.cu``. They are compiled at first use with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
loaded with ``ctypes``. The library goes into
``build/kompass_core_tpu_torch/<hash of the sources>/`` at the repository
root. A missing ``nvcc`` or a failed build raises with the compiler's
output; nothing falls back to the plain version.

Device rule: a wrapper given CPU tensors runs the plain version (that is
how the CPU tests run); given CUDA tensors it launches the kernel or
raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kompass_core_tpu_torch"
_LIB_NAME = "libkompass_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# plain version: largest [robots, rows, T, R] broadcast slab, in elements
_SLAB_ELEMS = 1 << 24
_MAX_BATCH = 65535  # the kernel's grid.y

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of kompass_core_tpu_torch are "
            "built from csrc/ at first use and need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return str(nvcc)


def library_path() -> Path:
    """Where the kernels' library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / _LIB_NAME


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the library unless it is already built.

    Returns its path. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``nvcc.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    sources = [str(s) for s in sorted(_CSRC_DIR.glob("*.cu"))]
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}"
        )
    (lib.parent / "nvcc.log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.kompass_fused_min_dist_sq.restype = ctypes.c_int
            lib.kompass_fused_min_dist_sq.argtypes = [
                p, p, i, i, i, p, i, p, p, i, p, p, p, p,
            ]
            lib.kompass_fused_min_dist_sq_moving.restype = ctypes.c_int
            lib.kompass_fused_min_dist_sq_moving.argtypes = [
                p, p, i, i, i, p, p, p, i, p, p, i, p, p, p, p,
            ]
            lib.kompass_scan_to_grid_cells.restype = ctypes.c_int
            lib.kompass_scan_to_grid_cells.argtypes = [
                p, p, i, i, p, i, p, i, i, p, p, i, p, p, p,
            ]
            _lib = lib
    return _lib


def _check_sweep(px, py, obs_xy, seg_x, seg_y, active_points, obs_vel, dt):
    """Check the sweep's inputs; returns (B, S, T, O, G, batched).

    Unbatched: px, py [S, T]; obs_xy (and obs_vel) [O, 2]; seg_x, seg_y
    [G]; active_points (and dt) one value. Batched: the same with a
    leading B, and active_points (and dt) [B]. No view is made: these
    checks run on every launch, so they stay cheap."""
    name = "fused_min_dist_sq" + ("_moving" if obs_vel is not None else "")
    tensors = [px, py, obs_xy, seg_x, seg_y, active_points]
    if obs_vel is not None:
        tensors += [obs_vel, dt]
    device = px.device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    if any(t.dtype != torch.float32 for t in tensors if t is not active_points):
        raise TypeError(f"{name}: every tensor but active_points must be float32")
    if active_points.dtype != torch.int32:
        raise TypeError(f"{name}: active_points must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    batched = px.dim() == 3
    if batched:
        B, S, T = px.shape
        lead = (B,)
    elif px.dim() == 2:
        (S, T), B, lead = px.shape, 1, ()
        if active_points.numel() != 1 or (dt is not None and dt.numel() != 1):
            raise TypeError(f"{name}: active_points and dt must be one value")
    else:
        raise ValueError(f"{name}: px, py must be [S, T] or [B, S, T]")
    O, G = obs_xy.shape[-2] if obs_xy.dim() > 1 else 0, seg_x.shape[-1]
    if py.shape != px.shape or px.numel() == 0:
        raise ValueError(f"{name}: px, py must be non-empty and of one shape")
    if S * T >= 2**31 or B > _MAX_BATCH:
        raise ValueError(f"{name}: S * T must fit in int32 and B <= {_MAX_BATCH}")
    if obs_xy.shape != lead + (O, 2) or O == 0:
        raise ValueError(f"{name}: obs_xy must be non-empty [O, 2] per robot")
    if seg_x.shape != lead + (G,) or seg_y.shape != seg_x.shape or G == 0:
        raise ValueError(f"{name}: seg_x, seg_y must be non-empty [G] per robot")
    if batched and active_points.shape != lead:
        raise ValueError(f"{name}: active_points must be [B]")
    if obs_vel is not None and (obs_vel.shape != obs_xy.shape
                                or (batched and dt.shape != lead)):
        raise ValueError(f"{name}: obs_vel must match obs_xy and dt be [B]")
    return B, S, T, O, G, batched


def _sweep_reference(px, py, xs, ys, vx=None, vy=None, tau=None):
    """[B, S, T] points vs [B, R] rows -> [B, S, T] min of |p - o|^2, the
    operations rounded one by one; rows move as o + v * tau[B, T] when
    velocities are given. Evaluated in slabs of robots and rows of S so
    the [.., T, R] broadcast stays bounded."""
    B, S, T = px.shape
    R = xs.shape[1]
    if vx is None:
        ox, oy = xs[:, None, None, :], ys[:, None, None, :]  # [B, 1, 1, R]
    else:
        step = tau[:, :, None]  # [B, T, 1]
        ox = (xs[:, None, :] + vx[:, None, :] * step)[:, None]  # [B, 1, T, R]
        oy = (ys[:, None, :] + vy[:, None, :] * step)[:, None]
    rows = max(1, _SLAB_ELEMS // (T * R))
    robots = max(1, rows // S)
    rows = min(rows, S)
    out = px.new_empty(px.shape)
    for b0 in range(0, B, robots):
        b = slice(b0, b0 + robots)
        for s0 in range(0, S, rows):
            s = slice(s0, s0 + rows)
            dx = px[b, s, :, None] - ox[b]
            dy = py[b, s, :, None] - oy[b]
            out[b, s] = torch.amin(dx * dx + dy * dy, dim=-1)
    return out


def fused_min_dist_sq_reference(
    px, py, obs_xy, seg_x, seg_y, active_points, obs_vel=None, dt=None
):
    """Plain PyTorch version of both kernels: the same operations, rounded
    one by one. Shapes as for ``fused_min_dist_sq``; with ``obs_vel`` and
    ``dt`` it is the moving sweep of ``fused_min_dist_sq_moving``."""
    *_, T, _, _, batched = _check_sweep(
        px, py, obs_xy, seg_x, seg_y, active_points, obs_vel, dt
    )
    if not batched:
        px, py, obs_xy, seg_x, seg_y = (
            t.unsqueeze(0) for t in (px, py, obs_xy, seg_x, seg_y)
        )
        active_points = active_points.reshape(1)
        if obs_vel is not None:
            obs_vel, dt = obs_vel.unsqueeze(0), dt.reshape(1)
    t = torch.arange(T, device=px.device)
    if obs_vel is None:
        d2_obs = _sweep_reference(px, py, obs_xy[..., 0], obs_xy[..., 1])
    else:
        tau = t.to(torch.float32)[None, :] * dt[:, None]  # [B, T]
        d2_obs = _sweep_reference(
            px, py, obs_xy[..., 0], obs_xy[..., 1],
            obs_vel[..., 0], obs_vel[..., 1], tau,
        )
    d2_seg = _sweep_reference(px, py, seg_x, seg_y)
    active = (t[None, :] < active_points[:, None])[:, None, :]  # [B, 1, T]
    d2_obs = torch.where(active, d2_obs, torch.inf)
    d2_seg = torch.where(active, d2_seg, torch.inf)
    if not batched:
        return d2_obs[0], d2_seg[0]
    return d2_obs, d2_seg


def _launch(fn, dims, px, py, obs, sx, sy, ap, vel=None, dt=None):
    """Launch ``fn`` of the library on the current stream of the inputs'
    card; returns the two output fields (shaped like px), or raises on a
    refused launch."""
    lib = _library()
    B, S, T, O, G, _ = dims
    out_obs = torch.empty_like(px)
    out_seg = torch.empty_like(px)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        mid = () if vel is None else (vel.data_ptr(), dt.data_ptr())
        err = getattr(lib, fn)(
            px.data_ptr(), py.data_ptr(), B, S * T, T, obs.data_ptr(), *mid,
            O, sx.data_ptr(), sy.data_ptr(), G, ap.data_ptr(),
            out_obs.data_ptr(), out_seg.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {err})")
    return out_obs, out_seg


def fused_min_dist_sq(px, py, obs_xy, seg_x, seg_y, active_points):
    """Both static min-distance sweeps of the tick in one kernel launch.

    px, py: [S, T] rollout points ([B, S, T] for B robots); obs_xy:
    [O, 2] obstacle rows ([B, O, 2]); seg_x, seg_y: [G] tracked-segment
    rows ([B, G]); pad rows sit at 1e8 and never win. active_points:
    one int32 ([B] int32) on the same device, read by the kernel there.
    Returns (d2_obs, d2_seg), each shaped like px, f32, +inf where t >=
    active_points. On CUDA it launches on the current stream without
    synchronising and adds one to ``fused_min_dist_sq.launches``."""
    if px.device.type == "cpu":
        return fused_min_dist_sq_reference(
            px, py, obs_xy, seg_x, seg_y, active_points
        )
    dims = _check_sweep(px, py, obs_xy, seg_x, seg_y, active_points, None, None)
    out = _launch("kompass_fused_min_dist_sq", dims, px, py, obs_xy, seg_x,
                  seg_y, active_points)
    fused_min_dist_sq.launches += 1
    return out


def fused_min_dist_sq_moving(px, py, obs_xy, obs_vel, dt, seg_x, seg_y,
                             active_points):
    """The moving obstacle sweep and the static segment sweep in one
    kernel launch.

    As ``fused_min_dist_sq``, plus obs_vel: [O, 2] world velocity per
    obstacle row ([B, O, 2]; pad rows zero) and dt: the control step,
    one f32 ([B] f32). At rollout step t an obstacle row sits at
    o + v * (t * dt). A zero velocity gives ``fused_min_dist_sq``'s
    values bit for bit. On CUDA it adds one to
    ``fused_min_dist_sq_moving.launches``."""
    if px.device.type == "cpu":
        return fused_min_dist_sq_reference(
            px, py, obs_xy, seg_x, seg_y, active_points, obs_vel, dt
        )
    dims = _check_sweep(px, py, obs_xy, seg_x, seg_y, active_points, obs_vel, dt)
    out = _launch("kompass_fused_min_dist_sq_moving", dims, px, py, obs_xy,
                  seg_x, seg_y, active_points, obs_vel, dt)
    fused_min_dist_sq_moving.launches += 1
    return out


fused_min_dist_sq.launches = 0
fused_min_dist_sq_moving.launches = 0


# --- the mapper's per-cell pass (K5) ------------------------------------------

OCCUPIED, EMPTY, UNEXPLORED = 100, 0, -1
CANDIDATES = 5  # beams per cell: its nearest bin and 2 on each side
N_MODEL_PARAMS = 6  # p_prior, p_empty, p_occupied, range_sure, range_max, wall_size


def _sqrt(x):
    """Correctly rounded float32 sqrt on every device (PyTorch's CPU
    float32 sqrt is not); the kernel's ``__fsqrt_rn``."""
    return torch.sqrt(x.double()).float()


def _fma(a, b, c):
    """a * b + c computed in float64 and rounded to float32: the FMA that
    XLA's CPU backend fuses there, unless the float64 sum is inexact and
    falls on a float32 midpoint. The kernel computes the same in double."""
    return (a.double() * b.double() + c.double()).float()


def _check_cells(base, dist_m, tables, endpoint, prev, params):
    """Check the per-cell pass's inputs; returns (R, H, W, B).

    base [H, W] int32 (each cell's nearest bin, in [0, B)); dist_m [H, W]
    f32; tables [R, B, 4] int32; endpoint [R, H, W] bool; the Bayesian
    form adds prev [R, H, W] f32 and params [6] f32."""
    name = "scan_to_grid_cells"
    if (prev is None) != (params is None):
        raise ValueError(f"{name}: give both prev and params, or neither")
    tensors = [base, dist_m, tables, endpoint]
    if prev is not None:
        tensors += [prev, params]
    device = base.device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    dtypes = [torch.int32, torch.float32, torch.int32, torch.bool,
              torch.float32, torch.float32]
    if any(t.dtype != d for t, d in zip(tensors, dtypes)):
        raise TypeError(f"{name}: base and tables int32, endpoint bool, "
                        "dist_m, prev and params float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    if base.dim() != 2 or tables.dim() != 3 or tables.shape[-1] != 4:
        raise ValueError(f"{name}: base must be [H, W] and tables [R, B, 4]")
    (H, W), (R, B, _) = base.shape, tables.shape
    if H * W == 0 or B == 0 or R == 0:
        raise ValueError(f"{name}: empty grid, scan or batch")
    if H * W >= 2**31 or R > _MAX_BATCH:
        raise ValueError(f"{name}: H * W must fit in int32 and R <= {_MAX_BATCH}")
    if dist_m.shape != (H, W) or endpoint.shape != (R, H, W):
        raise ValueError(f"{name}: dist_m must be [H, W] and endpoint [R, H, W]")
    if prev is not None and (prev.shape != (R, H, W)
                             or params.shape != (N_MODEL_PARAMS,)):
        raise ValueError(f"{name}: prev must be [R, H, W] and params [6]")
    return R, H, W, B


def scan_to_grid_candidates(base, tables):
    """[R, H, W, 5, 4]: a cell's candidate k is the table row of bin
    (base + k - 2) mod B, what the JAX package's rolled tables deliver."""
    B = tables.shape[1]
    k = torch.arange(CANDIDATES, device=base.device) - CANDIDATES // 2
    return tables[:, torch.remainder(base.long()[..., None] + k, B)]


def scan_to_grid_cells_reference(base, dist_m, tables, endpoint, start_cell,
                                 prev=None, params=None):
    """Plain PyTorch version of the per-cell pass: the same operations
    with the same roundings. Arguments as for ``scan_to_grid_cells``."""
    _, H, W, _ = _check_cells(base, dist_m, tables, endpoint, prev, params)
    si, sj = start_cell
    device = base.device
    cand = scan_to_grid_candidates(base, tables)  # [R, H, W, C, 4]
    vx = (cand[..., 0] - si).to(torch.float32)
    vy = (cand[..., 1] - sj).to(torch.float32)
    di = (torch.arange(H, device=device) - si).to(torch.float32)[:, None, None]
    dj = (torch.arange(W, device=device) - sj).to(torch.float32)[None, :, None]
    # diamond (super-cover) test against the line from the sensor cell to
    # each candidate's endpoint cell
    L = _sqrt(_fma(vx, vx, vy * vy))
    L_safe = torch.clamp(L, min=1e-6)
    t = (di * vx + dj * vy) / L_safe
    perp = torch.abs(di * vy - dj * vx) / L_safe
    halfwidth = (torch.abs(vx) + torch.abs(vy)) / (2.0 * L_safe) + 1e-4
    on_line = ((t >= -0.5) & (t <= L) & (perp <= halfwidth) & (L > 0)
               & (cand[..., 3] != 0))
    covered = on_line.any(dim=-1)
    occ = torch.where(endpoint, OCCUPIED,
                      torch.where(covered, EMPTY, UNEXPLORED)).to(torch.int32)
    if prev is None:
        return occ
    # the nearest covering candidate: offsets 0, -1, +1, -2, +2 in turn
    # (the JAX package's first argmax of -|k - 2|)
    r_c = cand[..., 2].view(torch.float32)
    r_sel = r_c[..., 4]
    for k in (0, 3, 1, 2):
        r_sel = torch.where(on_line[..., k], r_c[..., k], r_sel)
    p_prior, p_empty, p_occupied, range_sure, range_max, wall_size = params.unbind()
    one = torch.ones((), dtype=torch.float32, device=device)
    # inverse sensor model and Bayes odds update (updateGridCellProbability)
    p_f = torch.where(dist_m < r_sel - wall_size, p_empty, p_occupied)
    delta = torch.where(dist_m < range_sure, 0.0 * one, one)
    p_sensor = _fma(delta * ((dist_m - range_sure) / range_max),
                    p_prior - p_f, p_f)
    odds = (prev / (one - prev)) * (p_sensor / (one - p_sensor))
    new = one - one / _fma(odds, (one - p_prior) / p_prior, one)
    return occ, torch.where(covered, new, p_prior)


def scan_to_grid_cells(base, dist_m, tables, endpoint, start_cell,
                       prev=None, params=None):
    """The mapper's per-cell pass over R robots' grids in one launch.

    base: [H, W] int32, each cell's angularly nearest bin; dist_m: [H, W]
    f32, each cell's distance to the sensor cell in metres; tables:
    [R, B, 4] int32 per beam: endpoint cell i, j, range (f32 bits) and
    validity; endpoint: [R, H, W] bool, the cells a valid beam ends in;
    start_cell: the sensor cell (i, j). For the Bayesian form also prev:
    [R, H, W] f32, the previous probability grid, and params: [6] f32
    (p_prior, p_empty, p_occupied, range_sure, range_max, wall_size) on
    the device.

    Returns occ [R, H, W] int32, and in the Bayesian form (occ, prob
    [R, H, W] f32). On CUDA it launches on the current stream without
    synchronising and adds one to ``scan_to_grid_cells.launches``."""
    if base.device.type == "cpu":
        return scan_to_grid_cells_reference(base, dist_m, tables, endpoint,
                                            start_cell, prev, params)
    R, H, W, B = _check_cells(base, dist_m, tables, endpoint, prev, params)
    lib = _library()
    occ = torch.empty((R, H, W), dtype=torch.int32, device=base.device)
    prob = None if prev is None else torch.empty_like(prev)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        err = lib.kompass_scan_to_grid_cells(
            base.data_ptr(), dist_m.data_ptr(), H * W, W, tables.data_ptr(),
            B, endpoint.data_ptr(), start_cell[0], start_cell[1],
            None if prev is None else prev.data_ptr(),
            None if params is None else params.data_ptr(), R,
            occ.data_ptr(), None if prob is None else prob.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"scan_to_grid_cells: kernel launch failed (cudaError {err})")
    scan_to_grid_cells.launches += 1
    return occ if prob is None else (occ, prob)


scan_to_grid_cells.launches = 0
