"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
their loader.

The DWA tick's two sweeps, the obstacle min-distance field and the
tracked-segment min-distance field, run in one pass over the rollout
points, for one robot or a batch of robots (leading axis B). Which form
runs follows the solver's ``SolverSpec.backend``, as in the JAX package
(``ops/solver.py::_sweeps``):

- ``fused_min_dist_sq`` (K1, backend ``"xla"``): static obstacle rows in
  the direct form (p - o)^2, the function of the JAX package's XLA sweep
  ``kompass_core_tpu/ops/solver.py::_min_obstacle_dist_sq``.
- ``fused_min_dist_sq_expanded`` is the port of the TPU kernel
  ``kompass_core_tpu/ops/pallas_kernels.py::_fused_kernel_mxu`` (K2,
  backend ``"pallas"``): the same two sweeps in the expanded form
  |o|^2 - 2 o.p, + |p|^2, clamped at 0.
- ``fused_min_dist_sq_broadcast`` is the port of ``_fused_kernel_vpu``
  (K6, backend ``"pallas_vpu"``): the broadcast form (|o|^2 + (-2px) ox)
  + (-2py) oy, + |p|^2, clamped at 0.
- ``min_dist_sq_expanded`` is the port of ``_min_dist_kernel`` (K4,
  backend ``"pallas_v1"``): one expanded sweep, launched once for the
  obstacle rows and once for the segment rows.
- ``fused_min_dist_sq_moving`` (K3, backend ``"xla"`` with moving
  obstacles): every obstacle row moves at constant velocity, o + v * t *
  dt at rollout step t, in the direct form, the function of the XLA sweep
  ``_min_obstacle_dist_sq_moving``. The segment rows stay static.
- ``min_dist_sq_moving`` (K3s): K3's moving obstacle sweep alone, over the
  split mover rows (``dwa_solve``'s ``mover4``, every backend), as K4 is
  K2's obstacle sweep alone.
- ``fused_min_dist_sq_moving_expanded`` is the port of
  ``_fused_kernel_mxu_moving`` (K7, backends ``"pallas"`` and
  ``"pallas_v1"`` with moving obstacles): the 7-feature dot f(o).g(p) as
  a feature-order chain of fused multiply-adds, its segment sweep K2's.
- ``fused_min_dist_sq_moving_broadcast`` is the port of
  ``_fused_kernel_vpu_moving`` (K8, backend ``"pallas_vpu"`` with moving
  obstacles): the same features as a left fold of separately rounded
  products and sums, its segment sweep K6's.

``csrc/fused_min_dist.cu`` says what each form computes, operation by
operation, and how each kernel is laid out: K1, K2, K4 and K6 are one
static kernel, whose samples per thread are ``sweep_points``'. The
expanded forms cancel as the coordinates grow: their absolute error is a
few float32 ulps of |p|^2 + |o|^2, about 1e-5 m^2 within 10 m of the
origin, where the JAX package's scenarios lie (``bench.py``), and a
hundred times that at 100 m. They are ported as
the TPU kernels compute them; the XLA sweeps (K1, K3) use the direct
form.

BOX robots' collision field is one kernel (``csrc/box_min_dist.cu``):

- ``box_min_dist_sq`` (K9): the squared distance from the robot's
  oriented box to every obstacle row, min over the rows, the function of
  the JAX package's XLA sweep ``kompass_core_tpu/ops/solver.py::
  _min_box_dist_sq``; static or moving rows, per-robot half extents, the
  headings' cos and sin given by the caller.

The occupancy mapper's per-cell pass is one kernel:

- ``scan_to_grid_cells`` is the port of
  ``kompass_core_tpu/ops/mapping.py::_banded_lookup_dot_pallas`` (K5, the
  candidate-beam lookup of ``_candidate_lookup``), fused with what the
  JAX package does with the candidates: the diamond line test, the
  OCCUPIED / EMPTY / UNEXPLORED combine and, in the Bayesian form, the
  inverse sensor model of the nearest covering beam. What depends only
  on the beam (the line's length and the test's bounds,
  ``line_test_bounds``) is computed once per beam by a first launch in
  the same call, so a cell's test makes no division and no square root.

The kernel sources are ``csrc/*.cu``. At first use each source is
compiled with its own ``nvcc`` for ``sm_90a``, all at once, and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library goes into
``build/kompass_core_tpu_torch/<hash of the sources>/`` at the repository
root. A missing ``nvcc`` or a failed build raises with the compiler's
output; nothing falls back to the plain version.

Device rule: a wrapper given CPU tensors runs the plain version (that is
how the CPU tests run); given CUDA tensors it launches the kernel or
raises.
"""

import ctypes
import functools
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kompass_core_tpu_torch"
_LIB_NAME = "libkompass_torch_kernels.so"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

# plain version: largest [robots, rows, T, R] broadcast slab, in elements
_SLAB_ELEMS = 1 << 24
# a grid dimension's limit: the robots, K3's steps and K5's 8-row tiles
_MAX_BATCH = 65535

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(_CSRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / _LIB_NAME


def _run_all(cmds):
    """Run the commands at once; returns their outputs (stderr + stdout)
    or raises with the first failure's command and output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{err}{out}"
            )
    return [err + out for out, err in outs]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the library unless it is already built:
    one ``nvcc`` per source, all started together, then one link.

    Returns its path. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``nvcc.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    sources = sorted(_CSRC_DIR.glob("*.cu"))
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [lib.with_name(f".{src.stem}.{tag}.o") for src in sources]
    tmp = lib.with_name(f".{lib.name}.{tag}")
    nvcc = _nvcc()
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(sources, objs)])
        logs += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    (lib.parent / "nvcc.log").write_text("".join(logs))
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            for name in ("kompass_fused_min_dist_sq",
                         "kompass_fused_min_dist_sq_expanded",
                         "kompass_fused_min_dist_sq_broadcast"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = [
                    p, p, i, i, i, p, i, p, p, i, p, p, p, i, p,
                ]
            for name in ("kompass_fused_min_dist_sq_moving",
                         "kompass_fused_min_dist_sq_moving_expanded",
                         "kompass_fused_min_dist_sq_moving_broadcast"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = [
                    p, p, i, i, i, p, p, p, i, p, p, i, p, p, p, p,
                ]
            lib.kompass_min_dist_sq_expanded.restype = ctypes.c_int
            lib.kompass_min_dist_sq_expanded.argtypes = [
                p, p, i, i, i, p, i, p, p, i, p,
            ]
            lib.kompass_min_dist_sq_moving.restype = ctypes.c_int
            lib.kompass_min_dist_sq_moving.argtypes = [
                p, p, i, i, i, p, p, p, i, p, p, p,
            ]
            lib.kompass_box_min_dist_sq.restype = ctypes.c_int
            lib.kompass_box_min_dist_sq.argtypes = [
                p, p, p, p, i, i, i, p, p, p, i, p, p, p, i, p,
            ]
            lib.kompass_scan_to_grid_cells.restype = ctypes.c_int
            lib.kompass_scan_to_grid_cells.argtypes = [
                p, p, i, i, p, i, p, i, i, p, p, i, p, p, p, p,
            ]
            _lib = lib
    return _lib


def _check_sweep(name, px, py, obs_xy, seg_x, seg_y, active_points,
                 obs_vel=None, dt=None):
    """Check the sweep's inputs; returns (B, S, T, O, G, batched).

    Unbatched: px, py [S, T]; obs_xy (and obs_vel) [O, 2]; seg_x, seg_y
    [G]; active_points (and dt) one value. Batched: the same with a
    leading B, and active_points (and dt) [B]. The single sweep has no
    segment rows (seg_x None, G = 0). No view is made: these checks run
    on every launch, so they stay cheap."""
    tensors = [px, py, obs_xy, active_points]
    if seg_x is not None:
        tensors += [seg_x, seg_y]
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
    O = obs_xy.shape[-2] if obs_xy.dim() > 1 else 0
    G = 0 if seg_x is None else seg_x.shape[-1]
    if py.shape != px.shape or px.numel() == 0:
        raise ValueError(f"{name}: px, py must be non-empty and of one shape")
    if S * T >= 2**31 or B > _MAX_BATCH:
        raise ValueError(f"{name}: S * T must fit in int32 and B <= {_MAX_BATCH}")
    if obs_xy.shape != lead + (O, 2) or O == 0:
        raise ValueError(f"{name}: obs_xy must be non-empty [O, 2] per robot")
    if seg_x is not None and (seg_x.shape != lead + (G,)
                              or seg_y.shape != seg_x.shape or G == 0):
        raise ValueError(f"{name}: seg_x, seg_y must be non-empty [G] per robot")
    if batched and active_points.shape != lead:
        raise ValueError(f"{name}: active_points must be [B]")
    if obs_vel is not None and (obs_vel.shape != obs_xy.shape
                                or (batched and dt.shape != lead)):
        raise ValueError(f"{name}: obs_vel must match obs_xy and dt be [B]")
    if obs_vel is not None and T > _MAX_BATCH:
        raise ValueError(f"{name}: T must be <= {_MAX_BATCH} (the kernel's grid.y)")
    return B, S, T, O, G, batched


def _fma_rn(a, b, c):
    """a * b + c rounded once to float32, as CUDA's ``__fmaf_rn`` and the
    FMAs of XLA's CPU backend compute it (float32 tensors, broadcast).

    The product is exact in float64 and TwoSum gives the error of the
    float64 sum; where that sum falls on a float32 midpoint with the
    exact value off it, the result rounds toward the exact value, so
    there is no double rounding (``_fma`` keeps it)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    rd = r.double()
    n = torch.nextafter(r, torch.where(s > rd, math.inf, -math.inf))
    mid = (s == (rd + n.double()) * 0.5) & (s != rd) & (err != 0)
    toward = torch.where(err > 0, torch.maximum(r, n), torch.minimum(r, n))
    return torch.where(mid, toward, r)


def _norm_pair(form, ox, oy, px, py):
    """One (point, row) value of a static form: the direct distance, or
    the expanded or broadcast form without |p|^2, each operation rounded
    on its own (``csrc/fused_min_dist.cu``)."""
    if form == "direct":
        dx, dy = px - ox, py - oy
        return dx * dx + dy * dy
    onorm = ox * ox + oy * oy
    if form == "expanded":
        return onorm - 2.0 * (ox * px + oy * py)
    return (onorm + (-2.0 * px) * ox) + (-2.0 * py) * oy  # broadcast


def _feature_prefix(form, ox, oy, vx, vy, tau):
    """K7's ("expanded") or K8's ("broadcast") per-(row, step) prefix
    f0 + f1 tau^2 + f2 tau: rows [B, R], tau [B, T] -> [B, T, R]."""
    ox, oy, vx, vy = (v[:, None, :] for v in (ox, oy, vx, vy))
    tau = tau[:, :, None]
    tau2 = tau * tau
    f0 = ox * ox + oy * oy
    f1 = vx * vx + vy * vy
    f2 = 2.0 * (vx * ox + vy * oy)
    if form == "expanded":
        return _fma_rn(f2, tau, _fma_rn(f1, tau2, f0))
    return (f0 + f1 * tau2) + f2 * tau


def _feature_pair(form, c, f3, f4, f5, f6, px, py, tx, ty):
    """One (point, row) value of K7's or K8's obstacle form: the prefix c
    plus the four point terms (``csrc/fused_min_dist.cu``)."""
    if form == "expanded":
        return _fma_rn(f6, ty, _fma_rn(f5, tx, _fma_rn(f4, py, _fma_rn(f3, px, c))))
    return (((c + f3 * px) + f4 * py) + f5 * tx) + f6 * ty


def _sweep_reference(px, py, xs, ys, form="direct", vx=None, vy=None,
                     tau=None):
    """[B, S, T] points vs [B, R] rows -> [B, S, T] min over the rows of
    the form's per-pair value, the operations rounded one by one. With
    velocities, ``form`` "direct" moves the rows to o + v * tau[B, T]
    (K3), "expanded" and "broadcast" are K7's and K8's feature forms.
    Evaluated in slabs of robots and rows of S so the [.., T, R]
    broadcast stays bounded (a quarter of it for K7's float64 FMAs)."""
    B, S, T = px.shape
    R = xs.shape[1]
    features = vx is not None and form != "direct"
    if vx is None:
        ox, oy = xs[:, None, None, :], ys[:, None, None, :]  # [B, 1, 1, R]
    elif form == "direct":
        step = tau[:, :, None]  # [B, T, 1]
        ox = (xs[:, None, :] + vx[:, None, :] * step)[:, None]  # [B, 1, T, R]
        oy = (ys[:, None, :] + vy[:, None, :] * step)[:, None]
    else:
        c = _feature_prefix(form, xs, ys, vx, vy, tau)[:, None]  # [B, 1, T, R]
        f3, f4, f5, f6 = (-2.0 * v[:, None, None, :] for v in (xs, ys, vx, vy))
        tx, ty = tau[:, None, :] * px, tau[:, None, :] * py  # [B, S, T]
    slab = _SLAB_ELEMS // (4 if features and form == "expanded" else 1)
    rows = max(1, slab // (T * R))
    robots = max(1, rows // S)
    rows = min(rows, S)
    out = px.new_empty(px.shape)
    for b0 in range(0, B, robots):
        b = slice(b0, b0 + robots)
        for s0 in range(0, S, rows):
            s = slice(s0, s0 + rows)
            p_x, p_y = px[b, s, :, None], py[b, s, :, None]
            if features:
                d = _feature_pair(form, c[b], f3[b], f4[b], f5[b], f6[b], p_x,
                                  p_y, tx[b, s, :, None], ty[b, s, :, None])
            else:
                d = _norm_pair(form, ox[b], oy[b], p_x, p_y)
            out[b, s] = torch.amin(d, dim=-1)
    return out


def _reference(name, px, py, obs_xy, seg_x, seg_y, active_points,
               obs_vel=None, dt=None, form="direct"):
    """The plain version of every sweep kernel; returns (d2_obs, d2_seg),
    or d2_obs alone when there are no segment rows. ``form``: "direct"
    (K1, K3), "expanded" (K2, K4, K7) or "broadcast" (K6, K8)."""
    *_, T, _, _, batched = _check_sweep(
        name, px, py, obs_xy, seg_x, seg_y, active_points, obs_vel, dt
    )
    if not batched:
        px, py, obs_xy = (t.unsqueeze(0) for t in (px, py, obs_xy))
        if seg_x is not None:
            seg_x, seg_y = seg_x.unsqueeze(0), seg_y.unsqueeze(0)
        active_points = active_points.reshape(1)
        if obs_vel is not None:
            obs_vel, dt = obs_vel.unsqueeze(0), dt.reshape(1)
    t = torch.arange(T, device=px.device)
    if obs_vel is None:
        fields = [_sweep_reference(px, py, obs_xy[..., 0], obs_xy[..., 1], form)]
    else:
        tau = t.to(torch.float32)[None, :] * dt[:, None]  # [B, T]
        fields = [_sweep_reference(
            px, py, obs_xy[..., 0], obs_xy[..., 1], form,
            obs_vel[..., 0], obs_vel[..., 1], tau,
        )]
    if seg_x is not None:
        fields.append(_sweep_reference(px, py, seg_x, seg_y, form))
    if form != "direct":
        # + |p|^2, then max(., 0) keeping a NaN (the kernels' epilogue)
        pnorm = px * px + py * py
        fields = [torch.where(f + pnorm < 0.0, 0.0, f + pnorm) for f in fields]
    active = (t[None, :] < active_points[:, None])[:, None, :]  # [B, 1, T]
    fields = [torch.where(active, f, torch.inf) for f in fields]
    if not batched:
        fields = [f[0] for f in fields]
    return fields[0] if seg_x is None else tuple(fields)


def fused_min_dist_sq_reference(
    px, py, obs_xy, seg_x, seg_y, active_points, obs_vel=None, dt=None
):
    """Plain PyTorch version of K1 and K3: the same operations, rounded
    one by one. Shapes as for ``fused_min_dist_sq``; with ``obs_vel`` and
    ``dt`` it is the moving sweep of ``fused_min_dist_sq_moving``."""
    name = "fused_min_dist_sq" + ("_moving" if obs_vel is not None else "")
    return _reference(name, px, py, obs_xy, seg_x, seg_y, active_points,
                      obs_vel, dt)


def fused_min_dist_sq_expanded_reference(px, py, obs_xy, seg_x, seg_y,
                                         active_points):
    """Plain PyTorch version of K2, operation by operation: per row
    cross = ox * px + oy * py, |o|^2 - 2 * cross, the min over the rows,
    + |p|^2, max(., 0). Shapes as for ``fused_min_dist_sq``."""
    return _reference("fused_min_dist_sq_expanded", px, py, obs_xy, seg_x,
                      seg_y, active_points, form="expanded")


def fused_min_dist_sq_broadcast_reference(px, py, obs_xy, seg_x, seg_y,
                                          active_points):
    """Plain PyTorch version of K6, operation by operation: per row
    (|o|^2 + (-2 px) * ox) + (-2 py) * oy, the min over the rows, + |p|^2,
    max(., 0). Shapes as for ``fused_min_dist_sq``."""
    return _reference("fused_min_dist_sq_broadcast", px, py, obs_xy, seg_x,
                      seg_y, active_points, form="broadcast")


def fused_min_dist_sq_moving_expanded_reference(px, py, obs_xy, obs_vel, dt,
                                                seg_x, seg_y, active_points):
    """Plain PyTorch version of K7: the feature-order FMA chain of the
    7-feature dot (``_fma_rn``), every other operation rounded on its
    own, K2's segment sweep. Arguments as for
    ``fused_min_dist_sq_moving``."""
    return _reference("fused_min_dist_sq_moving_expanded", px, py, obs_xy,
                      seg_x, seg_y, active_points, obs_vel, dt, form="expanded")


def fused_min_dist_sq_moving_broadcast_reference(px, py, obs_xy, obs_vel, dt,
                                                 seg_x, seg_y, active_points):
    """Plain PyTorch version of K8: the 7-feature left fold, every
    operation rounded on its own, K6's segment sweep. Arguments as for
    ``fused_min_dist_sq_moving``."""
    return _reference("fused_min_dist_sq_moving_broadcast", px, py, obs_xy,
                      seg_x, seg_y, active_points, obs_vel, dt, form="broadcast")


def min_dist_sq_moving_reference(px, py, rows, vel, dt, active_points):
    """Plain PyTorch version of K3s: K3's moving obstacle sweep alone
    (``fused_min_dist_sq_reference``'s obstacle half), over ``rows``.
    Arguments as for ``min_dist_sq_moving``."""
    return _reference("min_dist_sq_moving", px, py, rows, None, None,
                      active_points, vel, dt)


def min_dist_sq_expanded_reference(px, py, rows, active_points):
    """Plain PyTorch version of K4: K2's obstacle sweep alone, over
    ``rows``. Shapes as for ``min_dist_sq_expanded``."""
    return _reference("min_dist_sq_expanded", px, py, rows, None, None,
                      active_points, form="expanded")


def _launch(fn, dims, px, py, obs, sx, sy, ap, vel=None, dt=None, points=()):
    """Launch ``fn`` of the library on the current stream of the inputs'
    card; returns the output fields (shaped like px; one without segment
    rows), or raises on a refused launch. ``points``: the static
    kernel's samples per thread, as a 1-tuple."""
    lib = _library()
    B, S, T, O, G, _ = dims
    outs = [torch.empty_like(px) for _ in range(1 if sx is None else 2)]
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        mid = () if vel is None else (vel.data_ptr(), dt.data_ptr())
        seg = () if sx is None else (sx.data_ptr(), sy.data_ptr(), G)
        err = getattr(lib, fn)(
            px.data_ptr(), py.data_ptr(), B, S * T, T, obs.data_ptr(), *mid,
            O, *seg, ap.data_ptr(), *(o.data_ptr() for o in outs), *points,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {err})")
    return outs[0] if sx is None else tuple(outs)


# the static kernel's launch (K1, K2, K4 and K6: csrc/fused_min_dist.cu,
# static_min_dist_kernel): threads per block, the samples of one step a
# thread may hold, and the warps per SM a launch should hold to hide the
# pair loop's latency: two per warp scheduler
STATIC_BLOCK = 128
STATIC_POINTS = (8, 2)
_TARGET_WARPS_PER_SM = 2 * 4
# the grid's x dimension: (steps x runs of samples) blocks
_MAX_GRID_X = 2**31 - 1


def _runs(S, k):
    """The blocks one step's S samples take at k samples per thread."""
    return -(-S // (STATIC_BLOCK * k))


def sweep_points(B, S, T, sms):
    """kPts, the samples per thread of the static kernel's launch (K1, K2,
    K4, K6) for B robots' [S, T] points on a card of ``sms`` SMs: 8 where
    the grid of B * T * runs blocks of 4 warps holds two warps per warp
    scheduler (64 robots, the cost evaluator's 5001 x 1000), else 2, which
    makes 4 times the blocks (one robot's 2025 x 30: 240 blocks, measured
    faster than 8 on the H100, PERF.md)."""
    warps = B * T * _runs(S, 8) * (STATIC_BLOCK // 32)
    return 8 if warps >= _TARGET_WARPS_PER_SM * sms else 2


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _forced_points(name, points):
    """Check samples per thread a caller forces (``_points``, None for the
    launch's own) on every device, before any launch or plain version."""
    if points is not None and points not in STATIC_POINTS:
        raise ValueError(f"{name}: {points} samples per thread; the kernel "
                         f"takes {STATIC_POINTS}")


def _static_points(name, dims, points, device):
    """The launch's kPts: ``points`` if given (checked), else
    ``sweep_points``' for the card of ``device``; raises where the grid
    would pass the card's limit."""
    B, S, T = dims[:3]
    _forced_points(name, points)
    if points is None:
        points = sweep_points(B, S, T, _sm_count(device))
    if _runs(S, points) * T > _MAX_GRID_X:
        raise ValueError(f"{name}: {S} x {T} points need too many blocks")
    return points


def _static_launch(name, px, py, rows, seg_x, seg_y, active_points, points):
    """Check a static sweep's inputs, choose its kPts and launch the
    static kernel's entry point ``kompass_<name>``; returns its fields."""
    dims = _check_sweep(name, px, py, rows, seg_x, seg_y, active_points)
    points = _static_points(name, dims, points, px.device)
    return _launch(f"kompass_{name}", dims, px, py, rows, seg_x, seg_y,
                   active_points, points=(points,))


def fused_min_dist_sq(px, py, obs_xy, seg_x, seg_y, active_points, *,
                      _points=None):
    """Both static min-distance sweeps of the tick in one kernel launch.

    px, py: [S, T] rollout points ([B, S, T] for B robots); obs_xy:
    [O, 2] obstacle rows ([B, O, 2]); seg_x, seg_y: [G] tracked-segment
    rows ([B, G]); pad rows sit at 1e8 and never win. active_points:
    one int32 ([B] int32) on the same device, read by the kernel there.
    Returns (d2_obs, d2_seg), each shaped like px, f32, +inf where t >=
    active_points. On CUDA it launches on the current stream without
    synchronising and adds one to ``fused_min_dist_sq.launches``; its
    samples per thread are ``sweep_points``', or ``_points`` where a test
    forces them (checked on every device)."""
    _forced_points("fused_min_dist_sq", _points)
    if px.device.type == "cpu":
        return fused_min_dist_sq_reference(
            px, py, obs_xy, seg_x, seg_y, active_points
        )
    out = _static_launch("fused_min_dist_sq", px, py, obs_xy, seg_x, seg_y,
                         active_points, _points)
    fused_min_dist_sq.launches += 1
    return out


def fused_min_dist_sq_expanded(px, py, obs_xy, seg_x, seg_y, active_points,
                               *, _points=None):
    """K2: both static sweeps in the TPU kernel's expanded form, in one
    kernel launch.

    Arguments and result as for ``fused_min_dist_sq``; each value is
    max(min over the rows of (|o|^2 - 2 o.p) + |p|^2, 0), which cancels
    as the coordinates grow (see the module's docstring): meant for
    points and rows within about 10 m of the origin. On CUDA it adds one
    to ``fused_min_dist_sq_expanded.launches``."""
    _forced_points("fused_min_dist_sq_expanded", _points)
    if px.device.type == "cpu":
        return fused_min_dist_sq_expanded_reference(
            px, py, obs_xy, seg_x, seg_y, active_points
        )
    out = _static_launch("fused_min_dist_sq_expanded", px, py, obs_xy, seg_x,
                         seg_y, active_points, _points)
    fused_min_dist_sq_expanded.launches += 1
    return out


def fused_min_dist_sq_broadcast(px, py, obs_xy, seg_x, seg_y, active_points,
                                *, _points=None):
    """K6: both static sweeps in the TPU vector-unit kernel's broadcast
    form, in one kernel launch.

    Arguments and result as for ``fused_min_dist_sq``; each value is
    max(min over the rows of ((|o|^2 + (-2 px) ox) + (-2 py) oy) + |p|^2,
    0), every operation rounded on its own, which cancels as the
    coordinates grow like K2. On CUDA it adds one to
    ``fused_min_dist_sq_broadcast.launches``."""
    _forced_points("fused_min_dist_sq_broadcast", _points)
    if px.device.type == "cpu":
        return fused_min_dist_sq_broadcast_reference(
            px, py, obs_xy, seg_x, seg_y, active_points
        )
    out = _static_launch("fused_min_dist_sq_broadcast", px, py, obs_xy, seg_x,
                         seg_y, active_points, _points)
    fused_min_dist_sq_broadcast.launches += 1
    return out


def min_dist_sq_expanded(px, py, rows, active_points, *, _points=None):
    """K4: one expanded sweep (K2's obstacle sweep alone) in one kernel
    launch.

    px, py: [S, T] ([B, S, T]); rows: [R, 2] ([B, R, 2]), pads at 1e8;
    active_points and ``_points`` as for ``fused_min_dist_sq``. Returns
    d2 shaped like px. On CUDA it adds one to
    ``min_dist_sq_expanded.launches``."""
    _forced_points("min_dist_sq_expanded", _points)
    if px.device.type == "cpu":
        return min_dist_sq_expanded_reference(px, py, rows, active_points)
    out = _static_launch("min_dist_sq_expanded", px, py, rows, None, None,
                         active_points, _points)
    min_dist_sq_expanded.launches += 1
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
    dims = _check_sweep("fused_min_dist_sq_moving", px, py, obs_xy, seg_x,
                        seg_y, active_points, obs_vel, dt)
    out = _launch("kompass_fused_min_dist_sq_moving", dims, px, py, obs_xy,
                  seg_x, seg_y, active_points, obs_vel, dt)
    fused_min_dist_sq_moving.launches += 1
    return out


def fused_min_dist_sq_moving_expanded(px, py, obs_xy, obs_vel, dt, seg_x,
                                      seg_y, active_points):
    """K7: the moving obstacle sweep as the TPU matrix-unit kernel's
    7-feature dot and K2's static segment sweep, in one kernel launch.

    Arguments as for ``fused_min_dist_sq_moving``. The obstacle field is
    max(min over the rows of f(o).g(p) + |p|^2, 0) with f(o) = [|o|^2,
    |v|^2, 2 v.o, -2ox, -2oy, -2vx, -2vy], g(p) = [1, tau^2, tau, px, py,
    tau px, tau py] and tau = t * dt, summed as a feature-order chain of
    fused multiply-adds (``csrc/fused_min_dist.cu``); the segment field is
    K2's. Pad rows sit at 1e8 with zero velocity. On CUDA it adds one to
    ``fused_min_dist_sq_moving_expanded.launches``."""
    if px.device.type == "cpu":
        return fused_min_dist_sq_moving_expanded_reference(
            px, py, obs_xy, obs_vel, dt, seg_x, seg_y, active_points
        )
    dims = _check_sweep("fused_min_dist_sq_moving_expanded", px, py, obs_xy,
                        seg_x, seg_y, active_points, obs_vel, dt)
    out = _launch("kompass_fused_min_dist_sq_moving_expanded", dims, px, py,
                  obs_xy, seg_x, seg_y, active_points, obs_vel, dt)
    fused_min_dist_sq_moving_expanded.launches += 1
    return out


def fused_min_dist_sq_moving_broadcast(px, py, obs_xy, obs_vel, dt, seg_x,
                                       seg_y, active_points):
    """K8: the moving obstacle sweep as the TPU vector-unit kernel's
    7-feature left fold and K6's static segment sweep, in one kernel
    launch.

    Arguments and features as for ``fused_min_dist_sq_moving_expanded``;
    the obstacle value is (((c + f3 px) + f4 py) + f5 tau px) + f6 tau py
    with c = (|o|^2 + |v|^2 tau^2) + 2 v.o tau, every operation rounded
    on its own. A zero velocity gives ``fused_min_dist_sq_broadcast``'s
    values bit for bit. On CUDA it adds one to
    ``fused_min_dist_sq_moving_broadcast.launches``."""
    if px.device.type == "cpu":
        return fused_min_dist_sq_moving_broadcast_reference(
            px, py, obs_xy, obs_vel, dt, seg_x, seg_y, active_points
        )
    dims = _check_sweep("fused_min_dist_sq_moving_broadcast", px, py, obs_xy,
                        seg_x, seg_y, active_points, obs_vel, dt)
    out = _launch("kompass_fused_min_dist_sq_moving_broadcast", dims, px, py,
                  obs_xy, seg_x, seg_y, active_points, obs_vel, dt)
    fused_min_dist_sq_moving_broadcast.launches += 1
    return out


def min_dist_sq_moving(px, py, rows, vel, dt, active_points):
    """K3s: K3's moving obstacle sweep alone, in one kernel launch (the
    split mover sweep).

    px, py: [S, T] ([B, S, T]); rows: [M, 2] ([B, M, 2]) world positions,
    pads at 1e8 with zero velocity; vel: [M, 2] ([B, M, 2]) world
    velocities; dt and active_points as for ``fused_min_dist_sq_moving``.
    Returns d2 shaped like px: the min over the rows of |p - (o + v * (t *
    dt))|^2, +inf where t >= active_points. On CUDA it adds one to
    ``min_dist_sq_moving.launches``."""
    if px.device.type == "cpu":
        return min_dist_sq_moving_reference(px, py, rows, vel, dt, active_points)
    dims = _check_sweep("min_dist_sq_moving", px, py, rows, None, None,
                        active_points, vel, dt)
    out = _launch("kompass_min_dist_sq_moving", dims, px, py, rows, None, None,
                  active_points, vel, dt)
    min_dist_sq_moving.launches += 1
    return out


# --- BOX robots' collision field (K9) ---------------------------------------------


def _check_box(px, py, cos_yaw, sin_yaw, rows, vel, dt, half, active_points):
    """Check K9's inputs; returns (B, S, T, O): px, py, cos_yaw, sin_yaw
    [B, S, T]; rows (and vel) [B, O, 2]; dt [B] (with vel); half [B, 2];
    active_points [B] int32; all on one device and contiguous."""
    name = "box_min_dist_sq"
    tensors = [px, py, cos_yaw, sin_yaw, rows, half, active_points]
    if vel is not None:
        tensors += [vel, dt]
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
    if px.dim() != 3 or px.numel() == 0 or any(
            t.shape != px.shape for t in (py, cos_yaw, sin_yaw)):
        raise ValueError(f"{name}: px, py, cos_yaw, sin_yaw must be one "
                         "non-empty [B, S, T] shape")
    B, S, T = px.shape
    if S * T >= 2**31 or B > _MAX_BATCH:
        raise ValueError(f"{name}: S * T must fit in int32 and B <= {_MAX_BATCH}")
    if rows.dim() != 3 or rows.shape[0] != B or rows.shape[2] != 2 or rows.shape[1] == 0:
        raise ValueError(f"{name}: rows must be non-empty [B, O, 2]")
    if half.shape != (B, 2) or active_points.shape != (B,):
        raise ValueError(f"{name}: half must be [B, 2] and active_points [B]")
    if vel is not None and (vel.shape != rows.shape or dt.shape != (B,)):
        raise ValueError(f"{name}: vel must match rows and dt be [B]")
    return B, S, T, rows.shape[1]


def box_min_dist_sq_reference(px, py, cos_yaw, sin_yaw, rows, vel, dt, half,
                              active_points):
    """Plain PyTorch version of K9, the JAX package's XLA form operation
    by operation, each rounded on its own: rows moved to o + v * (t * dt)
    when ``vel`` is given, dx = o - p, bx = c dx + s dy, by = (-s) dx + c
    dy, ex = max(|bx| - hl, 0), ey = max(|by| - hw, 0), ex^2 + ey^2, the
    min over the rows (NaN kept, as ``torch.amin`` keeps it), +inf where t
    >= active_points. Arguments as for ``box_min_dist_sq``; evaluated in
    slabs of samples so the [B, S, T, O] broadcast stays bounded."""
    B, S, T, O = _check_box(px, py, cos_yaw, sin_yaw, rows, vel, dt, half,
                            active_points)
    t = torch.arange(T, dtype=torch.float32, device=px.device)
    c = cos_yaw.unsqueeze(-1)
    s = sin_yaw.unsqueeze(-1)
    ox = rows[:, None, None, :, 0]  # [B, 1, 1, O]
    oy = rows[:, None, None, :, 1]
    if vel is not None:
        tau = (t * dt[:, None])[:, None, :, None]  # [B, 1, T, 1]
        ox = ox + vel[:, None, None, :, 0] * tau
        oy = oy + vel[:, None, None, :, 1] * tau
    hl = half[:, 0].reshape(B, 1, 1, 1)
    hw = half[:, 1].reshape(B, 1, 1, 1)
    step = max(1, _SLAB_ELEMS // (B * T * O))
    out = px.new_empty(px.shape)
    for s0 in range(0, S, step):
        sl = slice(s0, s0 + step)
        dxw = ox - px[:, sl, :, None]
        dyw = oy - py[:, sl, :, None]
        cs, ss = c[:, sl], s[:, sl]
        bx = cs * dxw + ss * dyw  # body-frame obstacle coordinates
        by = -ss * dxw + cs * dyw
        ex = torch.clamp(torch.abs(bx) - hl, min=0.0)
        ey = torch.clamp(torch.abs(by) - hw, min=0.0)
        out[:, sl] = torch.amin(ex * ex + ey * ey, dim=-1)
    active = (t[None, :] < active_points[:, None])[:, None, :]  # [B, 1, T]
    return torch.where(active, out, torch.inf)


def box_min_dist_sq(px, py, cos_yaw, sin_yaw, rows, vel, dt, half,
                    active_points, *, _points=None):
    """K9: the oriented-box collision field of B robots in one kernel
    launch (``csrc/box_min_dist.cu``).

    px, py: [B, S, T] rollout points; cos_yaw, sin_yaw: [B, S, T], the
    body's heading at each point (the caller's cos and sin, so the card
    evaluates no trigonometry); rows: [B, O, 2] obstacle rows, pads at
    1e8; vel: [B, O, 2] world velocities or None (static rows), with dt
    [B] the control step; half: [B, 2] the box's half extents (hl, hw),
    (0, 0) for a circle robot whose radius is in its margin;
    active_points: [B] int32. Returns d2 [B, S, T]: 0 inside the
    footprint, +inf where t >= active_points. On CUDA it launches on the
    current stream without synchronising and adds one to
    ``box_min_dist_sq.launches``; its samples per thread are
    ``sweep_points``', or ``_points`` where a test forces them."""
    _forced_points("box_min_dist_sq", _points)
    if px.device.type == "cpu":
        return box_min_dist_sq_reference(px, py, cos_yaw, sin_yaw, rows, vel,
                                         dt, half, active_points)
    B, S, T, O = _check_box(px, py, cos_yaw, sin_yaw, rows, vel, dt, half,
                            active_points)
    points = _static_points("box_min_dist_sq", (B, S, T), _points, px.device)
    lib = _library()
    out = torch.empty_like(px)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.kompass_box_min_dist_sq(
            px.data_ptr(), py.data_ptr(), cos_yaw.data_ptr(),
            sin_yaw.data_ptr(), B, S * T, T, rows.data_ptr(),
            None if vel is None else vel.data_ptr(),
            None if vel is None else dt.data_ptr(), O, half.data_ptr(),
            active_points.data_ptr(), out.data_ptr(), points, stream,
        )
    if err != 0:
        raise RuntimeError(f"box_min_dist_sq: kernel launch failed (cudaError {err})")
    box_min_dist_sq.launches += 1
    return out


# the sweep kernels by their PERF.md names
SWEEP_KERNELS = {
    "K1": fused_min_dist_sq,
    "K2": fused_min_dist_sq_expanded,
    "K3": fused_min_dist_sq_moving,
    "K3s": min_dist_sq_moving,
    "K4": min_dist_sq_expanded,
    "K6": fused_min_dist_sq_broadcast,
    "K7": fused_min_dist_sq_moving_expanded,
    "K8": fused_min_dist_sq_moving_broadcast,
    "K9": box_min_dist_sq,
}
for _wrapper in SWEEP_KERNELS.values():
    _wrapper.launches = 0


def launch_counts() -> dict:
    """Every kernel wrapper's launch count by its PERF.md name (K1-K9,
    K3s)."""
    counts = {k: w.launches for k, w in SWEEP_KERNELS.items()}
    counts["K5"] = scan_to_grid_cells.launches
    return dict(sorted(counts.items()))


# --- the mapper's per-cell pass (K5) ------------------------------------------

OCCUPIED, EMPTY, UNEXPLORED = 100, 0, -1
CANDIDATES = 5  # beams per cell: its nearest bin and 2 on each side
# p_prior, p_empty, p_occupied, range_sure, range_max, wall_size, and
# (1 - p_prior) / p_prior, the odds update's constant
N_MODEL_PARAMS = 7


def _sqrt(x):
    """Correctly rounded float32 sqrt on every device, through float64
    (PyTorch's CPU float32 sqrt is not correctly rounded)."""
    return torch.sqrt(x.double()).float()


def _fma(a, b, c):
    """a * b + c computed in float64 and rounded to float32: the FMA that
    XLA's CPU backend fuses there, unless the float64 sum is inexact and
    falls on a float32 midpoint. The kernel computes the same in double."""
    return (a.double() * b.double() + c.double()).float()


def _quotient_bound(h, d):
    """The largest float32 F such that, for every float32 n, the float32
    quotient RN(n / d) is <= h exactly when n <= F (float32 tensors, d > 0,
    h a positive normal float).

    Round to nearest gives h for an exact quotient x below the midpoint m
    of h and its successor, and the successor above m. With x = n / d and
    d > 0, x < m is n < a = m * d, which float64 holds exactly (m has 25
    significant bits, d at most 24). The lowest set bit of a is that of m
    (the half-ulp bit) times that of d, so a has at least 25 significant
    bits and is never a float32 itself: no n sits on the midpoint, and
    the floats that pass are those up to the largest float32 below a. So
    the division's decision becomes one compare, with the same outcome
    for every n."""
    inf = torch.full_like(h, math.inf)
    a = (h.double() + torch.nextafter(h, inf).double()) * 0.5 * d.double()
    f = a.float()
    return torch.where(f.double() > a, torch.nextafter(f, -inf), f)


def line_test_bounds(vx, vy):
    """The diamond line test's bounds per beam, [..., 3] float32: (t_lo,
    t_hi, p_hi) for the line from the sensor cell to the endpoint offset
    (vx, vy) (float32, integer-valued).

    The JAX package's test of a cell at offset (di, dj) from the sensor
    cell (``_line_membership``) is t >= -0.5, t <= L, perp <= halfwidth
    and L > 0, with L = sqrt(vx^2 + vy^2), L_safe = max(L, 1e-6),
    t = (di vx + dj vy) / L_safe, perp = |di vy - dj vx| / L_safe and
    halfwidth = (|vx| + |vy|) / (2 L_safe) + 1e-4, each rounded to
    float32. Here L, L_safe and halfwidth are computed once per beam with
    the same roundings, and each division's decision becomes a compare
    of its numerator (``_quotient_bound``): the test is t_lo <= n_t <= t_hi
    and |n_p| <= p_hi, with n_t = di vx + dj vy and n_p = di vy - dj vx.
    A zero-length line gets t_hi = -inf and covers no cell. The kernel's
    beam pass computes the same operations in the same order."""
    L = _sqrt(_fma(vx, vx, vy * vy))
    L_safe = torch.clamp(L, min=1e-6)
    halfwidth = (torch.abs(vx) + torch.abs(vy)) / (2.0 * L_safe) + 1e-4
    t_lo = -_quotient_bound(torch.full_like(L, 0.5), L_safe)
    t_hi = torch.where(L > 0, _quotient_bound(L, L_safe), -math.inf)
    p_hi = _quotient_bound(halfwidth, L_safe)
    return torch.stack([t_lo, t_hi, p_hi], dim=-1)


def _check_cells(base, dist_m, tables, endpoint, prev, params):
    """Check the per-cell pass's inputs; returns (R, H, W, B).

    base [H, W] int32 (each cell's nearest bin, in [0, B)); dist_m [H, W]
    f32; tables [R, B, 4] int32; endpoint [R, H, W] bool; the Bayesian
    form adds prev [R, H, W] f32 and params [7] f32."""
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
    if H * W >= 2**31 or R * B >= 2**31 or R > _MAX_BATCH or H > 8 * _MAX_BATCH:
        raise ValueError(f"{name}: H * W and R * B must fit in int32, H <= "
                         f"{8 * _MAX_BATCH} and R <= {_MAX_BATCH}")
    if dist_m.shape != (H, W) or endpoint.shape != (R, H, W):
        raise ValueError(f"{name}: dist_m must be [H, W] and endpoint [R, H, W]")
    if prev is not None and (prev.shape != (R, H, W)
                             or params.shape != (N_MODEL_PARAMS,)):
        raise ValueError(f"{name}: prev must be [R, H, W] and params "
                         f"[{N_MODEL_PARAMS}]")
    return R, H, W, B


def scan_to_grid_candidates(base, tables):
    """[R, H, W, 5, words]: a cell's candidate k is the table row of bin
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
    # the beam pass: each beam's line-test bounds, beside its table row
    bounds = line_test_bounds((tables[..., 0] - si).to(torch.float32),
                              (tables[..., 1] - sj).to(torch.float32))
    wide = torch.cat([tables, bounds.view(torch.int32)], dim=-1)
    cand = scan_to_grid_candidates(base, wide)  # [R, H, W, C, 7]
    vx = (cand[..., 0] - si).to(torch.float32)
    vy = (cand[..., 1] - sj).to(torch.float32)
    di = (torch.arange(H, device=device) - si).to(torch.float32)[:, None, None]
    dj = (torch.arange(W, device=device) - sj).to(torch.float32)[None, :, None]
    # diamond (super-cover) test against the line from the sensor cell to
    # each candidate's endpoint cell, by the beam's bounds
    n_t = di * vx + dj * vy
    n_p = torch.abs(di * vy - dj * vx)
    bounds = cand[..., 4:7].view(torch.float32)
    on_line = ((n_t >= bounds[..., 0]) & (n_t <= bounds[..., 1])
               & (n_p <= bounds[..., 2]) & (cand[..., 3] != 0))
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
    (p_prior, p_empty, p_occupied, range_sure, range_max, wall_size,
     odds_k) = params.unbind()
    one = torch.ones((), dtype=torch.float32, device=device)
    # inverse sensor model and Bayes odds update (updateGridCellProbability)
    p_f = torch.where(dist_m < r_sel - wall_size, p_empty, p_occupied)
    delta = torch.where(dist_m < range_sure, 0.0 * one, one)
    p_sensor = _fma(delta * ((dist_m - range_sure) / range_max),
                    p_prior - p_f, p_f)
    odds = (prev / (one - prev)) * (p_sensor / (one - p_sensor))
    new = one - one / _fma(odds, odds_k, one)
    return occ, torch.where(covered, new, p_prior)


def scan_to_grid_cells(base, dist_m, tables, endpoint, start_cell,
                       prev=None, params=None):
    """The mapper's per-cell pass over R robots' grids in one call: a
    beam pass (each beam's ``line_test_bounds``), then the cell pass.

    base: [H, W] int32, each cell's angularly nearest bin; dist_m: [H, W]
    f32, each cell's distance to the sensor cell in metres; tables:
    [R, B, 4] int32 per beam: endpoint cell i, j, range (f32 bits) and
    validity; endpoint: [R, H, W] bool, the cells a valid beam ends in; start_cell:
    the sensor cell (i, j). For the Bayesian form also prev: [R, H, W]
    f32, the previous probability grid, and params: [7] f32 (p_prior,
    p_empty, p_occupied, range_sure, range_max, wall_size,
    (1 - p_prior) / p_prior) on the device.

    Returns occ [R, H, W] int32, and in the Bayesian form (occ, prob
    [R, H, W] f32). On CUDA it launches on the current stream without
    synchronising and adds one to ``scan_to_grid_cells.launches``."""
    if base.device.type == "cpu":
        return scan_to_grid_cells_reference(base, dist_m, tables, endpoint,
                                            start_cell, prev, params)
    occ, prob, _ = _scan_to_grid_cells_cuda(base, dist_m, tables, endpoint,
                                            start_cell, prev, params)
    scan_to_grid_cells.launches += 1
    return occ if prob is None else (occ, prob)


def _scan_to_grid_cells_cuda(base, dist_m, tables, endpoint, start_cell,
                             prev, params):
    """Both passes on the card: (occ, prob or None, the beam pass's
    bounds [R, B, 4] int32: t_lo, t_hi, p_hi as f32 bits, and 0)."""
    R, H, W, B = _check_cells(base, dist_m, tables, endpoint, prev, params)
    lib = _library()
    occ = torch.empty((R, H, W), dtype=torch.int32, device=base.device)
    prob = None if prev is None else torch.empty_like(prev)
    bounds = torch.empty_like(tables)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        err = lib.kompass_scan_to_grid_cells(
            base.data_ptr(), dist_m.data_ptr(), H * W, W, tables.data_ptr(),
            B, endpoint.data_ptr(), start_cell[0], start_cell[1],
            None if prev is None else prev.data_ptr(),
            None if params is None else params.data_ptr(), R,
            bounds.data_ptr(), occ.data_ptr(),
            None if prob is None else prob.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"scan_to_grid_cells: kernel launch failed (cudaError {err})")
    return occ, prob, bounds


scan_to_grid_cells.launches = 0
