"""Hand-written CUDA kernels of the DWA tick, their plain PyTorch versions
and their loader.

``fused_min_dist_sq`` is the port of the TPU kernel
``kompass_core_tpu/ops/pallas_kernels.py::_fused_kernel_vpu`` (reached
there through ``fused_min_dist_sq`` with ``backend="pallas_vpu"``): both
O(samples x steps x rows) sweeps of the tick, the obstacle min-distance
field and the tracked-segment min-distance field, in one pass over the
rollout points. The kernel source is ``csrc/fused_min_dist.cu``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library goes into ``build/kompass_core_tpu_torch/<hash of the sources>/``
at the repository root. A missing ``nvcc`` or a failed build raises with
the compiler's output; nothing falls back to the plain version.

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

# plain version: largest [rows, T, R] broadcast slab, in elements
_SLAB_ELEMS = 1 << 24

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
            fn = lib.kompass_fused_min_dist_sq
            fn.restype = ctypes.c_int
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, i, i, p, i, p, p, i, p, p, p, p]
            _lib = lib
    return _lib


def _check_sweep_inputs(px, py, obs_xy, seg_x, seg_y, active_points):
    tensors = (px, py, obs_xy, seg_x, seg_y, active_points)
    device = px.device
    if any(t.device != device for t in tensors):
        raise ValueError("fused_min_dist_sq: all tensors must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_min_dist_sq: unsupported device {device}")
    if any(t.dtype != torch.float32 for t in tensors[:5]):
        raise TypeError("fused_min_dist_sq: px, py, obs_xy, seg_x, seg_y must be float32")
    if active_points.dtype != torch.int32 or active_points.numel() != 1:
        raise TypeError("fused_min_dist_sq: active_points must be one int32")
    if px.dim() != 2 or py.shape != px.shape or px.numel() == 0:
        raise ValueError("fused_min_dist_sq: px, py must be non-empty [S, T]")
    if px.numel() >= 2**31:
        raise ValueError("fused_min_dist_sq: S * T must fit in int32")
    if obs_xy.dim() != 2 or obs_xy.shape[1] != 2 or obs_xy.shape[0] == 0:
        raise ValueError("fused_min_dist_sq: obs_xy must be non-empty [O, 2]")
    if seg_x.dim() != 1 or seg_y.shape != seg_x.shape or seg_x.numel() == 0:
        raise ValueError("fused_min_dist_sq: seg_x, seg_y must be non-empty [G]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_min_dist_sq: all tensors must be contiguous")


def fused_min_dist_sq_reference(px, py, obs_xy, seg_x, seg_y, active_points):
    """Plain PyTorch version of the fused kernel: the same operations,
    rounded one by one, as a broadcast [S, T, R] min (in slabs of rows of
    S so the broadcast stays bounded)."""
    S, T = px.shape

    def sweep(xs, ys):
        rows = max(1, _SLAB_ELEMS // (T * xs.shape[0]))
        parts = []
        for s0 in range(0, S, rows):
            dx = px[s0 : s0 + rows, :, None] - xs
            dy = py[s0 : s0 + rows, :, None] - ys
            parts.append(torch.amin(dx * dx + dy * dy, dim=-1))
        return torch.cat(parts)

    active = torch.arange(T, device=px.device) < active_points.reshape(())
    return (
        torch.where(active, sweep(obs_xy[:, 0], obs_xy[:, 1]), torch.inf),
        torch.where(active, sweep(seg_x, seg_y), torch.inf),
    )


def fused_min_dist_sq(px, py, obs_xy, seg_x, seg_y, active_points):
    """Both min-distance sweeps of the tick in one kernel launch.

    px, py: [S, T] rollout points; obs_xy: [O, 2] obstacle rows; seg_x,
    seg_y: [G] tracked-segment rows (pad rows sit at 1e8 and never win);
    active_points: 0-d int32 on the same device, read by the kernel there.
    Returns (d2_obs, d2_seg), each [S, T] f32, +inf where t >=
    active_points. On CUDA it launches on the current stream without
    synchronising and adds one to ``fused_min_dist_sq.launches``."""
    _check_sweep_inputs(px, py, obs_xy, seg_x, seg_y, active_points)
    if px.device.type == "cpu":
        return fused_min_dist_sq_reference(
            px, py, obs_xy, seg_x, seg_y, active_points
        )
    lib = _library()
    S, T = px.shape
    out_obs = torch.empty_like(px)
    out_seg = torch.empty_like(px)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.kompass_fused_min_dist_sq(
            px.data_ptr(), py.data_ptr(), S * T, T,
            obs_xy.data_ptr(), obs_xy.shape[0],
            seg_x.data_ptr(), seg_y.data_ptr(), seg_x.shape[0],
            active_points.data_ptr(), out_obs.data_ptr(), out_seg.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_min_dist_sq: kernel launch failed (cudaError {err})")
    fused_min_dist_sq.launches += 1
    return out_obs, out_seg


fused_min_dist_sq.launches = 0
