// K9: the oriented-box collision field of BOX robots, with a robot axis.
//
// For every robot b and every point p of its [S, T] rollout, heading
// (c, s) = (cos yaw, sin yaw) at that point, one pass computes
//   d2[b, p] = min over obstacle rows o of ex^2 + ey^2,
//   (bx, by) = the row in the body frame: bx = c*dx + s*dy,
//              by = (-s)*dx + c*dy, with (dx, dy) = o(t) - p,
//   ex = max(|bx| - hl, 0), ey = max(|by| - hw, 0),
// the squared distance from the box of half extents (hl, hw) = half[b] to
// the row (0 inside the footprint), and +inf where the step index t >=
// active_points[b]. Statically o(t) = o; with velocities o(t) = o + v * tau,
// tau = f32(t) * dt[b]. It is the function of the JAX package's XLA sweep
// kompass_core_tpu/ops/solver.py:402 _min_box_dist_sq (BOX robots: a
// single robot's static collision_box and the dynamic_box fleet, whose
// circle robots are (0, 0) boxes). The headings come from the caller
// (torch's cos and sin of the plain version's yaw), so the kernel
// evaluates no trigonometry.
//
// What bounds it on Hopper: FP32 issue, as the point sweeps (K1, K3). A
// pair is 16 FP32 instructions here (2 FADD for dx, dy; 4 FMUL and 2 FADD
// for the rotation; 2 FADD and 2 FMNMX for the clamps; 2 FMUL and an FADD
// for the square; the min), against the point sweep's 6; rows and points
// of a 64-robot tick are a few MB, all in L2. The layout is the static
// point sweep's (fused_min_dist.cu, static_min_dist_kernel): a block is one
// robot, one step and a run of samples; each thread holds kPts samples
// of that step (x, y, c, -s, s) in registers, so one shared-memory
// broadcast of a row feeds kPts pairs; a moving row is advanced by tau once
// per block as its tile is staged; a step at or past active_points[b]
// writes +inf and sweeps nothing.
//
// Rounding: every operation is rounded on its own (__f*_rn), as the plain
// PyTorch version and XLA without FMA compute it, so the kernel equals the
// plain version bit for bit (a min is exact in any order; each value is a
// sum of squares, >= +0, so the sign of a zero never shows).
//
// NaN: torch.amin keeps a NaN and fminf drops it. The min is fminf unless
// the block's flag is set (reduced with __syncthreads_or, so the choice is
// block-uniform): a point coordinate, a heading, a half extent or a staged
// row above 1e18 in magnitude (NaN and inf included). Below that no
// difference, product or sum of the pair overflows (|c|, |s| <= 1 for a
// finite yaw), so no value is NaN, and the clamps may take fmaxf too.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 128;    // threads per block
constexpr int kTile = 1024;    // rows per staged tile (8 KB)
constexpr float kTame = 1e18f;

__device__ __forceinline__ bool tame(float v) { return fabsf(v) <= kTame; }

// max(v, 0) keeping a NaN (the plain version's clamp), or fmaxf where no
// value can be NaN.
template <bool kKeepNan>
__device__ __forceinline__ float clamp0(float v) {
  return kKeepNan ? (v < 0.0f ? 0.0f : v) : fmaxf(v, 0.0f);
}

// One (point, row) value: the squared surface distance of row (ox, oy)
// from the box at (x, y) heading (c, s), ns = -s.
template <bool kKeepNan>
__device__ __forceinline__ float box_pair(float ox, float oy, float x, float y,
                                          float c, float s, float ns, float hl,
                                          float hw) {
  const float dx = __fsub_rn(ox, x);
  const float dy = __fsub_rn(oy, y);
  const float bx = __fadd_rn(__fmul_rn(c, dx), __fmul_rn(s, dy));
  const float by = __fadd_rn(__fmul_rn(ns, dx), __fmul_rn(c, dy));
  const float ex = clamp0<kKeepNan>(__fsub_rn(fabsf(bx), hl));
  const float ey = clamp0<kKeepNan>(__fsub_rn(fabsf(by), hw));
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
}

__device__ __forceinline__ float min_nan(float acc, float d) {
  return (d < acc || d != d) ? d : acc;
}

template <int kPts, bool kKeepNan>
__device__ __forceinline__ void box_tile(const float (&x)[kPts],
                                         const float (&y)[kPts],
                                         const float (&c)[kPts],
                                         const float (&s)[kPts],
                                         float (&acc)[kPts], float hl, float hw,
                                         const float2* tile, int rows) {
#pragma unroll 2
  for (int j = 0; j < rows; ++j) {
    const float2 o = tile[j];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const float d =
          box_pair<kKeepNan>(o.x, o.y, x[k], y[k], c[k], s[k], -s[k], hl, hw);
      acc[k] = kKeepNan ? min_nan(acc[k], d) : fminf(acc[k], d);
    }
  }
}

// One block: step t of robot b = blockIdx.y for samples run * kBlock * kPts
// + threadIdx.x + k * kBlock, with blockIdx.x = t * runs + run. kMove: the
// rows move at vel (and dt is read).
template <int kPts, bool kMove>
__global__ void __launch_bounds__(kBlock) box_min_dist_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ cos_yaw, const float* __restrict__ sin_yaw,
    int samples, int steps, int runs, const float* __restrict__ rows,
    const float* __restrict__ vel, const float* __restrict__ dt, int n_rows,
    const float* __restrict__ half, const int* __restrict__ active_points,
    float* __restrict__ out) {
  __shared__ float2 tile[kTile];
  const int run = blockIdx.x % runs;
  const int t = blockIdx.x / runs;
  const int b = blockIdx.y;
  const int s0 = run * kBlock * kPts + threadIdx.x;
  const long long point0 = static_cast<long long>(b) * samples * steps + t;
  if (t >= active_points[b]) {  // the whole block's step: no barrier skipped
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int s = s0 + k * kBlock;
      if (s < samples) {
        out[point0 + static_cast<long long>(s) * steps] = CUDART_INF_F;
      }
    }
    return;
  }
  const float hl = half[2 * b];
  const float hw = half[2 * b + 1];
  float x[kPts], y[kPts], c[kPts], sn[kPts], acc[kPts];
  bool flag = !(tame(hl) && tame(hw));
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int s = s0 + k * kBlock;
    const long long p = point0 + static_cast<long long>(s) * steps;
    const bool in = s < samples;
    x[k] = in ? px[p] : 0.0f;
    y[k] = in ? py[p] : 0.0f;
    c[k] = in ? cos_yaw[p] : 1.0f;
    sn[k] = in ? sin_yaw[p] : 0.0f;
    flag |= !(tame(x[k]) && tame(y[k]) && tame(c[k]) && tame(sn[k]));
    acc[k] = CUDART_INF_F;
  }
  bool keep_nan = __syncthreads_or(flag);
  const float tau = kMove ? __fmul_rn(static_cast<float>(t), dt[b]) : 0.0f;
  const long long row0 = static_cast<long long>(b) * n_rows;
  for (int base = 0; base < n_rows; base += kTile) {
    const int n = min(kTile, n_rows - base);
    __syncthreads();  // the previous tile is no longer read
    bool wild = false;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const long long r = 2 * (row0 + base + i);
      float ox = rows[r];
      float oy = rows[r + 1];
      if constexpr (kMove) {
        ox = __fadd_rn(ox, __fmul_rn(vel[r], tau));
        oy = __fadd_rn(oy, __fmul_rn(vel[r + 1], tau));
      }
      wild |= !(tame(ox) && tame(oy));
      tile[i] = make_float2(ox, oy);
    }
    // a barrier that also makes the tile's flag block-uniform; once set it
    // stays (fminf would drop a NaN already in the running min)
    keep_nan = __syncthreads_or(wild) || keep_nan;
    if (keep_nan) {
      box_tile<kPts, true>(x, y, c, sn, acc, hl, hw, tile, n);
    } else {
      box_tile<kPts, false>(x, y, c, sn, acc, hl, hw, tile, n);
    }
  }
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int s = s0 + k * kBlock;
    if (s < samples) {
      out[point0 + static_cast<long long>(s) * steps] = acc[k];
    }
  }
}

template <int kPts, bool kMove>
int launch_points(const float* px, const float* py, const float* cos_yaw,
                  const float* sin_yaw, int batch, int samples, int steps,
                  const float* rows, const float* vel, const float* dt,
                  int n_rows, const float* half, const int* active_points,
                  float* out, void* stream) {
  const int per_block = kBlock * kPts;
  const int runs = (samples + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(runs) * steps, batch);
  box_min_dist_kernel<kPts, kMove>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          px, py, cos_yaw, sin_yaw, samples, steps, runs, rows, vel, dt,
          n_rows, half, active_points, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMove>
int launch(const float* px, const float* py, const float* cos_yaw,
           const float* sin_yaw, int batch, int samples, int steps,
           const float* rows, const float* vel, const float* dt, int n_rows,
           const float* half, const int* active_points, float* out,
           int points, void* stream) {
  switch (points) {
    case 2:
      return launch_points<2, kMove>(px, py, cos_yaw, sin_yaw, batch, samples,
                                     steps, rows, vel, dt, n_rows, half,
                                     active_points, out, stream);
    case 8:
      return launch_points<8, kMove>(px, py, cos_yaw, sin_yaw, batch, samples,
                                     steps, rows, vel, dt, n_rows, half,
                                     active_points, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes (all f32 contiguous unless noted, B = batch robots):
//   px, py, cos_yaw, sin_yaw: [B, S, T] (n_points = S * T, steps = T);
//   rows: [B, n_rows, 2]; vel: [B, n_rows, 2] or null (static rows), with
//   dt: [B] (read only with vel); half: [B, 2] (hl, hw);
//   active_points: [B] int32 on the device; out: [B, S, T];
//   points: samples per thread, 2 or 8 (ops/kernels.py::sweep_points).
// Launches on `stream` and does not synchronise. Returns
// cudaErrorInvalidValue for another `points`, else cudaGetLastError()
// after the launch.
extern "C" int kompass_box_min_dist_sq(
    const float* px, const float* py, const float* cos_yaw,
    const float* sin_yaw, int batch, int n_points, int steps,
    const float* rows, const float* vel, const float* dt, int n_rows,
    const float* half, const int* active_points, float* out, int points,
    void* stream) {
  const int samples = n_points / steps;
  if (vel == nullptr) {
    return launch<false>(px, py, cos_yaw, sin_yaw, batch, samples, steps, rows,
                         nullptr, nullptr, n_rows, half, active_points, out,
                         points, stream);
  }
  return launch<true>(px, py, cos_yaw, sin_yaw, batch, samples, steps, rows,
                      vel, dt, n_rows, half, active_points, out, points,
                      stream);
}
