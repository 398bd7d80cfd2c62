// Fused obstacle + tracked-segment min-distance sweeps for the DWA tick,
// with a robot axis.
//
// Replaces four TPU kernels of kompass_core_tpu/ops/pallas_kernels.py:
//   K1 ::_fused_kernel_vpu (static obstacles, through fused_min_dist_sq)
//   K2 ::_fused_kernel_mxu (the same sweeps in the expanded form, solver
//      backend "pallas")
//   K3 ::_fused_kernel_vpu_moving and ::_fused_kernel_mxu_moving
//      (constant-velocity obstacles, through fused_min_dist_sq_moving_pallas)
//   K4 ::_min_dist_kernel (one expanded sweep, through
//      min_point_dist_sq_pallas; solver backend "pallas_v1")
// For every robot b and every point p of its [S, T] rollout, one pass
// computes
//   d2_obs[b, p] = min over obstacle rows o of |p - o(t)|^2
//   d2_seg[b, p] = min over tracked-segment rows g of |p - g|^2
// and writes +inf where the step index t >= active_points[b]. Statically
// o(t) = o; in the moving sweep o(t) = o + v * tau with tau = f32(t) * dt[b],
// the operation order of the JAX package's XLA form
// (ops/solver.py::_min_obstacle_dist_sq_moving). The segment rows never
// move. K4 is the expanded form with the segment sweep compiled out.
//
// What bounds it on Hopper: FP32 ALU throughput. A 64-robot fleet tick
// (64 x 60,750 points x 768 obstacle rows, ~3.0 G moving pairs at ~12
// FP32 instructions each, plus ~1.5 G static segment pairs) reads a few
// MB, all of which fits in L2; memory is not the limit.
//
// Design (simple and right first):
//   * one thread per point, 256-thread blocks over one robot's S*T
//     points; the grid's second dimension is the robot;
//   * obstacle rows, then segment rows, are staged through shared memory
//     in tiles of 512 rows: (x, y) pairs in the direct form, (x, y, |o|^2)
//     in the expanded form, (x, y, vx, vy) in the moving sweep, all as
//     float4s but the direct form's; every thread reads the same row at
//     the same time, so the shared-memory read is a broadcast;
//   * the running min lives in a register;
//   * the ragged last tile and the ragged last block are masked: threads
//     past the last point still help stage tiles and reach every barrier.
//
// The forms:
//   * direct (K1, K3): (px-ox)^2 + (py-oy)^2. The port's choice for its
//     own sweeps: the expansion below cancels at ~10 m coordinates
//     (|o|^2 * 2^-24 ~ 6e-6 m^2 of error against centimetre collision
//     margins). The TPU needed the expansion to feed its matrix unit.
//   * expanded (K2, K4): the TPU kernels' function, ported as it is:
//     cross = ox*px + oy*py, d = |o|^2 - 2*cross, running min over the
//     rows, then + |p|^2 and a clamp at 0. Its absolute error is a few
//     ulps of |p|^2 + |o|^2, so it is meant for the JAX package's own
//     coordinates, within about 10 m of the origin (bench.py's
//     scenarios); it grows with the square of the distance from it. A
//     pad row at 1e8 stays finite (|o|^2 = 2e16) and never wins.
// The intrinsics below round each operation on its own, so nvcc cannot
// contract an expression into FMAs. Every form is then bit-identical to
// its plain PyTorch version, which evaluates the same operations one by
// one: a min is exact in any order. The min propagates NaN like
// torch.amin, and the expanded form's clamp keeps a NaN. A zero velocity
// adds +0 to the row, so the moving sweep gives the static sweep's values
// bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 256;  // threads (= points) per block
constexpr int kTile = 512;   // rows staged in shared memory per tile

enum Form : int { kDirect = 0, kMoving = 1, kExpanded = 2 };

__device__ __forceinline__ float dist_sq(float px, float py, float ox,
                                         float oy) {
  const float dx = __fsub_rn(px, ox);
  const float dy = __fsub_rn(py, oy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float norm_sq(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

__device__ __forceinline__ float min_nan(float acc, float d) {
  return (d < acc || d != d) ? d : acc;
}

// Running min of |p - row|^2 over `n` rows, row i at (xs[i*stride],
// ys[i*stride]). Every thread of the block must call it: it stages tiles
// and synchronises.
__device__ float sweep(float px, float py, const float* __restrict__ xs,
                       const float* __restrict__ ys, int stride, int n,
                       float2* tile) {
  float acc = CUDART_INF_F;
  for (int base = 0; base < n; base += kTile) {
    const int rows = min(kTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const long long r = static_cast<long long>(base + i) * stride;
      tile[i] = make_float2(xs[r], ys[r]);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      acc = min_nan(acc, dist_sq(px, py, tile[j].x, tile[j].y));
    }
  }
  return acc;
}

// Running min of |o|^2 - 2 (o . p) over `n` rows, laid out as in `sweep`;
// each row is staged with its |o|^2. Same staging and barriers.
__device__ float sweep_expanded(float px, float py,
                                const float* __restrict__ xs,
                                const float* __restrict__ ys, int stride,
                                int n, float4* tile) {
  float acc = CUDART_INF_F;
  for (int base = 0; base < n; base += kTile) {
    const int rows = min(kTile, n - base);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const long long r = static_cast<long long>(base + i) * stride;
      const float x = xs[r];
      const float y = ys[r];
      tile[i] = make_float4(x, y, norm_sq(x, y), 0.0f);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      const float4 o = tile[j];
      const float cross = __fadd_rn(__fmul_rn(o.x, px), __fmul_rn(o.y, py));
      acc = min_nan(acc, __fsub_rn(o.z, __fmul_rn(2.0f, cross)));
    }
  }
  return acc;
}

// The expanded form's epilogue: + |p|^2, then max(., 0) keeping a NaN.
__device__ __forceinline__ float finish_expanded(float acc, float pnorm) {
  const float v = __fadd_rn(acc, pnorm);
  return v < 0.0f ? 0.0f : v;
}

// Running min of |p - (o + v * tau)|^2 over `n` rows: obs [n, 2] and
// vel [n, 2] row-major. Same staging and barriers as `sweep`.
__device__ float sweep_moving(float px, float py, float tau,
                              const float* __restrict__ obs,
                              const float* __restrict__ vel, int n,
                              float4* tile) {
  float acc = CUDART_INF_F;
  for (int base = 0; base < n; base += kTile) {
    const int rows = min(kTile, n - base);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const long long r = 2LL * (base + i);
      tile[i] = make_float4(obs[r], obs[r + 1], vel[r], vel[r + 1]);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      const float4 o = tile[j];
      const float ox = __fadd_rn(o.x, __fmul_rn(o.z, tau));
      const float oy = __fadd_rn(o.y, __fmul_rn(o.w, tau));
      acc = min_nan(acc, dist_sq(px, py, ox, oy));
    }
  }
  return acc;
}

// One block: kBlock points of robot blockIdx.y. kForm selects the sweep
// (kMoving reads obs_vel and dt); kSegments = false compiles the segment
// sweep out (K4: seg_x, seg_y and out_seg are not read).
template <int kForm, bool kSegments>
__global__ void __launch_bounds__(kBlock) fused_min_dist_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    int n_points, int steps, const float* __restrict__ obs,
    const float* __restrict__ obs_vel, const float* __restrict__ dt,
    int n_obs, const float* __restrict__ seg_x,
    const float* __restrict__ seg_y, int n_seg,
    const int* __restrict__ active_points, float* __restrict__ out_obs,
    float* __restrict__ out_seg) {
  // kTile float4 rows for the moving and expanded sweeps; the direct
  // form reads it as kTile float2 rows, so K1 keeps its 4 KB
  __shared__ float4 tile[kForm == kDirect ? kTile / 2 : kTile];
  float2* tile2 = reinterpret_cast<float2*>(tile);
  const int b = blockIdx.y;
  const long long point0 = static_cast<long long>(b) * n_points;
  const long long row0 = static_cast<long long>(b) * n_obs;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < n_points;
  const float x = live ? px[point0 + p] : 0.0f;
  const float y = live ? py[point0 + p] : 0.0f;
  const int t = p % steps;
  float mo;
  if constexpr (kForm == kMoving) {
    const float tau = __fmul_rn(static_cast<float>(t), dt[b]);
    mo = sweep_moving(x, y, tau, obs + 2 * row0, obs_vel + 2 * row0, n_obs,
                      tile);
  } else if constexpr (kForm == kExpanded) {
    mo = sweep_expanded(x, y, obs + 2 * row0, obs + 2 * row0 + 1, 2, n_obs,
                        tile);
  } else {
    mo = sweep(x, y, obs + 2 * row0, obs + 2 * row0 + 1, 2, n_obs, tile2);
  }
  float ms = 0.0f;
  if constexpr (kSegments) {
    const long long seg0 = static_cast<long long>(b) * n_seg;
    ms = kForm == kExpanded
             ? sweep_expanded(x, y, seg_x + seg0, seg_y + seg0, 1, n_seg, tile)
             : sweep(x, y, seg_x + seg0, seg_y + seg0, 1, n_seg, tile2);
  }
  if constexpr (kForm == kExpanded) {
    const float pnorm = norm_sq(x, y);
    mo = finish_expanded(mo, pnorm);
    ms = finish_expanded(ms, pnorm);
  }
  if (live) {
    const bool active = t < active_points[b];
    out_obs[point0 + p] = active ? mo : CUDART_INF_F;
    if (kSegments) out_seg[point0 + p] = active ? ms : CUDART_INF_F;
  }
}

template <int kForm, bool kSegments>
int launch(const float* px, const float* py, int batch, int n_points,
           int steps, const float* obs, const float* obs_vel, const float* dt,
           int n_obs, const float* seg_x, const float* seg_y, int n_seg,
           const int* active_points, float* out_obs, float* out_seg,
           void* stream) {
  const dim3 grid((n_points + kBlock - 1) / kBlock, batch);
  fused_min_dist_kernel<kForm, kSegments>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          px, py, n_points, steps, obs, obs_vel, dt, n_obs, seg_x, seg_y,
          n_seg, active_points, out_obs, out_seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes (all f32 contiguous unless noted, B = batch robots):
//   px, py: [B, S, T] (n_points = S * T, steps = T);
//   obs: [B, n_obs, 2]; seg_x, seg_y: [B, n_seg];
//   active_points: [B] int32 on the device;
//   out_obs, out_seg: [B, S, T].
// Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int kompass_fused_min_dist_sq(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, int n_obs, const float* seg_x, const float* seg_y,
    int n_seg, const int* active_points, float* out_obs, float* out_seg,
    void* stream) {
  return launch<kDirect, true>(px, py, batch, n_points, steps, obs, nullptr,
                               nullptr, n_obs, seg_x, seg_y, n_seg,
                               active_points, out_obs, out_seg, stream);
}

// The moving sweep: as above, plus obs_vel [B, n_obs, 2] (pad rows zero)
// and dt [B], the per-robot control step.
extern "C" int kompass_fused_min_dist_sq_moving(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, const float* obs_vel, const float* dt, int n_obs,
    const float* seg_x, const float* seg_y, int n_seg,
    const int* active_points, float* out_obs, float* out_seg, void* stream) {
  return launch<kMoving, true>(px, py, batch, n_points, steps, obs, obs_vel,
                               dt, n_obs, seg_x, seg_y, n_seg, active_points,
                               out_obs, out_seg, stream);
}

// K2: both sweeps in the expanded form; arguments as for
// kompass_fused_min_dist_sq.
extern "C" int kompass_fused_min_dist_sq_expanded(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, int n_obs, const float* seg_x, const float* seg_y,
    int n_seg, const int* active_points, float* out_obs, float* out_seg,
    void* stream) {
  return launch<kExpanded, true>(px, py, batch, n_points, steps, obs,
                                 nullptr, nullptr, n_obs, seg_x, seg_y, n_seg,
                                 active_points, out_obs, out_seg, stream);
}

// K4: one expanded sweep of [B, S, T] points against rows [B, n_rows, 2]
// into out [B, S, T].
extern "C" int kompass_min_dist_sq_expanded(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* rows, int n_rows, const int* active_points, float* out,
    void* stream) {
  return launch<kExpanded, false>(px, py, batch, n_points, steps, rows,
                                  nullptr, nullptr, n_rows, nullptr, nullptr,
                                  0, active_points, out, nullptr, stream);
}
