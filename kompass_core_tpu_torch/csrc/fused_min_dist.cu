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
// What bounds them on Hopper: FP32 issue. Every operation is rounded on
// its own (no FMA), so a (point, row) pair costs at least its 6 FP32
// instructions (2 sub, 2 mul, add, min); the rows and points of a
// 64-robot tick are a few MB, all in L2.
//
// K1, K2 and K4: one thread per point (fused_min_dist_kernel below),
// 256-thread blocks over one robot's S*T points; rows are staged through
// shared memory in tiles of 512 and every thread reads the same row at
// the same time (a broadcast). The running min lives in a register; the
// ragged last tile and block are masked. About 9 instructions per pair.
//
// K3 (moving_min_dist_kernel below) is laid out for its own work:
//   * a block is one robot b, one step t and a run of samples, so the
//     moved row o + v * tau is formed once per (robot, step, row) when
//     its tile is staged, not once per pair; the inner loop is the static
//     direct form, for the moved obstacle rows and the segment rows alike;
//   * each thread holds kPoints samples of that step in registers, so one
//     shared-memory broadcast of a row feeds kPoints pairs;
//   * the min is fminf unless the block's points, the staged tile or an
//     earlier tile of the sweep hold a non-finite coordinate (flags
//     reduced with __syncthreads_or, so the choice is block-uniform); only
//     then can a distance, or the running min, be NaN, and the NaN-keeping
//     min runs. A min is exact in any order and d >= +0, so both give the
//     plain version's values bit for bit;
//   * a step at or past active_points[b] writes +inf and sweeps nothing;
//   * the points are read in place with stride T (one read per point per
//     launch; the [B, S, T] layout of the wrapper is kept).
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

enum Form : int { kDirect = 0, kExpanded = 2 };

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

// One block: kBlock points of robot blockIdx.y. kForm selects the sweep;
// kSegments = false compiles the segment sweep out (K4: seg_x, seg_y and
// out_seg are not read).
template <int kForm, bool kSegments>
__global__ void __launch_bounds__(kBlock) fused_min_dist_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    int n_points, int steps, const float* __restrict__ obs, int n_obs,
    const float* __restrict__ seg_x, const float* __restrict__ seg_y,
    int n_seg, const int* __restrict__ active_points,
    float* __restrict__ out_obs, float* __restrict__ out_seg) {
  // kTile float4 rows for the expanded sweep; the direct form reads it
  // as kTile float2 rows, so K1 keeps its 4 KB
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
  if constexpr (kForm == kExpanded) {
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
           int steps, const float* obs, int n_obs, const float* seg_x,
           const float* seg_y, int n_seg, const int* active_points,
           float* out_obs, float* out_seg, void* stream) {
  const dim3 grid((n_points + kBlock - 1) / kBlock, batch);
  fused_min_dist_kernel<kForm, kSegments>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          px, py, n_points, steps, obs, n_obs, seg_x, seg_y, n_seg,
          active_points, out_obs, out_seg);
  return static_cast<int>(cudaGetLastError());
}

// --- K3: the moving sweep ----------------------------------------------------

constexpr int kMovingBlock = 128;   // threads per block
constexpr int kPoints = 8;          // samples of one step per thread
constexpr int kMovingTile = 1024;   // rows per staged tile (8 KB of float2)

__device__ __forceinline__ bool both_finite(float x, float y) {
  return isfinite(x) && isfinite(y);
}

// One staged tile against the thread's kPoints points. kKeepNan selects
// the NaN-keeping min (a distance can be NaN only when a coordinate of
// the point or the row is non-finite).
template <bool kKeepNan>
__device__ __forceinline__ void sweep_tile(const float (&x)[kPoints],
                                           const float (&y)[kPoints],
                                           float (&acc)[kPoints],
                                           const float2* tile, int rows) {
#pragma unroll 4
  for (int j = 0; j < rows; ++j) {
    const float2 o = tile[j];
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const float d = dist_sq(x[k], y[k], o.x, o.y);
      acc[k] = kKeepNan ? min_nan(acc[k], d) : fminf(acc[k], d);
    }
  }
}

// Running mins over `n` rows, row i at (xs[i*stride], ys[i*stride]),
// moved to (x + vx * tau, y + vy * tau) with (vx, vy) = (vel[2i],
// vel[2i+1]) when kMove (the __fmul_rn / __fadd_rn order of the plain
// version). Every thread of the block must call it: it stages tiles and
// synchronises.
template <bool kMove>
__device__ void sweep_rows(const float (&x)[kPoints], const float (&y)[kPoints],
                           float (&acc)[kPoints], const float* __restrict__ xs,
                           const float* __restrict__ ys, int stride,
                           const float* __restrict__ vel, float tau, int n,
                           bool points_non_finite, float2* tile) {
  // once a distance may have been NaN, later tiles keep it: fminf would
  // drop a NaN already in the running min
  bool keep_nan = points_non_finite;
  for (int base = 0; base < n; base += kMovingTile) {
    const int rows = min(kMovingTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    bool non_finite = false;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const long long r = static_cast<long long>(base + i) * stride;
      float ox = xs[r];
      float oy = ys[r];
      if constexpr (kMove) {
        const long long v = 2LL * (base + i);
        ox = __fadd_rn(ox, __fmul_rn(vel[v], tau));
        oy = __fadd_rn(oy, __fmul_rn(vel[v + 1], tau));
      }
      non_finite |= !both_finite(ox, oy);
      tile[i] = make_float2(ox, oy);
    }
    // a barrier that also makes the tile's flag block-uniform
    keep_nan = __syncthreads_or(non_finite) || keep_nan;
    if (keep_nan) {
      sweep_tile<true>(x, y, acc, tile, rows);
    } else {
      sweep_tile<false>(x, y, acc, tile, rows);
    }
  }
}

// One block: step t = blockIdx.y of robot b = blockIdx.z, samples
// blockIdx.x * kMovingBlock * kPoints + threadIdx.x + k * kMovingBlock.
__global__ void __launch_bounds__(kMovingBlock) moving_min_dist_kernel(
    const float* __restrict__ px, const float* __restrict__ py, int samples,
    int steps, const float* __restrict__ obs, const float* __restrict__ obs_vel,
    const float* __restrict__ dt, int n_obs, const float* __restrict__ seg_x,
    const float* __restrict__ seg_y, int n_seg,
    const int* __restrict__ active_points, float* __restrict__ out_obs,
    float* __restrict__ out_seg) {
  __shared__ float2 tile[kMovingTile];
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = blockIdx.x * kMovingBlock * kPoints + threadIdx.x;
  const long long point0 = static_cast<long long>(b) * samples * steps + t;
  if (t >= active_points[b]) {  // block-uniform, before any barrier
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const int s = s0 + k * kMovingBlock;
      if (s < samples) {
        out_obs[point0 + static_cast<long long>(s) * steps] = CUDART_INF_F;
        out_seg[point0 + static_cast<long long>(s) * steps] = CUDART_INF_F;
      }
    }
    return;
  }
  float x[kPoints], y[kPoints], mo[kPoints], ms[kPoints];
  bool non_finite = false;
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int s = s0 + k * kMovingBlock;
    const long long p = point0 + static_cast<long long>(s) * steps;
    x[k] = s < samples ? px[p] : 0.0f;
    y[k] = s < samples ? py[p] : 0.0f;
    non_finite |= !both_finite(x[k], y[k]);
    mo[k] = CUDART_INF_F;
    ms[k] = CUDART_INF_F;
  }
  const bool points_non_finite = __syncthreads_or(non_finite);
  const float tau = __fmul_rn(static_cast<float>(t), dt[b]);
  const long long row0 = static_cast<long long>(b) * n_obs;
  sweep_rows<true>(x, y, mo, obs + 2 * row0, obs + 2 * row0 + 1, 2,
                   obs_vel + 2 * row0, tau, n_obs, points_non_finite, tile);
  const long long seg0 = static_cast<long long>(b) * n_seg;
  sweep_rows<false>(x, y, ms, seg_x + seg0, seg_y + seg0, 1, nullptr, 0.0f,
                    n_seg, points_non_finite, tile);
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int s = s0 + k * kMovingBlock;
    if (s < samples) {
      out_obs[point0 + static_cast<long long>(s) * steps] = mo[k];
      out_seg[point0 + static_cast<long long>(s) * steps] = ms[k];
    }
  }
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
  return launch<kDirect, true>(px, py, batch, n_points, steps, obs, n_obs,
                               seg_x, seg_y, n_seg, active_points, out_obs,
                               out_seg, stream);
}

// K3, the moving sweep: as above, plus obs_vel [B, n_obs, 2] (pad rows
// zero) and dt [B], the per-robot control step.
extern "C" int kompass_fused_min_dist_sq_moving(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, const float* obs_vel, const float* dt, int n_obs,
    const float* seg_x, const float* seg_y, int n_seg,
    const int* active_points, float* out_obs, float* out_seg, void* stream) {
  const int samples = n_points / steps;
  const int per_block = kMovingBlock * kPoints;
  const dim3 grid((samples + per_block - 1) / per_block, steps, batch);
  moving_min_dist_kernel<<<grid, kMovingBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      px, py, samples, steps, obs, obs_vel, dt, n_obs, seg_x, seg_y, n_seg,
      active_points, out_obs, out_seg);
  return static_cast<int>(cudaGetLastError());
}

// K2: both sweeps in the expanded form; arguments as for
// kompass_fused_min_dist_sq.
extern "C" int kompass_fused_min_dist_sq_expanded(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, int n_obs, const float* seg_x, const float* seg_y,
    int n_seg, const int* active_points, float* out_obs, float* out_seg,
    void* stream) {
  return launch<kExpanded, true>(px, py, batch, n_points, steps, obs, n_obs,
                                 seg_x, seg_y, n_seg, active_points, out_obs,
                                 out_seg, stream);
}

// K4: one expanded sweep of [B, S, T] points against rows [B, n_rows, 2]
// into out [B, S, T].
extern "C" int kompass_min_dist_sq_expanded(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* rows, int n_rows, const int* active_points, float* out,
    void* stream) {
  return launch<kExpanded, false>(px, py, batch, n_points, steps, rows,
                                  n_rows, nullptr, nullptr, 0, active_points,
                                  out, nullptr, stream);
}
