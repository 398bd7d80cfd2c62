// Fused obstacle + tracked-segment min-distance sweeps for the DWA tick,
// with a robot axis.
//
// For every robot b and every point p of its [S, T] rollout, one pass
// computes
//   d2_obs[b, p] = min over obstacle rows o of |p - o(t)|^2
//   d2_seg[b, p] = min over tracked-segment rows g of |p - g|^2
// and writes +inf where the step index t >= active_points[b]. Statically
// o(t) = o; in the moving sweeps o(t) = o + v * tau with tau = f32(t) *
// dt[b]. The segment rows never move. What each kernel computes, and what
// it replaces:
//   K1 static_min_dist_kernel<kDirect>: the JAX package's XLA form of the
//      static sweep, (p - o)^2 (kompass_core_tpu/ops/solver.py:347
//      _min_obstacle_dist_sq; solver backend "xla").
//   K2 static_min_dist_kernel<kExpanded>: the TPU kernel
//      kompass_core_tpu/ops/pallas_kernels.py:56 _fused_kernel_mxu, both
//      sweeps in the expanded form (backend "pallas").
//   K4 static_min_dist_kernel<kExpanded> with the segment sweep compiled
//      out (kSegments = false): pallas_kernels.py:387 _min_dist_kernel
//      (backend "pallas_v1").
//   K6 static_min_dist_kernel<kBroadcast>: pallas_kernels.py:89
//      _fused_kernel_vpu, both sweeps in the broadcast form (backend
//      "pallas_vpu").
//   K3 moving_min_dist_kernel<kDirect>: the XLA form of the moving sweep,
//      (p - (o + v tau))^2 (solver.py:365 _min_obstacle_dist_sq_moving;
//      backend "xla" with moving obstacles), its segment sweep direct.
//   K3s point_major_min_dist_kernel: the same function over the split mover
//      rows alone (solver.py:737 dwa_solve's mover4, every backend), a
//      few rows against every point, laid out point-major (below); past
//      ops/kernels.py::POINT_MAJOR_ROWS rows moving_min_dist_kernel<kDirect>
//      with the segment sweep compiled out (kSegments = false).
//   K7 moving_min_dist_kernel<kExpanded>: pallas_kernels.py:116
//      _fused_kernel_mxu_moving, the 7-feature dot (backends "pallas" and
//      "pallas_v1" with moving obstacles), its segment sweep K2's.
//   K8 moving_min_dist_kernel<kBroadcast>: pallas_kernels.py:171
//      _fused_kernel_vpu_moving, the 7-feature left fold (backend
//      "pallas_vpu" with moving obstacles), its segment sweep K6's.
//
// What bounds them on Hopper: FP32 issue. A (point, row) pair costs a
// handful of FP32 instructions (6 in the direct form: 2 sub, 2 mul, add,
// min; K7's is 4 FFMA and a min); the rows and points of a 64-robot tick
// are a few MB, all in L2. So each design cuts the instructions around
// the pair's own arithmetic (the row's shared-memory read, the NaN-keeping
// min's compares) and keeps enough warps in flight to hide their latency.
//
// The static sweeps K1, K2, K4 and K6 are one kernel
// (static_min_dist_kernel below) in the moving kernels' layout (next
// paragraph: kPts samples of one step per thread, fminf behind a
// block-uniform flag, an inactive step swept by nobody), with kPts chosen
// for the grid in Python (ops/kernels.py::sweep_points): 8 where the grid
// holds two warps per warp scheduler (64 robots, the cost evaluator),
// else 2. One robot's 2025 x 30 points make 60 blocks of 4 warps at kPts
// = 8, against the H100's 528 warp schedulers, each thread running 896
// dependent mins; at kPts = 2 they make 240 blocks, and the sweep stays
// latency-bound at about 40% of its bound. K1's flag is a non-finite
// coordinate (K3's rule); K2's, K4's and K6's a value above 1e18 (K7's
// rule, since the expanded forms make inf - inf from finite inputs).
// Below that bound 2 * cross is exact, so the unflagged expanded pair
// (K2, K4) takes |o|^2 - 2 * cross as one FFMA, bit-identical to the
// separate multiply and subtract the flagged pair keeps: 5 instructions
// per pair, K1's 6. K6's broadcast pair is 2 FMUL, 2 FADD and the min
// (rounded as the TPU's vector unit rounds it: no FMA to save); each
// thread holds -2px and -2py of its samples and reads its points again
// for |p|^2 after the sweeps.
//
// The moving kernels (K3, K7, K8: moving_min_dist_kernel below) are laid
// out for their own work:
//   * a block is one robot b, one step t and a run of samples, so what
//     depends on the row and the step (K3's moved row o + v * tau, K7's
//     and K8's prefix of the feature sum) is formed once per (robot, step,
//     row) when its tile is staged, not once per pair;
//   * each thread holds kPoints samples of that step in registers, so one
//     shared-memory broadcast of a row feeds kPoints pairs;
//   * the min is fminf unless the block's points, the staged tile or an
//     earlier tile of the sweep hold a value that can make a distance NaN
//     (flags reduced with __syncthreads_or, so the choice is
//     block-uniform); only then does the NaN-keeping min run. K3 flags a
//     non-finite coordinate; K7 and K8 flag any staged or per-point value
//     above 1e18 in magnitude (NaN and inf included): below it no product
//     or sum of the forms overflows, so no distance is NaN. A min is exact
//     in any order, and the forms' epilogue (+ |p|^2 >= +0) erases the
//     sign of a zero, so both mins give the plain version's values bit
//     for bit;
//   * a step at or past active_points[b] writes +inf and sweeps nothing;
//   * the points are read in place with stride T (one read per point per
//     launch; the [B, S, T] layout of the wrapper is kept).
//
// The forms:
//   * direct (K1, K3): (px-ox)^2 + (py-oy)^2, the XLA form's function.
//   * expanded (K2, K4, and K7's segment sweep): cross = ox*px + oy*py,
//     d = |o|^2 - 2*cross, running min over the rows, then + |p|^2 and a
//     clamp at 0, each operation rounded on its own.
//   * broadcast (K6, and K8's segment sweep): d = (|o|^2 + (-2px)*ox) +
//     (-2py)*oy, the TPU vector unit's broadcast products, each multiply
//     and add rounded on its own (that unit has no FMA); then + |p|^2 and
//     the clamp.
//   * the 7-feature forms (K7, K8): f(o) = [|o|^2, |v|^2, 2 v.o, -2ox,
//     -2oy, -2vx, -2vy] per row, g(p) = [1, tau^2, tau, px, py, tau*px,
//     tau*py] per point, d = f(o).g(p), then + |p|^2 and the clamp. g1, g2
//     depend on the step alone, so the prefix c = f0 + f1*tau^2 + f2*tau
//     is formed per staged row and the pair loop adds the four point
//     terms. Everything outside K7's dot is rounded as the TPU's vector
//     unit rounds it, every multiply and add on its own: the features
//     |o|^2, |v|^2 and 2 v.o, tau*px and tau*py, and the one |p|^2 per
//     point that both fields add. K8 is the TPU kernel's left fold, every
//     operation rounded on its own: c = (f0 + f1*tau^2) + f2*tau, d =
//     (((c + f3*px) + f4*py) + f5*(tau*px)) + f6*(tau*py). K7's K = 8 dot
//     has no rounding of its own (the TPU's matrix unit sums at its own
//     precision), so the port chooses one: the feature-order chain of
//     fused multiply-adds, c = fma(f2, tau, fma(f1, tau^2, f0)), d =
//     fma(f6, tau*py, fma(f5, tau*px, fma(f4, py, fma(f3, px, c)))), 4 FFMA
//     per pair. That chain is the order of XLA's CPU dot, so K7 equals the
//     JAX package's interpret-mode kernel bit for bit when XLA compiles
//     the rest without FMA (--xla_cpu_max_isa=SSE4_2), as K6 and K8 do.
// The expanded forms cancel as the coordinates grow: their absolute error
// is a few ulps of |p|^2 + |o|^2 (|p|^2 * 2^-24, about 6e-6 m^2 at 10 m
// from the origin, a hundred times that at 100 m), against centimetre
// collision margins. It is the function the JAX backends compute, ported
// as it is; the XLA form (K1, K3) has no such term. A pad row at 1e8
// stays finite (|o|^2 = 2e16, zero velocity) and never wins.
// The intrinsics below round each operation on its own (__f*_rn) or fuse
// exactly where the form says (__fmaf_rn), so nvcc contracts nothing else.
// Every form is then bit-identical to its plain PyTorch version, which
// evaluates the same operations one by one (K7's FMAs correctly rounded
// through float64, ops/kernels.py::_fma_rn): a min is exact in any order.
// The min propagates NaN like torch.amin, and the clamp keeps a NaN. A
// zero velocity adds +0 to K3's row, so K3 gives K1's values bit for bit,
// and K8's velocity terms add +-0, so K8 gives K6's.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include <type_traits>

namespace {

enum Form : int { kDirect = 0, kBroadcast = 1, kExpanded = 2 };

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

// A point coordinate as the expanded and broadcast forms' pair takes it:
// x, or -2x in the broadcast form.
template <int kForm>
__device__ __forceinline__ float operand(float x) {
  return kForm == kBroadcast ? __fmul_rn(-2.0f, x) : x;
}

// One pair of the expanded (K2, K4) or broadcast (K6) form, without
// |p|^2, against a staged row (ox, oy, |o|^2); (a, b) is the point's
// operand<kForm> pair.
template <int kForm>
__device__ __forceinline__ float norm_form(float4 o, float a, float b) {
  if constexpr (kForm == kBroadcast) {
    return __fadd_rn(__fadd_rn(o.z, __fmul_rn(a, o.x)), __fmul_rn(b, o.y));
  } else {
    const float cross = __fadd_rn(__fmul_rn(o.x, a), __fmul_rn(o.y, b));
    return __fsub_rn(o.z, __fmul_rn(2.0f, cross));
  }
}

// The expanded forms' epilogue: + |p|^2, then max(., 0) keeping a NaN.
__device__ __forceinline__ float finish_expanded(float acc, float pnorm) {
  const float v = __fadd_rn(acc, pnorm);
  return v < 0.0f ? 0.0f : v;
}

// --- K3, K7, K8: the moving sweeps ----------------------------------------------

constexpr int kMovingBlock = 128;   // threads per block
constexpr int kPoints = 8;          // samples of one step per thread
constexpr int kMovingTile = 1024;   // rows per staged tile
// K7 and K8: a value at most this large in magnitude keeps every product
// (< 1e36) and sum of their forms finite, so no distance is NaN
constexpr float kTame = 1e18f;

__device__ __forceinline__ bool both_finite(float x, float y) {
  return isfinite(x) && isfinite(y);
}

__device__ __forceinline__ bool tame(float v) { return fabsf(v) <= kTame; }

// K3's staged tile against the thread's kPoints points. kKeepNan selects
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

// K3's running mins over `n` rows, row i at (xs[i*stride], ys[i*stride]),
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

// The points of one K7 / K8 block: px, py, tau*px, tau*py per sample.
struct StepPoints {
  float x[kPoints], y[kPoints], tx[kPoints], ty[kPoints];
};

// One pair of K7's (kExpanded) or K8's (kBroadcast) obstacle form:
// the staged prefix c and (f3, f4, f5, f6) against point k.
template <int kForm>
__device__ __forceinline__ float feature_form(float c, float4 f,
                                              const StepPoints& p, int k) {
  if constexpr (kForm == kExpanded) {
    return __fmaf_rn(f.w, p.ty[k], __fmaf_rn(f.z, p.tx[k],
                     __fmaf_rn(f.y, p.y[k], __fmaf_rn(f.x, p.x[k], c))));
  } else {
    const float d = __fadd_rn(__fadd_rn(c, __fmul_rn(f.x, p.x[k])),
                              __fmul_rn(f.y, p.y[k]));
    return __fadd_rn(__fadd_rn(d, __fmul_rn(f.z, p.tx[k])),
                     __fmul_rn(f.w, p.ty[k]));
  }
}

template <int kForm, bool kKeepNan>
__device__ __forceinline__ void feature_tile(const StepPoints& p,
                                             float (&acc)[kPoints],
                                             const float4* feat,
                                             const float* prefix, int rows) {
#pragma unroll 4
  for (int j = 0; j < rows; ++j) {
    const float4 f = feat[j];
    const float c = prefix[j];
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const float d = feature_form<kForm>(c, f, p, k);
      acc[k] = kKeepNan ? min_nan(acc[k], d) : fminf(acc[k], d);
    }
  }
}

// K7's and K8's obstacle sweep: per staged row its features and the
// step's prefix c (module comment), then the pair loop. `wild`: the
// block's points are not all tame. Every thread must call it.
template <int kForm>
__device__ void feature_rows(const StepPoints& p, float (&acc)[kPoints],
                             const float* __restrict__ obs,
                             const float* __restrict__ vel, float tau,
                             float tau2, int n, bool wild, float4* feat,
                             float* prefix) {
  for (int base = 0; base < n; base += kMovingTile) {
    const int rows = min(kMovingTile, n - base);
    __syncthreads();
    bool wild_rows = false;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const long long r = 2LL * (base + i);
      const float ox = obs[r], oy = obs[r + 1];
      const float vx = vel[r], vy = vel[r + 1];
      const float f0 = norm_sq(ox, oy);
      const float f1 = norm_sq(vx, vy);
      const float f2 =
          __fmul_rn(2.0f, __fadd_rn(__fmul_rn(vx, ox), __fmul_rn(vy, oy)));
      const float c =
          kForm == kExpanded
              ? __fmaf_rn(f2, tau, __fmaf_rn(f1, tau2, f0))
              : __fadd_rn(__fadd_rn(f0, __fmul_rn(f1, tau2)), __fmul_rn(f2, tau));
      const float4 f = make_float4(__fmul_rn(-2.0f, ox), __fmul_rn(-2.0f, oy),
                                   __fmul_rn(-2.0f, vx), __fmul_rn(-2.0f, vy));
      wild_rows |= !(tame(c) && tame(f.x) && tame(f.y) && tame(f.z) && tame(f.w));
      feat[i] = f;
      prefix[i] = c;
    }
    wild = __syncthreads_or(wild_rows) || wild;
    if (wild) {
      feature_tile<kForm, true>(p, acc, feat, prefix, rows);
    } else {
      feature_tile<kForm, false>(p, acc, feat, prefix, rows);
    }
  }
}

template <int kForm, bool kKeepNan>
__device__ __forceinline__ void norm_tile(const StepPoints& p,
                                          float (&acc)[kPoints],
                                          const float4* tile, int rows) {
#pragma unroll 4
  for (int j = 0; j < rows; ++j) {
    const float4 o = tile[j];
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const float d = norm_form<kForm>(o, operand<kForm>(p.x[k]),
                                       operand<kForm>(p.y[k]));
      acc[k] = kKeepNan ? min_nan(acc[k], d) : fminf(acc[k], d);
    }
  }
}

// K7's (K2's expanded form) and K8's (K6's broadcast form) segment sweep
// over `n` rows (xs[i], ys[i]). Every thread must call it.
template <int kForm>
__device__ void norm_rows(const StepPoints& p, float (&acc)[kPoints],
                          const float* __restrict__ xs,
                          const float* __restrict__ ys, int n, bool wild,
                          float4* tile) {
  for (int base = 0; base < n; base += kMovingTile) {
    const int rows = min(kMovingTile, n - base);
    __syncthreads();
    bool wild_rows = false;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const float x = xs[base + i];
      const float y = ys[base + i];
      const float o2 = norm_sq(x, y);
      wild_rows |= !(tame(x) && tame(y) && tame(o2));
      tile[i] = make_float4(x, y, o2, 0.0f);
    }
    wild = __syncthreads_or(wild_rows) || wild;
    if (wild) {
      norm_tile<kForm, true>(p, acc, tile, rows);
    } else {
      norm_tile<kForm, false>(p, acc, tile, rows);
    }
  }
}

// One block: step t = blockIdx.y of robot b = blockIdx.z, samples
// blockIdx.x * kMovingBlock * kPoints + threadIdx.x + k * kMovingBlock.
// kForm: kDirect (K3; K3s with kSegments = false, which compiles the
// segment sweep and its stores out: seg_x, seg_y and out_seg are not
// read), kExpanded (K7) or kBroadcast (K8).
template <int kForm, bool kSegments = true>
__global__ void __launch_bounds__(kMovingBlock) moving_min_dist_kernel(
    const float* __restrict__ px, const float* __restrict__ py, int samples,
    int steps, const float* __restrict__ obs, const float* __restrict__ obs_vel,
    const float* __restrict__ dt, int n_obs, const float* __restrict__ seg_x,
    const float* __restrict__ seg_y, int n_seg,
    const int* __restrict__ active_points, float* __restrict__ out_obs,
    float* __restrict__ out_seg) {
  // K3: kMovingTile float2 rows (8 KB); K7, K8: kMovingTile float4 feature
  // rows and their prefixes (20 KB)
  __shared__ float4 tile[kForm == kDirect ? kMovingTile / 2 : kMovingTile];
  __shared__ float prefix[kForm == kDirect ? 1 : kMovingTile];
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
        if constexpr (kSegments) {
          out_seg[point0 + static_cast<long long>(s) * steps] = CUDART_INF_F;
        }
      }
    }
    return;
  }
  float mo[kPoints], ms[kPoints];
  const float tau = __fmul_rn(static_cast<float>(t), dt[b]);
  const long long row0 = static_cast<long long>(b) * n_obs;
  const long long seg0 = static_cast<long long>(b) * n_seg;
  if constexpr (kForm == kDirect) {
    float x[kPoints], y[kPoints];
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
    float2* tile2 = reinterpret_cast<float2*>(tile);
    sweep_rows<true>(x, y, mo, obs + 2 * row0, obs + 2 * row0 + 1, 2,
                     obs_vel + 2 * row0, tau, n_obs, points_non_finite, tile2);
    if constexpr (kSegments) {
      sweep_rows<false>(x, y, ms, seg_x + seg0, seg_y + seg0, 1, nullptr, 0.0f,
                        n_seg, points_non_finite, tile2);
    }
  } else {
    static_assert(kSegments, "the feature forms always sweep the segment");
    StepPoints p;
    bool wild = false;
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const int s = s0 + k * kMovingBlock;
      const long long i = point0 + static_cast<long long>(s) * steps;
      p.x[k] = s < samples ? px[i] : 0.0f;
      p.y[k] = s < samples ? py[i] : 0.0f;
      p.tx[k] = __fmul_rn(tau, p.x[k]);
      p.ty[k] = __fmul_rn(tau, p.y[k]);
      wild |= !(tame(p.x[k]) && tame(p.y[k]) && tame(p.tx[k]) && tame(p.ty[k]));
      mo[k] = CUDART_INF_F;
      ms[k] = CUDART_INF_F;
    }
    wild = __syncthreads_or(wild);
    feature_rows<kForm>(p, mo, obs + 2 * row0, obs_vel + 2 * row0, tau,
                        __fmul_rn(tau, tau), n_obs, wild, tile, prefix);
    norm_rows<kForm>(p, ms, seg_x + seg0, seg_y + seg0, n_seg, wild, tile);
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const float pnorm = norm_sq(p.x[k], p.y[k]);  // one per point, both fields
      mo[k] = finish_expanded(mo[k], pnorm);
      ms[k] = finish_expanded(ms[k], pnorm);
    }
  }
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int s = s0 + k * kMovingBlock;
    if (s < samples) {
      out_obs[point0 + static_cast<long long>(s) * steps] = mo[k];
      if constexpr (kSegments) {
        out_seg[point0 + static_cast<long long>(s) * steps] = ms[k];
      }
    }
  }
}

template <int kForm, bool kSegments = true>
int launch_moving(const float* px, const float* py, int batch, int n_points,
                  int steps, const float* obs, const float* obs_vel,
                  const float* dt, int n_obs, const float* seg_x,
                  const float* seg_y, int n_seg, const int* active_points,
                  float* out_obs, float* out_seg, void* stream) {
  const int samples = n_points / steps;
  const int per_block = kMovingBlock * kPoints;
  const dim3 grid((samples + per_block - 1) / per_block, steps, batch);
  moving_min_dist_kernel<kForm, kSegments><<<grid, kMovingBlock, 0,
                                             static_cast<cudaStream_t>(stream)>>>(
      px, py, samples, steps, obs, obs_vel, dt, n_obs, seg_x, seg_y, n_seg,
      active_points, out_obs, out_seg);
  return static_cast<int>(cudaGetLastError());
}

// --- K3s at a few rows: the point-major moving sweep ------------------------------
//
// K3s sweeps the split movers: 8 rows against 64 x 2025 x 30 points on the
// fleet's path. There each point meets so few rows that the sweep is bound
// by its bytes (the points read once, d2 written once: 46.7 MB), not by its
// pairs. moving_min_dist_kernel's block per (robot, step) reads a point
// stride-T apart from its neighbour's, one 32-byte sector per 4-byte access
// (8 times the bytes at T = 30), so here:
//   * a block is a run of kPointMajorBlock * kPointMajorPts consecutive
//     points of one robot b = blockIdx.y (grid (runs, B): no block spans
//     two robots), thread i holding points base + i + k * kPointMajorBlock;
//     each load of px, py and store of d2 is one coalesced 128-byte line
//     per warp. The step t = p mod T takes one division per thread and is
//     stepped per k (+ kPointMajorBlock mod T, less T on a wrap);
//   * the robot's M rows are staged once per block in shared memory as
//     (ox, oy, vx, vy); every thread reads the same row at once (a
//     broadcast), and moves it per pair, o + v * tau with tau = f32(t) *
//     dt[b] once per point: 2 FMUL and 2 FADD on top of K3's 6, so 10 FP32
//     instructions per pair, about 0.011 ms of issue at 8 rows against the
//     0.014 ms byte bound. The moved rows differ per step, and the steps
//     differ across a warp, so no per-step row is staged;
//   * the min is fminf unless the block holds a non-finite point, tau or
//     row value (flag reduced with __syncthreads_or, block-uniform); only
//     then does the NaN-keeping min run. From finite o, v and tau a moved
//     row can overflow to +-inf, but then each square is +inf or finite
//     and the distance +inf, never NaN, and fminf keeps it as the
//     NaN-keeping min does;
//   * an inactive point (t >= active_points[b]) reads nothing and writes
//     +inf.
// At many rows the per-pair move makes this layout issue-bound at 10
// instructions per pair against moving_min_dist_kernel's 6, so the wrapper
// takes that kernel past POINT_MAJOR_ROWS rows (measured on the H100,
// PERF.md). The rows take M * 16 bytes of dynamic shared memory, at most
// kPointMajorMaxRows.

constexpr int kPointMajorBlock = 128;  // threads per block
constexpr int kPointMajorPts = 4;      // points per thread
constexpr int kPointMajorMaxRows = 1024;

template <bool kKeepNan>
__device__ __forceinline__ void point_major_rows(const float (&x)[kPointMajorPts],
                                                 const float (&y)[kPointMajorPts],
                                                 const float (&tau)[kPointMajorPts],
                                                 float (&acc)[kPointMajorPts],
                                                 const float4* rows, int n) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 r = rows[j];
#pragma unroll
    for (int k = 0; k < kPointMajorPts; ++k) {
      const float ox = __fadd_rn(r.x, __fmul_rn(r.z, tau[k]));
      const float oy = __fadd_rn(r.y, __fmul_rn(r.w, tau[k]));
      const float d = dist_sq(x[k], y[k], ox, oy);
      acc[k] = kKeepNan ? min_nan(acc[k], d) : fminf(acc[k], d);
    }
  }
}

__global__ void __launch_bounds__(kPointMajorBlock) point_major_min_dist_kernel(
    const float* __restrict__ px, const float* __restrict__ py, int n_points,
    int steps, const float* __restrict__ rows, const float* __restrict__ vel,
    const float* __restrict__ dt, int n_rows,
    const int* __restrict__ active_points, float* __restrict__ out) {
  extern __shared__ float4 staged[];  // n_rows x (ox, oy, vx, vy)
  const int b = blockIdx.y;
  const long long robot0 = static_cast<long long>(b) * n_points;
  const int p0 = blockIdx.x * kPointMajorBlock * kPointMajorPts + threadIdx.x;
  const int active = active_points[b];
  const float step_dt = dt[b];
  const int stride_t = kPointMajorBlock % steps;
  bool flag = false;
  for (int i = threadIdx.x; i < n_rows; i += kPointMajorBlock) {
    const long long r = 2LL * (static_cast<long long>(b) * n_rows + i);
    const float4 row = make_float4(rows[r], rows[r + 1], vel[r], vel[r + 1]);
    flag |= !(both_finite(row.x, row.y) && both_finite(row.z, row.w));
    staged[i] = row;
  }
  float x[kPointMajorPts], y[kPointMajorPts], tau[kPointMajorPts];
  float acc[kPointMajorPts];
  bool live[kPointMajorPts];
  int t = p0 % steps;
#pragma unroll
  for (int k = 0; k < kPointMajorPts; ++k) {
    const int p = p0 + k * kPointMajorBlock;
    live[k] = p < n_points && t < active;
    x[k] = live[k] ? px[robot0 + p] : 0.0f;
    y[k] = live[k] ? py[robot0 + p] : 0.0f;
    tau[k] = __fmul_rn(static_cast<float>(t), step_dt);
    flag |= live[k] && !(both_finite(x[k], y[k]) && isfinite(tau[k]));
    acc[k] = CUDART_INF_F;
    t += stride_t;
    t -= t >= steps ? steps : 0;
  }
  // a barrier for the staged rows that also makes the flag block-uniform
  if (__syncthreads_or(flag)) {
    point_major_rows<true>(x, y, tau, acc, staged, n_rows);
  } else {
    point_major_rows<false>(x, y, tau, acc, staged, n_rows);
  }
#pragma unroll
  for (int k = 0; k < kPointMajorPts; ++k) {
    const int p = p0 + k * kPointMajorBlock;
    if (p < n_points) {
      out[robot0 + p] = live[k] ? acc[k] : CUDART_INF_F;
    }
  }
}

int launch_point_major(const float* px, const float* py, int batch,
                       int n_points, int steps, const float* rows,
                       const float* vel, const float* dt, int n_rows,
                       const int* active_points, float* out, void* stream) {
  const int per_block = kPointMajorBlock * kPointMajorPts;
  if (n_rows > kPointMajorMaxRows || n_points > INT_MAX - per_block) {
    return cudaErrorInvalidValue;  // the point indices stay in int
  }
  const dim3 grid((n_points + per_block - 1) / per_block, batch);
  const size_t shared = sizeof(float4) * n_rows;
  point_major_min_dist_kernel<<<grid, kPointMajorBlock, shared,
                              static_cast<cudaStream_t>(stream)>>>(
      px, py, n_points, steps, rows, vel, dt, n_rows, active_points, out);
  return static_cast<int>(cudaGetLastError());
}

// --- K1, K2, K4, K6: the static sweeps, several samples of one step per thread ---

constexpr int kStaticBlock = 128;  // threads per block
constexpr int kStaticTile = 1024;  // rows per staged tile

// A staged row: K1's (x, y); K2's, K4's and K6's (x, y, |o|^2, unused).
template <int kForm>
using StaticRow = std::conditional_t<kForm == kDirect, float2, float4>;

// Whether a value of a point or a staged row sets the block's flag: K1 a
// non-finite coordinate; K2, K4 and K6 a value above kTame in magnitude.
template <int kForm>
__device__ __forceinline__ bool flags(float x, float y, float o2) {
  if constexpr (kForm == kDirect) {
    return !both_finite(x, y);
  } else {
    return !(tame(x) && tame(y) && tame(o2));
  }
}

// Stage row i of the tile; returns whether it sets the flag.
template <int kForm>
__device__ __forceinline__ bool stage_row(StaticRow<kForm>* tile, int i,
                                          float x, float y) {
  if constexpr (kForm == kDirect) {
    tile[i] = make_float2(x, y);
    return flags<kDirect>(x, y, 0.0f);
  } else {
    const float o2 = norm_sq(x, y);
    tile[i] = make_float4(x, y, o2, 0.0f);
    return flags<kForm>(x, y, o2);
  }
}

// One pair; (a, b) is the point's operand<kForm> pair. The expanded form
// with the flag clear: every value is at most kTame, so 2 * cross (<
// 4e36) is exact and |o|^2 - 2 * cross rounds once either way; the FFMA
// saves the multiply. With the flag clear the broadcast pair stays below
// 4e36 + 1e18 too, so no pair is NaN and fminf is the NaN-keeping min.
template <int kForm, bool kKeepNan, typename Row>
__device__ __forceinline__ float static_pair(Row o, float a, float b) {
  if constexpr (kForm == kDirect) {
    return dist_sq(a, b, o.x, o.y);
  } else if constexpr (kForm == kExpanded && !kKeepNan) {
    const float cross = __fadd_rn(__fmul_rn(o.x, a), __fmul_rn(o.y, b));
    return __fmaf_rn(-2.0f, cross, o.z);
  } else {
    return norm_form<kForm>(o, a, b);
  }
}

template <int kForm, int kPts, bool kKeepNan>
__device__ __forceinline__ void static_tile(const float (&a)[kPts],
                                            const float (&b)[kPts],
                                            float (&acc)[kPts],
                                            const StaticRow<kForm>* tile,
                                            int rows) {
#pragma unroll 4
  for (int j = 0; j < rows; ++j) {
    const StaticRow<kForm> o = tile[j];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const float d = static_pair<kForm, kKeepNan>(o, a[k], b[k]);
      acc[k] = kKeepNan ? min_nan(acc[k], d) : fminf(acc[k], d);
    }
  }
}

// Running mins over `n` rows, row i at (xs[i*stride], ys[i*stride]),
// starting from the points' flag; once a tile sets it, later tiles keep
// the NaN-keeping min (fminf would drop a NaN already in the running
// min). Every thread of the block must call it: it stages tiles and
// synchronises.
template <int kForm, int kPts>
__device__ void static_rows(const float (&a)[kPts], const float (&b)[kPts],
                            float (&acc)[kPts], const float* __restrict__ xs,
                            const float* __restrict__ ys, int stride, int n,
                            bool keep_nan, StaticRow<kForm>* tile) {
  const int tiles = (n + kStaticTile - 1) / kStaticTile;
  for (int i = 0; i < tiles; ++i) {
    const int base = i * kStaticTile;
    const int rows = min(kStaticTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    bool flag = false;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const long long r = static_cast<long long>(base + i) * stride;
      flag |= stage_row<kForm>(tile, i, xs[r], ys[r]);
    }
    // a barrier that also makes the tile's flag block-uniform
    keep_nan = __syncthreads_or(flag) || keep_nan;
    if (keep_nan) {
      static_tile<kForm, kPts, true>(a, b, acc, tile, rows);
    } else {
      static_tile<kForm, kPts, false>(a, b, acc, tile, rows);
    }
  }
}

// One block: step t of robot b = blockIdx.y for samples run * kStaticBlock
// * kPts + threadIdx.x + k * kStaticBlock, with blockIdx.x = t * runs +
// run. kForm: kDirect (K1), kExpanded (K2; K4 with kSegments = false,
// which compiles the segment sweep and its stores out: seg_x, seg_y and
// out_seg are not read) or kBroadcast (K6). The launch bound of 7 blocks
// per SM caps a thread at 72 registers, what ptxas gives K1 at kPts = 8
// unasked; left to itself it gives K2 64 registers and spills, which
// measured slower on the H100.
template <int kForm, int kPts, bool kSegments>
__global__ void __launch_bounds__(kStaticBlock, 7) static_min_dist_kernel(
    const float* __restrict__ px, const float* __restrict__ py, int samples,
    int steps, int runs, const float* __restrict__ obs, int n_obs,
    const float* __restrict__ seg_x, const float* __restrict__ seg_y,
    int n_seg, const int* __restrict__ active_points,
    float* __restrict__ out_obs, float* __restrict__ out_seg) {
  // the staged rows: K1 8 KB, the others 16 KB
  __shared__ StaticRow<kForm> tile[kStaticTile];
  const int run = blockIdx.x % runs;
  const int t = blockIdx.x / runs;
  const int b = blockIdx.y;
  const int s0 = run * kStaticBlock * kPts + threadIdx.x;
  const long long point0 = static_cast<long long>(b) * samples * steps + t;
  if (t >= active_points[b]) {  // the whole block's step: no barrier skipped
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int s = s0 + k * kStaticBlock;
      if (s < samples) {
        out_obs[point0 + static_cast<long long>(s) * steps] = CUDART_INF_F;
        if constexpr (kSegments) {
          out_seg[point0 + static_cast<long long>(s) * steps] = CUDART_INF_F;
        }
      }
    }
    return;
  }
  // the samples' operand<kForm> pairs: (px, py), or K6's (-2px, -2py),
  // loaded into the arrays first and then turned into operands. With the
  // coordinates in locals instead, ptxas spills in K1 at kPts = 8 and K1
  // runs 4-8% slower on an H100 (chip_ab.py).
  float x[kPts], y[kPts], mo[kPts], ms[kPts];
  bool flag = false;
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int s = s0 + k * kStaticBlock;
    const long long p = point0 + static_cast<long long>(s) * steps;
    x[k] = s < samples ? px[p] : 0.0f;
    y[k] = s < samples ? py[p] : 0.0f;
    flag |= flags<kForm>(x[k], y[k], 0.0f);
    x[k] = operand<kForm>(x[k]);
    y[k] = operand<kForm>(y[k]);
    mo[k] = CUDART_INF_F;
    ms[k] = CUDART_INF_F;
  }
  const bool points_flag = __syncthreads_or(flag);
  const long long row0 = static_cast<long long>(b) * n_obs;
  const long long seg0 = static_cast<long long>(b) * n_seg;
  static_rows<kForm, kPts>(x, y, mo, obs + 2 * row0, obs + 2 * row0 + 1, 2,
                           n_obs, points_flag, tile);
  if constexpr (kSegments) {
    static_rows<kForm, kPts>(x, y, ms, seg_x + seg0, seg_y + seg0, 1, n_seg,
                             points_flag, tile);
  }
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int s = s0 + k * kStaticBlock;
    if (s < samples) {
      if constexpr (kForm == kExpanded) {
        const float pnorm = norm_sq(x[k], y[k]);
        mo[k] = finish_expanded(mo[k], pnorm);
        ms[k] = finish_expanded(ms[k], pnorm);
      } else if constexpr (kForm == kBroadcast) {
        const long long p = point0 + static_cast<long long>(s) * steps;
        const float pnorm = norm_sq(px[p], py[p]);
        mo[k] = finish_expanded(mo[k], pnorm);
        ms[k] = finish_expanded(ms[k], pnorm);
      }
      out_obs[point0 + static_cast<long long>(s) * steps] = mo[k];
      if constexpr (kSegments) {
        out_seg[point0 + static_cast<long long>(s) * steps] = ms[k];
      }
    }
  }
}

template <int kForm, int kPts, bool kSegments>
int launch_static_points(const float* px, const float* py, int batch,
                         int samples, int steps, const float* obs, int n_obs,
                         const float* seg_x, const float* seg_y, int n_seg,
                         const int* active_points, float* out_obs,
                         float* out_seg, void* stream) {
  const int per_block = kStaticBlock * kPts;
  const int runs = (samples + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(runs) * steps, batch);
  static_min_dist_kernel<kForm, kPts, kSegments>
      <<<grid, kStaticBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          px, py, samples, steps, runs, obs, n_obs, seg_x, seg_y, n_seg,
          active_points, out_obs, out_seg);
  return static_cast<int>(cudaGetLastError());
}

template <int kForm, bool kSegments = true>
int launch_static(const float* px, const float* py, int batch, int n_points,
                  int steps, const float* obs, int n_obs, const float* seg_x,
                  const float* seg_y, int n_seg, const int* active_points,
                  float* out_obs, float* out_seg, int points, void* stream) {
  const int samples = n_points / steps;
  switch (points) {
    case 2:
      return launch_static_points<kForm, 2, kSegments>(
          px, py, batch, samples, steps, obs, n_obs, seg_x, seg_y, n_seg,
          active_points, out_obs, out_seg, stream);
    case 8:
      return launch_static_points<kForm, 8, kSegments>(
          px, py, batch, samples, steps, obs, n_obs, seg_x, seg_y, n_seg,
          active_points, out_obs, out_seg, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes (all f32 contiguous unless noted, B = batch robots):
//   px, py: [B, S, T] (n_points = S * T, steps = T);
//   obs: [B, n_obs, 2]; seg_x, seg_y: [B, n_seg];
//   active_points: [B] int32 on the device;
//   out_obs, out_seg: [B, S, T];
//   points: samples per thread, 2 or 8 (ops/kernels.py::sweep_points).
// Launches on `stream` and does not synchronise. Returns
// cudaErrorInvalidValue for another `points`, else cudaGetLastError()
// after the launch.
extern "C" int kompass_fused_min_dist_sq(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, int n_obs, const float* seg_x, const float* seg_y,
    int n_seg, const int* active_points, float* out_obs, float* out_seg,
    int points, void* stream) {
  return launch_static<kDirect>(px, py, batch, n_points, steps, obs, n_obs,
                                seg_x, seg_y, n_seg, active_points, out_obs,
                                out_seg, points, stream);
}

// K2: both sweeps in the expanded form; arguments as for
// kompass_fused_min_dist_sq.
extern "C" int kompass_fused_min_dist_sq_expanded(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, int n_obs, const float* seg_x, const float* seg_y,
    int n_seg, const int* active_points, float* out_obs, float* out_seg,
    int points, void* stream) {
  return launch_static<kExpanded>(px, py, batch, n_points, steps, obs, n_obs,
                                  seg_x, seg_y, n_seg, active_points, out_obs,
                                  out_seg, points, stream);
}

// K6: both sweeps in the broadcast form; arguments as for
// kompass_fused_min_dist_sq.
extern "C" int kompass_fused_min_dist_sq_broadcast(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, int n_obs, const float* seg_x, const float* seg_y,
    int n_seg, const int* active_points, float* out_obs, float* out_seg,
    int points, void* stream) {
  return launch_static<kBroadcast>(px, py, batch, n_points, steps, obs, n_obs,
                                   seg_x, seg_y, n_seg, active_points, out_obs,
                                   out_seg, points, stream);
}

// K4: one expanded sweep of [B, S, T] points against rows [B, n_rows, 2]
// into out [B, S, T]; the rest as for kompass_fused_min_dist_sq.
extern "C" int kompass_min_dist_sq_expanded(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* rows, int n_rows, const int* active_points, float* out,
    int points, void* stream) {
  return launch_static<kExpanded, false>(px, py, batch, n_points, steps, rows,
                                         n_rows, nullptr, nullptr, 0,
                                         active_points, out, nullptr, points,
                                         stream);
}

// K3, the moving sweep in the direct form: as kompass_fused_min_dist_sq,
// without points, plus obs_vel [B, n_obs, 2] (pad rows zero) and dt [B],
// the per-robot control step.
extern "C" int kompass_fused_min_dist_sq_moving(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, const float* obs_vel, const float* dt, int n_obs,
    const float* seg_x, const float* seg_y, int n_seg,
    const int* active_points, float* out_obs, float* out_seg, void* stream) {
  return launch_moving<kDirect>(px, py, batch, n_points, steps, obs, obs_vel,
                                dt, n_obs, seg_x, seg_y, n_seg, active_points,
                                out_obs, out_seg, stream);
}

// K3s, K3's moving obstacle sweep alone: [B, S, T] points against rows
// [B, n_rows, 2] moving at vel [B, n_rows, 2] (pad rows zero) into out
// [B, S, T]; dt [B]. point_major: 1 for point_major_min_dist_kernel (at most
// kPointMajorMaxRows rows), 0 for moving_min_dist_kernel. Launches on
// `stream`; returns cudaErrorInvalidValue for rows or points the chosen
// kernel does not take, else cudaGetLastError().
extern "C" int kompass_min_dist_sq_moving(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* rows, const float* vel, const float* dt, int n_rows,
    const int* active_points, float* out, int point_major, void* stream) {
  if (point_major) {
    return launch_point_major(px, py, batch, n_points, steps, rows, vel, dt,
                              n_rows, active_points, out, stream);
  }
  return launch_moving<kDirect, false>(px, py, batch, n_points, steps, rows,
                                       vel, dt, n_rows, nullptr, nullptr, 0,
                                       active_points, out, nullptr, stream);
}

// K7, the moving sweep's 7-feature dot; arguments as for
// kompass_fused_min_dist_sq_moving.
extern "C" int kompass_fused_min_dist_sq_moving_expanded(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, const float* obs_vel, const float* dt, int n_obs,
    const float* seg_x, const float* seg_y, int n_seg,
    const int* active_points, float* out_obs, float* out_seg, void* stream) {
  return launch_moving<kExpanded>(px, py, batch, n_points, steps, obs,
                                  obs_vel, dt, n_obs, seg_x, seg_y, n_seg,
                                  active_points, out_obs, out_seg, stream);
}

// K8, the moving sweep's 7-feature left fold; arguments as for
// kompass_fused_min_dist_sq_moving.
extern "C" int kompass_fused_min_dist_sq_moving_broadcast(
    const float* px, const float* py, int batch, int n_points, int steps,
    const float* obs, const float* obs_vel, const float* dt, int n_obs,
    const float* seg_x, const float* seg_y, int n_seg,
    const int* active_points, float* out_obs, float* out_seg, void* stream) {
  return launch_moving<kBroadcast>(px, py, batch, n_points, steps, obs,
                                   obs_vel, dt, n_obs, seg_x, seg_y, n_seg,
                                   active_points, out_obs, out_seg, stream);
}
