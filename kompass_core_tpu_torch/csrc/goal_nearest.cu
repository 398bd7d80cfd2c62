// K10: the goal cost's nearest tracked-segment point, with a robot axis.
//
// For every robot b and every sample s of its S trajectories, one pass over
// the robot's G padded segment points g computes
//   d2[b, s, g] = (ex - gx)^2 + (ey - gy)^2,  (ex, ey) = end[b, s],
//   min_d2[b, s] = min over g of d2[b, s, g],
//   index[b, s]  = the first g that holds that minimum,
// the search of the DWA goal cost (ops/solver.py::_goal_cost), as the
// JAX package computes it (kompass_core_tpu/ops/solver.py:571 _goal_cost:
// the [S, G] distances, their argmin and min). It replaces no TPU kernel:
// the JAX package leaves this search to XLA, and the port's plain version
// wrote the [B, S, G] distances to device memory in seven operations
// (two subtractions, two products, the sum, argmin, amin), about 2.65 GB a
// tensor for 1024 robots at G = 320.
//
// What bounds it on Hopper: FP32 issue. The inputs and outputs are a few
// MB; a (sample, point) pair is 8 instructions: 2 FADD for the difference,
// 2 FMUL and an FADD for the square, and the running (min, index) as a
// compare and two selects. So the design keeps everything but the pair's
// own arithmetic out of the loop:
//   * a block serves one robot (blockIdx.y) and a run of its samples
//     (blockIdx.x); it stages the robot's segment points in shared memory
//     as float2, in tiles of kTile points when G is larger;
//   * each thread holds kPts samples' end points in registers, so one
//     broadcast shared-memory read of a point (LDS.64) feeds kPts pairs,
//     and keeps a running (min, index) per sample;
//   * where B * S samples cannot fill the card at one sample group per
//     thread (one robot's 2025 samples, the cost evaluator's 5001), a warp
//     splits G across its lanes instead: lane l takes the points l, l + 32,
//     ... of the warp's kPts samples, and the lanes merge their (min,
//     index) with shuffles, the lower index on ties.
// The launch parameters (kPts, and whether a warp splits G) come from the
// shapes, in Python (ops/kernels.py::goal_layout); every one gives the same
// bits.
//
// Rounding: every operation is rounded on its own (__f*_rn, no FMA
// contraction), as the plain PyTorch version and XLA without FMA compute
// it, so the kernel equals the plain version bit for bit. The minimum is
// taken with a strict < in index order, so the first minimum wins; a sum
// of squares is >= +0, so the sign of a zero never shows.
//
// NaN: torch.amin keeps a NaN and torch.argmin returns the first NaN's
// index (a NaN ranks below every number). The running min is the plain
// strict < unless the block's flag is set (reduced with __syncthreads_or,
// so the choice is block-uniform): an end point or a staged segment point
// above 1e18 in magnitude (NaN and inf included). Below that no
// difference, square or sum overflows, so no distance is NaN. Once set
// the flag stays, and the NaN-ranking min runs for the rest of the sweep.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 128;  // threads per block: 4 warps
constexpr int kWarp = 32;
constexpr int kTile = 1024;  // segment points per staged tile (8 KB)
constexpr float kTame = 1e18f;

__device__ __forceinline__ bool tame(float v) { return fabsf(v) <= kTame; }

__device__ __forceinline__ float pair_d2(float ex, float ey, float2 g) {
  const float dx = __fsub_rn(ex, g.x);
  const float dy = __fsub_rn(ey, g.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Fold the pair at point j into the running (m, idx), points in index
// order: a strict <, so the first minimum stays; with kKeepNan a NaN also
// replaces a number (torch.argmin's first NaN).
template <bool kKeepNan>
__device__ __forceinline__ void take(float d, int j, float& m, int& idx) {
  const bool better = kKeepNan ? (d < m || (d != d && m == m)) : d < m;
  if (better) {
    m = d;
    idx = j;
  }
}

// Whether (m2, i2) replaces (m1, i1) when two lanes' results merge: a NaN
// ranks below every number, then the smaller value, then the lower index.
__device__ __forceinline__ bool merged_better(float m2, int i2, float m1,
                                              int i1) {
  const bool n1 = m1 != m1;
  const bool n2 = m2 != m2;
  if (n1 || n2) {
    return n2 && (!n1 || i2 < i1);
  }
  return m2 < m1 || (m2 == m1 && i2 < i1);
}

// One tile of n points, staged from point base on. kSplit: lane l of the
// warp takes the points l, l + 32, ...; else every point.
template <int kPts, bool kSplit, bool kKeepNan>
__device__ __forceinline__ void goal_tile(const float (&ex)[kPts],
                                          const float (&ey)[kPts],
                                          float (&m)[kPts], int (&idx)[kPts],
                                          const float2* tile, int n, int base,
                                          int lane) {
  const int first = kSplit ? lane : 0;
  const int stride = kSplit ? kWarp : 1;
#pragma unroll 4
  for (int j = first; j < n; j += stride) {
    const float2 g = tile[j];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      take<kKeepNan>(pair_d2(ex[k], ey[k], g), base + j, m[k], idx[k]);
    }
  }
}

// A block: robot b = blockIdx.y, samples of run blockIdx.x. Without
// kSplit, thread x holds the samples run * kBlock * kPts + x + k * kBlock;
// with it, warp w holds (run * kBlock / 32 + w) * kPts + k in every lane.
template <int kPts, bool kSplit>
__global__ void __launch_bounds__(kBlock) goal_nearest_kernel(
    const float* __restrict__ end_x, const float* __restrict__ end_y,
    int samples, const float* __restrict__ seg_x,
    const float* __restrict__ seg_y, int seg_points,
    float* __restrict__ min_d2, long long* __restrict__ index) {
  __shared__ float2 tile[kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const long long row = static_cast<long long>(b) * samples;
  int sample[kPts];
  float ex[kPts], ey[kPts], m[kPts];
  int idx[kPts];
  bool flag = false;
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    sample[k] = kSplit
        ? (blockIdx.x * (kBlock / kWarp) + threadIdx.x / kWarp) * kPts + k
        : blockIdx.x * kBlock * kPts + threadIdx.x + k * kBlock;
    const bool in = sample[k] < samples;
    ex[k] = in ? end_x[row + sample[k]] : 0.0f;
    ey[k] = in ? end_y[row + sample[k]] : 0.0f;
    flag |= !(tame(ex[k]) && tame(ey[k]));
    m[k] = CUDART_INF_F;
    // the first point the thread visits: a lane past G visits none and
    // loses every merge (INT_MAX), an all-+inf row keeps its first point
    idx[k] = kSplit ? (lane < seg_points ? lane : INT_MAX) : 0;
  }
  bool keep_nan = __syncthreads_or(flag);
  const long long seg0 = static_cast<long long>(b) * seg_points;
  for (int base = 0; base < seg_points; base += kTile) {
    const int n = min(kTile, seg_points - base);
    __syncthreads();  // the previous tile is no longer read
    bool wild = false;
    for (int i = threadIdx.x; i < n; i += kBlock) {
      const float gx = seg_x[seg0 + base + i];
      const float gy = seg_y[seg0 + base + i];
      wild |= !(tame(gx) && tame(gy));
      tile[i] = make_float2(gx, gy);
    }
    // a barrier that also makes the tile's flag block-uniform; once set it
    // stays (the plain < would pass over a NaN already in the running min)
    keep_nan = __syncthreads_or(wild) || keep_nan;
    if (keep_nan) {
      goal_tile<kPts, kSplit, true>(ex, ey, m, idx, tile, n, base, lane);
    } else {
      goal_tile<kPts, kSplit, false>(ex, ey, m, idx, tile, n, base, lane);
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[k], offset);
        const int i2 = __shfl_xor_sync(0xffffffffu, idx[k], offset);
        if (merged_better(m2, i2, m[k], idx[k])) {
          m[k] = m2;
          idx[k] = i2;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const bool writes = kSplit ? lane == k : true;
    if (writes && sample[k] < samples) {
      min_d2[row + sample[k]] = m[k];
      index[row + sample[k]] = idx[k];
    }
  }
}

template <int kPts, bool kSplit>
int launch(const float* end_x, const float* end_y, int batch, int samples,
           const float* seg_x, const float* seg_y, int seg_points,
           float* min_d2, long long* index, void* stream) {
  const int per_block = kSplit ? kBlock / kWarp * kPts : kBlock * kPts;
  const int runs = (samples + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(runs), batch);
  goal_nearest_kernel<kPts, kSplit>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          end_x, end_y, samples, seg_x, seg_y, seg_points, min_d2, index);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes (f32 contiguous unless noted, B = batch robots): end_x, end_y:
// [B, S]; seg_x, seg_y: [B, G], G >= 1; min_d2: [B, S] f32; index: [B, S]
// int64. points: samples per thread (2 with split = 0, 4 with split = 1:
// ops/kernels.py::GOAL_LAYOUTS). Launches on `stream` and does not
// synchronise. Returns cudaErrorInvalidValue for another layout, else
// cudaGetLastError() after the launch.
extern "C" int kompass_goal_nearest(const float* end_x, const float* end_y,
                                    int batch, int samples, const float* seg_x,
                                    const float* seg_y, int seg_points,
                                    float* min_d2, long long* index, int points,
                                    int split, void* stream) {
  if (split == 0 && points == 2) {
    return launch<2, false>(end_x, end_y, batch, samples, seg_x, seg_y,
                            seg_points, min_d2, index, stream);
  }
  if (split == 1 && points == 4) {
    return launch<4, true>(end_x, end_y, batch, samples, seg_x, seg_y,
                           seg_points, min_d2, index, stream);
  }
  return cudaErrorInvalidValue;
}
