// Fused obstacle + tracked-segment min-distance sweep for the DWA tick.
//
// Replaces the TPU kernel kompass_core_tpu/ops/pallas_kernels.py
// ::_fused_kernel_vpu (reached through fused_min_dist_sq): one pass over
// the rollout points computes, for every point p of the [S, T] rollout,
//   d2_obs[p] = min over obstacle rows o of |p - o|^2
//   d2_seg[p] = min over tracked-segment rows g of |p - g|^2
// and writes +inf where the step index t >= active_points.
//
// What bounds it on Hopper: FP32 ALU throughput. At the flagship tick
// (60,750 points x (512 + 384) rows, ~54 M pairs) the kernel reads a few
// hundred KB and does ~7 FP32 instructions per pair; every byte it needs
// fits in L2, so memory is not the limit.
//
// Design (simple and right first):
//   * one thread per point, 256-thread blocks over the S*T points;
//   * obstacle rows, then segment rows, are staged through shared memory
//     in tiles of 512 (x, y) pairs; every thread reads the same row at the
//     same time, so the shared-memory read is a broadcast;
//   * the running min lives in a register;
//   * the ragged last tile and the ragged last block are masked: threads
//     past the last point still help stage tiles and reach every barrier.
//
// Why the direct form (px-ox)^2 + (py-oy)^2 and not the TPU kernel's
// |o|^2 - 2 p.o + |p|^2 expansion: the expansion cancels at ~10 m
// coordinates (|o|^2 * 2^-24 ~ 6e-6 m^2 of error against centimetre
// collision margins). The TPU needed it to feed its matrix unit; this
// card runs the direct form on its FP32 cores. The intrinsics below round
// each operation on its own, so nvcc cannot contract the expression into
// FMAs. The result is then bit-identical to the plain PyTorch version,
// which evaluates the same operations one by one: a min is exact in any
// order. The min propagates NaN like torch.amin.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 256;  // threads (= points) per block
constexpr int kTile = 512;   // rows staged in shared memory per tile

__device__ __forceinline__ float dist_sq(float px, float py, float2 o) {
  const float dx = __fsub_rn(px, o.x);
  const float dy = __fsub_rn(py, o.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
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
      acc = min_nan(acc, dist_sq(px, py, tile[j]));
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kBlock) fused_min_dist_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    int n_points, int steps, const float* __restrict__ obs, int n_obs,
    const float* __restrict__ seg_x, const float* __restrict__ seg_y,
    int n_seg, const int* __restrict__ active_points,
    float* __restrict__ out_obs, float* __restrict__ out_seg) {
  __shared__ float2 tile[kTile];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < n_points;
  const float x = live ? px[p] : 0.0f;
  const float y = live ? py[p] : 0.0f;
  const float mo = sweep(x, y, obs, obs + 1, 2, n_obs, tile);
  const float ms = sweep(x, y, seg_x, seg_y, 1, n_seg, tile);
  if (live) {
    const bool active = (p % steps) < *active_points;
    out_obs[p] = active ? mo : CUDART_INF_F;
    out_seg[p] = active ? ms : CUDART_INF_F;
  }
}

}  // namespace

// px, py: [S, T] f32 contiguous (n_points = S * T, steps = T);
// obs: [n_obs, 2] f32 contiguous; seg_x, seg_y: [n_seg] f32 contiguous;
// active_points: pointer to one int32 on the device;
// out_obs, out_seg: [S, T] f32. Launches on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launch.
extern "C" int kompass_fused_min_dist_sq(
    const float* px, const float* py, int n_points, int steps,
    const float* obs, int n_obs, const float* seg_x, const float* seg_y,
    int n_seg, const int* active_points, float* out_obs, float* out_seg,
    void* stream) {
  const int blocks = (n_points + kBlock - 1) / kBlock;
  fused_min_dist_kernel<<<blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      px, py, n_points, steps, obs, n_obs, seg_x, seg_y, n_seg,
      active_points, out_obs, out_seg);
  return static_cast<int>(cudaGetLastError());
}
