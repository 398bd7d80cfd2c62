// The occupancy mapper's per-cell pass, with a robot axis.
//
// Replaces the TPU kernel kompass_core_tpu/ops/mapping.py::
// _banded_lookup_dot_pallas (K5): per 16x16 cell tile, a one-hot of each
// cell's bin times a window of the [B, 35] bf16 beam table, which
// delivers each cell's 5 candidate beams (endpoint cell, range,
// validity). On this card the lookup is a plain indexed read, so the
// kernel also does what the JAX package does with the candidates right
// after (_line_membership, the combine of scan_to_grid and, in the
// Bayesian form, scan_to_grid_bayesian / bayes_cell_update):
//
//   for each cell (i, j) of robot r, candidate k = 0..4 reads the table
//   row of bin (base[i, j] + k - 2) mod B. The cell is EMPTY-covered by
//   a valid candidate when it passes the diamond (super-cover) test
//   against the line from the sensor cell to the candidate's endpoint
//   cell; OCCUPIED where endpoint[r, i, j] (the beam-side scatter), else
//   EMPTY where covered, else UNEXPLORED. The Bayesian form takes the
//   nearest covering candidate (offsets 0, -1, +1, -2, +2 in turn, the
//   JAX package's first argmax of -|k - 2|), applies the inverse sensor
//   model at the cell's distance and Bayes-fuses it with prev[r, i, j];
//   uncovered cells hold p_prior.
//
// What bounds it on Hopper: memory. Per cell it reads a 4-byte nearest
// bin, a 4-byte distance, a 1-byte endpoint flag, 4 bytes of previous
// probability and writes 4 + 4 bytes; the 5 table rows (16 bytes each)
// are shared by neighbouring cells and stay in L1 / L2. A 400 x 400 grid
// is about 3.4 MB of traffic, about 1 us at 3.35 TB/s; a 64-robot batch
// about 133 MB, about 40 us. The arithmetic (5 line tests of ~20 flops)
// is far below the FP32 rate.
//
// Design (simple and right first):
//   * one thread per cell, 256-thread blocks over one robot's H * W
//     cells; the grid's second dimension is the robot;
//   * the beam table rows (e_i, e_j, range bits, valid) are int4s read
//     through the read-only cache; nothing is staged in shared memory;
//   * each cell's nearest bin comes from the per-spec geometry computed
//     once on the host, never from an atan2f here, so the card and the
//     CPU read the same bins.
//
// Exactness: every + - * / sqrt is a __f*_rn intrinsic, so nvcc cannot
// contract them into FMAs. Where the JAX package's XLA CPU program fuses
// an FMA (the squared line length, the inverse sensor model, the odds
// denominator), the kernel computes a * b + c in double and rounds to
// float, as the plain PyTorch version does. The result equals the plain
// version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // threads (= cells) per block
constexpr int kOccupied = 100;
constexpr int kEmpty = 0;
constexpr int kUnexplored = -1;

// a * b + c in double, rounded once more to float: the plain version's
// _fma, and XLA's float FMA unless the double sum falls on a float midpoint
__device__ __forceinline__ float fma_via_double(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// The diamond test of the cell at (di, dj) from the sensor cell against
// the line to endpoint offset (vx, vy) (_line_membership).
__device__ __forceinline__ bool on_line(float di, float dj, float vx,
                                        float vy) {
  const float len = __fsqrt_rn(fma_via_double(vx, vx, __fmul_rn(vy, vy)));
  const float len_safe = fmaxf(len, 1e-6f);
  const float t = __fdiv_rn(__fadd_rn(__fmul_rn(di, vx), __fmul_rn(dj, vy)),
                            len_safe);
  const float perp = __fdiv_rn(
      fabsf(__fsub_rn(__fmul_rn(di, vy), __fmul_rn(dj, vx))), len_safe);
  const float halfwidth = __fadd_rn(
      __fdiv_rn(__fadd_rn(fabsf(vx), fabsf(vy)), __fmul_rn(2.0f, len_safe)),
      1e-4f);
  return t >= -0.5f && t <= len && perp <= halfwidth && len > 0.0f;
}

// updateGridCellProbability in the JAX package's operation order.
// params: p_prior, p_empty, p_occupied, range_sure, range_max, wall_size.
__device__ __forceinline__ float bayes_update(float dist, float range,
                                              float prev,
                                              const float* __restrict__ params) {
  const float p_prior = __ldg(params + 0);
  const float p_empty = __ldg(params + 1);
  const float p_occupied = __ldg(params + 2);
  const float range_sure = __ldg(params + 3);
  const float range_max = __ldg(params + 4);
  const float wall_size = __ldg(params + 5);
  const float p_f = dist < __fsub_rn(range, wall_size) ? p_empty : p_occupied;
  const float delta = dist < range_sure ? 0.0f : 1.0f;
  const float a = __fdiv_rn(__fsub_rn(dist, range_sure), range_max);
  const float p_sensor =
      fma_via_double(__fmul_rn(delta, a), __fsub_rn(p_prior, p_f), p_f);
  const float odds =
      __fmul_rn(__fdiv_rn(prev, __fsub_rn(1.0f, prev)),
                __fdiv_rn(p_sensor, __fsub_rn(1.0f, p_sensor)));
  const float k = __fdiv_rn(__fsub_rn(1.0f, p_prior), p_prior);
  return __fsub_rn(1.0f, __fdiv_rn(1.0f, fma_via_double(odds, k, 1.0f)));
}

// One block: kBlock cells of robot blockIdx.y. kBayes selects the
// Bayesian form (prev, params and prob are then used).
template <bool kBayes>
__global__ void __launch_bounds__(kBlock) scan_to_grid_cells_kernel(
    const int* __restrict__ base, const float* __restrict__ dist_m,
    int n_cells, int width, const int4* __restrict__ tables, int n_bins,
    const unsigned char* __restrict__ endpoint, int start_i, int start_j,
    const float* __restrict__ prev, const float* __restrict__ params,
    int* __restrict__ occ, float* __restrict__ prob) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  const long long o = static_cast<long long>(blockIdx.y) * n_cells + cell;
  const int4* tab = tables + static_cast<long long>(blockIdx.y) * n_bins;
  const int i = cell / width;
  const float di = static_cast<float>(i - start_i);
  const float dj = static_cast<float>(cell - i * width - start_j);
  const int nearest = __ldg(base + cell);
  bool covered = false;
  float range = 0.0f;
  // candidate offsets nearest first: 0, -1, +1, -2, +2
#pragma unroll
  for (int n = 0; n < 5; ++n) {
    const int offset = (n + 1) / 2 * (n % 2 ? -1 : 1);
    int bin = (nearest + offset) % n_bins;
    bin += bin < 0 ? n_bins : 0;
    const int4 row = __ldg(tab + bin);
    if (row.w != 0 &&
        on_line(di, dj, static_cast<float>(row.x - start_i),
                static_cast<float>(row.y - start_j))) {
      covered = true;
      range = __int_as_float(row.z);
      break;
    }
  }
  occ[o] = endpoint[o] ? kOccupied : (covered ? kEmpty : kUnexplored);
  if (kBayes) {
    prob[o] = covered ? bayes_update(__ldg(dist_m + cell), range, prev[o],
                                     params)
                      : __ldg(params);
  }
}

}  // namespace

// Shapes (all contiguous, R = robots):
//   base: [H * W] int32, each cell's nearest bin in [0, n_bins);
//   dist_m: [H * W] f32; tables: [R, n_bins, 4] int32 (endpoint i, j,
//   range as f32 bits, valid); endpoint: [R, H * W] bool (one byte);
//   prev: [R, H * W] f32 and params: [6] f32 for the Bayesian form, both
//   null for the plain form; occ: [R, H * W] int32; prob: [R, H * W] f32
//   (null for the plain form).
// Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int kompass_scan_to_grid_cells(
    const int* base, const float* dist_m, int n_cells, int width,
    const int* tables, int n_bins, const unsigned char* endpoint,
    int start_i, int start_j, const float* prev, const float* params,
    int robots, int* occ, float* prob, void* stream) {
  const dim3 grid((n_cells + kBlock - 1) / kBlock, robots);
  const auto* tab = reinterpret_cast<const int4*>(tables);
  auto s = static_cast<cudaStream_t>(stream);
  if (prev != nullptr) {
    scan_to_grid_cells_kernel<true><<<grid, kBlock, 0, s>>>(
        base, dist_m, n_cells, width, tab, n_bins, endpoint, start_i,
        start_j, prev, params, occ, prob);
  } else {
    scan_to_grid_cells_kernel<false><<<grid, kBlock, 0, s>>>(
        base, dist_m, n_cells, width, tab, n_bins, endpoint, start_i,
        start_j, nullptr, nullptr, occ, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
