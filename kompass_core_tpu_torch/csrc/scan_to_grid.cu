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
// What bounds it on Hopper: memory. Per cell and robot it reads a 1-byte
// endpoint flag and 4 bytes of previous probability and writes 4 + 4
// bytes (the nearest bin and the distance are shared by the robots; the
// 5 beams' rows, 32 bytes each, by neighbouring cells). A 64-robot batch
// of 400 x 400 cells is about 133 MB, about 40 us at 3.35 TB/s.
//
// Design: two launches in one call.
//   * the beam pass, one thread per (robot, beam): what depends only on
//     the beam, the line test's bounds on the numerators of t and perp
//     (ops/kernels.py::line_test_bounds, the same operations in the same
//     order), into a scratch row of 16 bytes beside the beam's table row.
//     With them each of the JAX package's three divisions becomes one
//     compare with the same outcome. It runs here, not in plain PyTorch
//     on the beam side: there it took a few dozen more small launches,
//     and the mapper update is host-bound on its launches;
//   * the cell pass: one thread per cell, a block per 32 x 8 tile of one
//     robot's cells (a warp per row of the tile: coalesced, and
//     neighbouring cells read the same table rows); the grid's third
//     dimension is the robot;
//   * the loads that do not depend on the table (nearest bin, endpoint
//     flag, and in the Bayesian form the previous probability, the
//     distance and the model's scalars) are issued before the table
//     reads, so the latencies overlap;
//   * a candidate test is 4 multiplies, 2 adds and 3 compares against
//     the beam's bounds: no square root, no division, no float64;
//   * the 5 candidates' rows are all read up front and tested without a
//     branch, the nearest covering one taking precedence, so a warp does
//     not diverge on the number of candidates tested;
//   * the Bayesian form's constant (1 - p_prior) / p_prior comes in
//     params[6];
//   * the rows are read through the read-only cache: a robot's table
//     (3600 rows, 115 KB) stays in L1 / L2. Staging each block's window of
//     rows in shared memory, as the TPU kernel staged its window, was
//     measured 18% slower at 64 robots x 400 x 400 (its block-wide
//     min/max reduction and barriers cost more than the L1 hits it
//     replaced), so it is not done;
//   * each cell's nearest bin comes from the per-spec geometry computed
//     once on the host, never from an atan2f here, so the card and the
//     CPU read the same bins.
//
// Exactness: every + - * / is a __f*_rn intrinsic, so nvcc cannot
// contract them into FMAs. Where the JAX package's XLA CPU program fuses
// an FMA (the inverse sensor model, the odds denominator), the kernel
// computes a * b + c in double and rounds to float, as the plain PyTorch
// version does; the beam pass takes its square root in double and rounds
// it, as the plain version's _sqrt does. The result equals the plain
// version bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileW = 32;  // a block's cells: 32 columns (one warp per row)
constexpr int kTileH = 8;   // ... by 8 rows
constexpr int kCandidates = 5;
constexpr int kOccupied = 100;
constexpr int kEmpty = 0;
constexpr int kUnexplored = -1;

// One beam's table row, (e_i, e_j, range bits, valid), and its bounds,
// (t_lo, t_hi, p_hi bits, 0).
struct Row {
  int4 a;
  int4 b;
};

// a * b + c in double, rounded once more to float: the plain version's
// _fma, and XLA's float FMA unless the double sum falls on a float midpoint
__device__ __forceinline__ float fma_via_double(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// The largest float F with RN(n / d) <= h exactly when n <= F, for d > 0
// and h a positive normal float (ops/kernels.py::_quotient_bound): the
// midpoint of h and its successor, times d, is exact in double and never a
// float, and F is the largest float below it.
__device__ __forceinline__ float quotient_bound(float h, float d) {
  const double a = __dmul_rn(
      __dmul_rn(__dadd_rn(static_cast<double>(h),
                          static_cast<double>(nextafterf(h, CUDART_INF_F))),
                0.5),
      static_cast<double>(d));
  const float f = __double2float_rn(a);
  return static_cast<double>(f) > a ? nextafterf(f, -CUDART_INF_F) : f;
}

// The beam pass: the bounds of beam k (robot-major) of the line from the
// sensor cell (si, sj) to its endpoint cell; t_hi = -inf for a zero-length
// line, which covers no cell.
__global__ void beam_bounds_kernel(const int4* __restrict__ tables, int n,
                                   int si, int sj, int4* __restrict__ bounds) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int4 row = tables[k];
  const float vx = static_cast<float>(row.x - si);
  const float vy = static_cast<float>(row.y - sj);
  const float len = __double2float_rn(__dsqrt_rn(
      static_cast<double>(fma_via_double(vx, vx, __fmul_rn(vy, vy)))));
  const float len_safe = len < 1e-6f ? 1e-6f : len;
  const float halfwidth =
      __fadd_rn(__fdiv_rn(__fadd_rn(fabsf(vx), fabsf(vy)),
                          __fmul_rn(2.0f, len_safe)),
                1e-4f);
  const float t_hi =
      len > 0.0f ? quotient_bound(len, len_safe) : -CUDART_INF_F;
  bounds[k] = make_int4(__float_as_int(-quotient_bound(0.5f, len_safe)),
                        __float_as_int(t_hi),
                        __float_as_int(quotient_bound(halfwidth, len_safe)),
                        0);
}

// The diamond test of the cell at (di, dj) from the sensor cell (si, sj)
// against the beam's line, by its bounds (ops/kernels.py::line_test_bounds).
__device__ __forceinline__ bool on_line(float di, float dj, int si, int sj,
                                        const Row& row) {
  const float vx = static_cast<float>(row.a.x - si);
  const float vy = static_cast<float>(row.a.y - sj);
  const float n_t = __fadd_rn(__fmul_rn(di, vx), __fmul_rn(dj, vy));
  const float n_p = fabsf(__fsub_rn(__fmul_rn(di, vy), __fmul_rn(dj, vx)));
  return row.a.w != 0 && n_t >= __int_as_float(row.b.x) &&
         n_t <= __int_as_float(row.b.y) && n_p <= __int_as_float(row.b.z);
}

// The inverse sensor model's scalars: p_prior, p_empty, p_occupied,
// range_sure, range_max, wall_size and k = (1 - p_prior) / p_prior.
struct Model {
  float p_prior, p_empty, p_occupied, range_sure, range_max, wall_size, k;
};

__device__ __forceinline__ Model load_model(const float* __restrict__ params) {
  return Model{__ldg(params + 0), __ldg(params + 1), __ldg(params + 2),
               __ldg(params + 3), __ldg(params + 4), __ldg(params + 5),
               __ldg(params + 6)};
}

// updateGridCellProbability in the JAX package's operation order.
__device__ __forceinline__ float bayes_update(float dist, float range,
                                              float prev, const Model& m) {
  const float p_f =
      dist < __fsub_rn(range, m.wall_size) ? m.p_empty : m.p_occupied;
  const float delta = dist < m.range_sure ? 0.0f : 1.0f;
  const float a = __fdiv_rn(__fsub_rn(dist, m.range_sure), m.range_max);
  const float p_sensor =
      fma_via_double(__fmul_rn(delta, a), __fsub_rn(m.p_prior, p_f), p_f);
  const float odds =
      __fmul_rn(__fdiv_rn(prev, __fsub_rn(1.0f, prev)),
                __fdiv_rn(p_sensor, __fsub_rn(1.0f, p_sensor)));
  return __fsub_rn(1.0f, __fdiv_rn(1.0f, fma_via_double(odds, m.k, 1.0f)));
}

__device__ __forceinline__ Row load_row(const int4* __restrict__ tab,
                                        const int4* __restrict__ bnd,
                                        unsigned bin) {
  return Row{__ldg(tab + bin), __ldg(bnd + bin)};
}

// Candidate n's bin offset, nearest first: 0, -1, +1, -2, +2.
__device__ __forceinline__ int candidate_offset(int n) {
  return (n + 1) / 2 * (n % 2 ? -1 : 1);
}

// One block: a kTileW x kTileH tile of cells (j = column, i = row) of
// robot blockIdx.z. kBayes selects the Bayesian form (prev, params and
// prob are then used).
template <bool kBayes>
__global__ void __launch_bounds__(kTileW * kTileH) scan_to_grid_cells_kernel(
    const int* __restrict__ base, const float* __restrict__ dist_m,
    int height, int width, const int4* __restrict__ tables,
    const int4* __restrict__ bounds, int n_bins,
    const unsigned char* __restrict__ endpoint, int start_i, int start_j,
    const float* __restrict__ prev, const float* __restrict__ params,
    int* __restrict__ occ, float* __restrict__ prob) {
  const int j = blockIdx.x * kTileW + threadIdx.x;
  const int i = blockIdx.y * kTileH + threadIdx.y;
  if (i >= height || j >= width) return;
  const int cell = i * width + j;
  const long long o = static_cast<long long>(blockIdx.z) * height * width + cell;
  // every load that does not depend on the table is issued first, so its
  // latency overlaps the table reads
  const int nearest = __ldg(base + cell);
  const bool hit = endpoint[o];
  float prev_p = 0.0f, dist = 0.0f;
  Model model{};
  if (kBayes) {
    prev_p = prev[o];
    dist = __ldg(dist_m + cell);
    model = load_model(params);
  }
  const int4* tab = tables + static_cast<long long>(blockIdx.z) * n_bins;
  const int4* bnd = bounds + static_cast<long long>(blockIdx.z) * n_bins;
  Row rows[kCandidates];
#pragma unroll
  for (int n = 0; n < kCandidates; ++n) {
    // nearest is in [0, n_bins) and the offset in [-2, 2]: one wrap
    // suffices from 2 bins on (no integer division)
    int bin = nearest + candidate_offset(n);
    if (n_bins >= 2) {
      bin += bin < 0 ? n_bins : (bin >= n_bins ? -n_bins : 0);
    } else {
      bin = 0;
    }
    rows[n] = load_row(tab, bnd, static_cast<unsigned>(bin));
  }
  const float di = static_cast<float>(i - start_i);
  const float dj = static_cast<float>(j - start_j);
  bool covered = false;
  float range = 0.0f;
  // the nearest covering candidate wins: test the farthest first
#pragma unroll
  for (int n = kCandidates - 1; n >= 0; --n) {
    if (on_line(di, dj, start_i, start_j, rows[n])) {
      covered = true;
      range = __int_as_float(rows[n].a.z);
    }
  }
  occ[o] = hit ? kOccupied : (covered ? kEmpty : kUnexplored);
  if (kBayes) {
    prob[o] = covered ? bayes_update(dist, range, prev_p, model)
                      : model.p_prior;
  }
}

}  // namespace

// Shapes (all contiguous, R = robots):
//   base: [H * W] int32, each cell's nearest bin in [0, n_bins);
//   dist_m: [H * W] f32; tables: [R, n_bins, 4] int32 (endpoint i, j,
//   range as f32 bits, valid); endpoint: [R, H * W] bool (one byte);
//   prev: [R, H * W] f32 and params: [7] f32 for the Bayesian form, both
//   null for the plain form; bounds: [R, n_bins, 4] int32 scratch, where
//   the beam pass writes (t_lo, t_hi, p_hi as f32 bits, 0); occ:
//   [R, H * W] int32; prob: [R, H * W] f32 (null for the plain form).
// Launches both passes on `stream` and does not synchronise. Returns the
// first nonzero cudaGetLastError() after a launch.
extern "C" int kompass_scan_to_grid_cells(
    const int* base, const float* dist_m, int n_cells, int width,
    const int* tables, int n_bins, const unsigned char* endpoint,
    int start_i, int start_j, const float* prev, const float* params,
    int robots, int* bounds, int* occ, float* prob, void* stream) {
  const auto* tab = reinterpret_cast<const int4*>(tables);
  auto* bnd = reinterpret_cast<int4*>(bounds);
  auto s = static_cast<cudaStream_t>(stream);
  const int beams = robots * n_bins;
  constexpr int kBeamBlock = 256;
  beam_bounds_kernel<<<(beams + kBeamBlock - 1) / kBeamBlock, kBeamBlock, 0,
                       s>>>(tab, beams, start_i, start_j, bnd);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int height = n_cells / width;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, robots);
  if (prev != nullptr) {
    scan_to_grid_cells_kernel<true><<<grid, block, 0, s>>>(
        base, dist_m, height, width, tab, bnd, n_bins, endpoint, start_i,
        start_j, prev, params, occ, prob);
  } else {
    scan_to_grid_cells_kernel<false><<<grid, block, 0, s>>>(
        base, dist_m, height, width, tab, bnd, n_bins, endpoint, start_i,
        start_j, nullptr, nullptr, occ, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
