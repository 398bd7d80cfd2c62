// Native host-side runtime for kompass_core_tpu_torch (the port's copy of
// the JAX package's host library; same code).
//
// The device owns the tensor hot loop; this library owns the *host* hot loop
// that feeds it at control rate (100 Hz x fleet size): reference-path
// machinery (closest-point searches mirroring controllers/follower.cpp of
// the reference), natural-cubic-spline path interpolation (role of the
// reference's embedded tk::spline, utils/spline.h), and the per-tick packed
// solver-input assembly (scan -> world-frame obstacle block + segment
// gather + padding) that would otherwise be several numpy passes per robot
// per tick.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// All functions are thread-safe (no global state) so a fleet host runtime
// can shard robots across worker threads.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// closest-point machinery (reference follower.cpp:149-264 semantics)
// ---------------------------------------------------------------------------

// Binary-search-like descent over segment start points. Returns the chosen
// segment index. seg_starts: indices into the path arrays, n_segs entries.
int kh_find_closest_segment(const float* xs, const float* ys,
                            const int64_t* seg_starts, int64_t n_segs,
                            double px, double py) {
  int64_t left = 0, right = n_segs - 1;
  if (right < 0) return 0;
  auto dist_sq = [&](int64_t seg) {
    const double dx = px - xs[seg_starts[seg]];
    const double dy = py - ys[seg_starts[seg]];
    return dx * dx + dy * dy;
  };
  while (left != right) {
    const int64_t mid = (left + right) / 2;
    const double left_d = dist_sq(left);
    const double right_d = dist_sq(right);
    if (mid == right || mid == left) {
      return static_cast<int>(left_d <= right_d ? left : right);
    }
    if (left_d <= right_d) {
      right = mid;
    } else {
      left = mid;
    }
  }
  return static_cast<int>(left);
}

// Linear scan for the closest point inside [start, end] (inclusive); ties
// keep the LATER point (reference follower.cpp:225 `<=`). Outputs the
// chosen local index and squared distance.
void kh_closest_point_on_segment(const float* xs, const float* ys,
                                 int64_t start, int64_t end, double px,
                                 double py, int64_t* out_idx,
                                 double* out_dist_sq) {
  double best = 1e300;
  int64_t best_i = start;
  for (int64_t i = start; i <= end; ++i) {
    const double dx = px - xs[i];
    const double dy = py - ys[i];
    const double d = dx * dx + dy * dy;
    if (d <= best) {
      best = d;
      best_i = i;
    }
  }
  *out_idx = best_i;
  *out_dist_sq = best;
}

// ---------------------------------------------------------------------------
// natural cubic spline interpolation (role of utils/spline.h + path.cpp)
// ---------------------------------------------------------------------------

// Fit a natural cubic spline through (s, y) [n knots] and evaluate at the
// m query points sq (monotonic). Thomas algorithm, O(n + m).
void kh_cubic_spline(const double* s, const double* y, int64_t n,
                     const double* sq, int64_t m, double* out) {
  if (n < 2) {
    // degenerate knot set: constant (or zero) output, no s[1] read
    for (int64_t k = 0; k < m; ++k) out[k] = (n == 1) ? y[0] : 0.0;
    return;
  }
  if (n < 3) {
    // linear fallback
    int64_t j = 0;
    for (int64_t k = 0; k < m; ++k) {
      while (j + 2 < n && s[j + 1] < sq[k]) ++j;
      const double t = (sq[k] - s[j]) / (s[j + 1] - s[j]);
      out[k] = (1.0 - t) * y[j] + t * y[j + 1];
    }
    return;
  }
  std::vector<double> h(n - 1), alpha(n - 1), l(n), mu(n), z(n), c(n), b(n - 1),
      d(n - 1);
  for (int64_t i = 0; i < n - 1; ++i) h[i] = s[i + 1] - s[i];
  for (int64_t i = 1; i < n - 1; ++i) {
    alpha[i] = 3.0 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1]);
  }
  l[0] = 1.0; mu[0] = 0.0; z[0] = 0.0;
  for (int64_t i = 1; i < n - 1; ++i) {
    l[i] = 2.0 * (s[i + 1] - s[i - 1]) - h[i - 1] * mu[i - 1];
    mu[i] = h[i] / l[i];
    z[i] = (alpha[i] - h[i - 1] * z[i - 1]) / l[i];
  }
  l[n - 1] = 1.0; z[n - 1] = 0.0; c[n - 1] = 0.0;
  for (int64_t j = n - 2; j >= 0; --j) {
    c[j] = z[j] - mu[j] * c[j + 1];
    b[j] = (y[j + 1] - y[j]) / h[j] - h[j] * (c[j + 1] + 2.0 * c[j]) / 3.0;
    d[j] = (c[j + 1] - c[j]) / (3.0 * h[j]);
  }
  int64_t j = 0;
  for (int64_t k = 0; k < m; ++k) {
    while (j + 2 < n && s[j + 1] < sq[k]) ++j;
    const double dx = sq[k] - s[j];
    out[k] = y[j] + b[j] * dx + c[j] * dx * dx + d[j] * dx * dx * dx;
  }
}

// ---------------------------------------------------------------------------
// per-tick packed input assembly
// ---------------------------------------------------------------------------

// Fill the obstacle block of the packed solver input: polar scan ->
// sensor frame -> body -> world, padded with pad_value. Non-finite ranges
// are clamped to pad_value. Writes obs_x[scan_cap], obs_y[scan_cap]
// contiguously into out (2 * scan_cap floats). Returns the number of real
// points written.
int kh_scan_to_obstacle_block(const double* ranges, const double* angles,
                              int64_t n_rays, double sensor_x, double sensor_y,
                              double sensor_yaw, double robot_x, double robot_y,
                              double robot_yaw, float pad_value,
                              int64_t scan_cap, float* out) {
  const double cs = std::cos(sensor_yaw), ss = std::sin(sensor_yaw);
  const double cy = std::cos(robot_yaw), sy = std::sin(robot_yaw);
  float* out_x = out;
  float* out_y = out + scan_cap;
  const int64_t n = std::min(n_rays, scan_cap);
  for (int64_t i = 0; i < n; ++i) {
    double r = ranges[i];
    if (!std::isfinite(r)) r = pad_value;
    const double a = angles[i];
    const double pxs = r * std::cos(a);
    const double pys = r * std::sin(a);
    const double bx = cs * pxs - ss * pys + sensor_x;
    const double by = ss * pxs + cs * pys + sensor_y;
    out_x[i] = static_cast<float>(cy * bx - sy * by + robot_x);
    out_y[i] = static_cast<float>(sy * bx + cy * by + robot_y);
  }
  for (int64_t i = n; i < scan_cap; ++i) {
    out_x[i] = pad_value;
    out_y[i] = pad_value;
  }
  return static_cast<int>(n);
}

// Gather + pad the tracked-segment block: copies path[start..end] into
// seg_x/seg_y/seg_arc (each seg_cap floats, padded with pad_value /
// zero for arc) and returns the segment total chord length.
double kh_segment_block(const float* xs, const float* ys, const float* arc,
                        int64_t start, int64_t end, float pad_value,
                        int64_t seg_cap, float* seg_x, float* seg_y,
                        float* seg_arc) {
  const int64_t n = std::min(end - start + 1, seg_cap);
  double total = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    seg_x[i] = xs[start + i];
    seg_y[i] = ys[start + i];
    seg_arc[i] = arc[start + i];
    if (i > 0) {
      const double dx = xs[start + i] - xs[start + i - 1];
      const double dy = ys[start + i] - ys[start + i - 1];
      total += std::sqrt(dx * dx + dy * dy);
    }
  }
  for (int64_t i = n; i < seg_cap; ++i) {
    seg_x[i] = pad_value;
    seg_y[i] = pad_value;
    seg_arc[i] = 0.0f;
  }
  return total;
}

// Exponential speed-regulation factor (reference follower.cpp:319-353):
// integrate |curvature| point-by-point from start_idx until the chord
// distance reaches the lookahead, then
//   factor = max(exp(-(k_curv * sum|k| + k_rot * |omega|)), min_factor).
// Loop structure matches the Python engine exactly (curvature at idx is
// accumulated BEFORE the distance break check).
double kh_speed_factor(const float* xs, const float* ys, const float* curv,
                       int64_t n, int64_t start_idx, double lookahead,
                       double k_curv, double k_rot, double omega,
                       double min_factor) {
  double curvature_sum = 0.0, dist = 0.0;
  for (int64_t i = start_idx; i < n - 1; ++i) {
    curvature_sum += std::abs(static_cast<double>(curv[i]));
    // subtract in float first: identical rounding to the numpy-f32 path
    const double dx = static_cast<double>(xs[i + 1] - xs[i]);
    const double dy = static_cast<double>(ys[i + 1] - ys[i]);
    dist += std::hypot(dx, dy);
    if (dist >= lookahead) break;
  }
  const double exponent = k_curv * curvature_sum + k_rot * std::abs(omega);
  return std::max(std::exp(-exponent), min_factor);
}

// PurePursuit lookahead point: circle((cx, cy), radius) x path-segment
// intersections, scanning segments [last_found_index, n-2] with NO early
// break so the LAST intersection wins, t2 (far root) preferred per
// segment — exact reference semantics (pure_pursuit.cpp:214-254 of the
// upstream), incl. the a > 0 duplicate-point guard used by the Python
// engine. Returns 1 and writes target/out_index when an intersection is
// found; returns 0 (outputs untouched) otherwise — the caller handles the
// end-of-path / radius-growth fallback.
int kh_find_lookahead(const float* xs, const float* ys, int64_t n,
                      int64_t last_found_index, double cx, double cy,
                      double radius, double* out_x, double* out_y,
                      int64_t* out_index) {
  int found = 0;
  for (int64_t i = last_found_index; i < n - 1; ++i) {
    const double x1 = xs[i], y1 = ys[i];
    const double dx = xs[i + 1] - x1, dy = ys[i + 1] - y1;
    const double fx = x1 - cx, fy = y1 - cy;
    const double a = dx * dx + dy * dy;
    const double b = 2.0 * (fx * dx + fy * dy);
    const double c = fx * fx + fy * fy - radius * radius;
    const double disc = b * b - 4.0 * a * c;
    if (disc >= 0.0 && a > 0.0) {
      const double sq = std::sqrt(disc);
      const double t1 = (-b - sq) / (2.0 * a);
      const double t2 = (-b + sq) / (2.0 * a);
      if (t2 >= 0.0 && t2 <= 1.0) {
        *out_x = x1 + t2 * dx;
        *out_y = y1 + t2 * dy;
        *out_index = i;
        found = 1;
      } else if (t1 >= 0.0 && t1 <= 1.0) {
        *out_x = x1 + t1 * dx;
        *out_y = y1 + t1 * dy;
        *out_index = i;
        found = 1;
      }
    }
  }
  return found;
}

}  // extern "C"
