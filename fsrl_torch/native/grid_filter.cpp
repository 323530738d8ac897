// Native grid-density filter for TrajectoryBuffer.
//
// C++ implementation of the 2-D spatial downsampling filter
// (fsrl_torch/data/traj_buf.py::filter_points, semantics from reference
// fsrl/data/traj_buf.py:119-161): bucket points on a sqrt(target)-sized grid,
// keep one point per non-empty cell first, then fill round-robin from random
// non-empty cells. The Python version walks dict-of-lists per point; this one
// is a single pass + compact arrays, ~50x faster at dataset scale (millions of
// trajectories during long offline-data generation sweeps).
//
// Exposed as a C ABI for ctypes:
//   int grid_filter(const double* pts, long n, long target, unsigned seed,
//                   long* out_idx)  -> number of kept indices written.
//
// Built by fsrl_torch/native/__init__.py (g++ -O2 -shared -fPIC) into
// fsrl_torch/_build on first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

extern "C" {

long grid_filter(const double* pts, long n, long target, unsigned seed,
                 long* out_idx) {
  if (n <= 0 || target <= 0) return 0;
  if (n <= target) {
    for (long i = 0; i < n; ++i) out_idx[i] = i;
    return n;
  }
  const long gs = static_cast<long>(std::ceil(std::sqrt((double)target)));

  double minx = pts[0], maxx = pts[0], miny = pts[1], maxy = pts[1];
  for (long i = 1; i < n; ++i) {
    minx = std::min(minx, pts[2 * i]);
    maxx = std::max(maxx, pts[2 * i]);
    miny = std::min(miny, pts[2 * i + 1]);
    maxy = std::max(maxy, pts[2 * i + 1]);
  }
  const double cx = std::max((maxx - minx) / gs, 1e-12);
  const double cy = std::max((maxy - miny) / gs, 1e-12);

  // bucket points: cell id -> list of point indices (CSR layout)
  const long ncells = (gs + 1) * (gs + 1);
  std::vector<long> cell_of(n), count(ncells, 0);
  for (long i = 0; i < n; ++i) {
    long ix = std::min((long)((pts[2 * i] - minx) / cx), gs);
    long iy = std::min((long)((pts[2 * i + 1] - miny) / cy), gs);
    long c = ix * (gs + 1) + iy;
    cell_of[i] = c;
    count[c]++;
  }
  std::vector<long> offset(ncells + 1, 0);
  for (long c = 0; c < ncells; ++c) offset[c + 1] = offset[c] + count[c];
  std::vector<long> items(n), fill(offset.begin(), offset.end() - 1);
  for (long i = 0; i < n; ++i) items[fill[cell_of[i]]++] = i;

  // phase 1: one point (the last, matching the Python .pop()) per cell
  long kept = 0;
  std::vector<long> remaining;  // non-empty cells after taking one
  std::vector<long> taken(ncells, 0);
  for (long c = 0; c < ncells && kept < target; ++c) {
    if (count[c] > 0) {
      out_idx[kept++] = items[offset[c] + count[c] - 1];
      taken[c] = 1;
      if (count[c] > 1) remaining.push_back(c);
    }
  }
  // phase 2: random non-empty cell round-robin
  std::mt19937 rng(seed);
  while (kept < target && !remaining.empty()) {
    std::uniform_int_distribution<size_t> pick(0, remaining.size() - 1);
    size_t j = pick(rng);
    long c = remaining[j];
    long left = count[c] - taken[c];
    out_idx[kept++] = items[offset[c] + left - 1];
    taken[c]++;
    if (count[c] - taken[c] == 0) {
      remaining[j] = remaining.back();
      remaining.pop_back();
    }
  }
  return kept;
}

}  // extern "C"
