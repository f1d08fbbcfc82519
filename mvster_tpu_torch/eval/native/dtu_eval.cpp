// Native point-cloud metric kernels for the DTU benchmark.
//
// Replaces the MATLAB KDTreeSearcher pipeline (reference
// evaluations/dtu/reducePts_haa.m, MaxDistCP.m) with a SPARSE uniform-grid
// spatial hash: greedy stochastic min-distance thinning and nearest-neighbor
// distances with expanding-shell search.  Exposed as a plain C ABI for
// ctypes; single-threaded but O(n log n) with small constants.
//
// The grid must be sparse: at the DTU operating point (0.2 mm cells over a
// ~1 m scan extent) a dense cell array is ~1e11 cells and std::bad_allocs —
// only occupied cells may cost memory.  Cells live in one array of
// (packed-coord key, point index) pairs sorted by key; a cell lookup is a
// binary search, a build is one sort.
//
// Built at first use by mvster_tpu_torch/eval/dtu_metric.py:
//   g++ -O3 -march=native -std=c++17 -shared -fPIC -o libdtu_eval.so dtu_eval.cpp
// into build/mvster_tpu_torch/dtu_eval/<hash>/ at the repository root.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

// 21 bits per axis (2M cells/axis) packed into one 63-bit key; cell sizes
// are clamped below so quantized coordinates always fit.
constexpr int kAxisBits = 21;
constexpr int64_t kAxisMax = ((int64_t)1 << kAxisBits) - 1;

struct SparseGrid {
  float origin[3];
  float cell;
  int64_t dims[3];
  // (cell key, point index), sorted by key: all points of one occupied cell
  // are a contiguous run located by binary search
  std::vector<std::pair<uint64_t, int64_t>> entries;

  void coords_of(const float* p, int64_t* c) const {
    for (int k = 0; k < 3; ++k) {
      int64_t v = (int64_t)std::floor((p[k] - origin[k]) / cell);
      c[k] = std::min(std::max(v, (int64_t)0), dims[k] - 1);
    }
  }

  static uint64_t key_of(const int64_t* c) {
    return ((uint64_t)c[0] << (2 * kAxisBits)) |
           ((uint64_t)c[1] << kAxisBits) | (uint64_t)c[2];
  }

  // [begin, end) range of entries for the cell at quantized coords c
  void cell_range(const int64_t* c, int64_t* begin, int64_t* end) const {
    uint64_t key = key_of(c);
    auto lo = std::lower_bound(
        entries.begin(), entries.end(), key,
        [](const std::pair<uint64_t, int64_t>& e, uint64_t k) {
          return e.first < k;
        });
    auto hi = lo;
    while (hi != entries.end() && hi->first == key) ++hi;
    *begin = lo - entries.begin();
    *end = hi - entries.begin();
  }
};

SparseGrid build_grid(const float* pts, int64_t n, float cell) {
  SparseGrid g;
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], pts[3 * i + k]);
      hi[k] = std::max(hi[k], pts[3 * i + k]);
    }
  }
  // grow the cell if the extent would overflow the packed-key axis range
  // (27-neighborhood correctness only needs cell >= the query radius, which
  // callers guarantee; larger cells stay correct, just scan more points)
  for (int k = 0; k < 3; ++k) {
    double extent = (double)hi[k] - lo[k];
    cell = std::max(cell, (float)(extent / (double)kAxisMax) * 1.0001f);
  }
  g.cell = cell;
  for (int k = 0; k < 3; ++k) {
    g.origin[k] = lo[k];
    double extent = (double)hi[k] - lo[k];
    g.dims[k] = std::max((int64_t)1, (int64_t)std::floor(extent / cell) + 1);
  }
  g.entries.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3];
    g.coords_of(pts + 3 * i, c);
    g.entries[i] = {SparseGrid::key_of(c), i};
  }
  std::sort(g.entries.begin(), g.entries.end());
  return g;
}

inline float dist2(const float* a, const float* b) {
  float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return dx * dx + dy * dy + dz * dz;
}

}  // namespace

extern "C" {

// Greedy stochastic thinning: visit points in a seeded random order; a point
// still active at its turn is kept and suppresses every neighbor within dst.
// keep[i] = 1 for surviving points.  Matches reducePts_haa.m semantics.
void reduce_points(const float* pts, int64_t n, float dst, uint64_t seed,
                   uint8_t* keep) {
  if (n == 0) return;
  SparseGrid g = build_grid(pts, n, dst);
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::mt19937_64 rng(seed);
  std::shuffle(order.begin(), order.end(), rng);

  std::vector<uint8_t> active(n, 1);
  const float dst2 = dst * dst;
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    if (!active[i]) continue;
    const float* p = pts + 3 * i;
    int64_t c[3];
    g.coords_of(p, c);
    for (int64_t dx = -1; dx <= 1; ++dx) {
      int64_t x = c[0] + dx;
      if (x < 0 || x >= g.dims[0]) continue;
      for (int64_t dy = -1; dy <= 1; ++dy) {
        int64_t y = c[1] + dy;
        if (y < 0 || y >= g.dims[1]) continue;
        for (int64_t dz = -1; dz <= 1; ++dz) {
          int64_t z = c[2] + dz;
          if (z < 0 || z >= g.dims[2]) continue;
          int64_t nc[3] = {x, y, z}, s, e;
          g.cell_range(nc, &s, &e);
          for (; s < e; ++s) {
            int64_t j = g.entries[s].second;
            if (active[j] && dist2(p, pts + 3 * j) <= dst2) active[j] = 0;
          }
        }
      }
    }
    active[i] = 1;  // the visited point survives its own suppression
  }
  std::memcpy(keep, active.data(), n);
}

// For each `from` point: distance to the nearest `to` point, clamped at
// max_dist (MaxDistCP.m contract).  Expanding-shell search over a grid whose
// cell size adapts to the `to` density.  `accurate_radius` bounds the exact
// search: a query with no neighbor within it reports max_dist.  (The DTU
// stats discard distances above the 20 mm outlier cut, so distances in
// (accurate_radius, max_dist) never affect the metric as long as
// accurate_radius > outlier threshold; bounding the radius keeps far-away
// queries from scanning the entire grid.)
void nn_distances(const float* from, int64_t n_from, const float* to,
                  int64_t n_to, float max_dist, float accurate_radius,
                  float* out) {
  if (n_to == 0) {
    for (int64_t i = 0; i < n_from; ++i) out[i] = max_dist;
    return;
  }
  if (accurate_radius <= 0 || accurate_radius > max_dist)
    accurate_radius = max_dist;
  // pick cell so that an average occupied cell holds a handful of points,
  // but never so small that the shell search exceeds ~16 rings
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n_to; ++i)
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], to[3 * i + k]);
      hi[k] = std::max(hi[k], to[3 * i + k]);
    }
  double vol = 1.0;
  for (int k = 0; k < 3; ++k) vol *= std::max((double)hi[k] - lo[k], 1e-3);
  float cell = (float)std::cbrt(vol * 8.0 / (double)n_to);
  cell = std::max(cell, accurate_radius / 16.0f);
  cell = std::min(std::max(cell, 1e-3f), max_dist);
  SparseGrid g = build_grid(to, n_to, cell);
  cell = g.cell;  // may have grown to fit the packed-key axis range

  const float max2 = max_dist * max_dist;
  const float acc2 = accurate_radius * accurate_radius;
  for (int64_t i = 0; i < n_from; ++i) {
    const float* p = from + 3 * i;
    int64_t c[3];
    g.coords_of(p, c);
    float best2 = max2;
    int64_t max_shell = (int64_t)(accurate_radius / cell) + 2;
    for (int64_t shell = 0; shell <= max_shell; ++shell) {
      // lower bound on distance to any cell in this shell
      if (shell > 0) {
        float bound = (shell - 1) * cell;
        if (bound * bound >= best2 || bound * bound >= acc2) break;
      }
      for (int64_t dx = -shell; dx <= shell; ++dx) {
        int64_t x = c[0] + dx;
        if (x < 0 || x >= g.dims[0]) continue;
        for (int64_t dy = -shell; dy <= shell; ++dy) {
          int64_t y = c[1] + dy;
          if (y < 0 || y >= g.dims[1]) continue;
          bool face_x = std::abs(dx) == shell;
          bool face_y = std::abs(dy) == shell;
          int64_t step = (face_x || face_y) ? 1 : 2 * shell;
          if (step == 0) step = 1;
          for (int64_t dz = -shell; dz <= shell; dz += step) {
            int64_t z = c[2] + dz;
            if (z < 0 || z >= g.dims[2]) continue;
            int64_t nc[3] = {x, y, z}, s, e;
            g.cell_range(nc, &s, &e);
            for (; s < e; ++s) {
              float d2 = dist2(p, to + 3 * g.entries[s].second);
              if (d2 < best2) best2 = d2;
            }
          }
        }
      }
    }
    out[i] = std::sqrt(best2);
  }
}

}  // extern "C"
