// Native runtime: exact Euclidean distance transform (Felzenszwalb &
// Huttenlocher 2004, O(n) per scanline) for the per-map likelihood-field
// precompute.  This replaces the host-side scipy.ndimage call the reference
// makes once per map (amcmh_localizer.py:156); the accelerator compute path
// never touches it (maps/edt.py has the on-device variant).
//
// C ABI, bound from python via ctypes (mcmh_localization/native).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Large finite stand-in for +inf keeps the lower-envelope arithmetic
// well-defined on obstacle-free scanlines (double precision below, so
// 1e30 + n^2 stays exact enough for the comparisons that matter).
constexpr double kBig = 1e30;

// 1-D squared distance transform of sampled function f -> d.
// v (parabola sites) and z (envelope boundaries) are scratch.
void dt_1d(const double* f, double* d, int* v, double* z, int n) {
  int k = 0;
  v[0] = 0;
  z[0] = -kBig;
  z[1] = kBig;
  for (int q = 1; q < n; ++q) {
    double s = ((f[q] + (double)q * q) - (f[v[k]] + (double)v[k] * v[k])) /
               (2.0 * q - 2.0 * v[k]);
    while (s <= z[k]) {
      --k;
      s = ((f[q] + (double)q * q) - (f[v[k]] + (double)v[k] * v[k])) /
          (2.0 * q - 2.0 * v[k]);
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kBig;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    double dq = q - (double)v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

}  // namespace

extern "C" {

// occupied: (h*w) row-major uint8 (nonzero = obstacle)
// out:      (h*w) row-major float32 distance in CELLS to nearest obstacle
void mcmh_edt(const uint8_t* occupied, float* out, int h, int w) {
  const int m = h > w ? h : w;
  std::vector<double> f(m), d(m), z(m + 1);
  std::vector<int> v(m);
  std::vector<double> tmp((size_t)h * w);

  // pass 1: columns (squared distance along y)
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      f[y] = occupied[(size_t)y * w + x] ? 0.0 : kBig;
    }
    dt_1d(f.data(), d.data(), v.data(), z.data(), h);
    for (int y = 0; y < h; ++y) tmp[(size_t)y * w + x] = d[y];
  }
  // pass 2: rows (adds squared distance along x)
  for (int y = 0; y < h; ++y) {
    dt_1d(&tmp[(size_t)y * w], d.data(), v.data(), z.data(), w);
    for (int x = 0; x < w; ++x) {
      out[(size_t)y * w + x] = (float)std::sqrt(d[x]);
    }
  }
}

}  // extern "C"
