// mtp_native: host-side native components for the MTP framework.
//
// The reference's runtime services (neighbor lists, buffered config writing)
// are C++ inside LAMMPS; these are our native equivalents for the host side
// of the pipeline (device-side neighbor lists live in ops/neighbors.py as
// XLA programs). Used for initial-configuration setup, slab
// pre-partitioning, active-learning pool construction, and million-atom
// .cfg streaming where Python formatting is the bottleneck (the reference
// buffers rows with fmt::memory_buffer, pair_mtp_extrapolation.cpp:401-479).
//
// Build: make -C csrc   (g++ -O3 -march=native -fopenmp -shared -fPIC)
// ABI: plain C, consumed via ctypes (utils/native.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Mat3 {
  double m[3][3];
};

// inverse of a row-vector cell matrix
static bool invert3(const double* c, Mat3* out) {
  const double a = c[0], b = c[1], cc = c[2];
  const double d = c[3], e = c[4], f = c[5];
  const double g = c[6], h = c[7], i = c[8];
  const double A = e * i - f * h, B = f * g - d * i, C = d * h - e * g;
  const double det = a * A + b * B + cc * C;
  if (std::fabs(det) < 1e-300) return false;
  const double inv = 1.0 / det;
  out->m[0][0] = A * inv;
  out->m[1][0] = B * inv;
  out->m[2][0] = C * inv;
  out->m[0][1] = (cc * h - b * i) * inv;
  out->m[1][1] = (a * i - cc * g) * inv;
  out->m[2][1] = (b * g - a * h) * inv;
  out->m[0][2] = (b * f - cc * e) * inv;
  out->m[1][2] = (cc * d - a * f) * inv;
  out->m[2][2] = (a * e - b * d) * inv;
  return true;
}

}  // namespace

extern "C" {

// Periodic cell-list neighbor build (minimum-image regime).
//   pos:  (n,3) row-major, may be unwrapped
//   cell: (3,3) row-vector cell
//   idx_out: (n, max_neighbors) padded with the row's own index
//   counts_out: (n,) neighbor counts (optional, may be null)
// Returns 0 on success, 1 on neighbor overflow (idx still filled, truncated),
// -1 on invalid cell.
int mtp_cell_list(const double* pos, int64_t n, const double* cell,
                  double cutoff, int max_neighbors, int32_t* idx_out,
                  int32_t* counts_out) {
  Mat3 inv;
  if (!invert3(cell, &inv)) return -1;

  // perpendicular widths = 1/||row of inverse|| (columns of inv^T)
  int gx[3];
  for (int a = 0; a < 3; a++) {
    double nrm = std::sqrt(inv.m[0][a] * inv.m[0][a] +
                           inv.m[1][a] * inv.m[1][a] +
                           inv.m[2][a] * inv.m[2][a]);
    double w = 1.0 / nrm;
    gx[a] = (int)std::floor(w / cutoff);
    if (gx[a] < 1) gx[a] = 1;
  }
  const int64_t ncells = (int64_t)gx[0] * gx[1] * gx[2];

  std::vector<double> frac(3 * n);
  std::vector<int32_t> bin(n);
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < n; k++) {
    double f[3];
    for (int a = 0; a < 3; a++) {
      f[a] = pos[3 * k + 0] * inv.m[0][a] + pos[3 * k + 1] * inv.m[1][a] +
             pos[3 * k + 2] * inv.m[2][a];
      f[a] -= std::floor(f[a]);
      frac[3 * k + a] = f[a];
    }
    int bx = (int)(f[0] * gx[0]);
    int by = (int)(f[1] * gx[1]);
    int bz = (int)(f[2] * gx[2]);
    if (bx >= gx[0]) bx = gx[0] - 1;
    if (by >= gx[1]) by = gx[1] - 1;
    if (bz >= gx[2]) bz = gx[2] - 1;
    bin[k] = (int32_t)(((int64_t)bx * gx[1] + by) * gx[2] + bz);
  }

  // counting sort into cells
  std::vector<int64_t> start(ncells + 1, 0);
  for (int64_t k = 0; k < n; k++) start[bin[k] + 1]++;
  for (int64_t c = 0; c < ncells; c++) start[c + 1] += start[c];
  std::vector<int32_t> order(n);
  {
    std::vector<int64_t> cur(start.begin(), start.end() - 1);
    for (int64_t k = 0; k < n; k++) order[cur[bin[k]]++] = (int32_t)k;
  }

  const double cut2 = cutoff * cutoff;
  int overflow = 0;

#pragma omp parallel for schedule(dynamic, 64) reduction(max : overflow)
  for (int64_t k = 0; k < n; k++) {
    const int64_t b = bin[k];
    const int bz0 = (int)(b % gx[2]);
    const int by0 = (int)((b / gx[2]) % gx[1]);
    const int bx0 = (int)(b / ((int64_t)gx[1] * gx[2]));
    int cnt = 0;
    int32_t* row = idx_out + k * max_neighbors;

    const int rx = gx[0] < 3 ? gx[0] : 3;
    const int ry = gx[1] < 3 ? gx[1] : 3;
    const int rz = gx[2] < 3 ? gx[2] : 3;
    for (int ox = 0; ox < rx; ox++) {
      int cx = gx[0] < 3 ? ox : (bx0 + ox - 1 + gx[0]) % gx[0];
      for (int oy = 0; oy < ry; oy++) {
        int cy = gx[1] < 3 ? oy : (by0 + oy - 1 + gx[1]) % gx[1];
        for (int oz = 0; oz < rz; oz++) {
          int cz = gx[2] < 3 ? oz : (bz0 + oz - 1 + gx[2]) % gx[2];
          int64_t cid = ((int64_t)cx * gx[1] + cy) * gx[2] + cz;
          for (int64_t s = start[cid]; s < start[cid + 1]; s++) {
            const int32_t j = order[s];
            if (j == (int32_t)k) continue;
            // min-image displacement in fractional space
            double df[3];
            for (int a = 0; a < 3; a++) {
              df[a] = frac[3 * j + a] - frac[3 * k + a];
              df[a] -= std::nearbyint(df[a]);
            }
            double r[3];
            for (int a = 0; a < 3; a++)
              r[a] = df[0] * cell[0 + a] + df[1] * cell[3 + a] +
                     df[2] * cell[6 + a];
            const double d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
            if (d2 <= cut2) {
              if (cnt < max_neighbors)
                row[cnt] = j;
              cnt++;
            }
          }
        }
      }
    }
    if (cnt > max_neighbors) overflow = 1;
    for (int q = cnt < max_neighbors ? cnt : max_neighbors; q < max_neighbors;
         q++)
      row[q] = (int32_t)k;
    if (counts_out) counts_out[k] = cnt;
  }
  return overflow;
}

// Format .cfg AtomData rows (id, type, x, y, z[, grade]) into `out`.
// Returns bytes written, or -(needed) if cap is too small.
int64_t mtp_format_cfg_atoms(const double* pos, const int32_t* types,
                             const double* grades, int64_t n,
                             int64_t id_offset, char* out, int64_t cap) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; i++) {
    char buf[256];
    int len;
    if (grades)
      len = snprintf(buf, sizeof buf, "%lld\t%d\t%.6f\t%.6f\t%.6f\t%.5f\n",
                     (long long)(i + 1 + id_offset), types[i], pos[3 * i],
                     pos[3 * i + 1], pos[3 * i + 2], grades[i]);
    else
      len = snprintf(buf, sizeof buf, "%lld\t%d\t%.6f\t%.6f\t%.6f\n",
                     (long long)(i + 1 + id_offset), types[i], pos[3 * i],
                     pos[3 * i + 1], pos[3 * i + 2]);
    if (w + len > cap) return -(w + len);
    std::memcpy(out + w, buf, len);
    w += len;
  }
  return w;
}

int mtp_native_version() { return 1; }

int mtp_native_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
