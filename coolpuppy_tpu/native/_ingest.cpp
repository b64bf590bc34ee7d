// Native host-side ingest kernels for coolpuppy-tpu.
//
// The hot host-side loops behind the device pipeline: scattering COO pixels
// into the block-sparse tile stack (ops/tiles.py fallback is a numpy
// bincount chain over ~3 temporary arrays) and enumerating all-vs-all
// feature pairs with distance filtering. Compiled to a plain shared library
// and bound with ctypes (no pybind11 in this environment).
//
// Build: python -m coolpuppy_tpu.native.build

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

// Two-pass conflict-free scatter: counting-sort the (tile, cell, value)
// entries by tile (parallel, per-thread histograms), then reduce each tile's
// run with exactly one thread. Beats both float atomics (~2x) and
// thread-private stack copies (whose 67 MB-per-thread serial merge dominated
// at 12M nnz / K~1000). `emit(i, ks, ix, vs)` yields 0..2 entries for input
// i, already filtered to mapped tiles (k >= 1).
template <typename EmitFn>
static void scatter_two_pass(int64_t nnz, int64_t K, int64_t B, EmitFn emit,
                             float* out) {
#ifdef _OPENMP
  int nt = omp_get_max_threads();
  if (nt > 16) nt = 16;
#else
  int nt = 1;
#endif
  const int64_t nb = K;  // buckets are tiles 1..K, stored at k-1
  std::vector<int64_t> hist((size_t)nt * nb, 0);
#pragma omp parallel num_threads(nt)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
    int64_t* h = hist.data() + (size_t)t * nb;
    int32_t ks[2], ix[2];
    float vs[2];
    for (int64_t i = lo; i < hi; i++) {
      const int n = emit(i, ks, ix, vs);
      for (int e = 0; e < n; e++) h[ks[e] - 1]++;
    }
  }
  std::vector<int64_t> bstart(nb + 1);
  int64_t run = 0;
  for (int64_t b = 0; b < nb; b++) {
    bstart[b] = run;
    int64_t total = 0;
    for (int tt = 0; tt < nt; tt++) {
      int64_t c = hist[(size_t)tt * nb + b];
      hist[(size_t)tt * nb + b] = run + total;
      total += c;
    }
    run += total;
  }
  bstart[nb] = run;
  // raw allocations: value-init of ~100 MB staging would cost real memsets
  std::unique_ptr<int32_t[]> ecell(new int32_t[run]);
  std::unique_ptr<float[]> evalv(new float[run]);
#pragma omp parallel num_threads(nt)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
    int64_t* cur = hist.data() + (size_t)t * nb;
    int32_t ks[2], ix[2];
    float vs[2];
    for (int64_t i = lo; i < hi; i++) {
      const int n = emit(i, ks, ix, vs);
      for (int e = 0; e < n; e++) {
        const int64_t p = cur[ks[e] - 1]++;
        ecell[p] = ix[e];
        evalv[p] = vs[e];
      }
    }
  }
#pragma omp parallel for schedule(dynamic, 8) num_threads(nt)
  for (int64_t k = 0; k < nb; k++) {
    float* tile = out + (k + 1) * B * B;
    for (int64_t p = bstart[k]; p < bstart[k + 1]; p++) {
      tile[ecell[p]] += evalv[p];
    }
  }
}

// Scatter nnz COO entries into a zeroed tile stack [K+1, B, B] (f32).
// tile_map is the dense [tm_rows, tm_cols] grid -> stack index (0 = skip).
template <typename I, typename V>
static void tile_scatter_impl(const I* rows, const I* cols, const V* vals,
                              int64_t nnz, const int32_t* tile_map,
                              int64_t tm_cols, int64_t B, int64_t K,
                              float* out) {
  if (nnz > (int64_t)1 << 19 && K < (int64_t)1 << 18) {
    scatter_two_pass(
        nnz, K, B,
        [=](int64_t i, int32_t* ks, int32_t* ix, float* vs) -> int {
          const int64_t tr = (int64_t)rows[i] / B;
          const int64_t tc = (int64_t)cols[i] / B;
          const int32_t k = tile_map[tr * tm_cols + tc];
          if (k <= 0) return 0;
          ks[0] = k;
          ix[0] = (int32_t)(((int64_t)rows[i] - tr * B) * B +
                            ((int64_t)cols[i] - tc * B));
          vs[0] = (float)vals[i];
          return 1;
        },
        out);
    return;
  }
  const int64_t stack = (K + 1) * B * B;
#ifdef _OPENMP
  const bool priv = stack * (int64_t)sizeof(float) < (int64_t)128 << 20 &&
                    nnz > stack / 4;
#else
  const bool priv = false;
#endif
  if (!priv) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nnz; i++) {
      const int64_t tr = (int64_t)rows[i] / B;
      const int64_t tc = (int64_t)cols[i] / B;
      const int32_t k = tile_map[tr * tm_cols + tc];
      if (k > 0) {
        float* cell = out + ((int64_t)k * B + ((int64_t)rows[i] - tr * B)) * B +
                      ((int64_t)cols[i] - tc * B);
#pragma omp atomic
        *cell += (float)vals[i];
      }
    }
    return;
  }
#ifdef _OPENMP
#pragma omp parallel
  {
    const int t = omp_get_thread_num();
    float* buf = t == 0 ? out : new float[stack]();
#pragma omp for schedule(static)
    for (int64_t i = 0; i < nnz; i++) {
      const int64_t tr = (int64_t)rows[i] / B;
      const int64_t tc = (int64_t)cols[i] / B;
      const int32_t k = tile_map[tr * tm_cols + tc];
      if (k > 0) {
        buf[((int64_t)k * B + ((int64_t)rows[i] - tr * B)) * B +
            ((int64_t)cols[i] - tc * B)] += (float)vals[i];
      }
    }
    if (t != 0) {
#pragma omp critical
      {
        for (int64_t j = 0; j < stack; j++) out[j] += buf[j];
      }
      delete[] buf;
    }
  }
#endif
}

extern "C" {

void tile_scatter(const int64_t* rows, const int64_t* cols, const double* vals,
                  int64_t nnz, const int32_t* tile_map, int64_t tm_cols,
                  int64_t B, int64_t K, float* out) {
  tile_scatter_impl(rows, cols, vals, nnz, tile_map, tm_cols, B, K, out);
}

// scipy's native COO dtypes (int32 indices, float32 data) — scatter without
// the 200 MB of dtype-conversion copies the generic entry would force
void tile_scatter_i32f32(const int32_t* rows, const int32_t* cols,
                         const float* vals, int64_t nnz,
                         const int32_t* tile_map, int64_t tm_cols, int64_t B,
                         int64_t K, float* out) {
  tile_scatter_impl(rows, cols, vals, nnz, tile_map, tm_cols, B, K, out);
}

void tile_scatter_i32f64(const int32_t* rows, const int32_t* cols,
                         const double* vals, int64_t nnz,
                         const int32_t* tile_map, int64_t tm_cols, int64_t B,
                         int64_t K, float* out) {
  tile_scatter_impl(rows, cols, vals, nnz, tile_map, tm_cols, B, K, out);
}

// Fused triangle scatter: one pass over the STORED (upper-triangle) pixels of
// a cooler region fetch, folding in balancing weights and the symmetric
// mirror, so the host never materializes the mirrored/balanced COO (the
// reference materializes it via clr.matrix(sparse=True).fetch, then slices —
// coolpup.py:1053–1057, 1115–1121).
//
// rows/cols are GLOBAL bin ids; the logical rectangle is rows in
// [lo1, lo1+n1), cols in [lo2, lo2+n2). w (global per-bin, NaN already
// cleaned to 0) may be NULL for unbalanced. mirror!=0 additionally scatters
// the transposed pixel (cis same-extent fetches, skipping the diagonal).
static inline void scatter_one_wtri(int64_t gr, int64_t gc, float v,
                                    int64_t lo1, int64_t lo2, int64_t n1,
                                    int64_t n2, const int32_t* tile_map,
                                    int64_t tm_cols, int64_t B, float* buf) {
  const int64_t r = gr - lo1, c = gc - lo2;
  if (r >= 0 && r < n1 && c >= 0 && c < n2) {
    const int32_t k = tile_map[(r / B) * tm_cols + (c / B)];
    if (k > 0) {
      buf[((int64_t)k * B + (r % B)) * B + (c % B)] += v;
    }
  }
}

void tile_scatter_wtri(const int64_t* rows, const int64_t* cols,
                       const float* vals, int64_t nnz, int64_t lo1,
                       int64_t lo2, int64_t n1, int64_t n2, const float* w,
                       const int32_t* tile_map, int64_t tm_cols, int64_t B,
                       int64_t K, int32_t mirror, float* out) {
  if (nnz > (int64_t)1 << 19 && K < (int64_t)1 << 18) {
    scatter_two_pass(
        nnz, K, B,
        [=](int64_t i, int32_t* ks, int32_t* ix, float* vs) -> int {
      const int64_t gr = rows[i], gc = cols[i];
      float v = vals[i];
      if (w) v *= w[gr] * w[gc];
      int n = 0;
      {
        const int64_t r = gr - lo1, c = gc - lo2;
        if (r >= 0 && r < n1 && c >= 0 && c < n2) {
          const int32_t k = tile_map[(r / B) * tm_cols + (c / B)];
          if (k > 0) {
            ks[n] = k;
            ix[n] = (int32_t)((r % B) * B + (c % B));
            vs[n] = v;
            n++;
          }
        }
      }
      if (mirror && gr != gc) {
        const int64_t r = gc - lo1, c = gr - lo2;
        if (r >= 0 && r < n1 && c >= 0 && c < n2) {
          const int32_t k = tile_map[(r / B) * tm_cols + (c / B)];
          if (k > 0) {
            ks[n] = k;
            ix[n] = (int32_t)((r % B) * B + (c % B));
            vs[n] = v;
            n++;
          }
        }
      }
      return n;
        },
        out);
    return;
  }
  const int64_t stack = (K + 1) * B * B;
#ifdef _OPENMP
  const bool priv = stack * (int64_t)sizeof(float) < (int64_t)128 << 20 &&
                    nnz > stack / 4;
  if (priv) {
#pragma omp parallel
    {
      const int t = omp_get_thread_num();
      float* buf = t == 0 ? out : new float[stack]();
#pragma omp for schedule(static)
      for (int64_t i = 0; i < nnz; i++) {
        const int64_t gr = rows[i], gc = cols[i];
        float v = vals[i];
        if (w) v *= w[gr] * w[gc];
        scatter_one_wtri(gr, gc, v, lo1, lo2, n1, n2, tile_map, tm_cols, B,
                         buf);
        if (mirror && gr != gc) {
          scatter_one_wtri(gc, gr, v, lo1, lo2, n1, n2, tile_map, tm_cols, B,
                           buf);
        }
      }
      if (t != 0) {
#pragma omp critical
        {
          for (int64_t j = 0; j < stack; j++) out[j] += buf[j];
        }
        delete[] buf;
      }
    }
    return;
  }
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nnz; i++) {
    const int64_t gr = rows[i], gc = cols[i];
    float v = vals[i];
    if (w) v *= w[gr] * w[gc];
    const int64_t r = gr - lo1, c = gc - lo2;
    if (r >= 0 && r < n1 && c >= 0 && c < n2) {
      const int32_t k = tile_map[(r / B) * tm_cols + (c / B)];
      if (k > 0) {
        float* cell = out + ((int64_t)k * B + (r % B)) * B + (c % B);
#pragma omp atomic
        *cell += v;
      }
    }
    if (mirror && gr != gc) {
      const int64_t r2 = gc - lo1, c2 = gr - lo2;
      if (r2 >= 0 && r2 < n1 && c2 >= 0 && c2 < n2) {
        const int32_t k = tile_map[(r2 / B) * tm_cols + (c2 / B)];
        if (k > 0) {
          float* cell = out + ((int64_t)k * B + (r2 % B)) * B + (c2 % B);
#pragma omp atomic
          *cell += v;
        }
      }
    }
  }
}

// Enumerate ordered pairs (i, j), i < j, with |center[j] - center[i]| in
// [mindist, maxdist], assuming centers sorted ascending. Writes pair indices
// into out_i/out_j (caller-allocated, capacity cap); returns the number of
// pairs written, or -1 if capacity was exceeded. k-th superdiagonal sweep
// with early exit once min distance at k exceeds maxdist (same enumeration
// order as coords.py::_batches_cis_bed).
int64_t enumerate_pairs(const double* centers, int64_t n, double mindist,
                        double maxdist, int64_t* out_i, int64_t* out_j,
                        int64_t cap) {
  int64_t count = 0;
  for (int64_t k = 1; k < n; k++) {
    double dmin = 1e300;
    for (int64_t i = 0; i + k < n; i++) {
      const double d = centers[i + k] - centers[i];
      if (d < dmin) dmin = d;
      const double ad = d < 0 ? -d : d;
      if (ad >= mindist && ad <= maxdist) {
        if (count >= cap) return -1;
        out_i[count] = i;
        out_j[count] = i + k;
        count++;
      }
    }
    if (dmin > maxdist) break;
  }
  return count;
}

}  // extern "C"
