// Native per-chunk float pipeline: conditioner -> CDF 9/7 DWT -> q estimation
// -> midtread quantization -> [PWE outlier coding] -> SPECK entropy stage,
// and the inverse.  Templated on the working precision F:
//   F = double: byte-identical streams to the exact host engine and the
//               reference binaries (behavioral spec: SPECK_FLT.cpp,
//               CDF97.cpp, Conditioner.cpp, Outlier_Coder.cpp).
//   F = float:  fast mode — half the memory traffic; streams remain
//               format-valid SPERR (q/mean still stored as f64).  PWE is
//               margin-certified: outliers detected at tol - eta (eta
//               bounds the f32/f64 reconstruction discrepancy), so the
//               bound holds for f64 decoders too; chunks whose tolerance
//               f32 cannot certify escalate to the f64 pipeline.
//
// Compile with -ffp-contract=off: every floating-point op in the F=double
// path must round exactly once for stream parity.

#include "speck.cpp"  // bit coders + utilities (single-TU build)

#include <cfenv>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>

namespace {

// ------------------------------------------------------------- CDF 9/7 ----
// Lifting constants derived exactly as in CDF97.h:135-147 (in double), then
// narrowed to the working precision.
struct Cdf97Base {
  double ALPHA, BETA, GAMMA, DELTA, EPSILON, INV_EPSILON;
  Cdf97Base() {
    const double h[5] = {0.602949018236, 0.266864118443, -0.078223266529,
                         -0.016864118443, 0.026748757411};
    const double r0 = h[0] - 2.0 * h[4] * h[1] / h[3];
    const double r1 = h[2] - h[4] - h[4] * h[1] / h[3];
    const double s0 = h[1] - h[3] - h[3] * r0 / r1;
    const double t0 = h[0] - 2.0 * (h[2] - h[4]);
    ALPHA = h[4] / h[3];
    BETA = h[3] / r1;
    GAMMA = r1 / s0;
    DELTA = s0 / t0;
    EPSILON = std::sqrt(2.0) * t0;
    INV_EPSILON = 1.0 / EPSILON;
  }
};
static const Cdf97Base CCD;

template <typename F>
struct Cdf97C {
  static inline const F A = F(CCD.ALPHA), B = F(CCD.BETA), G = F(CCD.GAMMA),
                        D = F(CCD.DELTA), E = F(CCD.EPSILON),
                        IE = F(CCD.INV_EPSILON);
};

template <typename F>
void lift_fwd(F* buf, size_t n) {
  using C = Cdf97C<F>;
  const size_t el = n - n / 2, ol = n / 2;
  F* e = buf;
  F* o = buf + el;
  for (size_t i = 0; i + 1 < ol; i++) o[i] += C::A * (e[i] + e[i + 1]);
  o[ol - 1] += C::A * (e[ol - 1] + e[el - 1]);
  e[0] += F(2) * C::B * o[0];
  for (size_t i = 1; i + 1 < el; i++) e[i] += C::B * (o[i - 1] + o[i]);
  e[el - 1] += C::B * (o[el - 2] + o[ol - 1]);
  for (size_t i = 0; i + 1 < ol; i++) o[i] += C::G * (e[i] + e[i + 1]);
  o[ol - 1] += C::G * (e[ol - 1] + e[el - 1]);
  e[0] = C::E * (e[0] + F(2) * C::D * o[0]);
  for (size_t i = 1; i + 1 < el; i++) e[i] = C::E * (e[i] + C::D * (o[i - 1] + o[i]));
  e[el - 1] = C::E * (e[el - 1] + C::D * (o[el - 2] + o[ol - 1]));
  for (size_t i = 0; i < ol; i++) o[i] *= -C::IE;
}

template <typename F>
void lift_inv(F* buf, size_t n) {
  using C = Cdf97C<F>;
  const size_t el = n - n / 2, ol = n / 2;
  F* e = buf;
  F* o = buf + el;
  for (size_t i = 0; i < ol; i++) o[i] *= -C::E;
  e[0] = e[0] * C::IE - F(2) * C::D * o[0];
  for (size_t i = 1; i + 1 < el; i++) e[i] = e[i] * C::IE - C::D * (o[i - 1] + o[i]);
  e[el - 1] = e[el - 1] * C::IE - C::D * (o[el - 2] + o[ol - 1]);
  for (size_t i = 0; i + 1 < ol; i++) o[i] -= C::G * (e[i] + e[i + 1]);
  o[ol - 1] -= C::G * (e[ol - 1] + e[el - 1]);
  e[0] -= F(2) * C::B * o[0];
  for (size_t i = 1; i + 1 < el; i++) e[i] -= C::B * (o[i - 1] + o[i]);
  e[el - 1] -= C::B * (o[el - 2] + o[ol - 1]);
  for (size_t i = 0; i + 1 < ol; i++) o[i] -= C::A * (e[i] + e[i + 1]);
  o[ol - 1] -= C::A * (e[ol - 1] + e[el - 1]);
}

// Lane-parallel lifting: `buf` holds K interleaved columns in row-major
// [position][lane] layout (already even/odd-deinterleaved along positions,
// like lift_fwd's input).  Each lane runs exactly the scalar lift_fwd
// operation sequence, so results are bit-identical per column; the inner
// j-loops are contiguous and vectorize.
template <typename F>
void lift_fwd_lanes(F* buf, size_t n, size_t K, size_t k) {
  using C = Cdf97C<F>;
  const size_t el = n - n / 2, ol = n / 2;
  F* e = buf;
  F* o = buf + el * K;
  for (size_t i = 0; i + 1 < ol; i++)
    for (size_t j = 0; j < k; j++)
      o[i * K + j] += C::A * (e[i * K + j] + e[(i + 1) * K + j]);
  for (size_t j = 0; j < k; j++)
    o[(ol - 1) * K + j] += C::A * (e[(ol - 1) * K + j] + e[(el - 1) * K + j]);
  for (size_t j = 0; j < k; j++) e[j] += F(2) * C::B * o[j];
  for (size_t i = 1; i + 1 < el; i++)
    for (size_t j = 0; j < k; j++)
      e[i * K + j] += C::B * (o[(i - 1) * K + j] + o[i * K + j]);
  for (size_t j = 0; j < k; j++)
    e[(el - 1) * K + j] += C::B * (o[(el - 2) * K + j] + o[(ol - 1) * K + j]);
  for (size_t i = 0; i + 1 < ol; i++)
    for (size_t j = 0; j < k; j++)
      o[i * K + j] += C::G * (e[i * K + j] + e[(i + 1) * K + j]);
  for (size_t j = 0; j < k; j++)
    o[(ol - 1) * K + j] += C::G * (e[(ol - 1) * K + j] + e[(el - 1) * K + j]);
  for (size_t j = 0; j < k; j++)
    e[j] = C::E * (e[j] + F(2) * C::D * o[j]);
  for (size_t i = 1; i + 1 < el; i++)
    for (size_t j = 0; j < k; j++)
      e[i * K + j] =
          C::E * (e[i * K + j] + C::D * (o[(i - 1) * K + j] + o[i * K + j]));
  for (size_t j = 0; j < k; j++)
    e[(el - 1) * K + j] =
        C::E * (e[(el - 1) * K + j] +
                C::D * (o[(el - 2) * K + j] + o[(ol - 1) * K + j]));
  for (size_t i = 0; i < ol; i++)
    for (size_t j = 0; j < k; j++) o[i * K + j] *= -C::IE;
}

template <typename F>
void lift_inv_lanes(F* buf, size_t n, size_t K, size_t k) {
  using C = Cdf97C<F>;
  const size_t el = n - n / 2, ol = n / 2;
  F* e = buf;
  F* o = buf + el * K;
  for (size_t i = 0; i < ol; i++)
    for (size_t j = 0; j < k; j++) o[i * K + j] *= -C::E;
  for (size_t j = 0; j < k; j++)
    e[j] = e[j] * C::IE - F(2) * C::D * o[j];
  for (size_t i = 1; i + 1 < el; i++)
    for (size_t j = 0; j < k; j++)
      e[i * K + j] =
          e[i * K + j] * C::IE - C::D * (o[(i - 1) * K + j] + o[i * K + j]);
  for (size_t j = 0; j < k; j++)
    e[(el - 1) * K + j] =
        e[(el - 1) * K + j] * C::IE -
        C::D * (o[(el - 2) * K + j] + o[(ol - 1) * K + j]);
  for (size_t i = 0; i + 1 < ol; i++)
    for (size_t j = 0; j < k; j++)
      o[i * K + j] -= C::G * (e[i * K + j] + e[(i + 1) * K + j]);
  for (size_t j = 0; j < k; j++)
    o[(ol - 1) * K + j] -= C::G * (e[(ol - 1) * K + j] + e[(el - 1) * K + j]);
  for (size_t j = 0; j < k; j++) e[j] -= F(2) * C::B * o[j];
  for (size_t i = 1; i + 1 < el; i++)
    for (size_t j = 0; j < k; j++)
      e[i * K + j] -= C::B * (o[(i - 1) * K + j] + o[i * K + j]);
  for (size_t j = 0; j < k; j++)
    e[(el - 1) * K + j] -= C::B * (o[(el - 2) * K + j] + o[(ol - 1) * K + j]);
  for (size_t i = 0; i + 1 < ol; i++)
    for (size_t j = 0; j < k; j++)
      o[i * K + j] -= C::A * (e[i * K + j] + e[(i + 1) * K + j]);
  for (size_t j = 0; j < k; j++)
    o[(ol - 1) * K + j] -= C::A * (e[(ol - 1) * K + j] + e[(el - 1) * K + j]);
}

template <typename F>
void deinterleave(const F* src, size_t n, F* dst) {
  const size_t el = n - n / 2;
  for (size_t i = 0; i < el; i++) dst[i] = src[2 * i];
  for (size_t i = 0; i < n / 2; i++) dst[el + i] = src[2 * i + 1];
}

template <typename F>
void interleave(const F* src, size_t n, F* dst) {
  const size_t el = n - n / 2;
  for (size_t i = 0; i < el; i++) dst[2 * i] = src[i];
  for (size_t i = 0; i < n / 2; i++) dst[2 * i + 1] = src[el + i];
}

struct OutlierList {
  std::vector<uint64_t> pos;
  std::vector<double> err;
};

template <typename F>
struct Wavelet {
  std::vector<F> tmp, tmp2;

  void fwd_axis_x(F* p, size_t len, size_t rows, size_t row_stride,
                  F* acc_max = nullptr) {
    tmp.resize(len);
    for (size_t r = 0; r < rows; r++) {
      F* row = p + r * row_stride;
      deinterleave(row, len, tmp.data());
      lift_fwd(tmp.data(), len);
      if (acc_max) {
        F mx = *acc_max < 0 ? F(0) : *acc_max;
        for (size_t i = 0; i < len; i++) {
          F a = std::fabs(tmp[i]);
          mx = a > mx ? a : mx;
        }
        *acc_max = mx;
      }
      std::memcpy(row, tmp.data(), len * sizeof(F));
    }
  }
  // Level-0 forward x-pass with the conditioner fused: reads raw rows,
  // subtracts the mean (mirroring the conditioned value into `orig`), then
  // lifts — the separate subtract+copy sweep disappears.  Values identical.
  void fwd_axis_x_sub(F* p, size_t len, size_t rows, size_t row_stride, F mean,
                      F* orig) {
    tmp.resize(len);
    std::vector<F>& sub = tmp2;
    sub.resize(len);
    for (size_t r = 0; r < rows; r++) {
      F* row = p + r * row_stride;
      F* og = orig + r * row_stride;
      for (size_t i = 0; i < len; i++) {
        F v = row[i] - mean;
        sub[i] = v;
        og[i] = v;
      }
      deinterleave(sub.data(), len, tmp.data());
      lift_fwd(tmp.data(), len);
      std::memcpy(row, tmp.data(), len * sizeof(F));
    }
  }
  // Level-0 inverse x-pass with the PWE outlier scan fused: right after a
  // row is reconstructed (cache-hot), compare against the conditioned
  // original and collect outliers in ascending global-index order.
  // `orig_plane` aligns with `p`; `global_base` = linear index of p[0].
  void inv_axis_x_outliers(F* p, size_t len, size_t rows, size_t row_stride,
                           const F* orig_plane, size_t global_base, double tol,
                           OutlierList* out, double bias = 0.0) {
    tmp.resize(len);
    for (size_t r = 0; r < rows; r++) {
      F* row = p + r * row_stride;
      lift_inv(row, len);
      interleave(row, len, tmp.data());
      std::memcpy(row, tmp.data(), len * sizeof(F));
      const F* og = orig_plane + r * row_stride;
      size_t base = global_base + r * row_stride;
      for (size_t i = 0; i < len; i++) {
        double d = (double(og[i]) - bias) - double(row[i]);
        if (std::fabs(d) > tol) {
          out->pos.push_back(base + i);
          out->err.push_back(d);
        }
      }
    }
  }
  // Final-level inverse x-pass with the inverse conditioner fused: writes
  // val + mean directly, and applies the sparse PWE outlier corrections in
  // the reference's exact order — (raw + corr) + mean — using the raw row
  // buffer (SPECK_FLT.cpp:576-585 then Conditioner.cpp:66-96 semantics).
  // Rows must advance in ascending global index order and cover every index
  // once (true for the lev==1 dyadic x-pass, where the box is the volume).
  void inv_axis_x_mean(F* p, size_t len, size_t rows, size_t row_stride,
                       F mean, size_t global_base, const uint64_t* opos,
                       const F* ocorr, size_t onum, size_t* ocur) {
    tmp.resize(len);
    for (size_t r = 0; r < rows; r++) {
      F* row = p + r * row_stride;
      lift_inv(row, len);
      interleave(row, len, tmp.data());
      for (size_t i = 0; i < len; i++) row[i] = tmp[i] + mean;
      size_t base = global_base + r * row_stride;
      while (*ocur < onum && opos[*ocur] < base + len) {
        if (opos[*ocur] >= base) {
          size_t i = size_t(opos[*ocur] - base);
          row[i] = (tmp[i] + ocorr[*ocur]) + mean;
        }
        ++*ocur;
      }
    }
  }
  void inv_axis_x(F* p, size_t len, size_t rows, size_t row_stride) {
    tmp.resize(len);
    for (size_t r = 0; r < rows; r++) {
      F* row = p + r * row_stride;
      lift_inv(row, len);
      interleave(row, len, tmp.data());
      std::memcpy(row, tmp.data(), len * sizeof(F));
    }
  }
  // Strided (non-contiguous) axis, lane-parallel: gather K adjacent columns
  // as contiguous rows ([position][lane] layout — a memcpy per position when
  // col_stride==1, which is every caller), run all K lifts simultaneously
  // (lift_*_lanes: contiguous SIMD over lanes, bit-identical per column),
  // scatter rows back.  Compared with per-column lifting this amortizes the
  // page/TLB cost of the big elem_stride (the z-pass strides nx*ny) across a
  // whole row instead of one element.
  static constexpr size_t LANES = 256 / sizeof(F);  // 64 f32 / 32 f64 lanes
  // `acc_max`: running max of |written value| over this pass (the caller
  // passes it on each level's final pass so the quantizer width needs no
  // separate full-volume scan; see compress_chunk).
  void fwd_axis_strided(F* p, size_t len, size_t ncols, size_t col_stride,
                        size_t elem_stride, F* acc_max = nullptr) {
    constexpr size_t K = LANES;
    const size_t el = len - len / 2;
    tmp2.resize(len * K);
    for (size_t c0 = 0; c0 < ncols; c0 += K) {
      size_t k = std::min(K, ncols - c0);
      // gather + even/odd deinterleave along positions, lane layout
      if (col_stride == 1) {
        const F* base = p + c0;
        for (size_t i = 0; i < len; i++) {
          F* dst = (i & 1) ? tmp2.data() + (el + i / 2) * K
                           : tmp2.data() + (i / 2) * K;
          std::memcpy(dst, base + i * elem_stride, k * sizeof(F));
        }
      } else {
        for (size_t i = 0; i < len; i++) {
          F* dst = (i & 1) ? tmp2.data() + (el + i / 2) * K
                           : tmp2.data() + (i / 2) * K;
          for (size_t j = 0; j < k; j++)
            dst[j] = p[(c0 + j) * col_stride + i * elem_stride];
        }
      }
      lift_fwd_lanes(tmp2.data(), len, K, k);
      if (acc_max) {
        F mxl[K] = {};  // per-lane accumulators: the i-loop vectorizes
        for (size_t i = 0; i < len; i++)
          for (size_t j = 0; j < k; j++) {
            F a = std::fabs(tmp2[i * K + j]);
            mxl[j] = a > mxl[j] ? a : mxl[j];
          }
        F mx = *acc_max < 0 ? F(0) : *acc_max;
        for (size_t j = 0; j < k; j++) mx = mxl[j] > mx ? mxl[j] : mx;
        *acc_max = mx;
      }
      if (col_stride == 1) {
        F* base = p + c0;
        for (size_t i = 0; i < len; i++)
          std::memcpy(base + i * elem_stride, tmp2.data() + i * K,
                      k * sizeof(F));
      } else {
        for (size_t i = 0; i < len; i++)
          for (size_t j = 0; j < k; j++)
            p[(c0 + j) * col_stride + i * elem_stride] = tmp2[i * K + j];
      }
    }
  }
  void inv_axis_strided(F* p, size_t len, size_t ncols, size_t col_stride,
                        size_t elem_stride) {
    constexpr size_t K = LANES;
    const size_t el = len - len / 2;
    tmp2.resize(len * K);
    for (size_t c0 = 0; c0 < ncols; c0 += K) {
      size_t k = std::min(K, ncols - c0);
      if (col_stride == 1) {
        const F* base = p + c0;
        for (size_t i = 0; i < len; i++)
          std::memcpy(tmp2.data() + i * K, base + i * elem_stride,
                      k * sizeof(F));
      } else {
        for (size_t i = 0; i < len; i++)
          for (size_t j = 0; j < k; j++)
            tmp2[i * K + j] = p[(c0 + j) * col_stride + i * elem_stride];
      }
      lift_inv_lanes(tmp2.data(), len, K, k);
      // interleave along positions while scattering rows back
      if (col_stride == 1) {
        F* base = p + c0;
        for (size_t i = 0; i < len; i++) {
          const F* src = (i & 1) ? tmp2.data() + (el + i / 2) * K
                                 : tmp2.data() + (i / 2) * K;
          std::memcpy(base + i * elem_stride, src, k * sizeof(F));
        }
      } else {
        for (size_t i = 0; i < len; i++) {
          const F* src = (i & 1) ? tmp2.data() + (el + i / 2) * K
                                 : tmp2.data() + (i / 2) * K;
          for (size_t j = 0; j < k; j++)
            p[(c0 + j) * col_stride + i * elem_stride] = src[j];
        }
      }
    }
  }

  void level2_fwd(F* plane, size_t lx, size_t ly, size_t stride,
                  F* acc_max = nullptr) {
    fwd_axis_x(plane, lx, ly, stride);
    fwd_axis_strided(plane, ly, lx, 1, stride, acc_max);
  }
  void level2_inv(F* plane, size_t lx, size_t ly, size_t stride) {
    inv_axis_strided(plane, ly, lx, 1, stride);
    inv_axis_x(plane, lx, ly, stride);
  }

  void dwt2d(F* plane, size_t nx, size_t ny, size_t levels, size_t stride,
             F* acc_max = nullptr) {
    for (size_t lev = 0; lev < levels; lev++) {
      size_t lx, dx, ly, dy;
      approx_detail(nx, lev, &lx, &dx);
      approx_detail(ny, lev, &ly, &dy);
      level2_fwd(plane, lx, ly, stride, acc_max);
    }
  }
  void idwt2d(F* plane, size_t nx, size_t ny, size_t levels, size_t stride) {
    for (size_t lev = levels; lev > 0; lev--) {
      size_t lx, dx, ly, dy;
      approx_detail(nx, lev - 1, &lx, &dx);
      approx_detail(ny, lev - 1, &ly, &dy);
      level2_inv(plane, lx, ly, stride);
    }
  }

  void dwt1d(F* p, size_t n, size_t levels, F* acc_max = nullptr) {
    size_t len = n;
    for (size_t lev = 0; lev < levels; lev++) {
      fwd_axis_x(p, len, 1, 0, acc_max);
      len -= len / 2;
    }
  }
  void idwt1d(F* p, size_t n, size_t levels) {
    for (size_t lev = levels; lev > 0; lev--) {
      size_t lo, hi;
      approx_detail(n, lev - 1, &lo, &hi);
      inv_axis_x(p, lo, 1, 0);
    }
  }

  // Dyadic 3D forward with the conditioner fused into the level-0 x-pass
  // (see fwd_axis_x_sub).  Returns false for wavelet-packet dims, where the
  // caller must pre-subtract and call dwt3d.
  bool dwt3d_fused_sub(F* v, size_t nx, size_t ny, size_t nz, F mean, F* orig,
                       F* acc_max = nullptr) {
    size_t dy_lev = 0;
    if (!can_use_dyadic(nx, ny, nz, &dy_lev)) return false;
    for (size_t lev = 0; lev < dy_lev; lev++) {
      size_t lx, ly, lz, d;
      approx_detail(nx, lev, &lx, &d);
      approx_detail(ny, lev, &ly, &d);
      approx_detail(nz, lev, &lz, &d);
      for (size_t z = 0; z < lz; z++) {
        if (lev == 0)
          fwd_axis_x_sub(v + z * nx * ny, lx, ly, nx, mean, orig + z * nx * ny);
        else
          fwd_axis_x(v + z * nx * ny, lx, ly, nx);
        fwd_axis_strided(v + z * nx * ny, ly, lx, 1, nx);
      }
      for (size_t y = 0; y < ly; y++)
        fwd_axis_strided(v + y * nx, lz, lx, 1, nx * ny, acc_max);
    }
    if (dy_lev == 0) {  // no transform levels: conditioner still applies
      const size_t n = nx * ny * nz;
      for (size_t i = 0; i < n; i++) {
        F t = v[i] - mean;
        v[i] = t;
        orig[i] = t;
      }
    }
    return true;
  }

  void dwt3d(F* v, size_t nx, size_t ny, size_t nz, F* acc_max = nullptr) {
    size_t dy_lev = 0;
    if (can_use_dyadic(nx, ny, nz, &dy_lev)) {
      for (size_t lev = 0; lev < dy_lev; lev++) {
        size_t lx, ly, lz, d;
        approx_detail(nx, lev, &lx, &d);
        approx_detail(ny, lev, &ly, &d);
        approx_detail(nz, lev, &lz, &d);
        for (size_t z = 0; z < lz; z++) level2_fwd(v + z * nx * ny, lx, ly, nx);
        for (size_t y = 0; y < ly; y++)
          fwd_axis_strided(v + y * nx, lz, lx, 1, nx * ny, acc_max);
      }
    } else {
      size_t zl = num_of_xforms(nz);
      for (size_t y = 0; y < ny; y++) {
        size_t len = nz;
        for (size_t lev = 0; lev < zl; lev++) {
          fwd_axis_strided(v + y * nx, len, nx, 1, nx * ny);
          len -= len / 2;
        }
      }
      // the 2D levels run after the z transform and their y-passes cover
      // every element's final value across levels
      size_t xyl = num_of_xforms(nx < ny ? nx : ny);
      for (size_t z = 0; z < nz; z++)
        dwt2d(v + z * nx * ny, nx, ny, xyl, nx, acc_max);
    }
  }

  // Dyadic 3D inverse with the PWE outlier scan fused into the level-0
  // x-pass (rows compared cache-hot; ascending positions).  Returns false
  // for wavelet-packet dims.
  bool idwt3d_fused_outliers(F* v, size_t nx, size_t ny, size_t nz,
                             const F* orig, double tol, OutlierList* out,
                             double bias = 0.0) {
    size_t dy_lev = 0;
    if (!can_use_dyadic(nx, ny, nz, &dy_lev)) return false;
    if (dy_lev == 0) {  // no transform levels: compare directly
      const size_t n = nx * ny * nz;
      for (size_t i = 0; i < n; i++) {
        double d = (double(orig[i]) - bias) - double(v[i]);
        if (std::fabs(d) > tol) {
          out->pos.push_back(i);
          out->err.push_back(d);
        }
      }
      return true;
    }
    for (size_t lev = dy_lev; lev > 0; lev--) {
      size_t lx, ly, lz, d;
      approx_detail(nx, lev - 1, &lx, &d);
      approx_detail(ny, lev - 1, &ly, &d);
      approx_detail(nz, lev - 1, &lz, &d);
      for (size_t y = 0; y < ly; y++)
        inv_axis_strided(v + y * nx, lz, lx, 1, nx * ny);
      for (size_t z = 0; z < lz; z++) {
        inv_axis_strided(v + z * nx * ny, ly, lx, 1, nx);
        if (lev == 1)
          inv_axis_x_outliers(v + z * nx * ny, lx, ly, nx, orig + z * nx * ny,
                              z * nx * ny, tol, out, bias);
        else
          inv_axis_x(v + z * nx * ny, lx, ly, nx);
      }
    }
    return true;
  }

  void idwt3d(F* v, size_t nx, size_t ny, size_t nz) {
    size_t dy_lev = 0;
    if (can_use_dyadic(nx, ny, nz, &dy_lev)) {
      for (size_t lev = dy_lev; lev > 0; lev--) {
        size_t lx, ly, lz, d;
        approx_detail(nx, lev - 1, &lx, &d);
        approx_detail(ny, lev - 1, &ly, &d);
        approx_detail(nz, lev - 1, &lz, &d);
        for (size_t y = 0; y < ly; y++)
          inv_axis_strided(v + y * nx, lz, lx, 1, nx * ny);
        for (size_t z = 0; z < lz; z++) level2_inv(v + z * nx * ny, lx, ly, nx);
      }
    } else {
      size_t xyl = num_of_xforms(nx < ny ? nx : ny);
      for (size_t z = 0; z < nz; z++) idwt2d(v + z * nx * ny, nx, ny, xyl, nx);
      size_t zl = num_of_xforms(nz);
      for (size_t y = 0; y < ny; y++) {
        for (size_t lev = zl; lev > 0; lev--) {
          size_t lo, hi;
          approx_detail(nz, lev - 1, &lo, &hi);
          inv_axis_strided(v + y * nx, lo, nx, 1, nx * ny);
        }
      }
    }
  }
};

template <typename F>
void wavelet_fwd(int ndim, F* v, size_t nx, size_t ny, size_t nz,
                 F* acc_max = nullptr) {
  Wavelet<F> w;
  if (ndim == 3)
    w.dwt3d(v, nx, ny, nz, acc_max);
  else if (ndim == 2)
    w.dwt2d(v, nx, ny, num_of_xforms(nx < ny ? nx : ny), nx, acc_max);
  else
    w.dwt1d(v, nx, num_of_xforms(nx), acc_max);
}

template <typename F>
void wavelet_inv(int ndim, F* v, size_t nx, size_t ny, size_t nz) {
  Wavelet<F> w;
  if (ndim == 3)
    w.idwt3d(v, nx, ny, nz);
  else if (ndim == 2)
    w.idwt2d(v, nx, ny, num_of_xforms(nx < ny ? nx : ny), nx);
  else
    w.idwt1d(v, nx, num_of_xforms(nx));
}

// ----------------------------------------------------------- conditioner --
size_t adjust_strides(size_t len) {
  size_t num = 2048;
  if (len % num == 0) return num;
  for (size_t c = num; c <= 32768; c++)
    if (len % c == 0) return c;
  for (size_t c = num; c > 0; c--)
    if (len % c == 0) return c;
  return 1;
}

template <typename F>
F strided_mean(const F* p, size_t n) {
  size_t ns = adjust_strides(n);
  size_t stride = n / ns;
  std::vector<F> per(ns);
  for (size_t s = 0; s < ns; s++) {
    F acc = 0;
    const F* b = p + s * stride;
    for (size_t i = 0; i < stride; i++) acc += b[i];
    per[s] = acc / F(stride);
  }
  F sum = 0;
  for (size_t s = 0; s < ns; s++) sum += per[s];
  return sum / F(ns);
}

// ------------------------------------------------------------ quantizer ---
template <typename F>
double estimate_mse_midtread(const F* p, size_t n, F q) {
  const size_t stride = 4096;
  const size_t ns = n / stride;
  std::vector<F> sums(ns + 1);
  const F rcp = F(1) / q;
  for (size_t s = 0; s < ns; s++) {
    F acc = 0;
    const F* b = p + s * stride;
    for (size_t i = 0; i < stride; i++) {
      F d = std::fma(-q, std::rint(b[i] * rcp), b[i]);
      acc += d * d;
    }
    sums[s] = acc;
  }
  F acc = 0;
  for (size_t i = ns * stride; i < n; i++) {
    F d = std::fma(-q, std::rint(p[i] * rcp), p[i]);
    acc += d * d;
  }
  sums[ns] = acc;
  F total = 0;
  for (F v : sums) total += v;
  return double(total) / double(n);
}

constexpr double DBL_BIG_ODD = 9007199254740991.0;  // 0x1.fffffffffffffp52
// f32 fast mode: magnitudes must stay exactly representable in float.
constexpr double F32_RATE_MAX = 1048575.0;  // 2^20 - 1

template <typename F>
double estimate_q(int mode, double quality, double param, const F* p, size_t n,
                  bool high_prec) {
  if (mode == 2) {  // psnr
    double t_mse = (param * param) * std::pow(10.0, -quality / 10.0);
    double q = 2.0 * std::sqrt(t_mse * 3.0);
    const double shrink = std::exp2(0.25);
    while (estimate_mse_midtread(p, n, F(q)) > t_mse) q /= shrink;
    return q;
  }
  if (mode == 3) return quality * 1.5;  // pwe
  if (mode == 4) return quality;        // directq: q given verbatim
  if constexpr (std::is_same_v<F, float>)
    return param / F32_RATE_MAX;  // rate, fast mode
  else
    return param / (high_prec ? DBL_BIG_ODD : 4294967295.0);  // rate
}

template <typename F, typename U>
void quantize_into(const F* p, size_t n, F q, rvec<U>& mags,
                   rvec<uint8_t>& signs) {
  // rint + cast == llrint for in-range values under FE_TONEAREST (width was
  // picked from the max magnitude), and rint vectorizes to packed rounding.
  const F inv = F(1) / q;
  mags.resize(n);
  signs.resize(n);
  for (size_t i = 0; i < n; i++) {
    F r = std::rint(p[i] * inv);
    signs[i] = !(r < F(0));  // -0.0 counts as non-negative, like llrint
    mags[i] = U(std::fabs(r));
  }
}

// Quantize and reconstruct in one pass (PWE path): rec = q*r equals the
// two-pass inv_quantize(quantize(x)) bit-for-bit, since r is an exact
// integer in F and the sign-symmetric product q*r == +-(q*|r|).
template <typename F, typename U>
void quantize_into_with_rec(const F* p, size_t n, F q, rvec<U>& mags,
                            rvec<uint8_t>& signs, F* rec) {
  const F inv = F(1) / q;
  mags.resize(n);
  signs.resize(n);
  for (size_t i = 0; i < n; i++) {
    F r = std::rint(p[i] * inv);
    signs[i] = !(r < F(0));
    mags[i] = U(std::fabs(r));
    rec[i] = q * r;
  }
}

template <typename F, typename U>
void inv_quantize(const rvec<U>& mags, const rvec<uint8_t>& signs,
                  F q, F* out) {
  const size_t n = mags.size();
  const U* mp = mags.data();
  const uint8_t* sp = signs.data();
  for (size_t i = 0; i < n; i++) {
    F v = q * F(mp[i]);
    out[i] = sp[i] ? v : -v;  // exact negation: identical either branch order
  }
}

template <typename F, typename U>
void inv_quant_box(const U* mags, const uint8_t* signs, F q, F* out, size_t nx,
                   size_t ny, size_t x0, size_t x1, size_t y0, size_t y1,
                   size_t z0, size_t z1) {
  for (size_t z = z0; z < z1; z++)
    for (size_t y = y0; y < y1; y++) {
      size_t b = (z * ny + y) * nx;
      for (size_t x = x0; x < x1; x++) {
        F v = q * F(mags[b + x]);
        out[b + x] = signs[b + x] ? v : -v;
      }
    }
}

// Decode-side fusion: inverse-quantize each region of the volume only when
// the dyadic IDWT first touches it (coarsest corner, then per-level shells),
// skipping the separate full-volume inverse-quantization sweep.  Values are
// identical element-wise, so streams/outputs stay bit-exact.
// `fuse_mean`: also apply the inverse conditioner (+mean) and the sparse
// PWE corrections inside the final-level x-pass — one full read+write sweep
// fewer than reconstruct-then-correct-then-add-mean, with bit-identical
// results (see inv_axis_x_mean).
template <typename F, typename U>
bool idwt3d_lazy(const U* mags, const uint8_t* signs, F q, F* v, size_t nx,
                 size_t ny, size_t nz, bool fuse_mean = false, F mean = F(0),
                 const uint64_t* opos = nullptr, const F* ocorr = nullptr,
                 size_t onum = 0) {
  size_t dy_lev = 0;
  if (!can_use_dyadic(nx, ny, nz, &dy_lev)) return false;
  Wavelet<F> w;
  size_t px, py, pz, d;
  approx_detail(nx, dy_lev, &px, &d);
  approx_detail(ny, dy_lev, &py, &d);
  approx_detail(nz, dy_lev, &pz, &d);
  inv_quant_box(mags, signs, q, v, nx, ny, 0, px, 0, py, 0, pz);
  size_t ocur = 0;
  for (size_t lev = dy_lev; lev > 0; lev--) {
    size_t lx, ly, lz;
    approx_detail(nx, lev - 1, &lx, &d);
    approx_detail(ny, lev - 1, &ly, &d);
    approx_detail(nz, lev - 1, &lz, &d);
    // shell = cube(lev-1) \ cube(lev), as three disjoint boxes
    inv_quant_box(mags, signs, q, v, nx, ny, 0, lx, 0, ly, pz, lz);
    inv_quant_box(mags, signs, q, v, nx, ny, 0, lx, py, ly, 0, pz);
    inv_quant_box(mags, signs, q, v, nx, ny, px, lx, 0, py, 0, pz);
    for (size_t y = 0; y < ly; y++)
      w.inv_axis_strided(v + y * nx, lz, lx, 1, nx * ny);
    for (size_t z = 0; z < lz; z++) {
      if (fuse_mean && lev == 1) {
        // lev==1 box is the full volume: rows ascend and cover every index
        w.inv_axis_strided(v + z * nx * ny, ly, lx, 1, nx);
        w.inv_axis_x_mean(v + z * nx * ny, lx, ly, nx, mean, z * nx * ny,
                          opos, ocorr, onum, &ocur);
      } else {
        w.level2_inv(v + z * nx * ny, lx, ly, nx);
      }
    }
    px = lx;
    py = ly;
    pz = lz;
  }
  if (fuse_mean && dy_lev == 0) {  // no transform levels: apply directly,
    // in the reference's order: corrections on raw values, then +mean
    for (size_t k = 0; k < onum; k++) v[opos[k]] += ocorr[k];
    const size_t n = nx * ny * nz;
    for (size_t i = 0; i < n; i++) v[i] += mean;
  }
  return true;
}

// ------------------------------------------------------------- outliers ---

// `mags` is scratch owned by the caller: the encoder may mutate it in place.
template <typename U>
std::vector<uint8_t> speck_encode_vec(int ndim, U* mags,
                                      const uint8_t* signs, size_t nx,
                                      size_t ny, size_t nz, size_t budget_bits) {
  uint8_t* buf = nullptr;
  int64_t len = encode_any<U>(ndim, mags, signs, nx, ny, nz,
                              budget_bits, &buf, true);
  std::vector<uint8_t> out(buf, buf + len);
  std::free(buf);
  return out;
}

std::vector<uint8_t> encode_outliers(const OutlierList& los, size_t total_len,
                                     double tol) {
  double maxerr = 0.0;
  for (double e : los.err) maxerr = std::max(maxerr, std::fabs(e));
  long long maxint = std::llrint(maxerr);  // raw-error width quirk (normative)
  int width = maxint <= 0xFF ? 8 : maxint <= 0xFFFF ? 16 : maxint <= 0xFFFFFFFFll ? 32 : 64;

  const double inv = 1.0 / tol;
  auto run = [&](auto tag) -> std::vector<uint8_t> {
    using U = decltype(tag);
    // sparse codec: state ~ #outliers, streams byte-identical to the dense
    // Codec1D (and therefore to the reference's SPECK1D_INT_ENC)
    SparseEnc1D<U> c;
    c.n = total_len;
    c.pos.reserve(los.pos.size());
    c.val.reserve(los.pos.size());
    c.sgn.reserve(los.pos.size());
    for (size_t k = 0; k < los.pos.size(); k++) {
      long long ll = std::llrint(los.err[k] * inv);
      if (ll == 0) continue;  // zero entries are not nonzeros
      c.pos.push_back(los.pos[k]);
      c.sgn.push_back(ll >= 0);
      c.val.push_back(U(ll < 0 ? -(unsigned long long)ll : (unsigned long long)ll));
    }
    c.encode();
    uint64_t tb = c.total_bits;
    std::vector<uint8_t> out(9 + (tb + 7) / 8);
    out[0] = c.num_bitplanes;
    std::memcpy(out.data() + 1, &tb, 8);
    c.sink.emit(out.data() + 9, tb);
    return out;
  };
  switch (width) {
    case 8: return run(uint8_t{});
    case 16: return run(uint16_t{});
    case 32: return run(uint32_t{});
    default: return run(uint64_t{});
  }
}

template <typename F>
void decode_outlier_list(const uint8_t* stream, size_t len, size_t total_len,
                         double tol, std::vector<uint64_t>* pos,
                         std::vector<F>* corr) {
  // Sparse decode: consumes exactly the dense coder's bits, returns only the
  // significant entries (callers pass complete outlier sections;
  // decompress_chunk verifies the section length first).
  if (len < 9) return;
  int nbp = stream[0];
  int width = nbp <= 8 ? 8 : nbp <= 16 ? 16 : nbp <= 32 ? 32 : 64;
  uint64_t total_bits;
  std::memcpy(&total_bits, stream + 1, 8);
  size_t avail = (len - 9) * 8;
  if (avail > total_bits) avail = total_bits;
  auto run = [&](auto tag) {
    using U = decltype(tag);
    SparseDec1D<U> c;
    c.n = total_len;
    c.num_bitplanes = uint8_t(nbp);
    c.total_bits = total_bits;
    c.src.load(stream + 9, avail, total_bits);
    c.decode();
    for (size_t k : c.lsp_order) {  // ascending positions (dense scan order)
      U m = c.sp_val[k];
      if (m == 0) continue;
      double v = m == 1 ? 1.1 : double(m) - 0.25;
      pos->push_back(c.sp_pos[k]);
      corr->push_back(F(v * (tol * (c.sp_sgn[k] ? 1.0 : -1.0))));
    }
  };
  switch (width) {
    case 8: run(uint8_t{}); break;
    case 16: run(uint16_t{}); break;
    case 32: run(uint32_t{}); break;
    default: run(uint64_t{}); break;
  }
}

template <typename F>
void decode_outliers(const uint8_t* stream, size_t len, size_t total_len,
                     double tol, F* add_to) {
  std::vector<uint64_t> pos;
  std::vector<F> corr;
  decode_outlier_list<F>(stream, len, total_len, tol, &pos, &corr);
  for (size_t k = 0; k < pos.size(); k++) add_to[pos[k]] += corr[k];
}

// --------------------------------------------------------------- headers --
// pack_8_booleans convention: b[0] -> bit 7 (sperr_helper.cpp magic trick).
void write_condi(uint8_t* h, bool constant, double mean_or_val, uint64_t nval,
                 double q) {
  h[0] = constant ? 0x81 : 0x80;  // [subtract-mean, 0.., constant]
  if (constant) {
    std::memcpy(h + 1, &nval, 8);
    std::memcpy(h + 9, &mean_or_val, 8);
  } else {
    std::memcpy(h + 1, &mean_or_val, 8);
    std::memcpy(h + 9, &q, 8);
  }
}

// ------------------------------------------------------------- pipeline ---
// SPERR_TPU_PROFILE=1: per-stage wall times to stderr (diagnostics only).
struct StageClock {
  bool on;
  std::chrono::steady_clock::time_point t;
  StageClock() : on(std::getenv("SPERR_TPU_PROFILE") != nullptr) {
    if (on) t = std::chrono::steady_clock::now();
  }
  void lap(const char* name) {
    if (!on) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[sperr_tpu] %-18s %7.1f ms\n", name,
                 std::chrono::duration<double, std::milli>(now - t).count());
    t = now;
  }
};

template <typename F>
std::vector<uint8_t> compress_chunk(int ndim, rvec<F>& vals, size_t nx,
                                    size_t ny, size_t nz, int mode, double quality,
                                    const F* premean = nullptr) {
  StageClock ck;
  // `premean`: mean already computed (in strided_mean's exact summation
  // order) while `vals` was being filled — skips one full read.
  const size_t n = vals.size();
  std::fesetround(FE_TONEAREST);

  bool constant = true;
  for (size_t i = 1; i < n; i++)
    if (vals[i] != vals[0]) {
      constant = false;
      break;
    }
  std::vector<uint8_t> stream(17);
  if (constant) {
    write_condi(stream.data(), true, double(vals[0]), n, 0.0);
    return stream;
  }
  F mean = premean ? *premean : strided_mean(vals.data(), n);
  ck.lap("const+mean");
  rvec<F> orig;
  double param = 0.0;
  Wavelet<F> wav;
  // Coefficient max tracked inside each level's final forward pass: an
  // upper bound on max|coeff| (per-level boxes overlap the next level's
  // approx corner), which is all the width ladder needs — no full-volume
  // scan.  Stays -1 when no transform pass ran (fallback scan below).
  F coeff_max = F(-1);
  bool transformed = false;
  if (mode == 3) {  // pwe: fuse mean-subtract+copy into the level-0 DWT pass
    orig.resize(n);
    if (ndim == 3)
      transformed = wav.dwt3d_fused_sub(vals.data(), nx, ny, nz, mean,
                                        orig.data(), &coeff_max);
    if (!transformed) {
      for (size_t i = 0; i < n; i++) {
        F v = vals[i] - mean;
        vals[i] = v;
        orig[i] = v;
      }
    }
  } else {
    for (size_t i = 0; i < n; i++) vals[i] -= mean;
  }
  if (mode == 2) {             // psnr: data range
    F mn = vals[0], mx = vals[0];
    for (size_t i = 1; i < n; i++) {
      mn = std::min(mn, vals[i]);
      mx = std::max(mx, vals[i]);
    }
    param = double(mx - mn);
  }

  if (!transformed) wavelet_fwd(ndim, vals.data(), nx, ny, nz, &coeff_max);
  ck.lap("fwd dwt");

  if (mode == 1) {  // rate: largest |coeff|
    size_t arg = 0;
    F best = -1;
    for (size_t i = 0; i < n; i++) {
      F a = std::fabs(vals[i]);
      if (a > best) {
        best = a;
        arg = i;
      }
    }
    param = double(std::fabs(vals[arg]));
  }
  size_t budget = mode == 1 ? size_t(quality * double(n)) : 0;

  for (int high_prec = 0; high_prec < 2; high_prec++) {
    double q = estimate_q<F>(mode, quality, param, vals.data(), n, high_prec);
    write_condi(stream.data(), false, double(mean), 0, q);

    // rate mode's q derives from the exact max (param); otherwise use the
    // tracked bound.  Width only selects the uint container type — streams
    // are independent of it (bitstream_definition; SPECK_INT.cpp header is
    // num_bitplanes, a property of the values).
    F best = mode == 1 ? F(param) : coeff_max;
    if (best < 0) {  // no transform pass ran: scan once
      best = 0;
      for (size_t i = 0; i < n; i++) {
        F a = std::fabs(vals[i]);
        best = a > best ? a : best;
      }
      coeff_max = best;
    }
    long long maxll = std::llrint(best / F(q));
    int width = maxll <= 0xFF ? 8 : maxll <= 0xFFFF ? 16
                : maxll <= 0xFFFFFFFFll ? 32 : 64;
    std::vector<uint8_t> body, outlier_stream;

    // f32 fast mode, PWE: certify the f64-decode bound on f32 hardware by
    // detecting outliers at tol - eta, where eta conservatively bounds the
    // f32-vs-f64 reconstruction discrepancy (same scheme as the TPU
    // compressor's pwe_strict="device").  When eta > tol/4 the tolerance cannot
    // be certified at this data scale: return the escalation sentinel (an
    // empty stream) and let the entry point redo the chunk in f64.
    double pwe_thr = quality;
    if (std::is_same_v<F, float> && mode == 3) {
      double dmax = 0;  // max |conditioned| (8 lanes: vectorizable)
      {
        double acc[8] = {0};
        size_t i = 0;
        for (; i + 8 <= n; i += 8)
          for (int j = 0; j < 8; j++) {
            double a = std::fabs(double(orig[i + j]));
            acc[j] = a > acc[j] ? a : acc[j];
          }
        for (; i < n; i++) {
          double a = std::fabs(double(orig[i]));
          acc[0] = a > acc[0] ? a : acc[0];
        }
        for (int j = 0; j < 8; j++) dmax = acc[j] > dmax ? acc[j] : dmax;
      }
      double cmax = coeff_max < 0 ? dmax : double(coeff_max);
      // K = 64: two orders above the measured lifting-chain discrepancy
      // (~0.5 eps * scale) for this deterministic arithmetic
      double eta =
          64.0 * 1.1920928955078125e-07 * (cmax > dmax ? cmax : dmax);
      if (eta > quality / 4.0) return {};  // escalate to the f64 pipeline
      pwe_thr = quality - eta;
    }

    auto run = [&](auto tag) {
      using U = decltype(tag);
      rvec<U> mags;
      rvec<uint8_t> signs;
      if (mode == 3) {  // PWE: quantize+reconstruct fused, collect outliers
        rvec<F> rec(n);
        quantize_into_with_rec<F, U>(vals.data(), n, F(q), mags, signs,
                                     rec.data());
        ck.lap("quantize+rec");
        OutlierList los;
        bool fused = ndim == 3 && wav.idwt3d_fused_outliers(
                                      rec.data(), nx, ny, nz, orig.data(),
                                      pwe_thr, &los);
        if (!fused) {
          wavelet_inv(ndim, rec.data(), nx, ny, nz);
          for (size_t i = 0; i < n; i++) {
            double d = double(orig[i]) - double(rec[i]);
            if (std::fabs(d) > pwe_thr) {
              los.pos.push_back(i);
              los.err.push_back(d);
            }
          }
        }
        ck.lap("inv dwt+outlier");
        if (!los.pos.empty()) outlier_stream = encode_outliers(los, n, quality);
        ck.lap("outlier encode");
      } else {
        quantize_into<F, U>(vals.data(), n, F(q), mags, signs);
        ck.lap("quantize");
      }
      body = speck_encode_vec<U>(ndim, mags.data(), signs.data(), nx, ny, nz, budget);
      ck.lap("speck encode");
    };
    switch (width) {
      case 8: run(uint8_t{}); break;
      case 16: run(uint16_t{}); break;
      case 32: run(uint32_t{}); break;
      default: run(uint64_t{}); break;
    }

    if (mode == 1 && !high_prec && body.size() * 8 < budget &&
        !std::is_same_v<F, float>)
      continue;

    stream.insert(stream.end(), body.begin(), body.end());
    stream.insert(stream.end(), outlier_stream.begin(), outlier_stream.end());
    return stream;
  }
  return stream;  // unreachable
}

template <typename F>
int decompress_chunk(int ndim, const uint8_t* stream, size_t len, size_t nx,
                     size_t ny, size_t nz, F* out) {
  StageClock ck;
  const size_t n = nx * ny * nz;
  if (len < 17) return -1;
  if (stream[0] & 0x01) {  // constant field
    double val;
    std::memcpy(&val, stream + 9, 8);
    for (size_t i = 0; i < n; i++) out[i] = F(val);
    return 0;
  }
  double mean, q;
  std::memcpy(&mean, stream + 1, 8);
  std::memcpy(&q, stream + 9, 8);
  size_t pos = 17;
  if (len < pos + 9) return -2;
  // invalid conditioner: the quantization step must be a positive finite
  // real (the reference's q > 0 invariant, SPECK_FLT.cpp:55, promoted from
  // a debug assert to a hard stream error)
  if (!(q > 0.0) || !std::isfinite(q) || !std::isfinite(mean)) return -3;

  int nbp = stream[pos];
  uint64_t nbits;
  std::memcpy(&nbits, stream + pos + 1, 8);
  // impossible SPECK headers: > 64 bitplanes cannot arise from any uint
  // width; a bit count beyond ~(num_bp+2) bits/sample is not a valid
  // stream of these dims (progressive TRUNCATION makes streams shorter,
  // never longer)
  if (nbp > 64) return -4;
  if (nbits > (uint64_t(nbp) + 2) * n + 4096) return -5;
  size_t full = 9 + (nbits + 7) / 8;
  size_t speck_len = std::min(full, len - pos);
  int width = nbp <= 8 ? 8 : nbp <= 16 ? 16 : nbp <= 32 ? 32 : 64;

  // Parse the outlier section (if any) before reconstruction so the
  // corrections and the inverse conditioner can fuse into the final IDWT
  // x-pass (one fewer full read+write sweep; values bit-identical).
  std::vector<uint64_t> opos;
  std::vector<F> ocorr;
  {
    size_t p2 = pos + speck_len;
    if (p2 + 9 <= len) {
      uint64_t obits;
      std::memcpy(&obits, stream + p2 + 1, 8);
      size_t olen = 9 + (obits + 7) / 8;
      if (len - p2 == olen)
        decode_outlier_list<F>(stream + p2, olen, n, q / 1.5, &opos, &ocorr);
    }
  }
  ck.lap("outlier decode");

  bool fused = false;
  auto run = [&](auto tag) {
    using U = decltype(tag);
    rvec<U> mags(n);
    rvec<uint8_t> signs(n);
    decode_any<U>(ndim, stream + pos, speck_len, nx, ny, nz, mags.data(),
                  signs.data());
    ck.lap("speck decode");
    if (ndim == 3 &&
        idwt3d_lazy<F, U>(mags.data(), signs.data(), F(q), out, nx, ny, nz,
                          true, F(mean), opos.data(), ocorr.data(),
                          opos.size())) {
      fused = true;  // fused inv-quantize + IDWT + corrections + mean
      ck.lap("inv dwt fused");
      return;
    }
    inv_quantize<F, U>(mags, signs, F(q), out);
    wavelet_inv(ndim, out, nx, ny, nz);
  };
  switch (width) {
    case 8: run(uint8_t{}); break;
    case 16: run(uint16_t{}); break;
    case 32: run(uint32_t{}); break;
    default: run(uint64_t{}); break;
  }

  if (!fused) {  // wavelet-packet dims: correct, then inverse-condition
    for (size_t k = 0; k < opos.size(); k++) out[opos[k]] += ocorr[k];
    for (size_t i = 0; i < n; i++) out[i] += F(mean);
  }
  return 0;
}

}  // namespace

extern "C" {

// Full per-chunk pipeline.  mode: 1=rate(bpp), 2=psnr, 3=pwe.
// `src`: f64 (is_float==0) or f32 (is_float==1).
// `precision`: 64 = exact/parity mode (f64), 32 = fast mode (f32).
int64_t st_compress_chunk2(int ndim, const void* src, int is_float, uint64_t nx,
                           uint64_t ny, uint64_t nz, int mode, double quality,
                           int precision, uint8_t** out) {
  size_t n = size_t(nx) * ny * nz;
  std::vector<uint8_t> stream;
  if (precision == 32) {
    rvec<float> vals(n);
    if (is_float)
      std::memcpy(vals.data(), src, n * sizeof(float));
    else {
      const double* p = static_cast<const double*>(src);
      for (size_t i = 0; i < n; i++) vals[i] = float(p[i]);
    }
    stream = compress_chunk<float>(ndim, vals, nx, ny, nz, mode, quality);
    if (stream.empty())  // f32 cannot certify this PWE tolerance: redo exact
      return st_compress_chunk2(ndim, src, is_float, nx, ny, nz, mode,
                                quality, 64, out);
  } else {
    rvec<double> vals(n);
    if (is_float) {
      const float* p = static_cast<const float*>(src);
      for (size_t i = 0; i < n; i++) vals[i] = p[i];
    } else {
      std::memcpy(vals.data(), src, n * sizeof(double));
    }
    stream = compress_chunk<double>(ndim, vals, nx, ny, nz, mode, quality);
  }
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(stream.size()));
  if (!buf) return -1;
  std::memcpy(buf, stream.data(), stream.size());
  *out = buf;
  return int64_t(stream.size());
}

int64_t st_compress_chunk(int ndim, const void* src, int is_float, uint64_t nx,
                          uint64_t ny, uint64_t nz, int mode, double quality,
                          uint8_t** out) {
  return st_compress_chunk2(ndim, src, is_float, nx, ny, nz, mode, quality, 64, out);
}

// `precision`: 64 -> out is double*, 32 -> out is float*.
int64_t st_decompress_chunk2(int ndim, const uint8_t* stream, uint64_t len,
                             uint64_t nx, uint64_t ny, uint64_t nz, int precision,
                             void* out) {
  if (precision == 32)
    return decompress_chunk<float>(ndim, stream, len, nx, ny, nz,
                                   static_cast<float*>(out));
  return decompress_chunk<double>(ndim, stream, len, nx, ny, nz,
                                  static_cast<double*>(out));
}

int64_t st_decompress_chunk(int ndim, const uint8_t* stream, uint64_t len,
                            uint64_t nx, uint64_t ny, uint64_t nz, double* out) {
  return st_decompress_chunk2(ndim, stream, len, nx, ny, nz, 64, out);
}

// Strided whole-volume variants: gather/scatter the chunk block directly
// from/to the caller's volume (vnx*vny*vnz, x fastest), fusing the Python
// layer's block copy into the native pass (SPERR3D_OMP_C.cpp:236-261 /
// SPERR3D_OMP_D.cpp:167-184 equivalents).
// `src`/`dst` point at the volume base; f32 iff is_float/prec 32.
int64_t st_compress_chunk_strided(const void* src, int is_float, uint64_t vnx,
                                  uint64_t vny, uint64_t x0, uint64_t y0,
                                  uint64_t z0, uint64_t lx, uint64_t ly,
                                  uint64_t lz, int mode, double quality,
                                  int precision, uint8_t** out) {
  size_t n = size_t(lx) * ly * lz;
  // Fused mean: per-block partial means accumulated in gather order, which
  // is exactly strided_mean's summation order over the contiguous buffer —
  // one less full read of the chunk.
  auto gather_mean = [&](auto* vals, auto& mean_out) {
    using F = std::remove_reference_t<decltype(mean_out)>;
    const size_t ns = adjust_strides(n);
    const size_t stride = n / ns;
    std::vector<F> per;
    per.reserve(ns);
    F acc = 0;
    size_t in_block = 0;
    size_t idx = 0;
    for (size_t z = z0; z < z0 + lz; z++)
      for (size_t y = y0; y < y0 + ly; y++) {
        size_t base = (z * vny + y) * vnx + x0;
        for (size_t x = 0; x < lx; x++) {
          F v = is_float ? F(static_cast<const float*>(src)[base + x])
                         : F(static_cast<const double*>(src)[base + x]);
          vals[idx++] = v;
          acc += v;
          if (++in_block == stride) {
            per.push_back(acc / F(stride));
            acc = 0;
            in_block = 0;
          }
        }
      }
    F sum = 0;
    for (F m : per) sum += m;
    mean_out = sum / F(ns);
  };
  std::vector<uint8_t> stream;
  if (precision == 32) {
    rvec<float> vals(n);
    float mean = 0;
    gather_mean(vals.data(), mean);
    stream = compress_chunk<float>(3, vals, lx, ly, lz, mode, quality, &mean);
    if (stream.empty())  // f32 cannot certify this PWE tolerance: redo exact
      return st_compress_chunk_strided(src, is_float, vnx, vny, x0, y0, z0,
                                       lx, ly, lz, mode, quality, 64, out);
  } else {
    rvec<double> vals(n);
    double mean = 0;
    gather_mean(vals.data(), mean);
    stream = compress_chunk<double>(3, vals, lx, ly, lz, mode, quality, &mean);
  }
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(stream.size()));
  if (!buf) return -1;
  std::memcpy(buf, stream.data(), stream.size());
  *out = buf;
  return int64_t(stream.size());
}

int64_t st_decompress_chunk_strided(const uint8_t* stream, uint64_t len,
                                    uint64_t vnx, uint64_t vny, uint64_t x0,
                                    uint64_t y0, uint64_t z0, uint64_t lx,
                                    uint64_t ly, uint64_t lz, int precision,
                                    void* dst) {
  size_t n = size_t(lx) * ly * lz;
  auto scatter = [&](const auto* vals) {
    using T = std::remove_cv_t<std::remove_pointer_t<decltype(vals)>>;
    size_t idx = 0;
    for (size_t z = z0; z < z0 + lz; z++)
      for (size_t y = y0; y < y0 + ly; y++) {
        T* p = static_cast<T*>(dst) + (z * vny + y) * vnx + x0;
        for (size_t x = 0; x < lx; x++) p[x] = vals[idx++];
      }
  };
  if (precision == 32) {
    rvec<float> buf(n);
    int rtn = decompress_chunk<float>(3, stream, len, lx, ly, lz, buf.data());
    if (rtn < 0) return rtn;
    scatter(buf.data());
  } else {
    rvec<double> buf(n);
    int rtn = decompress_chunk<double>(3, stream, len, lx, ly, lz, buf.data());
    if (rtn < 0) return rtn;
    scatter(buf.data());
  }
  return 0;
}

// Exact decoder-visible residual scan for the device fast path ("strict"
// PWE): reconstruct rec = IDWT_f64(q * ll) with the same f64 arithmetic the
// decoder will run (SPECK_FLT.cpp:543-606 order), then collect outliers of
// (orig - mean) - rec beyond `tol` in ascending position order.  `ll` are
// the (possibly reduced-precision) quantized signed coefficients; `orig` is
// the unconditioned f64 chunk.  Fills malloc'd pos/err arrays (st_free) and
// returns the outlier count.
int64_t st_residual_outliers(const int32_t* ll, uint64_t nx, uint64_t ny,
                             uint64_t nz, double q, double mean,
                             const double* orig, double tol,
                             uint64_t** pos_out, double** err_out) {
  const size_t n = size_t(nx) * ny * nz;
  rvec<double> v(n);
  for (size_t i = 0; i < n; i++) v[i] = q * double(ll[i]);
  OutlierList out;
  Wavelet<double> w;
  if (!w.idwt3d_fused_outliers(v.data(), nx, ny, nz, orig, tol, &out, mean)) {
    w.idwt3d(v.data(), nx, ny, nz);
    for (size_t i = 0; i < n; i++) {
      double d = (orig[i] - mean) - v[i];
      if (std::fabs(d) > tol) {
        out.pos.push_back(i);
        out.err.push_back(d);
      }
    }
  }
  const size_t m = out.pos.size();
  uint64_t* pp = static_cast<uint64_t*>(std::malloc(std::max<size_t>(m, 1) * 8));
  double* ep = static_cast<double*>(std::malloc(std::max<size_t>(m, 1) * 8));
  if (!pp || !ep) {
    std::free(pp);
    std::free(ep);
    return -1;
  }
  if (m) {
    std::memcpy(pp, out.pos.data(), m * 8);
    std::memcpy(ep, out.err.data(), m * 8);
  }
  *pos_out = pp;
  *err_out = ep;
  return int64_t(m);
}

}  // extern "C"
