// The device SPECK schedule (K5, K6 and the schedule half of K14/K15) for
// Hopper.
//
// Replaces the XLA programs of sperr_tpu/ops/speck_jax.py msbp1_device
// (K5), sperr_tpu/ops/speck_virtual.py pixel_schedule_virtual (K6, with
// box_reduce_max and _morton_flatten), and speck_jax.py node_max +
// pixel_schedule (K15's child-table form, and every 2D field of K14) and
// pixel_schedule_pyramid (K15's pyramid form).  For magnitudes mags they
// give
//   pm  = msb position + 1 of each magnitude (0 for zero),
//   num_bp = max pm,
//   s   = num_bp - pm, or NEVER (0x7FFF) where pm = 0,
//   e   = the same of the pixel's parent set's maximum,
//   nm  = each partition node's maximum pm, in the tree's BFS order.
// Every result is an integer and equals the plain versions beside the
// callers (ops/speck_virtual.py, ops/speck.py) bit for bit.
//
// Bound: device memory.  The work per pixel is a count of leading zeros
// and a few maxima; what costs is reading the int32 magnitudes once and
// writing s and e (int32 each).  The designs:
//   * power-of-two cubes (two launches): sched_boxmax takes one aligned
//     2x2x2 box per thread (four 8-byte row loads, coalesced across the
//     warp's x-adjacent boxes), writes pm as one byte per pixel, the box
//     maximum to its morton slot of the half grid, and the maxima of the
//     morton sub-cubes its block covers (a block is an aligned cube of
//     8 x 8 x 8 boxes, a contiguous morton range), and raises num_bp by one
//     integer atomicMax per block (order-free, so deterministic).
//     sched_virtual reads num_bp on the device (no host wait), writes s and
//     e from the byte copy (8-byte row stores), gathers nm through a static
//     table of (grid, lo, hi, output offset) segments, and one block of it
//     finishes the small levels of the pyramid and their segments;
//   * child tables (1 + depths + 1 launches): pm and num_bp; one launch per
//     depth, deepest first, a thread per node reducing its contiguous child
//     rows; s and e (e through each pixel's parent node);
//   * pyramids (1 + levels + 1 launches): pm scattered into the deep box,
//     one max-pool launch per level, then s, e and nm by gathers.
// The pyramids are kept as bytes (values <= 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNever = 0x7FFF;
constexpr int kThreads = 256;
constexpr int kMaxSegs = 256;  // segments of the virtual nm table

__device__ __forceinline__ int msbp1(int m) { return m > 0 ? 32 - __clz(m) : 0; }

__device__ __forceinline__ int sched_of(int v, int nb) { return v > 0 ? nb - v : kNever; }

// The bits of v (< 2^10) moved to every third bit.
__device__ __forceinline__ unsigned spread3(unsigned v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// Morton index, x lowest, then y, then z; the coarser digit more significant.
__device__ __forceinline__ unsigned morton3(unsigned x, unsigned y, unsigned z) {
  return spread3(x) | (spread3(y) << 1) | (spread3(z) << 2);
}

// Offset of grid g's cells in the concatenated morton pyramid: (8^g - 1) / 7.
__device__ __forceinline__ long long level_off(int g) {
  return ((1LL << (3 * g)) - 1) / 7;
}

// -- power-of-two cubes ------------------------------------------------------
// mags (N, N, N), N = 2^K; a block is an aligned cube of S^3 boxes, S = 2^j.
__global__ void sched_boxmax(const int32_t* __restrict__ mags, uint8_t* __restrict__ pm8,
                             uint8_t* __restrict__ M, int32_t* __restrict__ num_bp, int K,
                             int j) {
  __shared__ uint8_t cell[512];
  const int Kh = K - 1, bb = Kh - j;
  const long long N = 1LL << K;
  const unsigned t = threadIdx.x, S1 = (1u << j) - 1;
  const unsigned tx = t & S1, ty = (t >> j) & S1, tz = t >> (2 * j);
  const unsigned b = blockIdx.x, B1 = (1u << bb) - 1;
  const unsigned Bx = b & B1, By = (b >> bb) & B1, Bz = b >> (2 * bb);
  const unsigned bx = (Bx << j) | tx, by = (By << j) | ty, bz = (Bz << j) | tz;
  int bm = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long row = ((2LL * bz + (r >> 1)) * N + (2LL * by + (r & 1))) * N + 2LL * bx;
    const int2 v = *reinterpret_cast<const int2*>(mags + row);
    const int a = msbp1(v.x), c = msbp1(v.y);
    *reinterpret_cast<uint16_t*>(pm8 + row) = (uint16_t)(a | (c << 8));
    bm = max(bm, max(a, c));
  }
  const unsigned ml = morton3(tx, ty, tz);
  const long long mb = (long long)morton3(Bx, By, Bz);
  M[level_off(Kh) + (mb << (3 * j)) + ml] = (uint8_t)bm;
  cell[ml] = (uint8_t)bm;
  __syncthreads();
  // the block's morton sub-cubes: grids Kh-1 .. Kh-j
  unsigned cnt = 1u << (3 * j);
  for (int l = 1; l <= j; ++l) {
    cnt >>= 3;
    int v = 0;
    if (t < cnt) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v = max(v, (int)cell[8 * t + k]);
    }
    __syncthreads();
    if (t < cnt) {
      cell[t] = (uint8_t)v;
      M[level_off(Kh - l) + (mb << (3 * (j - l))) + t] = (uint8_t)v;
    }
    __syncthreads();
  }
  // cell[0] is now the maximum over the block's boxes
  if (t == 0) atomicMax(num_bp, (int)cell[0]);
}

// Block 0: grids gmin-1 .. 0 of the pyramid and the nm segments on them.
// Blocks 1 .. nb_se: s and e, one 2x2x2 box per thread.  The rest: nm for
// the segments on grids >= gmin, one node per thread.
__global__ void sched_virtual(const uint8_t* __restrict__ pm8, uint8_t* __restrict__ M,
                              const int32_t* __restrict__ num_bp, const int32_t* __restrict__ segs,
                              int nseg, int32_t* __restrict__ s, int32_t* __restrict__ e,
                              int32_t* __restrict__ nm, int K, int gmin, long long nb_se,
                              long long nn) {
  __shared__ int4 seg[kMaxSegs];
  const unsigned t = threadIdx.x;
  const long long b = blockIdx.x;
  if (b == 0) {
    for (int g = gmin - 1; g >= 0; --g) {
      const long long cnt = 1LL << (3 * g), src = level_off(g + 1), dst = level_off(g);
      for (long long c = t; c < cnt; c += blockDim.x) {
        int v = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) v = max(v, (int)M[src + 8 * c + k]);
        M[dst + c] = (uint8_t)v;
      }
      __syncthreads();
    }
    for (int q = 0; q < nseg; ++q) {
      const int g = segs[4 * q], lo = segs[4 * q + 1], hi = segs[4 * q + 2], out = segs[4 * q + 3];
      if (g >= gmin) continue;
      for (int i = t; i < hi - lo; i += blockDim.x) nm[out + i] = M[level_off(g) + lo + i];
    }
    return;
  }
  if (b <= nb_se) {
    const int Kh = K - 1;
    const long long N = 1LL << K, Nh1 = (1LL << Kh) - 1;
    const long long box = (b - 1) * blockDim.x + t;
    if (box >> (3 * Kh)) return;
    const long long bx = box & Nh1, by = (box >> Kh) & Nh1, bz = box >> (2 * Kh);
    const int nb = *num_bp;
    int p[8], bm = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long row = ((2 * bz + (r >> 1)) * N + (2 * by + (r & 1))) * N + 2 * bx;
      const unsigned w = *reinterpret_cast<const uint16_t*>(pm8 + row);
      p[2 * r] = w & 0xff;
      p[2 * r + 1] = w >> 8;
      bm = max(bm, max(p[2 * r], p[2 * r + 1]));
    }
    const int ev = sched_of(bm, nb);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long row = ((2 * bz + (r >> 1)) * N + (2 * by + (r & 1))) * N + 2 * bx;
      *reinterpret_cast<int2*>(s + row) = make_int2(sched_of(p[2 * r], nb), sched_of(p[2 * r + 1], nb));
      *reinterpret_cast<int2*>(e + row) = make_int2(ev, ev);
    }
    return;
  }
  for (int q = t; q < nseg; q += blockDim.x) {
    seg[q] = make_int4(segs[4 * q], segs[4 * q + 1], segs[4 * q + 2], segs[4 * q + 3]);
  }
  __syncthreads();
  const long long i = (b - 1 - nb_se) * blockDim.x + t;
  if (i >= nn) return;
  int q = 0;
  while (q + 1 < nseg && seg[q + 1].w <= i) ++q;
  const int4 sg = seg[q];
  if (sg.x >= gmin) nm[i] = M[level_off(sg.x) + sg.y + (i - sg.w)];
}

// -- child tables ------------------------------------------------------------
__global__ void table_msb(const int32_t* __restrict__ mags, int32_t* __restrict__ pm,
                          int32_t* __restrict__ num_bp, long long n) {
  int m = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int p = msbp1(mags[i]);
    pm[i] = p;
    m = max(m, p);
  }
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ int warp_max[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_down_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(num_bp, m);
  }
}

// nodes lo .. hi-1: the maximum over child rows ch_bounds[k] .. ch_bounds[k+1]-1,
// each a pixel (ch_src >= 0, its linear index) or a deeper node (-(id + 1))
__global__ void table_depth(const int32_t* __restrict__ pm, const int32_t* __restrict__ ch_src,
                            const int32_t* __restrict__ ch_bounds, int32_t* __restrict__ nm,
                            long long lo, long long hi) {
  const long long k = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= hi) return;
  int v = 0;
  for (int r = ch_bounds[k]; r < ch_bounds[k + 1]; ++r) {
    const int c = ch_src[r];
    v = max(v, c >= 0 ? pm[c] : nm[-(c + 1)]);
  }
  nm[k] = v;
}

__global__ void table_se(const int32_t* __restrict__ pm, const int32_t* __restrict__ nm,
                         const int32_t* __restrict__ px_parent, const int32_t* __restrict__ num_bp,
                         int32_t* __restrict__ s, int32_t* __restrict__ e, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nb = *num_bp;
  s[i] = sched_of(pm[i], nb);
  e[i] = sched_of(nm[px_parent[i]], nb);
}

// -- pyramids ------------------------------------------------------------------
__global__ void pyramid_scatter(const int32_t* __restrict__ mags, const int32_t* __restrict__ deep_idx,
                                uint8_t* __restrict__ deep, int32_t* __restrict__ num_bp, long long n) {
  int m = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int p = msbp1(mags[i]);
    deep[deep_idx[i]] = (uint8_t)p;
    m = max(m, p);
  }
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ int warp_max[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_down_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(num_bp, m);
  }
}

// level d (2^dz, 2^dy, 2^dx cells) from level d + 1, per-axis factors 1 or 2
__global__ void pyramid_pool(const uint8_t* __restrict__ fine, uint8_t* __restrict__ coarse,
                             int dz, int dy, int dx, int z2, int y2, int x2) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >> (dz + dy + dx)) return;
  const long long cx = c & ((1LL << dx) - 1), cy = (c >> dx) & ((1LL << dy) - 1), cz = c >> (dx + dy);
  const int fy = dy + (y2 - 1), fx = dx + (x2 - 1);  // log2 of the finer level's y and x sides
  int v = 0;
  for (int a = 0; a < z2; ++a)
    for (int b = 0; b < y2; ++b)
      for (int k = 0; k < x2; ++k)
        v = max(v, (int)fine[(((cz * z2 + a) << fy) | (cy * y2 + b)) << fx | (cx * x2 + k)]);
  coarse[c] = (uint8_t)v;
}

// threads 0 .. n-1: s and e of a pixel; n .. n+nn-1: a node's maximum
__global__ void pyramid_finish(const int32_t* __restrict__ mags, const uint8_t* __restrict__ flat,
                               const int32_t* __restrict__ e_src, const int32_t* __restrict__ nm_src,
                               const int32_t* __restrict__ num_bp, int32_t* __restrict__ s,
                               int32_t* __restrict__ e, int32_t* __restrict__ nm, long long n,
                               long long nn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int nb = *num_bp;
    s[i] = sched_of(msbp1(mags[i]), nb);
    e[i] = sched_of(flat[e_src[i]], nb);
  } else if (i < n + nn) {
    nm[i - n] = flat[nm_src[i - n]];
  }
}

unsigned blocks_for(long long count) { return (unsigned)((count + kThreads - 1) / kThreads); }

}  // namespace

// Launch 1 of the power-of-two cube schedule: mags (2^K)^3 int32 (8-byte
// aligned) -> pm8 (n bytes), grids K-1 .. max(K-4, 0) of the morton pyramid
// M (bytes, grid g at (8^g - 1) / 7), num_bp raised by atomicMax (the
// caller zeroes it).
extern "C" int sperr_sched_boxmax(const int32_t* mags, uint8_t* pm8, uint8_t* M, int32_t* num_bp,
                                  int K, cudaStream_t stream) {
  if (K < 1 || K > 10) return (int)cudaErrorInvalidValue;
  const int j = K - 1 < 3 ? K - 1 : 3;
  const unsigned grid = 1u << (3 * (K - 1 - j));
  sched_boxmax<<<grid, 1u << (3 * j), 0, stream>>>(mags, pm8, M, num_bp, K, j);
  return (int)cudaGetLastError();
}

// Launch 2: s, e (n int32 each) from pm8 and *num_bp; the rest of the
// pyramid; nm (nn int32) through nseg segments (g, lo, hi, out) of segs.
extern "C" int sperr_sched_virtual(const uint8_t* pm8, uint8_t* M, const int32_t* num_bp,
                                   const int32_t* segs, int nseg, int32_t* s, int32_t* e,
                                   int32_t* nm, int K, long long nn, cudaStream_t stream) {
  if (K < 1 || K > 10 || nseg < 1 || nseg > kMaxSegs || nn < 1) return (int)cudaErrorInvalidValue;
  const int gmin = K - 1 < 3 ? 0 : K - 4;
  const long long nb_se = blocks_for(1LL << (3 * (K - 1)));
  const long long grid = 1 + nb_se + blocks_for(nn);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sched_virtual<<<(unsigned)grid, kThreads, 0, stream>>>(pm8, M, num_bp, segs, nseg, s, e, nm, K,
                                                          gmin, nb_se, nn);
  return (int)cudaGetLastError();
}

// The child-table schedule: pm, num_bp (zeroed by the caller), nm by one
// launch per depth range (depths: ndepth (lo, hi) pairs, deepest first), s, e.
extern "C" int sperr_sched_table(const int32_t* mags, long long n, const int32_t* ch_src,
                                 const int32_t* ch_bounds, const long long* depths, int ndepth,
                                 const int32_t* px_parent, int32_t* num_bp, int32_t* pm, int32_t* nm, int32_t* s, int32_t* e,
                                 cudaStream_t stream) {
  if (n < 1 || ndepth < 0) return (int)cudaErrorInvalidValue;
  long long grid = blocks_for(n);
  table_msb<<<(unsigned)(grid < 4096 ? grid : 4096), kThreads, 0, stream>>>(mags, pm, num_bp, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int d = 0; d < ndepth; ++d) {
    const long long lo = depths[2 * d], hi = depths[2 * d + 1];
    if (hi <= lo) return (int)cudaErrorInvalidValue;
    table_depth<<<blocks_for(hi - lo), kThreads, 0, stream>>>(pm, ch_src, ch_bounds, nm, lo, hi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  table_se<<<blocks_for(n), kThreads, 0, stream>>>(pm, nm, px_parent, num_bp, s, e, n);
  return (int)cudaGetLastError();
}

// The pyramid schedule: flat holds levels 0 .. L (level d: 2^min(d, az) x
// 2^min(d, ay) x 2^min(d, ax) bytes, depth 0 first); num_bp zeroed by the
// caller.  Launches: the scatter into level L (which this call zeroes
// first), one pool per level, the finish.
extern "C" int sperr_sched_pyramid(const int32_t* mags, long long n, const int32_t* deep_idx,
                                   int L, int az, int ay, int ax, uint8_t* flat,
                                   const int32_t* e_src, const int32_t* nm_src, long long nn,
                                   int32_t* num_bp, int32_t* s, int32_t* e,
                                   int32_t* nm, cudaStream_t stream) {
  if (n < 1 || L < 0 || L > 30) return (int)cudaErrorInvalidValue;
  long long off[32];
  off[0] = 0;
  for (int d = 0; d <= L; ++d) {
    const int dz = d < az ? d : az, dy = d < ay ? d : ay, dx = d < ax ? d : ax;
    off[d + 1] = off[d] + (1LL << (dz + dy + dx));
  }
  cudaError_t err = cudaMemsetAsync(flat + off[L], 0, (size_t)(off[L + 1] - off[L]), stream);
  if (err != cudaSuccess) return (int)err;
  long long grid = blocks_for(n);
  pyramid_scatter<<<(unsigned)(grid < 4096 ? grid : 4096), kThreads, 0, stream>>>(
      mags, deep_idx, flat + off[L], num_bp, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int d = L - 1; d >= 0; --d) {
    const int dz = d < az ? d : az, dy = d < ay ? d : ay, dx = d < ax ? d : ax;
    pyramid_pool<<<blocks_for(off[d + 1] - off[d]), kThreads, 0, stream>>>(
        flat + off[d + 1], flat + off[d], dz, dy, dx, d < az ? 2 : 1, d < ay ? 2 : 1, d < ax ? 2 : 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pyramid_finish<<<blocks_for(n + nn), kThreads, 0, stream>>>(
      mags, flat, e_src, nm_src, num_bp, s, e, nm, n, nn);
  return (int)cudaGetLastError();
}
