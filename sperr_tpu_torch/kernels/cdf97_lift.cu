// CDF 9/7 lifting for Hopper: one level along one axis per launch.
//
// Carries the 3D transform (K4: sperr_tpu/ops/cdf97_jax.py dwt3d/idwt3d,
// levels at :214-227) and the per-axis 1D/2D drivers.
//
// Data: a contiguous f32 tensor (B, nz, ny, nx).  A level works on the
// sub-box (lz, ly, lx) at the origin; every line of that box along `axis`
// (length L) is transformed in place, which is what _set_corner3 does.
//   forward: gather (even samples to the front, odd to the back, :90-93),
//            then the alpha, beta, gamma and delta/epsilon steps of
//            `analysis` (:51-68) in that order of operations;
//   inverse: `synthesis` (:71-87), then the interleave of `scatter`
//            (:95-112).
// Boundary neighbours are clamped as _lift_neighbors does (:38-48), for even
// and odd L: even[min(j+1, el-1)], odd[max(i-1, 0)], odd[min(i, ol-1)].
//
// Bound: device memory.  A level reads and writes each sample of its box
// once, with ~10 flops per sample.  Two designs, by the shape of the work
// (an earlier design kept a tile of lines in shared memory for every axis,
// with one 1 KB line per block along x):
//   x lines of up to 512 samples (lift_x): one warp per line, several lines
//     per block.  Lane l holds the K (even, odd) pairs 2lK .. 2lK+2K-1 in
//     registers, loaded and stored with 16-byte accesses; the lifting steps
//     run on registers, and the one neighbour a lane lacks comes from the
//     next or previous lane by a shuffle.  No shared memory, no barrier.
//   y and z lines, and longer x lines (lift_tile): a block holds a tile of
//     W lines in shared memory (dynamic, up to 96 KB by opt-in).  Along y
//     and z the W lines are x-neighbours, so each row of the tile is W
//     contiguous floats, copied with 16-byte cp.async (all rows in flight,
//     the gather folded into the destination row) and stored as float4.
// A kernel that ran every level of a corner of at most 32^3 in one block
// was tried and dropped: one SM walking the lines one after another took
// 0.051-0.059 ms where the six launches it replaced take 0.018 ms of
// device time (PERF.md).
// Built with --fmad=false and without fast math: each product and sum rounds
// on its own, as in the plain version (sperr_tpu_torch/ops/cdf97.py
// lift_axis_ref), and every sample sees the same operations in the same
// order in both designs.  No atomics: results are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileMaxShared = 96 * 1024;   // a tile of lines (opt-in)
constexpr int kMaxTileW = 32;               // lines per tile
constexpr int kXMaxLen = 512;               // longest x line on registers

struct Lift {
  float alpha, beta, gamma, delta, epsilon, inv_epsilon;
};

// ---------------------------------------------------------------------------
// One lifting level on registers.  Lane l holds pairs p = l*K + k (k < K):
// e[k] = even[p] (p < el), o[k] = odd[p] (p < ol).  Entries past el / ol
// are never read by a real pair.  The clamped neighbours map to the pair
// itself or its left neighbour:
//   even[min(p+1, el-1)] is even[p] when p+1 > el-1;
//   odd[max(p-1, 0)]     is odd[0]  when p = 0;
//   odd[min(p, ol-1)]    is odd[p-1] when p > ol-1 (p = el-1, L odd).
// ---------------------------------------------------------------------------
template <int K>
__device__ __forceinline__ float even_right(const float (&e)[K], int k, int p, int el, float nxt) {
  if (p + 1 > el - 1) return e[k];
  return k + 1 < K ? e[k + 1] : nxt;
}

template <int K>
__device__ __forceinline__ float odd_left(const float (&o)[K], int k, int p, float prv) {
  if (p == 0) return o[0];
  return k > 0 ? o[k - 1] : prv;
}

// odd[j] + s * (even[j] + even[min(j+1, el-1)]), or minus for the inverse
template <int K, bool SUB>
__device__ __forceinline__ void odd_step(float (&e)[K], float (&o)[K], int lane, int el, int ol, float s) {
  const float nxt = __shfl_down_sync(kFull, e[0], 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = lane * K + k;
    if (p < ol) {
      const float t = e[k] + even_right<K>(e, k, p, el, nxt);
      o[k] = SUB ? o[k] - s * t : o[k] + s * t;
    }
  }
}

// even[i] +/- s * (odd[max(i-1, 0)] + odd[min(i, ol-1)])
template <int K, bool SUB>
__device__ __forceinline__ void even_step(float (&e)[K], float (&o)[K], int lane, int el, int ol, float s) {
  const float prv = __shfl_up_sync(kFull, o[K - 1], 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = lane * K + k;
    if (p < el) {
      const float l = odd_left<K>(o, k, p, prv);
      const float r = p <= ol - 1 ? o[k] : l;
      e[k] = SUB ? e[k] - s * (l + r) : e[k] + s * (l + r);
    }
  }
}

template <int K>
__device__ __forceinline__ void forward_pairs(float (&e)[K], float (&o)[K], int lane, int el, int ol,
                                              const Lift& c) {
  odd_step<K, false>(e, o, lane, el, ol, c.alpha);
  even_step<K, false>(e, o, lane, el, ol, c.beta);
  odd_step<K, false>(e, o, lane, el, ol, c.gamma);
  // even: epsilon * (even + delta * (odd_l + odd_r)); odd: odd * -1/epsilon
  const float prv = __shfl_up_sync(kFull, o[K - 1], 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = lane * K + k;
    if (p < el) {
      const float l = odd_left<K>(o, k, p, prv);
      const float r = p <= ol - 1 ? o[k] : l;
      e[k] = c.epsilon * (e[k] + c.delta * (l + r));
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) o[k] = o[k] * (-c.inv_epsilon);
}

// The inverse, on pairs whose odd halves are already scaled by -epsilon.
template <int K>
__device__ __forceinline__ void inverse_pairs(float (&e)[K], float (&o)[K], int lane, int el, int ol,
                                              const Lift& c) {
  // even * (1/epsilon) - delta * (odd_l + odd_r)
  const float prv = __shfl_up_sync(kFull, o[K - 1], 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = lane * K + k;
    if (p < el) {
      const float l = odd_left<K>(o, k, p, prv);
      const float r = p <= ol - 1 ? o[k] : l;
      e[k] = e[k] * c.inv_epsilon - c.delta * (l + r);
    }
  }
  odd_step<K, true>(e, o, lane, el, ol, c.gamma);
  even_step<K, true>(e, o, lane, el, ol, c.beta);
  odd_step<K, true>(e, o, lane, el, ol, c.alpha);
}

// N consecutive floats from p + start (entries at or past `limit` read as
// 0), with 16-byte loads where the span is whole and aligned.
template <int N>
__device__ __forceinline__ void load_span(const float* p, int start, int limit, float (&v)[N]) {
  const float* q = p + start;
  if constexpr (N % 4 == 0) {
    if (start + N <= limit && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 t = *reinterpret_cast<const float4*>(q + i);
        v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = start + i < limit ? q[i] : 0.0f;
}

template <int N>
__device__ __forceinline__ void store_span(float* p, int start, int limit, const float (&v)[N]) {
  float* q = p + start;
  if constexpr (N % 4 == 0) {
    if (start + N <= limit && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        *reinterpret_cast<float4*>(q + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (start + i < limit) q[i] = v[i];
  }
}

// ---------------------------------------------------------------------------
// x lines on registers: one warp per line of L = lx <= 64 K samples.
// ---------------------------------------------------------------------------
template <int K, bool INV>
__global__ void lift_x(float* __restrict__ x, long long nlines, int ly, int lz, int ny, int nx,
                       long long plane, int L, Lift c) {
  const int lane = threadIdx.x & 31;
  const int el = L - L / 2, ol = L / 2;
  for (long long line = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       line < nlines; line += (long long)gridDim.x * (kThreads / 32)) {
    const int y = (int)(line % ly);
    const long long t = line / ly;
    const int z = (int)(t % lz);
    const long long b = t / lz;
    float* row = x + b * plane + ((long long)z * ny + y) * nx;
    float e[K], o[K];
    if (!INV) {
      float s[2 * K];
      load_span<2 * K>(row, 2 * lane * K, L, s);
#pragma unroll
      for (int k = 0; k < K; ++k) { e[k] = s[2 * k]; o[k] = s[2 * k + 1]; }
      forward_pairs<K>(e, o, lane, el, ol, c);
      store_span<K>(row, lane * K, el, e);
      store_span<K>(row + el, lane * K, ol, o);
    } else {
      load_span<K>(row, lane * K, el, e);
      load_span<K>(row + el, lane * K, ol, o);
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = o[k] * (-c.epsilon);
      inverse_pairs<K>(e, o, lane, el, ol, c);
      float s[2 * K];
#pragma unroll
      for (int k = 0; k < K; ++k) { s[2 * k] = e[k]; s[2 * k + 1] = o[k]; }
      store_span<2 * K>(row, 2 * lane * K, L, s);
    }
  }
}

// ---------------------------------------------------------------------------
// A tile of W lines in shared memory.  Tile element (w, p) lives at
// s[p * W + w]; rows [0, el) hold the even half, rows [el, L) the odd half.
// W is a power of two; threads (ty, tx) = (tid >> logW, tid & (W-1)).
// ---------------------------------------------------------------------------
struct Geometry {
  long long sb, su, sv, sl;  // strides: batch, tiled dim, other dim, line
  int eu, ev;                // extents of the tiled and the other dim
  int L, W, logW, ntiles;    // line length, lines per tile, log2 W, tiles along u
  int vec;                   // su == 1 and W % 4 == 0: rows as float4
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy the tile's rows into shared memory: source row i goes to row dst(i)
// (the gather for the forward, the identity for the inverse).
template <bool GATHER>
__device__ __forceinline__ void load_tile(float* s, const float* base, const Geometry& g, int wn) {
  const int L = g.L, W = g.W, el = L - L / 2;
  if (g.vec) {
    const int lq = g.logW - 2;  // quads per row = W / 4
    for (int idx = threadIdx.x; idx < (L << lq); idx += blockDim.x) {
      const int i = idx >> lq, cq = (idx & ((1 << lq) - 1)) << 2;
      const int p = GATHER ? ((i & 1) ? el + (i >> 1) : (i >> 1)) : i;
      const float* src = base + i * g.sl + cq;
      float* dst = s + p * W + cq;
      if (cq + 4 <= wn && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        cp_async16(dst, src);
      } else {
        for (int t = 0; t < 4; ++t) {
          if (cq + t < wn) dst[t] = src[t];
        }
      }
    }
    cp_async_wait_all();
  } else {
    for (int idx = threadIdx.x; idx < (L << g.logW); idx += blockDim.x) {
      const int i = idx >> g.logW, w = idx & (W - 1);
      const int p = GATHER ? ((i & 1) ? el + (i >> 1) : (i >> 1)) : i;
      if (w < wn) s[p * W + w] = base[w * g.su + i * g.sl];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float* tile_base(float* x, const Geometry& g, int* wn) {
  long long blk = blockIdx.x;
  const int tile = (int)(blk % g.ntiles);
  blk /= g.ntiles;
  const int v = (int)(blk % g.ev);
  const long long b = blk / g.ev;
  const int u0 = tile * g.W;
  *wn = min(g.W, g.eu - u0);
  return x + b * g.sb + (long long)v * g.sv + (long long)u0 * g.su;
}

// Store the tile's output: value(i, w) of output row i, as float4 rows where
// the geometry allows.
template <typename F>
__device__ __forceinline__ void store_tile(float* base, const Geometry& g, int wn, F value) {
  const int L = g.L, W = g.W;
  if (g.vec) {
    const int lq = g.logW - 2;
    for (int idx = threadIdx.x; idx < (L << lq); idx += blockDim.x) {
      const int i = idx >> lq, cq = (idx & ((1 << lq) - 1)) << 2;
      float* dst = base + i * g.sl + cq;
      if (cq + 4 <= wn && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(value(i, cq), value(i, cq + 1), value(i, cq + 2), value(i, cq + 3));
      } else {
        for (int t = 0; t < 4; ++t) {
          if (cq + t < wn) dst[t] = value(i, cq + t);
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < (L << g.logW); idx += blockDim.x) {
      const int i = idx >> g.logW, w = idx & (W - 1);
      if (w < wn) base[w * g.su + i * g.sl] = value(i, w);
    }
  }
}

__global__ void lift_tile_forward(float* __restrict__ x, Geometry g, Lift k) {
  extern __shared__ __align__(16) float s[];
  int wn;
  float* base = tile_base(x, g, &wn);
  const int L = g.L, W = g.W, el = L - L / 2, ol = L / 2;
  const int tx = threadIdx.x & (W - 1), ty = threadIdx.x >> g.logW, TY = blockDim.x >> g.logW;
  float* ev = s;
  float* od = s + el * W;
  load_tile<true>(s, base, g, wn);
  if (tx < wn) {
    for (int j = ty; j < ol; j += TY)
      od[j * W + tx] = od[j * W + tx] + k.alpha * (ev[j * W + tx] + ev[min(j + 1, el - 1) * W + tx]);
  }
  __syncthreads();
  if (tx < wn) {
    for (int i = ty; i < el; i += TY)
      ev[i * W + tx] = ev[i * W + tx] + k.beta * (od[max(i - 1, 0) * W + tx] + od[min(i, ol - 1) * W + tx]);
  }
  __syncthreads();
  if (tx < wn) {
    for (int j = ty; j < ol; j += TY)
      od[j * W + tx] = od[j * W + tx] + k.gamma * (ev[j * W + tx] + ev[min(j + 1, el - 1) * W + tx]);
  }
  __syncthreads();
  // delta and epsilon on the even half, -1/epsilon on the odd half, stored
  // straight back as [even | odd]
  store_tile(base, g, wn, [&](int i, int w) {
    if (i < el)
      return k.epsilon * (ev[i * W + w] + k.delta * (od[max(i - 1, 0) * W + w] + od[min(i, ol - 1) * W + w]));
    return od[(i - el) * W + w] * (-k.inv_epsilon);
  });
}

__global__ void lift_tile_inverse(float* __restrict__ x, Geometry g, Lift k) {
  extern __shared__ __align__(16) float s[];
  int wn;
  float* base = tile_base(x, g, &wn);
  const int L = g.L, W = g.W, el = L - L / 2, ol = L / 2;
  const int tx = threadIdx.x & (W - 1), ty = threadIdx.x >> g.logW, TY = blockDim.x >> g.logW;
  float* ev = s;
  float* od = s + el * W;
  load_tile<false>(s, base, g, wn);
  // the first synthesis step scales the odd half
  if (tx < wn) {
    for (int j = ty; j < ol; j += TY) od[j * W + tx] = od[j * W + tx] * (-k.epsilon);
  }
  __syncthreads();
  if (tx < wn) {
    for (int i = ty; i < el; i += TY)
      ev[i * W + tx] = ev[i * W + tx] * k.inv_epsilon -
                       k.delta * (od[max(i - 1, 0) * W + tx] + od[min(i, ol - 1) * W + tx]);
  }
  __syncthreads();
  if (tx < wn) {
    for (int j = ty; j < ol; j += TY)
      od[j * W + tx] = od[j * W + tx] - k.gamma * (ev[j * W + tx] + ev[min(j + 1, el - 1) * W + tx]);
  }
  __syncthreads();
  if (tx < wn) {
    for (int i = ty; i < el; i += TY)
      ev[i * W + tx] = ev[i * W + tx] - k.beta * (od[max(i - 1, 0) * W + tx] + od[min(i, ol - 1) * W + tx]);
  }
  __syncthreads();
  // last alpha step on the odd half, written interleaved: position 2h takes
  // even[h], position 2h+1 takes odd[h]
  store_tile(base, g, wn, [&](int p, int w) {
    const int h = p >> 1;
    if (p & 1) return od[h * W + w] - k.alpha * (ev[h * W + w] + ev[min(h + 1, el - 1) * W + w]);
    return ev[h * W + w];
  });
}

template <int K>
int launch_x(float* x, long long B, int nz, int ny, int nx, int lz, int ly, int lx, bool inverse,
             const Lift& k, cudaStream_t stream) {
  const long long nlines = B * lz * ly;
  long long blocks = (nlines + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  const long long plane = (long long)nz * ny * nx;
  if (inverse) {
    lift_x<K, true><<<(unsigned)blocks, kThreads, 0, stream>>>(x, nlines, ly, lz, ny, nx, plane, lx, k);
  } else {
    lift_x<K, false><<<(unsigned)blocks, kThreads, 0, stream>>>(x, nlines, ly, lz, ny, nx, plane, lx, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous f32 (B, nz, ny, nx) on the device, updated in place on the
// sub-box (lz, ly, lx) at the origin.  axis: -1 (x), -2 (y) or -3 (z).
// consts: host array {alpha, beta, gamma, delta, epsilon, inv_epsilon}.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sperr_cdf97_lift(float* x, long long B, int nz, int ny, int nx,
                                int lz, int ly, int lx, int axis, int inverse,
                                const float* consts, cudaStream_t stream) {
  if (B <= 0 || lz < 1 || ly < 1 || lx < 1 || lz > nz || ly > ny || lx > nx) {
    return (int)cudaErrorInvalidValue;
  }
  const Lift k = {consts[0], consts[1], consts[2], consts[3], consts[4], consts[5]};
  if (axis == -1 && lx >= 2 && lx <= kXMaxLen) {
    const int el = lx - lx / 2;
    if (el <= 32) return launch_x<1>(x, B, nz, ny, nx, lz, ly, lx, inverse, k, stream);
    if (el <= 64) return launch_x<2>(x, B, nz, ny, nx, lz, ly, lx, inverse, k, stream);
    if (el <= 128) return launch_x<4>(x, B, nz, ny, nx, lz, ly, lx, inverse, k, stream);
    return launch_x<8>(x, B, nz, ny, nx, lz, ly, lx, inverse, k, stream);
  }
  Geometry g;
  g.sb = (long long)nz * ny * nx;
  if (axis == -1) {  // long lines along x; one line per tile
    g.L = lx; g.sl = 1;
    g.eu = ly; g.su = nx;
    g.ev = lz; g.sv = (long long)ny * nx;
    g.W = 1;
  } else if (axis == -2) {  // lines along y; tiles over x; z outside
    g.L = ly; g.sl = nx;
    g.eu = lx; g.su = 1;
    g.ev = lz; g.sv = (long long)ny * nx;
    g.W = kMaxTileW;
  } else if (axis == -3) {  // lines along z; tiles over x; y outside
    g.L = lz; g.sl = (long long)ny * nx;
    g.eu = lx; g.su = 1;
    g.ev = ly; g.sv = nx;
    g.W = kMaxTileW;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (g.L < 2) return (int)cudaErrorInvalidValue;
  while (g.W > 1 && g.W / 2 >= g.eu) g.W >>= 1;  // the least power of two >= eu
  while (g.W > 1 && (long long)g.L * g.W * 4 > kTileMaxShared) g.W >>= 1;
  if ((long long)g.L * g.W * 4 > kTileMaxShared) return (int)cudaErrorInvalidValue;
  g.logW = 0;
  while ((1 << g.logW) < g.W) ++g.logW;
  g.vec = g.su == 1 && g.W % 4 == 0;
  g.ntiles = (g.eu + g.W - 1) / g.W;
  const long long blocks = (long long)g.ntiles * g.ev * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)g.L * g.W * sizeof(float);
  auto fn = inverse ? &lift_tile_inverse : &lift_tile_forward;
  if (shmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  fn<<<(unsigned)blocks, kThreads, shmem, stream>>>(x, g, k);
  return (int)cudaGetLastError();
}

extern "C" const char* sperr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
