// Whole-plane CDF 9/7 transforms for Hopper: every level and both axes of a
// batch of 2D planes in one launch.
//
// Replaces the Pallas kernels K2 and K3 of sperr_tpu/ops/pallas_kernels.py:
//   dwt2d_full  <- dwt2d_pallas  / _dwt2d_full_kernel  (:168-224)
//   idwt2d_full <- idwt2d_pallas / _idwt2d_full_kernel (:194-238)
// which compute what sperr_tpu/ops/cdf97_jax.py dwt2d/idwt2d compute.
//
// Data: a contiguous f32 tensor (B, ny, nx), transformed in place.  Forward
// level lev lifts the rows (x) of the (ly, lx) approximation corner, then its
// columns (y), with lx, ly = calc_approx_detail_len(n, lev); the inverse
// undoes levels lev_hi .. lev_lo+1 in reverse, columns then rows.  Each line
// is one lifting level of sperr_tpu_torch/kernels/cdf97_lift.cu: gather,
// the alpha, beta, gamma and delta/epsilon steps in the plain version's
// order of operations (sperr_tpu_torch/ops/cdf97.py lift_axis_ref), and the
// clamped neighbours of _lift_neighbors for even and odd lengths.
//
// Bound: device memory.  A 1024^2 plane is 4 MiB, more than a block's shared
// memory, so the plane stays in device memory (L2 for a few planes) between
// passes.  The kernel is persistent and cooperative: a grid no larger than
// the card holds at once walks tiles with grid-stride loops, and a grid-wide
// barrier separates the row pass from the column pass and one level from the
// next.  One launch replaces the 2 x levels launches of the per-axis driver.
// A tile keeps its lines in shared memory for all four lifting steps:
//   rows:    R neighbouring rows, each one contiguous line;
//   columns: W neighbouring columns, so each row of the tile is one
//            contiguous access (W a multiple of 8: whole 32-byte sectors).
// Built with --fmad=false and without fast math.  Each line is done by one
// block and no float reduction spans lines or planes, so the result equals
// the plain version bit for bit whatever B is and however tiles fall on
// blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 32;
// A tile of W columns stops growing at this much shared memory, so that a
// few blocks fit on each SM; a single line longer than this still gets a
// block of its own, up to the card's opt-in maximum.
constexpr int kTargetShared = 64 * 1024;
constexpr int kMaxShared = 227 * 1024;
constexpr int kDefaultShared = 48 * 1024;

struct Lift {
  float alpha, beta, gamma, delta, epsilon, inv_epsilon;
};

struct Args {
  float* x;
  long long B;
  int ny, nx;
  int lev_hi, lev_lo;  // forward: levels [lev_lo, lev_hi); inverse: lev_hi .. lev_lo+1
  int cap;             // shared memory of a block, in floats
  Lift k;
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int approx_len(int n, int lev) {
  for (int i = 0; i < lev; ++i) n -= n / 2;
  return n;
}

// Rows per row tile and columns per column tile at one level.
__host__ __device__ inline int rows_per_tile(int cap, int lx, int ly) {
  return imax(1, imin(cap / lx, ly));
}

__host__ __device__ inline int cols_per_tile(int cap, int lx, int ly) {
  int w = imin(kMaxW, cap / ly);
  if (w >= 8) w &= ~7;
  return imax(1, imin(w, lx));
}

// Tile element (w, p): line w, sample p.  Consecutive threads take
// consecutive w for column tiles and consecutive p for row tiles, so the
// device-memory and the shared-memory accesses of a warp are contiguous.
template <bool kCols>
__device__ __forceinline__ void split(int idx, int n, int wn, int& w, int& p) {
  if (kCols) {
    w = idx % wn;
    p = idx / wn;
  } else {
    p = idx % n;
    w = idx / n;
  }
}

template <bool kCols>
__device__ __forceinline__ int sidx(int w, int p, int wn, int L) {
  return kCols ? p * wn + w : w * L + p;
}

// One forward lifting level on wn lines of length L; sample p of line w is
// g[w * gw + p * gp].  Shared samples [0, el) hold the even half, [el, L)
// the odd half.
template <bool kCols>
__device__ void forward_tile(float* g, long long gw, long long gp, int wn, int L,
                             float* s, const Lift& k) {
  const int el = L - L / 2, ol = L / 2;
#define S(w, p) s[sidx<kCols>((w), (p), wn, L)]
  for (int idx = threadIdx.x; idx < wn * L; idx += blockDim.x) {
    int w, i;
    split<kCols>(idx, L, wn, w, i);
    const int p = (i & 1) ? el + (i >> 1) : (i >> 1);
    S(w, p) = g[w * gw + i * gp];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < wn * ol; idx += blockDim.x) {
    int w, j;
    split<kCols>(idx, ol, wn, w, j);
    S(w, el + j) = S(w, el + j) + k.alpha * (S(w, j) + S(w, imin(j + 1, el - 1)));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < wn * el; idx += blockDim.x) {
    int w, i;
    split<kCols>(idx, el, wn, w, i);
    S(w, i) = S(w, i) + k.beta * (S(w, el + imax(i - 1, 0)) + S(w, el + imin(i, ol - 1)));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < wn * ol; idx += blockDim.x) {
    int w, j;
    split<kCols>(idx, ol, wn, w, j);
    S(w, el + j) = S(w, el + j) + k.gamma * (S(w, j) + S(w, imin(j + 1, el - 1)));
  }
  __syncthreads();
  // delta and epsilon on the even half, -1/epsilon on the odd half, stored
  // straight back as [even | odd]
  for (int idx = threadIdx.x; idx < wn * L; idx += blockDim.x) {
    int w, i;
    split<kCols>(idx, L, wn, w, i);
    float r;
    if (i < el) {
      r = k.epsilon *
          (S(w, i) + k.delta * (S(w, el + imax(i - 1, 0)) + S(w, el + imin(i, ol - 1))));
    } else {
      r = S(w, i) * (-k.inv_epsilon);
    }
    g[w * gw + i * gp] = r;
  }
#undef S
}

template <bool kCols>
__device__ void inverse_tile(float* g, long long gw, long long gp, int wn, int L,
                             float* s, const Lift& k) {
  const int el = L - L / 2, ol = L / 2;
#define S(w, p) s[sidx<kCols>((w), (p), wn, L)]
  // load [even | odd]; the first synthesis step scales the odd half
  for (int idx = threadIdx.x; idx < wn * L; idx += blockDim.x) {
    int w, i;
    split<kCols>(idx, L, wn, w, i);
    const float v = g[w * gw + i * gp];
    S(w, i) = i < el ? v : v * (-k.epsilon);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < wn * el; idx += blockDim.x) {
    int w, i;
    split<kCols>(idx, el, wn, w, i);
    S(w, i) = S(w, i) * k.inv_epsilon -
              k.delta * (S(w, el + imax(i - 1, 0)) + S(w, el + imin(i, ol - 1)));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < wn * ol; idx += blockDim.x) {
    int w, j;
    split<kCols>(idx, ol, wn, w, j);
    S(w, el + j) = S(w, el + j) - k.gamma * (S(w, j) + S(w, imin(j + 1, el - 1)));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < wn * el; idx += blockDim.x) {
    int w, i;
    split<kCols>(idx, el, wn, w, i);
    S(w, i) = S(w, i) - k.beta * (S(w, el + imax(i - 1, 0)) + S(w, el + imin(i, ol - 1)));
  }
  __syncthreads();
  // last alpha step on the odd half, written interleaved: position 2h takes
  // even[h], position 2h+1 takes odd[h]
  for (int idx = threadIdx.x; idx < wn * L; idx += blockDim.x) {
    int w, p;
    split<kCols>(idx, L, wn, w, p);
    const int h = p >> 1;
    float r;
    if (p & 1) {
      r = S(w, el + h) - k.alpha * (S(w, h) + S(w, imin(h + 1, el - 1)));
    } else {
      r = S(w, h);
    }
    g[w * gw + p * gp] = r;
  }
#undef S
}

// One pass over the (ly, lx) corner of every plane: rows (lines along x) or
// columns (lines along y), tiles walked grid-stride.
template <bool kCols, bool kInverse>
__device__ void pass(const Args& a, int lx, int ly, float* s) {
  const long long plane = (long long)a.ny * a.nx;
  int per, span, L;
  long long gw, gp, step;
  if (kCols) {
    span = cols_per_tile(a.cap, lx, ly);
    per = (lx + span - 1) / span;
    L = ly;
    gw = 1;
    gp = a.nx;
    step = 1;  // tile t starts span columns further along x
  } else {
    span = rows_per_tile(a.cap, lx, ly);
    per = (ly + span - 1) / span;
    L = lx;
    gw = a.nx;
    gp = 1;
    step = a.nx;  // and span rows further along y
  }
  const int extent = kCols ? lx : ly;
  const long long ntiles = a.B * per;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long b = t / per;
    const int u0 = (int)(t % per) * span;
    const int wn = imin(span, extent - u0);
    float* g = a.x + b * plane + (long long)u0 * step;
    __syncthreads();  // the previous tile's last step still reads s
    if (kInverse) {
      inverse_tile<kCols>(g, gw, gp, wn, L, s, a.k);
    } else {
      forward_tile<kCols>(g, gw, gp, wn, L, s, a.k);
    }
  }
}

__global__ void __launch_bounds__(kThreads) dwt2d_full(Args a) {
  extern __shared__ float s[];
  cg::grid_group grid = cg::this_grid();
  for (int lev = a.lev_lo; lev < a.lev_hi; ++lev) {
    const int lx = approx_len(a.nx, lev), ly = approx_len(a.ny, lev);
    pass<false, false>(a, lx, ly, s);  // rows (x) first
    grid.sync();
    pass<true, false>(a, lx, ly, s);   // then columns (y)
    if (lev + 1 < a.lev_hi) grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads) idwt2d_full(Args a) {
  extern __shared__ float s[];
  cg::grid_group grid = cg::this_grid();
  for (int lev = a.lev_hi; lev > a.lev_lo; --lev) {
    const int lx = approx_len(a.nx, lev - 1), ly = approx_len(a.ny, lev - 1);
    pass<true, true>(a, lx, ly, s);    // columns (y) first
    grid.sync();
    pass<false, true>(a, lx, ly, s);   // then rows (x)
    if (lev - 1 > a.lev_lo) grid.sync();
  }
}

}  // namespace

// x: contiguous f32 (B, ny, nx) on the current device, transformed in place.
// inverse = 0: forward levels [lev_lo, lev_hi); inverse = 1: undo levels
// lev_hi .. lev_lo+1.  consts: host {alpha, beta, gamma, delta, epsilon,
// inv_epsilon}.  info (host, 4 ints) receives the grid, the blocks per SM,
// the shared bytes per block and the threads per block.  Returns the
// cudaError_t of the launch (0 on success); a grid the card cannot hold at
// once is refused by the cooperative launch, never split.
extern "C" int sperr_cdf97_2d(float* x, long long B, int ny, int nx, int inverse,
                              int lev_hi, int lev_lo, const float* consts, int* info,
                              cudaStream_t stream) {
  if (B <= 0 || ny < 1 || nx < 1 || lev_lo < 0 || lev_hi <= lev_lo) {
    return (int)cudaErrorInvalidValue;
  }
  // every line of every level needs two samples; the longest lines are
  // those of level lev_lo (forward: its own level; inverse: the last undone)
  const int lx0 = approx_len(nx, lev_lo), ly0 = approx_len(ny, lev_lo);
  if (approx_len(nx, lev_hi - 1) < 2 || approx_len(ny, lev_hi - 1) < 2) {
    return (int)cudaErrorInvalidValue;
  }
  long long cap = ly0 * (long long)kMaxW;
  if (cap * 4 > kTargetShared) cap = kTargetShared / 4;
  cap = cap > lx0 ? cap : lx0;
  cap = cap > ly0 ? cap : ly0;
  if (cap * 4 > kMaxShared) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)cap * sizeof(float);
  const void* fn = inverse ? (const void*)idwt2d_full : (const void*)dwt2d_full;

  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (shmem > kDefaultShared) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, shmem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;

  // no more blocks than the largest pass has tiles
  long long tiles = 1;
  for (int lev = lev_lo; lev < lev_hi; ++lev) {
    const int lx = approx_len(nx, lev), ly = approx_len(ny, lev);
    const int c = (int)cap;
    const long long rt = B * ((ly + rows_per_tile(c, lx, ly) - 1) / rows_per_tile(c, lx, ly));
    const long long ct = B * ((lx + cols_per_tile(c, lx, ly) - 1) / cols_per_tile(c, lx, ly));
    tiles = tiles > rt ? tiles : rt;
    tiles = tiles > ct ? tiles : ct;
  }
  long long grid = (long long)per_sm * sms;
  if (grid > tiles) grid = tiles;

  Args a;
  a.x = x;
  a.B = B;
  a.ny = ny;
  a.nx = nx;
  a.lev_hi = lev_hi;
  a.lev_lo = lev_lo;
  a.cap = (int)cap;
  a.k = Lift{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5]};
  void* params[] = {&a};
  if (info) {
    info[0] = (int)grid;
    info[1] = per_sm;
    info[2] = (int)shmem;
    info[3] = kThreads;
  }
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), dim3(kThreads), params, shmem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
