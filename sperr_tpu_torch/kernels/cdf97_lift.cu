// One CDF 9/7 lifting level along one axis, forward and inverse, for Hopper.
//
// Carries the 3D transform (K4: sperr_tpu/ops/cdf97_jax.py dwt3d/idwt3d,
// levels at :214-227) and is the body of the 2D Pallas kernels K2/K3
// (sperr_tpu/ops/pallas_kernels.py dwt2d_pallas/idwt2d_pallas).
//
// Data: a contiguous f32 tensor (B, nz, ny, nx).  The level works on the
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
// Bound: device memory.  A level reads and writes each sample of the box
// once, with ~10 flops per sample.  One block holds a tile of W lines in
// shared memory for all lifting steps, so intermediates never reach device
// memory.  Along x (contiguous lines) W = 1 and neighbouring threads read
// neighbouring samples; along y and z W = 32 lines that are neighbours in x,
// so each row of the tile is one coalesced 128-byte access.
// Built with --fmad=false and without fast math: each product and sum rounds
// on its own, as in the plain version (sperr_tpu_torch/ops/cdf97.py
// lift_axis_ref).  No atomics: results are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShared = 48 * 1024;

struct Lift {
  float alpha, beta, gamma, delta, epsilon, inv_epsilon;
};

struct Geometry {
  long long sb, su, sv, sl;  // strides: batch, tiled dim, other dim, line
  int eu, ev;                // extents of the tiled and the other dim
  int L, W, ntiles;          // line length, lines per tile, tiles along u
};

// Tile element (w, p) lives at s[p * W + w]; rows [0, el) hold the even
// half, rows [el, L) the odd half.
__device__ inline float* tile_base(float* x, const Geometry& g, int* wn) {
  long long blk = blockIdx.x;
  const int tile = (int)(blk % g.ntiles);
  blk /= g.ntiles;
  const int v = (int)(blk % g.ev);
  const long long b = blk / g.ev;
  const int u0 = tile * g.W;
  *wn = min(g.W, g.eu - u0);
  return x + b * g.sb + (long long)v * g.sv + (long long)u0 * g.su;
}

__global__ void lift_forward(float* __restrict__ x, Geometry g, Lift k) {
  extern __shared__ float s[];
  int wn;
  float* base = tile_base(x, g, &wn);
  const int L = g.L, W = g.W, el = L - L / 2, ol = L / 2;
  float* ev = s;
  float* od = s + el * W;
  // gather: position i goes to even[i/2] or odd[i/2]
  for (int idx = threadIdx.x; idx < L * W; idx += blockDim.x) {
    const int w = idx % W, i = idx / W;
    if (w < wn) {
      const int p = (i & 1) ? el + (i >> 1) : (i >> 1);
      s[p * W + w] = base[w * g.su + i * g.sl];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ol * W; idx += blockDim.x) {
    const int w = idx % W, j = idx / W;
    if (w < wn) {
      od[j * W + w] =
          od[j * W + w] + k.alpha * (ev[j * W + w] + ev[min(j + 1, el - 1) * W + w]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < el * W; idx += blockDim.x) {
    const int w = idx % W, i = idx / W;
    if (w < wn) {
      ev[i * W + w] =
          ev[i * W + w] + k.beta * (od[max(i - 1, 0) * W + w] + od[min(i, ol - 1) * W + w]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ol * W; idx += blockDim.x) {
    const int w = idx % W, j = idx / W;
    if (w < wn) {
      od[j * W + w] =
          od[j * W + w] + k.gamma * (ev[j * W + w] + ev[min(j + 1, el - 1) * W + w]);
    }
  }
  __syncthreads();
  // delta and epsilon on the even half, -1/epsilon on the odd half, stored
  // straight back as [even | odd]
  for (int idx = threadIdx.x; idx < L * W; idx += blockDim.x) {
    const int w = idx % W, i = idx / W;
    if (w < wn) {
      float r;
      if (i < el) {
        r = k.epsilon * (ev[i * W + w] +
                         k.delta * (od[max(i - 1, 0) * W + w] + od[min(i, ol - 1) * W + w]));
      } else {
        r = od[(i - el) * W + w] * (-k.inv_epsilon);
      }
      base[w * g.su + i * g.sl] = r;
    }
  }
}

__global__ void lift_inverse(float* __restrict__ x, Geometry g, Lift k) {
  extern __shared__ float s[];
  int wn;
  float* base = tile_base(x, g, &wn);
  const int L = g.L, W = g.W, el = L - L / 2, ol = L / 2;
  float* ev = s;
  float* od = s + el * W;
  // load [even | odd]; the first synthesis step scales the odd half
  for (int idx = threadIdx.x; idx < L * W; idx += blockDim.x) {
    const int w = idx % W, i = idx / W;
    if (w < wn) {
      const float v = base[w * g.su + i * g.sl];
      s[i * W + w] = i < el ? v : v * (-k.epsilon);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < el * W; idx += blockDim.x) {
    const int w = idx % W, i = idx / W;
    if (w < wn) {
      ev[i * W + w] = ev[i * W + w] * k.inv_epsilon -
                      k.delta * (od[max(i - 1, 0) * W + w] + od[min(i, ol - 1) * W + w]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ol * W; idx += blockDim.x) {
    const int w = idx % W, j = idx / W;
    if (w < wn) {
      od[j * W + w] =
          od[j * W + w] - k.gamma * (ev[j * W + w] + ev[min(j + 1, el - 1) * W + w]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < el * W; idx += blockDim.x) {
    const int w = idx % W, i = idx / W;
    if (w < wn) {
      ev[i * W + w] =
          ev[i * W + w] - k.beta * (od[max(i - 1, 0) * W + w] + od[min(i, ol - 1) * W + w]);
    }
  }
  __syncthreads();
  // last alpha step on the odd half, written interleaved: position 2i takes
  // even[i], position 2j+1 takes odd[j]
  for (int idx = threadIdx.x; idx < L * W; idx += blockDim.x) {
    const int w = idx % W, p = idx / W;
    if (w < wn) {
      const int h = p >> 1;
      float r;
      if (p & 1) {
        r = od[h * W + w] - k.alpha * (ev[h * W + w] + ev[min(h + 1, el - 1) * W + w]);
      } else {
        r = ev[h * W + w];
      }
      base[w * g.su + p * g.sl] = r;
    }
  }
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
  Geometry g;
  g.sb = (long long)nz * ny * nx;
  if (axis == -1) {  // lines along x; tiles over y; z outside
    g.L = lx; g.sl = 1;
    g.eu = ly; g.su = nx;
    g.ev = lz; g.sv = (long long)ny * nx;
    g.W = 1;
  } else if (axis == -2) {  // lines along y; tiles over x; z outside
    g.L = ly; g.sl = nx;
    g.eu = lx; g.su = 1;
    g.ev = lz; g.sv = (long long)ny * nx;
    g.W = 32;
  } else if (axis == -3) {  // lines along z; tiles over x; y outside
    g.L = lz; g.sl = (long long)ny * nx;
    g.eu = lx; g.su = 1;
    g.ev = ly; g.sv = nx;
    g.W = 32;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (g.L < 2) return (int)cudaErrorInvalidValue;
  if (g.W > g.eu) g.W = g.eu;
  while (g.W > 1 && (long long)g.L * g.W * 4 > kMaxShared) g.W >>= 1;
  if ((long long)g.L * g.W * 4 > kMaxShared) return (int)cudaErrorInvalidValue;
  g.ntiles = (g.eu + g.W - 1) / g.W;
  const long long blocks = (long long)g.ntiles * g.ev * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Lift k = {consts[0], consts[1], consts[2], consts[3], consts[4], consts[5]};
  const size_t shmem = (size_t)g.L * g.W * sizeof(float);
  if (inverse) {
    lift_inverse<<<(unsigned)blocks, kThreads, shmem, stream>>>(x, g, k);
  } else {
    lift_forward<<<(unsigned)blocks, kThreads, shmem, stream>>>(x, g, k);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sperr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
