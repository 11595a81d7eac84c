// Fused midtread quantizer (K1) for Hopper.
//
// Replaces sperr_tpu/ops/pallas_kernels.py quantize_pallas/_quantize_kernel.
// Per element of row b: ll = rint(c * inv_q[b]) (round half to even, a
// multiply by the reciprocal, never a division), sign = ll >= 0 (so -0.0 is
// positive), mag = |ll| as int32; per row: the max magnitude.
//
// Bound: device memory.  Each element reads 4 bytes and writes 5 (4 for the
// magnitude, 1 for the sign) with two flops in between, far below the card's
// flop-per-byte balance.  The design keeps the pass to one read and one
// write: neighbouring threads touch neighbouring elements, the row maximum is
// reduced in registers and shared memory and leaves the block as one integer
// atomicMax (exact and independent of order, so results are deterministic).
// Built with --fmad=false and without fast math; the outputs equal the plain
// version (sperr_tpu_torch/ops/quantize.py quantize_ref) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void quantize_kernel(const float* __restrict__ coeffs,
                                const float* __restrict__ inv_q,
                                int32_t* __restrict__ mags,
                                uint8_t* __restrict__ signs,
                                int32_t* __restrict__ maxmag, long long n) {
  const int b = blockIdx.y;
  const float inv = inv_q[b];
  const long long row = (long long)b * n;
  int m = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float ll = rintf(coeffs[row + i] * inv);
    signs[row + i] = ll >= 0.0f;
    const int mag = (int)fabsf(ll);
    mags[row + i] = mag;
    m = max(m, mag);
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  __shared__ int warp_max[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      m = max(m, __shfl_down_sync(0xffffffffu, m, off));
    }
    if (lane == 0) atomicMax(&maxmag[b], m);
  }
}

}  // namespace

// coeffs (B, n) f32, inv_q (B,) f32 -> mags (B, n) i32, signs (B, n) bool,
// maxmag (B,) i32, which the caller zeroes.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int sperr_quantize(const float* coeffs, const float* inv_q,
                              int32_t* mags, uint8_t* signs, int32_t* maxmag,
                              long long B, long long n, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  long long per_row = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (per_row > 4096) per_row = 4096;
  dim3 grid((unsigned)per_row, (unsigned)B);
  quantize_kernel<<<grid, kThreads, 0, stream>>>(coeffs, inv_q, mags, signs,
                                                 maxmag, n);
  return (int)cudaGetLastError();
}
