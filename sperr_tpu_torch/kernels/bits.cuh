// Device helpers shared by the bit kernels (bits.cu: K10) and the emission
// kernels (emit.cu: K9).
#pragma once

#include <stdint.h>

namespace sperr_bits {

// the 32x32 transpose of the warp's words by five shuffle stages: stage j
// swaps the off-diagonal j-blocks (lanes l, l ^ j; bits with and without
// bit j of their index set), so lane p ends with bit l = bit p of lane l
__device__ __forceinline__ uint32_t transpose32_shfl(uint32_t x, int lane) {
  constexpr uint32_t kMasks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u,
                                  0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const uint32_t m = kMasks[s];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? ((x & ~m) | ((y >> j) & m)) : ((x & m) | ((y & m) << j));
  }
  return x;
}

// exclusive scan of one int64 per thread over a block of kThreads (1,024:
// warp 0 scans all 32 warp sums); the block's total in *total (every
// thread); sh holds 32 words
template <int kThreads>
__device__ long long block_scan64(long long x, long long* total, long long* sh) {
  static_assert(kThreads == 1024, "block_scan64 scans 32 warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    long long s = sh[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s;
  }
  __syncthreads();
  const long long excl = (warp ? sh[warp - 1] : 0) + inc - x;
  *total = sh[kThreads / 32 - 1];
  __syncthreads();
  return excl;
}

}  // namespace sperr_bits
