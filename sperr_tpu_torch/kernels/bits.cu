// Bit machinery of the device SPECK encoder for Hopper: the 32x32 bit
// transpose (K10), the masked pack (K11) and the flag compaction (K12).
//
// Replaces XLA programs of sperr_tpu/ops/packemit.py, which the TPU composed
// from elementwise ops, rolls, sorts and scatters because it has no ballot,
// no popcount and no bit-disjoint atomics:
//   K10  transpose_bits32 (:82) and transpose_bits32_pair (:102);
//   K11  masked_pack (:420) with pext32 (:51);
//   K12  compact_flags_rows (:305).
// Words are 32-bit patterns; the torch side carries them in int32 tensors.
//
// Bound: device memory.  Each kernel reads its input once and writes its
// output once, with a few dozen integer operations per word in between:
//   K10  one warp per 32-item block; lane l holds item l, and
//        __ballot_sync over bit p of every lane is output word (p, block).
//        The 32 ballots replace the TPU's five masked-swap stages.
//   K11  pass 1 counts the valid bits of every word (__popc); torch scans
//        the counts between the passes (the JAX package computes these
//        offsets outside any kernel too); pass 2 extracts each word's valid
//        bits (Hacker's Delight 7-4: the card has no PEXT instruction) and
//        ORs them into at most two output words with atomicOr.  Bits of two
//        words never overlap, so the result does not depend on order.  The
//        TPU's piece merge and piece compaction existed to make its scatter
//        small; here each word scatters on its own.
//   K12  pass 1 counts the set flags of each 1024-flag block with ballots;
//        torch scans the block counts; pass 2 recounts each block in order
//        and writes the ascending indices from the block's base.
// No floating point; every result equals the plain versions in
// sperr_tpu_torch/ops/packemit.py bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFlagBlock = 1024;  // flags per block of K12

long long grid_for(long long work, long long per_block) {
  long long g = (work + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 65535LL * 32) g = 65535LL * 32;
  return g;
}

// K10: out[p * W + w] bit l = bit p of item (32 w + l).
__global__ void transpose_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ out, long long W) {
  const int lane = threadIdx.x & 31;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < W; w += (long long)gridDim.x * kWarps) {
    const uint32_t v = x[32 * w + lane];
    uint32_t mine = 0;
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      const uint32_t b = __ballot_sync(0xffffffffu, (v >> p) & 1u);
      if (lane == p) mine = b;
    }
    out[(long long)lane * W + w] = mine;
  }
}

// K10, pair form: the cell stream a_0 b_0 a_1 b_1 ...; word w holds items
// 16 w .. 16 w + 15, lane l the cell of item 16 w + l / 2 from a (l even) or
// b (l odd).
__global__ void transpose_pair_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      uint32_t* __restrict__ out, long long W) {
  const int lane = threadIdx.x & 31;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < W; w += (long long)gridDim.x * kWarps) {
    const long long item = 16 * w + (lane >> 1);
    const uint32_t v = (lane & 1) ? b[item] : a[item];
    uint32_t mine = 0;
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      const uint32_t bb = __ballot_sync(0xffffffffu, (v >> p) & 1u);
      if (lane == p) mine = bb;
    }
    out[(long long)lane * W + w] = mine;
  }
}

// K11 pass 1: valid bits per word.
__global__ void popcount_kernel(const uint32_t* __restrict__ valid,
                                int32_t* __restrict__ counts, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    counts[i] = __popc(valid[i]);
  }
}

// Hacker's Delight 7-4 "compress": the bits of x at the set positions of m,
// packed toward bit 0 in order.
__device__ __forceinline__ uint32_t pext32(uint32_t x, uint32_t m) {
  x &= m;
  uint32_t mk = ~m << 1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint32_t mp = mk ^ (mk << 1);
    mp ^= mp << 2;
    mp ^= mp << 4;
    mp ^= mp << 8;
    mp ^= mp << 16;
    const uint32_t mv = mp & m;
    m = (m ^ mv) | (mv >> (1 << i));
    const uint32_t t = x & mv;
    x = (x ^ t) | (t >> (1 << i));
    mk &= ~mp;
  }
  return x;
}

// K11 pass 2: word i of a part (rows of W words) starts at stream bit
// S[i] + corr[i / W]; its compacted bits go to out words off / 32 and
// off / 32 + 1.  Words past out_words are dropped (the caller's byte cap
// flags that case as an overflow).
__global__ void pack_scatter_kernel(const uint32_t* __restrict__ valid,
                                    const uint32_t* __restrict__ bits,
                                    const long long* __restrict__ S,
                                    const long long* __restrict__ corr,
                                    long long n, long long W,
                                    uint32_t* __restrict__ out,
                                    long long out_words) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t m = valid[i];
    if (m == 0) continue;
    const uint32_t cw = pext32(bits[i], m);
    if (cw == 0) continue;
    const long long off = S[i] + corr[i / W];
    const long long w = off >> 5;
    const int r = (int)(off & 31);
    if (w < out_words) atomicOr(out + w, cw << r);
    if (r != 0 && w + 1 < out_words) {
      const uint32_t hi = cw >> (32 - r);
      if (hi) atomicOr(out + w + 1, hi);
    }
  }
}

// K12 pass 1: set flags per 1024-flag block of each row.
__global__ void flag_count_kernel(const uint8_t* __restrict__ flags,
                                  int32_t* __restrict__ bcnt, long long n,
                                  long long nblk) {
  const long long row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ int part[kWarps];
  for (long long blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
    int c = 0;
    for (int k = threadIdx.x; k < kFlagBlock; k += kThreads) {
      const long long i = blk * kFlagBlock + k;
      const bool f = i < n && flags[row * n + i] != 0;
      c += __popc(__ballot_sync(0xffffffffu, f));
    }
    if (lane == 0) part[warp] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int j = 0; j < kWarps; ++j) s += part[j];
      bcnt[row * nblk + blk] = s;
    }
    __syncthreads();
  }
}

// K12 pass 2: each block walks its flags in order and writes the indices of
// the set ones from its base; slots past `take` are skipped.
__global__ void flag_write_kernel(const uint8_t* __restrict__ flags,
                                  const long long* __restrict__ bbase,
                                  int32_t* __restrict__ idx, long long n,
                                  long long nblk, long long take) {
  const long long row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ int wsum[kWarps];
  for (long long blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
    long long base = bbase[row * nblk + blk];
    if (base >= take) continue;  // uniform across the block
    for (int k0 = 0; k0 < kFlagBlock; k0 += kThreads) {
      const long long i = blk * kFlagBlock + k0 + threadIdx.x;
      const bool f = i < n && flags[row * n + i] != 0;
      const uint32_t bal = __ballot_sync(0xffffffffu, f);
      if (lane == 0) wsum[warp] = __popc(bal);
      __syncthreads();
      long long pos = base + __popc(bal & ((1u << lane) - 1u));
      int total = 0;
      for (int j = 0; j < kWarps; ++j) {
        if (j < warp) pos += wsum[j];
        total += wsum[j];
      }
      if (f && pos < take) idx[row * take + pos] = (int32_t)i;
      base += total;
      __syncthreads();
    }
  }
}

}  // namespace

// K10: x (32 W) words -> out (32, W).
extern "C" int sperr_transpose_bits32(const uint32_t* x, uint32_t* out,
                                      long long W, cudaStream_t stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  transpose_kernel<<<(unsigned)grid_for(W, kWarps), kThreads, 0, stream>>>(
      x, out, W);
  return (int)cudaGetLastError();
}

// K10 pair form: a, b (16 W) words -> out (32, W).
extern "C" int sperr_transpose_bits32_pair(const uint32_t* a, const uint32_t* b,
                                           uint32_t* out, long long W,
                                           cudaStream_t stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  transpose_pair_kernel<<<(unsigned)grid_for(W, kWarps), kThreads, 0, stream>>>(
      a, b, out, W);
  return (int)cudaGetLastError();
}

// K11 pass 1: counts[i] = popcount(valid[i]) for n words.
extern "C" int sperr_popcount_words(const uint32_t* valid, int32_t* counts,
                                    long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  popcount_kernel<<<(unsigned)grid_for(n, kThreads * 4LL), kThreads, 0, stream>>>(
      valid, counts, n);
  return (int)cudaGetLastError();
}

// K11 pass 2 over one part of n words in rows of W: out (out_words), which
// the caller zeroes, receives the packed bits.
extern "C" int sperr_masked_pack_scatter(const uint32_t* valid,
                                         const uint32_t* bits,
                                         const long long* S,
                                         const long long* corr, long long n,
                                         long long W, uint32_t* out,
                                         long long out_words,
                                         cudaStream_t stream) {
  if (n <= 0 || W <= 0 || n % W != 0) return (int)cudaErrorInvalidValue;
  pack_scatter_kernel<<<(unsigned)grid_for(n, kThreads * 4LL), kThreads, 0,
                        stream>>>(valid, bits, S, corr, n, W, out, out_words);
  return (int)cudaGetLastError();
}

// K12 pass 1: flags (B, n) bytes -> bcnt (B, nblk) set flags per block.
extern "C" int sperr_flag_block_counts(const uint8_t* flags, int32_t* bcnt,
                                       long long B, long long n,
                                       long long nblk, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || n <= 0 ||
      nblk != (n + kFlagBlock - 1) / kFlagBlock)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_for(nblk, 1), (unsigned)B);
  flag_count_kernel<<<grid, kThreads, 0, stream>>>(flags, bcnt, n, nblk);
  return (int)cudaGetLastError();
}

// K12 pass 2: bbase (B, nblk) exclusive scan of the block counts -> idx
// (B, take), which the caller fills with n, receives the first `take`
// ascending indices of each row's set flags.
extern "C" int sperr_flag_compact(const uint8_t* flags, const long long* bbase,
                                  int32_t* idx, long long B, long long n,
                                  long long nblk, long long take,
                                  cudaStream_t stream) {
  if (B <= 0 || B > 65535 || n <= 0 || take <= 0 ||
      nblk != (n + kFlagBlock - 1) / kFlagBlock)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_for(nblk, 1), (unsigned)B);
  flag_write_kernel<<<grid, kThreads, 0, stream>>>(flags, bbase, idx, n, nblk,
                                                   take);
  return (int)cudaGetLastError();
}
