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
//   K12  one pass (redesigned for Hopper): each block counts its 16384 flags
//        from 16-byte loads, scans them in the block, and finds its base by
//        a decoupled look-back over its predecessors' status words (warp 0,
//        32 predecessors per step, with ballots); a second, small launch
//        writes the sentinel past each row's count.  The count-then-write
//        pair with a torch scan between them took some 7 launches, and lost
//        to torch.nonzero.
// No floating point; every result equals the plain versions in
// sperr_tpu_torch/ops/packemit.py bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// K12: one pass over the flags with a decoupled look-back.  Each block takes
// 16384 flags of one row (64 per thread, four 16-byte loads in flight),
// scans its counts in registers and shared memory, publishes its
// aggregate, and warp 0 walks
// back over its predecessors' status words, 32 at a time, until it meets an
// inclusive prefix.  Blocks of a row start in order (the usual assumption of
// single-pass scans), so every wait ends.  A status word is
//   state (2 bits) << 32 | count (32 bits),
// state 0 (not yet published) in the buffer the caller zeroes for the call.
constexpr int kFlagLoads = 4;  // 16-byte loads per thread
constexpr int kFlagsPerThread = 16 * kFlagLoads;
constexpr int kFlagTile = kThreads * kFlagsPerThread;
constexpr unsigned long long kStateAggregate = 1, kStatePrefix = 2;

__device__ __forceinline__ unsigned long long flag_status(unsigned long long state,
                                                          unsigned count) {
  return (state << 32) | count;
}

__global__ void flag_compact_kernel(const uint8_t* __restrict__ flags,
                                    int32_t* __restrict__ idx,
                                    int32_t* __restrict__ count,
                                    unsigned long long* status, long long n,
                                    long long nblk, long long take) {
  const long long row = blockIdx.y, blk = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* f = flags + row * n;
  const long long i0 = blk * kFlagTile + (long long)threadIdx.x * kFlagsPerThread;
  // bit k of m: flag i0 + k
  unsigned long long m = 0;
  if (i0 + kFlagsPerThread <= n && (reinterpret_cast<uintptr_t>(f + i0) & 15) == 0) {
    uint4 v[kFlagLoads];
#pragma unroll
    for (int l = 0; l < kFlagLoads; ++l) v[l] = reinterpret_cast<const uint4*>(f + i0)[l];
#pragma unroll
    for (int l = 0; l < kFlagLoads; ++l) {
      const unsigned w[4] = {v[l].x, v[l].y, v[l].z, v[l].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if ((w[q] >> (8 * b)) & 0xffu) m |= 1ull << (16 * l + 4 * q + b);
        }
      }
    }
  } else {
    for (int k = 0; k < kFlagsPerThread; ++k) {
      if (i0 + k < n && f[i0 + k] != 0) m |= 1ull << k;
    }
  }
  const int c = __popcll(m);
  // block scan of the per-thread counts
  __shared__ int wsum[kWarps];
  __shared__ long long s_prefix;
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < kWarps) wsum[lane] = v;
  }
  __syncthreads();
  const int excl = (warp ? wsum[warp - 1] : 0) + x - c;
  const int agg = wsum[kWarps - 1];
  if (warp == 0) {
    unsigned long long* st = status + row * nblk;
    long long prefix = 0;
    if (blk == 0) {
      if (lane == 0) atomicExch(st, flag_status(kStatePrefix, (unsigned)agg));
    } else {
      if (lane == 0) atomicExch(st + blk, flag_status(kStateAggregate, (unsigned)agg));
      for (long long j = blk - 1;; j -= 32) {
        const long long q = j - lane;  // lane 0 is the nearest predecessor
        unsigned long long state = kStatePrefix, val = 0;
        if (q >= 0) {
          unsigned long long w;
          do {
            w = *reinterpret_cast<volatile unsigned long long*>(st + q);
          } while (((w >> 32) & 3) == 0);
          state = (w >> 32) & 3;
          val = w & 0xffffffffull;
        }
        const unsigned pm = __ballot_sync(0xffffffffu, state == kStatePrefix);
        const int first = pm ? __ffs(pm) - 1 : 32;
        long long add = lane <= first ? (long long)val : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(0xffffffffu, add, o);
        prefix += add;
        if (pm) break;
      }
      if (lane == 0) {
        atomicExch(st + blk, flag_status(kStatePrefix, (unsigned)(prefix + agg)));
      }
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  long long pos = s_prefix + excl;
  while (m) {
    const int k = __ffsll((long long)m) - 1;
    m &= m - 1;
    if (pos < take) idx[row * take + pos] = (int32_t)(i0 + k);
    ++pos;
  }
  if (blk == nblk - 1 && threadIdx.x == 0) count[row] = (int32_t)(s_prefix + agg);
}

// K12, second launch: the sentinel n in the slots past each row's count.
__global__ void flag_fill_kernel(int32_t* __restrict__ idx,
                                 const int32_t* __restrict__ count, long long n,
                                 long long take) {
  const long long row = blockIdx.y;
  const long long c = count[row];
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < take;
       s += (long long)gridDim.x * blockDim.x) {
    if (s >= c) idx[row * take + s] = (int32_t)n;
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

// K12: flags (B, n) bytes -> idx (B, take), the first `take` ascending
// indices of each row's set flags with n in the unused slots, and count (B,)
// the set flags of each row.  status: B * ceil(n / 16384) words, zeroed by
// the caller.
extern "C" int sperr_flag_compact_rows(const uint8_t* flags, int32_t* idx,
                                       int32_t* count,
                                       unsigned long long* status, long long B,
                                       long long n, long long take,
                                       cudaStream_t stream) {
  if (B <= 0 || B > 65535 || n <= 0 || take <= 0)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (n + kFlagTile - 1) / kFlagTile;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flag_compact_kernel<<<dim3((unsigned)nblk, (unsigned)B), kThreads, 0, stream>>>(
      flags, idx, count, status, n, nblk, take);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long g = (take + kThreads - 1) / kThreads;
  if (g > 1024) g = 1024;
  flag_fill_kernel<<<dim3((unsigned)g, (unsigned)B), kThreads, 0, stream>>>(
      idx, count, n, take);
  return (int)cudaGetLastError();
}
