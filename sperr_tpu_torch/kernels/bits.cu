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
// Bound: device memory.  Each kernel reads its input once (K11 twice) and
// writes its output once, with a few dozen integer operations per word:
//   K10  (redesigned for Hopper) one block per 32 consecutive output words.
//        Each warp loads the items of 4 of them (128-byte loads), lane l
//        item l, and transposes each 32x32 bit block in registers with five
//        shuffle stages, so lane p holds plane p's word.  The words go
//        through a [32][33] shared tile, and each plane the caller keeps
//        (`take`: 14 of 32 at the first tier, 22 at the second) leaves as
//        one 128-byte line of 32 consecutive words, straight into rows
//        row0 .. row0+take-1 of the caller's (P, W) buffer.  A
//        __ballot_sync per plane bounds the kernel by its instructions,
//        not its bytes: with these stores and only the kept planes it ran
//        4x slower than the shuffles at the second tier.  Stores of one
//        word per plane row (out[p * W + w] from lane p) fill 4 bytes of
//        each 32-byte sector.  The wave paths run its shuffle stages
//        (bits.cuh) inside K9b (emit.cu), which builds the masks in
//        registers; this kernel stays an entry point of its own.
//   K11  (redesigned for Hopper) three launches over all parts at once, no
//        torch op between them.  A tile is 2048 words of one row.
//        count: each block reads its tile's valid words (16-byte loads) and
//          writes the tile's valid-bit count and its non-empty pieces; the
//          grid also zeroes the output buffer.
//        scan: one block of 1024 threads scans the tile counts in order,
//          staged through shared memory so that its loads and stores stay
//          coalesced: each tile's int64 prefix, each row's count and a
//          correction to its byte-aligned base (rows start on a byte, so a
//          prefix across rows is not a plain sum), the total bytes, the
//          non-empty pieces and overflow.
//        pack: each block re-reads its tile's valid and bits words, scans
//          the words' counts in the block (two 16-bit fields in one 32-bit
//          scan), extracts each word's valid bits (Hacker's Delight 7-4:
//          the card has no PEXT instruction; skipped for empty and full
//          masks), ORs them into a shared-memory image of the tile's output
//          words, and stores that image with coalesced stores.  Only its
//          first and last words, which a neighbouring tile or row may
//          share, go out with atomicOr.  Words past the caller's cap are
//          dropped (overflow reports that case).
//        Reading `valid` twice caps K11 at about 0.66 of the bound of one
//        read of each input.  A popcount pass, torch scans with an int64
//        offset per word and a scatter of one or two global atomicOr per
//        word would move some 1.4 GB at the second tier, against about
//        0.23 GB here.
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

#include "bits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

long long grid_for(long long work, long long per_block) {
  long long g = (work + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 65535LL * 32) g = 65535LL * 32;
  return g;
}

// K10: planes 0 .. take-1 of the transpose; out[p * W + w] bit l = bit p of
// item (32 w + l) (single form) or of the cell stream a_0 b_0 a_1 b_1 ...
// (pair form: word w holds items 16 w .. 16 w + 15, lane l the cell of item
// 16 w + l / 2 from a (l even) or b (l odd)).  out points at row row0.
constexpr int kTrWords = 32;                   // output words per block
constexpr int kTrPerWarp = kTrWords / kWarps;  // 4

using sperr_bits::transpose32_shfl;  // bits.cuh

template <bool kPair>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out, long long W, int take) {
  __shared__ uint32_t tile[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long w0 = (long long)blockIdx.x * kTrWords; w0 < W;
       w0 += (long long)gridDim.x * kTrWords) {
    uint32_t v[kTrPerWarp];
#pragma unroll
    for (int i = 0; i < kTrPerWarp; ++i) {
      const long long w = w0 + warp + i * kWarps;
      v[i] = 0;
      if (w < W) {
        if (kPair) {
          const long long item = 16 * w + (lane >> 1);
          v[i] = (lane & 1) ? __ldg(b + item) : __ldg(a + item);
        } else {
          v[i] = __ldg(a + 32 * w + lane);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTrPerWarp; ++i)
      tile[lane][warp + i * kWarps] = transpose32_shfl(v[i], lane);  // plane lane, word warp + 8 i
    __syncthreads();
    const long long w = w0 + lane;
    if (w < W) {
      for (int p = warp; p < take; p += kWarps) out[(long long)p * W + w] = tile[p][lane];
    }
    __syncthreads();
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

// K11.  Parts are (rows, W) word arrays; rows concatenate across parts in
// order.  Tiles are numbered part by part, row by row; a row of W words has
// ceil(W / kPackTile) tiles, the last one short when W is not a multiple.
constexpr int kMaxParts = 4;
constexpr int kPackTile = 2048;                          // words per tile
constexpr int kPackGroups = kPackTile / (4 * kThreads);  // uint4 loads per thread
constexpr int kScanThreads = 1024;
static_assert(kPackGroups == 2, "the pack kernel scans two 16-bit count fields");

struct PackParts {
  const uint32_t* valid[kMaxParts];
  const uint32_t* bits[kMaxParts];
  long long W[kMaxParts];              // words per row
  long long tpr[kMaxParts];            // tiles per row
  long long tile0[kMaxParts + 1];      // first tile of each part; [n] = all tiles
  long long row0[kMaxParts + 1];       // first row of each part; [n] = all rows
  int n;
};

struct TileRef {
  long long off;  // first word of the tile in its part
  long long row;  // global row
  int cnt;        // words in the tile
  int part;
};

__device__ __forceinline__ TileRef locate_tile(const PackParts& P, long long t) {
  int p = 0;
  while (p + 1 < P.n && t >= P.tile0[p + 1]) ++p;
  const long long local = t - P.tile0[p];
  const long long r = local / P.tpr[p], k = local - r * P.tpr[p];
  const long long left = P.W[p] - k * kPackTile;
  TileRef ref;
  ref.off = r * P.W[p] + k * kPackTile;
  ref.row = P.row0[p] + r;
  ref.cnt = (int)(left < kPackTile ? left : kPackTile);
  ref.part = p;
  return ref;
}

// words j .. j+3 of a tile of cnt words (zero past cnt)
__device__ __forceinline__ void load4(const uint32_t* base, int j, int cnt, bool vec,
                                      uint32_t (&w)[4]) {
  if (vec && j + 4 <= cnt) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(base + j));
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = j + k < cnt ? __ldg(base + j + k) : 0u;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K11 count: valid bits and non-empty pieces of each tile (tile_cnt, .x and
// .y), and the zeroed output buffer.  Thread t holds
// words g * 1024 + 4 t .. + 3 of its tile, so a piece of 8 (16) words spans
// 2 (4) neighbouring lanes.
__global__ void __launch_bounds__(kThreads)
pack_count_kernel(PackParts P, long long ntiles, int piece_words, int2* __restrict__ tile_cnt,
                  uint32_t* __restrict__ out, long long out_words) {
  __shared__ int s_c[kWarps], s_nz[kWarps];
  // the pack launch ORs into out: zero it here, spread over the grid
  const long long stride = (long long)gridDim.x * kThreads;
  long long z = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (aligned16(out)) {
    for (; z < out_words / 4; z += stride) reinterpret_cast<uint4*>(out)[z] = make_uint4(0, 0, 0, 0);
    if (blockIdx.x == 0 && threadIdx.x < (out_words & 3)) out[(out_words & ~3LL) + threadIdx.x] = 0;
  } else {
    for (; z < out_words; z += stride) out[z] = 0;
  }
  const long long t = blockIdx.x;
  if (t >= ntiles) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TileRef tr = locate_tile(P, t);
  const uint32_t* vb = P.valid[tr.part] + tr.off;
  const bool vec = aligned16(vb);
  uint32_t v[kPackGroups][4];
#pragma unroll
  for (int g = 0; g < kPackGroups; ++g)
    load4(vb, g * 4 * kThreads + 4 * threadIdx.x, tr.cnt, vec, v[g]);
  const int lanes = piece_words > 4 ? piece_words / 4 : 1;
  int c = 0, nz = 0;
#pragma unroll
  for (int g = 0; g < kPackGroups; ++g) {
    c += __popc(v[g][0]) + __popc(v[g][1]) + __popc(v[g][2]) + __popc(v[g][3]);
    if (piece_words == 2) {
      nz += ((v[g][0] | v[g][1]) != 0) + ((v[g][2] | v[g][3]) != 0);
    } else {
      int any = (v[g][0] | v[g][1] | v[g][2] | v[g][3]) != 0;
      for (int o = 1; o < lanes; o <<= 1) any |= __shfl_xor_sync(0xffffffffu, any, o);
      if ((lane & (lanes - 1)) == 0) nz += any;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c += __shfl_xor_sync(0xffffffffu, c, o);
    nz += __shfl_xor_sync(0xffffffffu, nz, o);
  }
  if (lane == 0) s_c[warp] = c, s_nz[warp] = nz;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sc = 0, snz = 0;
    for (int k = 0; k < kWarps; ++k) sc += s_c[k], snz += s_nz[k];
    tile_cnt[t] = make_int2(sc, snz);
  }
}

using sperr_bits::block_scan64;  // bits.cuh

// the part of global row r; its first tile in *first
__device__ __forceinline__ int row_part(const PackParts& P, long long r, long long* first) {
  int p = 0;
  while (p + 1 < P.n && r >= P.row0[p + 1]) ++p;
  *first = P.tile0[p] + (r - P.row0[p]) * P.tpr[p];
  return p;
}

// K11 scan, one block.  The tiles go through shared memory in chunks of
// 4096, loaded and stored with coalesced accesses; in between, each thread
// sums and scans a run of 4 consecutive tiles.  (Runs read straight from
// device memory spread a warp's accesses over 32 sectors each, and one SM
// issues them one sector at a time: 0.1 ms at 48,500 tiles.)
// tile_excl: each tile's exclusive prefix of valid bits over all tiles; a
// row's count is the difference across its tiles; corr[r] moves the
// prefixes of row r's tiles to its byte-aligned base (the pack adds it).
constexpr int kScanRun = 4;
constexpr int kScanChunk = kScanThreads * kScanRun;

__global__ void __launch_bounds__(kScanThreads)
pack_scan_kernel(PackParts P, const int2* __restrict__ tile_cnt, long long ntiles,
                 long long nrows, long long take, long long out_cap_bytes,
                 int32_t* __restrict__ counts, long long* __restrict__ stats,
                 long long* __restrict__ tile_excl, long long* __restrict__ corr,
                 uint8_t* __restrict__ overflow) {
  __shared__ long long sh[kScanThreads / 32];
  __shared__ long long stage[kScanChunk];  // int2 counts in, int64 prefixes out
  int2* stage_cnt = reinterpret_cast<int2*>(stage);
  const int tid = threadIdx.x;
  long long carry = 0, nz = 0;
  for (long long c0 = 0; c0 < ntiles; c0 += kScanChunk) {
#pragma unroll
    for (int j = 0; j < kScanRun; ++j) {
      const long long i = c0 + j * kScanThreads + tid;
      stage_cnt[j * kScanThreads + tid] = i < ntiles ? tile_cnt[i] : make_int2(0, 0);
    }
    __syncthreads();
    int x[kScanRun];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kScanRun; ++k) {
      const int2 c = stage_cnt[kScanRun * tid + k];
      x[k] = c.x;
      sum += c.x;
      nz += c.y;
    }
    long long total;
    long long run = carry + block_scan64<kScanThreads>(sum, &total, sh);  // its syncs end the reads
#pragma unroll
    for (int k = 0; k < kScanRun; ++k) {
      stage[kScanRun * tid + k] = run;
      run += x[k];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanRun; ++j) {
      const long long i = c0 + j * kScanThreads + tid;
      if (i < ntiles) tile_excl[i] = stage[j * kScanThreads + tid];
    }
    carry += total;
    __syncthreads();
  }
  long long n_nz;
  block_scan64<kScanThreads>(nz, &n_nz, sh);

  const long long ipr = (nrows + kScanThreads - 1) / kScanThreads;
  const long long b0 = min((long long)threadIdx.x * ipr, nrows), b1 = min(b0 + ipr, nrows);
  long long bytes = 0;
  for (long long r = b0; r < b1; ++r) {
    long long f;
    const int p = row_part(P, r, &f);
    long long c = 0;
    if (P.tpr[p] > 0) {
      const long long l = f + P.tpr[p] - 1;
      c = tile_excl[l] + tile_cnt[l].x - tile_excl[f];
    }
    counts[r] = (int32_t)c;
    bytes += (c + 7) >> 3;
  }
  long long total_bytes;
  long long rb = block_scan64<kScanThreads>(bytes, &total_bytes, sh);
  for (long long r = b0; r < b1; ++r) {
    long long f;
    const int p = row_part(P, r, &f);
    if (P.tpr[p] > 0) corr[r] = 8 * rb - tile_excl[f];
    rb += ((long long)counts[r] + 7) >> 3;
  }
  if (threadIdx.x == 0) {
    stats[0] = total_bytes;
    stats[1] = n_nz;
    *overflow = (n_nz > take) || (total_bytes > out_cap_bytes);
  }
}

// K11 pack: one tile per block.
__global__ void __launch_bounds__(kThreads)
pack_tile_kernel(PackParts P, const long long* __restrict__ tile_excl,
                 const long long* __restrict__ corr, uint32_t* __restrict__ out,
                 long long out_words) {
  __shared__ uint32_t img[kPackTile + 1];  // the tile's output words
  __shared__ unsigned s_warp[kWarps];
  const long long t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TileRef tr = locate_tile(P, t);
  const uint32_t* vb = P.valid[tr.part] + tr.off;
  const uint32_t* bb = P.bits[tr.part] + tr.off;
  const bool vec = aligned16(vb) && aligned16(bb);
  uint32_t v[kPackGroups][4], x[kPackGroups][4];
#pragma unroll
  for (int g = 0; g < kPackGroups; ++g) {
    load4(vb, g * 4 * kThreads + 4 * threadIdx.x, tr.cnt, vec, v[g]);
    load4(bb, g * 4 * kThreads + 4 * threadIdx.x, tr.cnt, vec, x[g]);
  }
  for (int i = threadIdx.x; i <= kPackTile; i += kThreads) img[i] = 0;

  // counts of the two groups as the low and high 16 bits of one word: each
  // field's block total is at most 256 * 128 = 32768, so neither carries
  unsigned cg[kPackGroups];
#pragma unroll
  for (int g = 0; g < kPackGroups; ++g)
    cg[g] = __popc(v[g][0]) + __popc(v[g][1]) + __popc(v[g][2]) + __popc(v[g][3]);
  const unsigned mine = cg[0] | (cg[1] << 16);
  unsigned inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) s_warp[lane] = s;
  }
  __syncthreads();
  const unsigned excl = (warp ? s_warp[warp - 1] : 0) + inc - mine;
  const unsigned total = s_warp[kWarps - 1];
  const long long nbits = (long long)(total & 0xffffu) + (total >> 16);
  if (nbits == 0) return;
  const long long base = tile_excl[t] + corr[tr.row];
  const int s0 = (int)(base & 31);
  unsigned e[kPackGroups] = {s0 + (excl & 0xffffu), s0 + (total & 0xffffu) + (excl >> 16)};
#pragma unroll
  for (int g = 0; g < kPackGroups; ++g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = v[g][k];
      if (m == 0) continue;
      const uint32_t cw = m == 0xffffffffu ? x[g][k] : pext32(x[g][k], m);
      const unsigned q = e[g];
      e[g] += __popc(m);
      if (cw == 0) continue;
      const int r = q & 31;
      atomicOr(img + (q >> 5), cw << r);
      if (r != 0 && (cw >> (32 - r))) atomicOr(img + (q >> 5) + 1, cw >> (32 - r));
    }
  }
  __syncthreads();
  const long long nout = (s0 + nbits + 31) >> 5;
  const long long w0 = base >> 5;
  for (long long i = threadIdx.x; i < nout && w0 + i < out_words; i += kThreads) {
    const uint32_t val = img[i];
    if (i == 0 || i == nout - 1) {
      if (val) atomicOr(out + w0 + i, val);
    } else {
      out[w0 + i] = val;
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

// K10: x (32 W) items (b null) or the pair a, b (16 W items each) -> planes
// 0 .. take-1 of the transpose into rows row0 .. row0+take-1 of out, a
// buffer of rows of W words.
extern "C" int sperr_transpose_bits32(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                      long long W, long long row0, int take,
                                      cudaStream_t stream) {
  if (W <= 0 || row0 < 0 || take < 1 || take > 32) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)grid_for(W, kTrWords);
  uint32_t* dst = out + row0 * W;
  if (b)
    transpose_kernel<true><<<grid, kThreads, 0, stream>>>(a, b, dst, W, take);
  else
    transpose_kernel<false><<<grid, kThreads, 0, stream>>>(a, nullptr, dst, W, take);
  return (int)cudaGetLastError();
}

// K11 over nparts parts (valid[p], bits[p]: rows[p] x W[p] words).  out
// (out_cap_bytes / 4 words) receives the packed bits (the count launch
// zeroes it); counts the bit count of every row.  i64: total bytes and
// non-empty pieces, then scratch: two words per tile and one per row;
// overflow: one byte.  Launches count, scan and pack (pack
// only when there is a tile).
extern "C" int sperr_masked_pack(int nparts, const uint32_t* const* valid,
                                 const uint32_t* const* bits, const long long* rows,
                                 const long long* W, int piece_words, long long take,
                                 long long out_cap_bytes, uint32_t* out, int32_t* counts,
                                 long long* i64, uint8_t* overflow, cudaStream_t stream) {
  if (nparts < 1 || nparts > kMaxParts || out_cap_bytes < 0 || out_cap_bytes % 4 ||
      !(piece_words == 2 || piece_words == 4 || piece_words == 8 || piece_words == 16))
    return (int)cudaErrorInvalidValue;
  PackParts P = {};
  long long tiles = 0, nrows = 0;
  for (int p = 0; p < nparts; ++p) {
    if (rows[p] < 0 || W[p] < 0 || W[p] % piece_words) return (int)cudaErrorInvalidValue;
    P.valid[p] = valid[p];
    P.bits[p] = bits[p];
    P.W[p] = W[p];
    P.tpr[p] = (W[p] + kPackTile - 1) / kPackTile;
    P.tile0[p] = tiles;
    P.row0[p] = nrows;
    tiles += rows[p] * P.tpr[p];
    nrows += rows[p];
  }
  for (int p = nparts; p <= kMaxParts; ++p) P.tile0[p] = tiles, P.row0[p] = nrows;
  P.n = nparts;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long* stats = i64;
  long long* tile_excl = i64 + 2;
  int2* tile_cnt = reinterpret_cast<int2*>(tile_excl + tiles);
  long long* corr = tile_excl + 2 * tiles;
  pack_count_kernel<<<(unsigned)(tiles ? tiles : 1), kThreads, 0, stream>>>(
      P, tiles, piece_words, tile_cnt, out, out_cap_bytes / 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pack_scan_kernel<<<1, kScanThreads, 0, stream>>>(P, tile_cnt, tiles, nrows, take,
                                                   out_cap_bytes, counts, stats, tile_excl,
                                                   corr, overflow);
  err = cudaGetLastError();
  if (err != cudaSuccess || !tiles) return (int)err;
  pack_tile_kernel<<<(unsigned)tiles, kThreads, 0, stream>>>(P, tile_excl, corr, out,
                                                             out_cap_bytes / 4);
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
  // the status words, zeroed here: no torch op runs between the launches
  // of a walk that compacts
  cudaError_t zerr = cudaMemsetAsync(status, 0, sizeof(unsigned long long) * B * nblk, stream);
  if (zerr != cudaSuccess) return (int)zerr;
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
