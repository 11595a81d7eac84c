// The 3D set walk of the device SPECK encoder (K7 and K8) for Hopper, and
// the stable LSD radix sort that its sorts, and the table and 2D walks'
// sorts, run on.
//
// Replaces the XLA programs of sperr_tpu/ops/speck_virtual.py
// dense_anchor_ranks (:457, K7; with box_major_pixels :299 and vtab_from
// :310, the 8-aligned child value table) and sperr_tpu/ops/speck_lis_jax.py
// _lis_items_virtual (:175, K8).  For a power-of-two cube's partition
// forest (ids: depth-major, root-major, morton-minor) they give
//   J   each node's same-pass chain top (its topmost ancestor reachable
//       through nodes of its own significance pass),
//   R   the dense rank, among its level's nodes, of the node's hop-word
//       string (leaf levels 0: never read),
//   pay one payload word per LIS item (born list entries, roots, child
//       rows), in walk order: sorted by (walk rank, path), ties in the
//       plain version's input order.
// Every result is an integer and equals the plain versions
// (ops/speck_virtual.py dense_anchor_ranks_ref, ops/speck_lis.py
// _lis_items_virtual_ref) bit for bit, padding items included.
//
// Bound: the walk reads the node passes and the child value table once and
// writes one word per item; what the plain version spends is some 1,300
// torch launches (scans, cummax, int64 sorts).  The designs:
//   * walk_vtab: one thread per 2x2x2 box, eight pixels from four 8-byte
//     rows, one 32-byte row of the box-major table; the node sections are
//     copied with their NEVER padding by the same launch.
//   * anchor_chain: one thread per node walks its parent chain (at most
//     depth_max hops, through L1) for J and for the hop word u of its key;
//     it also writes the significance flags K12 compacts and sets the walk
//     rank table to BIG.
//   * the ranks, level by level (each level's key reads its parent chain's
//     rank), without a sort (rank.cuh, shared with the table and 2D walks
//     of walk_table.cu): a dense rank is the number of distinct keys
//     below a key, so each level sets one bit per key in a presence bitmap
//     of 2^(12 + wk) bits and counts the distinct keys of each 8-word
//     group (the first lane of a warp's equal keys tries, only if the bit
//     reads unset, and counts only if its atomicOr set it: many nodes share
//     a key), takes the exclusive prefix of the groups' counts, and ranks
//     each node by its group's prefix and the popcounts below its bit.  The
//     levels of at most 4,096 nodes and 21 key bits in one block of 1,024
//     threads (group counts in shared memory); each larger level in three
//     launches (mark; the group prefixes within blocks of 1,024 groups and
//     the blocks' prefixes, from the last block to finish; rank).  The
//     bitmaps, counts and block sums are zeroed by one memset per call.
//     At 256^3 the largest bitmap is 2^28 bits (32 MB), which stays in the
//     H100's 50 MB L2.
//   * walk_rows: a thread per compacted parent decodes its id, loads its
//     8-value row in one 32-byte load, and writes the row items' payloads;
//     the skip rule's "an earlier sibling turned significant" is a bit test
//     on the row's 8-bit significance mask.
//   * walk_born / walk_entries / walk_rowkeys: the born entries' insertion
//     keys and per-level counts (shared-memory histogram, integer atomics),
//     then after their sort the level starts as an exclusive prefix of the
//     counts, the walk ranks as arithmetic, the walk rank table, and the
//     walk-sort keys of every item.
//   * the radix sort: a one-sweep LSD sort of 8-bit digits over only the
//     digits that the keys' static widths leave nonzero, the sign bit
//     flipped so that int32 and int64 keys sort as torch.sort sorts them.
//     One launch reads the keys once for the counts of every digit it will
//     pass over (the counts do not depend on the order; each thread adds a
//     run of equal digits in its 16 consecutive keys once), and its last
//     block turns them into each digit's start.  Then one launch per digit:
//     a block takes its tile number from an atomic counter, holds 16 keys
//     and their values a thread in registers (two blocks an SM: loading the
//     values with the keys measured faster than three blocks an SM that
//     load them later), ranks them stably (warp, then round, then lane:
//     the load order) with __match_any_sync and per-warp counters,
//     publishes its per-digit counts, stages keys and values in shared
//     memory in digit order, looks back over the earlier tiles' status
//     words (one thread per digit, four words in flight), and writes each
//     digit's run out contiguously.  Status words carry the pass number, so
//     one memset per sort serves all its passes.  Keys are packed so that
//     one 64-bit key holds what the plain version sorts as (hi, lo) pairs
//     and path words, where the widths fit.  Bound: each pass reads and
//     writes every key and value once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank.cuh"

namespace {

constexpr int kNever = 0x7FFF;
constexpr int kBig = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kMaxRoots = 64;
constexpr int kMaxDepth = 14;  // entries of the per-depth tables
// radix sort: 256 threads of 16 keys each per tile; at most 8 digit passes
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;
constexpr int kTile = kSortThreads * kSortItems;
constexpr int kSortPasses = 8;
constexpr int kHistThreads = 256;
constexpr int kHistItems = 16;  // consecutive keys a histogram thread reads at a time
constexpr int kHistBlocks = 1024;  // the histogram's grid, at most (grid-stride beyond)
// the sort's status words: pass tag << 34 | state << 32 | count
constexpr unsigned long long kStateAggregate = 1, kStatePrefix = 2;

}  // namespace

// The forest's constants, as ops/speck_virtual.py walk_forest() lays them
// out (outside the unnamed namespace: a C entry point that takes a type of
// internal linkage gets internal linkage too, and is not exported).
struct WalkForest {
  int K, N, n, nn, D, R, nlev, S;
  int db[kMaxDepth];  // first id at each depth, D + 2 entries
  int r0[kMaxDepth];  // first root with nodes at each depth
  int a8[kMaxDepth];  // child value table row of each depth's node section
  int slog[kMaxRoots];
  int ox[kMaxRoots], oy[kMaxRoots], oz[kMaxRoots];
  int rlev[kMaxRoots];
  int o0[kMaxRoots];
  int off0[32];
};

namespace {

using sperr_rank::block_excl_scan;

unsigned blocks_for(long long count, int threads = kThreads) {
  return (unsigned)((count + threads - 1) / threads);
}

__device__ __forceinline__ void decode(const WalkForest* f, int id, int& r, int& d, int& m) {
  d = 0;
  for (int k = 1; k <= f->D + 1; ++k) d += id >= f->db[k];
  const int rem = id - f->db[d];
  r = f->r0[d] + (rem >> (3 * d));
  m = rem & ((1 << (3 * d)) - 1);
}

__device__ __forceinline__ int node_id(const WalkForest* f, int r, int d, int m) {
  return f->db[d] + ((r - f->r0[d]) << (3 * d)) + m;
}

__device__ __forceinline__ int level_of(const WalkForest* f, int r, int d) {
  return 3 * (f->K - f->slog[r] + d);
}

__device__ __forceinline__ int clamp63(int v) { return v < 0 ? 0 : (v > 63 ? 63 : v); }

__device__ __forceinline__ int pow9(int e) {
  int p = 1;
  for (int k = 0; k < e; ++k) p *= 9;
  return p;
}

// Walk-key path words of the node (d, m), its digits 1 .. 8 (0 past its
// depth) in depth order: one base-9 word (depth j's digit times
// 9^(S - 1 - j), 23 bits at S = 7 where 4-bit digits take 28) when S <= 7,
// else two words of 5-bit digits (depth j at 5 (5 - j), then 5 (11 - j)),
// as codec/speck_sorted.py lays them out.  Either orders as the digit
// strings do.
__device__ __forceinline__ void path_words(int S, int d, int m, int& w0, int& w1) {
  w0 = w1 = 0;
  for (int j = 0; j < d; ++j) {
    const int dig = ((m >> (3 * (d - 1 - j))) & 7) + 1;
    if (S <= 7)
      w0 = 9 * w0 + dig;
    else if (j < 6)
      w0 |= dig << (5 * (5 - j));
    else
      w1 |= dig << (5 * (11 - j));
  }
  if (S <= 7) w0 *= pow9(S - d);
}

// The path words of child slot k of the node (d, m).
__device__ __forceinline__ void child_path_words(int S, int d, int m, int k, int& w0, int& w1) {
  path_words(S, d, m, w0, w1);
  if (S <= 7)
    w0 += (k + 1) * pow9(S - 1 - d);
  else if (d < 6)
    w0 += (k + 1) << (5 * (5 - d));
  else if (d < 12)
    w1 += (k + 1) << (5 * (11 - d));
}

// -- the child value table ----------------------------------------------------
// Threads below nbox: one 2x2x2 box each (pixel section, slots dz dy dx);
// the rest: one node-section element each (node_s, NEVER past a depth's
// nodes up to its 8-aligned end).
__global__ void walk_vtab(const int32_t* __restrict__ s, const uint8_t* __restrict__ sg,
                          const int32_t* __restrict__ mags, const int32_t* __restrict__ node_s,
                          const WalkForest* __restrict__ f, int N, long long nbox, long long nt,
                          int32_t* __restrict__ vtab) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < nbox) {
    const int Nh = N >> 1, lb = __ffs(Nh) - 1;
    const long long xb = t & (Nh - 1), yb = (t >> lb) & (Nh - 1), zb = t >> (2 * lb);
    int v[8];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int dz = rr >> 1, dy = rr & 1;
      const long long row = ((2 * zb + dz) * N + (2 * yb + dy)) * N + 2 * xb;
      const int2 sv = *reinterpret_cast<const int2*>(s + row);
      const uint16_t gv = *reinterpret_cast<const uint16_t*>(sg + row);
      int a = min(max(sv.x, 0), 127) | ((gv & 1) << 7);
      int b = min(max(sv.y, 0), 127) | (((gv >> 8) & 1) << 7);
      if (mags) {
        const int2 mv = *reinterpret_cast<const int2*>(mags + row);
        a |= (int)((unsigned)min(mv.x, 0x7FFFFF) << 8);
        b |= (int)((unsigned)min(mv.y, 0x7FFFFF) << 8);
      }
      v[4 * dz + 2 * dy] = a;
      v[4 * dz + 2 * dy + 1] = b;
    }
    int4* out = reinterpret_cast<int4*>(vtab + 8 * t);
    out[0] = make_int4(v[0], v[1], v[2], v[3]);
    out[1] = make_int4(v[4], v[5], v[6], v[7]);
    return;
  }
  const long long e = 8 * nbox + (t - nbox);
  if (e >= nt) return;
  int d = 0;
  while (d < f->D && e >= 8LL * f->a8[d + 1]) ++d;
  const long long idx = e - 8LL * f->a8[d];
  const int cnt = f->db[d + 1] - f->db[d];
  vtab[e] = idx < cnt ? node_s[f->db[d] + idx] : kNever;
}

// -- K7: chain tops, hop words -------------------------------------------------
// For each node z: J[z]; for nodes of ranked levels (side > 2) the hop word
// u[z] and the chain top jp[z] of its parent (-1 at roots), whose rank is
// the second half of z's key; R[z] = 0 on leaf levels.  With sigf, also the
// significance flags, and wbuf[0 .. nn] = BIG.
__global__ void anchor_chain(const int32_t* __restrict__ node_s, const WalkForest* __restrict__ f,
                             long long nn, int32_t* __restrict__ J, int32_t* __restrict__ R,
                             int32_t* __restrict__ u, int32_t* __restrict__ jp,
                             uint8_t* __restrict__ sigf, int32_t* __restrict__ wbuf) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nn) return;
  const int z = (int)t;
  int r, d, m;
  decode(f, z, r, d, m);
  const int s = node_s[z];
  if (sigf) {
    sigf[z] = s < kNever;
    wbuf[z] = kBig;
    if (z == 0) wbuf[nn] = kBig;
  }
  const int slog = f->slog[r];
  const bool ranked = slog - d >= 2;
  int Jz = z;
  if (d == 0) {
    if (ranked) {
      u[z] = f->o0[r];
      jp[z] = -1;
    }
  } else {
    int cd = d - 1, cm = m >> 3;
    int cur = node_id(f, r, cd, cm);
    const int sp = node_s[cur];
    while (cd > 0) {
      const int gd = cd - 1, gm = cm >> 3;
      const int g = node_id(f, r, gd, gm);
      if (node_s[g] != sp) break;
      cur = g;
      cd = gd;
      cm = gm;
    }
    if (sp == s) Jz = cur;
    if (ranked) {
      u[z] = (1 << 11) | (clamp63(sp) << 5) | (31 - 3 * (f->K - slog + cd));
      jp[z] = cur;
    }
  }
  J[z] = Jz;
  if (!ranked) R[z] = 0;
}

// -- the radix sort ---------------------------------------------------------------
template <typename KT>
__device__ __forceinline__ int digit_of(KT k, int shift) {
  const KT flip = (KT)1 << (sizeof(KT) * 8 - 1);
  return (int)(((k ^ flip) >> shift) & 255);
}

struct Shifts {
  int s[kSortPasses];
};

__device__ __forceinline__ unsigned long long sort_status(int pass, unsigned long long state,
                                                          unsigned count) {
  return ((unsigned long long)(pass + 1) << 34) | (state << 32) | count;
}

// kHistItems consecutive keys from k0 (16-byte loads where aligned and
// whole); keys past n are never read.
template <typename KT>
__device__ __forceinline__ void load_run(const KT* __restrict__ keys, long long k0, long long n,
                                         KT (&k)[kHistItems]) {
  if (k0 + kHistItems <= n && (reinterpret_cast<uintptr_t>(keys + k0) & 15) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(keys + k0);
    uint4 v[kHistItems * sizeof(KT) / 16];
#pragma unroll
    for (int q = 0; q < (int)(kHistItems * sizeof(KT) / 16); ++q) v[q] = p[q];
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) k[j] = reinterpret_cast<const KT*>(v)[j];
  } else {
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) k[j] = k0 + j < n ? keys[k0 + j] : (KT)0;
  }
}

// Launch 1: the counts of every digit of every pass (hist[pass * 256 +
// digit], zeroed by the caller) from one read of the keys.  A thread takes
// kHistItems consecutive keys and adds each run of one digit once to a
// shared-memory counter (the walk's keys hold long runs in their high
// digits), then integer atomics.  The last block to finish turns each
// pass's counts into the digits' exclusive starts.
template <typename KT>
__global__ void __launch_bounds__(kHistThreads) radix_hist(const KT* __restrict__ keys, long long n,
                                                           Shifts sh, int nshift, int32_t* hist,
                                                           unsigned* done, const int32_t* __restrict__ gate) {
  __shared__ int h[kSortPasses * 256];
  __shared__ int ws[32];
  __shared__ bool s_last;
  if (gate && !*gate) return;
  const int tid = threadIdx.x;
  for (int i = tid; i < nshift * 256; i += kHistThreads) h[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kHistThreads * kHistItems;
  for (long long k0 = ((long long)blockIdx.x * kHistThreads + tid) * kHistItems; k0 < n; k0 += stride) {
    KT k[kHistItems];
    load_run(keys, k0, n, k);
    const int m = (int)min((long long)kHistItems, n - k0);
    for (int p = 0; p < nshift; ++p) {
      int* hp = h + p * 256;
      int cur = digit_of(k[0], sh.s[p]), run = 1;
#pragma unroll
      for (int j = 1; j < kHistItems; ++j) {
        if (j < m) {
          const int d = digit_of(k[j], sh.s[p]);
          if (d == cur) {
            ++run;
          } else {
            atomicAdd(hp + cur, run);
            cur = d;
            run = 1;
          }
        }
      }
      atomicAdd(hp + cur, run);
    }
  }
  __syncthreads();
  for (int i = tid; i < nshift * 256; i += kHistThreads)
    if (h[i]) atomicAdd(&hist[i], h[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int p = 0; p < nshift; ++p) {
    const int v = __ldcg(&hist[p * 256 + tid]);
    hist[p * 256 + tid] = block_excl_scan(v, ws, nullptr);
  }
}

// One launch per digit: a tile of kTile keys per block (lane l of warp w
// holds keys w * 32 * kSortItems + 32 j + l, j < kSortItems).  Stable ranks
// within the warp from __match_any_sync and per-warp digit counters (round
// j after round j - 1), the warps' offsets per digit, the tile's counts
// published, keys and values staged in shared memory in digit order, the
// earlier tiles looked back over (thread d for digit d), and the staged
// keys written out as one run per digit.  dbase: the digits' starts; vin
// null: the values are the input positions.
template <typename KT>
__global__ void __launch_bounds__(kSortThreads, 2) radix_onesweep(
    const KT* __restrict__ kin, const int32_t* __restrict__ vin, KT* __restrict__ kout,
    int32_t* __restrict__ vout, long long n, int shift, int pass, const int32_t* __restrict__ dbase,
    unsigned long long* status, unsigned* tiles, const int32_t* __restrict__ gate) {
  extern __shared__ __align__(16) unsigned char sort_smem[];
  if (gate && !*gate) return;
  KT* sk = reinterpret_cast<KT*>(sort_smem);
  int32_t* sv = reinterpret_cast<int32_t*>(sk + kTile);
  int* wh = reinterpret_cast<int*>(sv + kTile);  // [kSortWarps][256]
  __shared__ int s_bex[256], s_gofs[256], ws[32];
  __shared__ int s_tile;
  static_assert(kSortThreads == 256, "one thread per digit");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(tiles, 1u);
  for (int i = tid; i < kSortWarps * 256; i += kSortThreads) wh[i] = 0;
  __syncthreads();
  // n < 2^31: positions fit 32 bits unsigned, also past n in the last tile
  const unsigned tile = s_tile, t0 = tile * kTile, un = (unsigned)n;
  const unsigned b0 = t0 + warp * (32 * kSortItems) + lane;
  KT key[kSortItems];
  int32_t val[kSortItems];
  int dr[kSortItems];  // rank in the warp << 9 | digit (256: past n)
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const unsigned i = b0 + 32 * j;
    key[j] = i < un ? kin[i] : (KT)0;
    val[j] = i < un ? (vin ? vin[i] : (int32_t)i) : 0;
  }
  int* mine = wh + warp * 256;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int d = b0 + 32 * j < un ? digit_of(key[j], shift) : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = d < 256 ? mine[d] : 0;
    __syncwarp();
    if (d < 256 && lane == 31 - __clz(peers)) mine[d] = before + __popc(peers);
    __syncwarp();
    dr[j] = ((before + __popc(peers & lt)) << 9) | d;
  }
  __syncthreads();
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int c = wh[w * 256 + tid];
    wh[w * 256 + tid] = cnt;
    cnt += c;
  }
  unsigned long long* st = status + (size_t)tile * 256 + tid;
  atomicExch(st, sort_status(pass, tile == 0 ? kStatePrefix : kStateAggregate, (unsigned)cnt));
  const int bex = block_excl_scan(cnt, ws, nullptr);
  s_bex[tid] = bex;
  __syncthreads();
  // staged in digit order while the earlier tiles finish
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int d = dr[j] & 511;
    if (d < 256) {
      const int pos = s_bex[d] + wh[warp * 256 + d] + (dr[j] >> 9);
      sk[pos] = key[j];
      sv[pos] = val[j];
    }
  }
  // the look-back: four status words in flight; a word not yet published
  // in this pass is read again
  long long excl = 0;
  if (tile > 0) {
    const unsigned long long tag = (unsigned long long)(pass + 1);
    for (int t = (int)tile - 1;;) {
      unsigned long long w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = t - q >= 0
                   ? *reinterpret_cast<volatile unsigned long long*>(status + (size_t)(t - q) * 256 + tid)
                   : sort_status(pass, kStatePrefix, 0u);
      int used = 0;
      bool fin = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (fin || used < q || (w[q] >> 34) != tag) continue;
        excl += w[q] & 0xffffffffull;
        ++used;
        fin = ((w[q] >> 32) & 3) == kStatePrefix;
      }
      if (fin) break;
      t -= used;
    }
    atomicExch(st, sort_status(pass, kStatePrefix, (unsigned)(excl + cnt)));
  }
  s_gofs[tid] = dbase[tid] + (int)excl - bex;
  __syncthreads();
  const int m = (int)min((unsigned)kTile, un - t0);
  for (int i = tid; i < m; i += kSortThreads) {
    const KT k = sk[i];
    const unsigned g = (unsigned)(s_gofs[digit_of(k, shift)] + i);
    kout[g] = k;
    vout[g] = sv[i];
  }
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ src, const int32_t* __restrict__ idx,
                              T* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[idx[i]];
}

// The sort's scratch, in 8-byte words: the status words (256 per tile),
// the counts (kSortPasses x 256 int32), the counters (the histogram's
// blocks done, then one tile counter per pass).
long long sort_scratch_words(long long n) {
  return (n + kTile - 1) / kTile * 256 + kSortPasses * 256 / 2 + kSortPasses;
}

// nshift passes over the digits at shifts[]; the last pass writes kout and
// vout, the others alternate with kbuf and vbuf.  vals null: the values are
// the input positions.  zbuf: sort_scratch_words(n), zeroed here.  gate: a
// device word, the launches sort only where it is nonzero (null: always).
template <typename KT>
cudaError_t radix_passes(const KT* keys, const int32_t* vals, long long n, const int* shifts,
                         int nshift, KT* kbuf, int32_t* vbuf, KT* kout, int32_t* vout,
                         unsigned long long* zbuf, cudaStream_t st, const int32_t* gate) {
  const long long ntiles = (n + kTile - 1) / kTile;
  unsigned long long* status = zbuf;
  int32_t* hist = reinterpret_cast<int32_t*>(zbuf + ntiles * 256);
  unsigned* ctr = reinterpret_cast<unsigned*>(hist + kSortPasses * 256);
  cudaError_t err = cudaMemsetAsync(zbuf, 0, sizeof(unsigned long long) * sort_scratch_words(n), st);
  if (err != cudaSuccess) return err;
  Shifts sh = {};
  for (int p = 0; p < nshift; ++p) sh.s[p] = shifts[p];
  const long long hb = (n + kHistItems * kHistThreads - 1) / (kHistItems * kHistThreads);
  radix_hist<KT><<<(unsigned)(hb < kHistBlocks ? hb : kHistBlocks), kHistThreads, 0, st>>>(
      keys, n, sh, nshift, hist, ctr, gate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = kTile * (int)(sizeof(KT) + sizeof(int32_t)) + kSortWarps * 256 * (int)sizeof(int);
  err = cudaFuncSetAttribute(radix_onesweep<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const KT* ks = keys;
  const int32_t* vs = vals;
  for (int p = 0; p < nshift; ++p) {
    const bool last = (nshift - 1 - p) % 2 == 0;
    KT* kd = last ? kout : kbuf;
    int32_t* vd = last ? vout : vbuf;
    radix_onesweep<KT><<<(unsigned)ntiles, kSortThreads, smem, st>>>(
        ks, vs, kd, vd, n, shifts[p], p, hist + p * 256, status, ctr + 1 + p, gate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ks = kd;
    vs = vd;
  }
  return cudaSuccess;
}

// -- K8: the walk --------------------------------------------------------------------
// The born entry b (parent slot b / 8 of the born list, child slot b % 8).
struct Born {
  bool ok;
  int bid, bn, arank, alev5, s, lev, p0, p1;
};

__device__ __forceinline__ Born born_entry(long long b, const int32_t* __restrict__ sid, int take,
                                           const int32_t* __restrict__ idxE, long long C,
                                           const int32_t* __restrict__ node_s,
                                           const int32_t* __restrict__ J,
                                           const int32_t* __restrict__ R,
                                           const WalkForest* __restrict__ f) {
  Born e;
  const int nn = f->nn;
  const long long j = b >> 3;
  const int k = (int)(b & 7);
  const long long c = idxE ? (long long)idxE[j] : j;
  int q = nn - 1, r = 0, d = 0, m = 0;
  bool ok = c < C;
  if (ok) {
    const int sd = c < take ? sid[c] : nn;
    ok = sd < nn;
    if (ok) {
      q = sd;
      decode(f, q, r, d, m);
      ok = f->slog[r] - d != 1;
    }
  }
  e.ok = ok;
  if (ok) {
    const int cd = d + 1, cm = (m << 3) | k;
    e.bid = node_id(f, r, cd, cm);
    e.bn = node_s[q];
    const int anc = J[q];
    int ar, ad, am;
    decode(f, anc, ar, ad, am);
    e.arank = R[anc];
    e.alev5 = 31 - level_of(f, ar, ad);
    e.s = node_s[e.bid] & kNever;
    e.lev = level_of(f, r, cd);
    path_words(f->S, cd, cm, e.p0, e.p1);
  } else {
    e.bid = nn;
    e.bn = kBig;
    e.arank = 0;
    e.alev5 = 0;
    e.s = kNever;
    decode(f, nn - 1, r, d, m);
    e.lev = level_of(f, r, d);
    path_words(f->S, d, m, e.p0, e.p1);
  }
  return e;
}

// A thread per compacted parent c < C (sid[c] for c < take, else none):
// the payload words of its 8 child rows, and whether its children are
// nodes (born entries).  Payload bits as ops/speck_lis.py _walk_order.
__global__ void walk_rows(const int32_t* __restrict__ sid, int take,
                          const int32_t* __restrict__ node_s, const int32_t* __restrict__ vtab,
                          const WalkForest* __restrict__ f, long long C, int32_t* __restrict__ pay,
                          uint8_t* __restrict__ elig) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int nn = f->nn, N = f->N, Nh = N >> 1;
  const int sd = c < take ? sid[c] : nn;
  const bool ok = sd < nn;
  const int q = ok ? sd : nn - 1;
  int r, d, m;
  decode(f, q, r, d, m);
  const bool pxp = f->slog[r] - d == 1;
  const int rowpass = ok ? node_s[q] : kNever;
  long long tb8 = 0;
  if (ok) {
    if (pxp) {
      int bx = 0, by = 0, bz = 0;
      for (int t = 0; t <= f->D; ++t) {
        bx |= ((m >> (3 * t)) & 1) << t;
        by |= ((m >> (3 * t + 1)) & 1) << t;
        bz |= ((m >> (3 * t + 2)) & 1) << t;
      }
      const long long oxh = (f->ox[r] >> 1) + bx, oyh = (f->oy[r] >> 1) + by,
                      ozh = (f->oz[r] >> 1) + bz;
      tb8 = (ozh * Nh + oyh) * Nh + oxh;
    } else {
      const int dc = min(d + 1, f->D);
      tb8 = (long long)f->a8[dc] + ((long long)(r - f->r0[dc]) << min(3 * d, 30)) + m;
    }
  }
  const int4* row = reinterpret_cast<const int4*>(vtab + 8 * tb8);
  const int4 va = row[0], vb = row[1];
  const int v[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int rs = pxp ? (v[k] & 127) : (v[k] & kNever);
    if (ok && rs == rowpass) mask |= 1u << k;
  }
  const int base = clamp63(rowpass) << 1;
  const int ispx = (ok && pxp) ? 1 : 0;
  int p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int sig = (mask >> k) & 1;
    const bool prev = (mask & ((1u << k) - 1)) != 0;
    const int emitted = (ok && (prev || k != 7)) ? 1 : 0;
    const int sign = (v[k] >> 7) & 1;
    p[k] = base | ((sign & ispx) << 13) | (sig << 14) | ((ispx & sig) << 15) | (emitted << 16);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) pay[8 * c + k] = p[k];
  elig[c] = (ok && !pxp) ? 1 : 0;
}

// A thread per born entry: its insertion-sort key (lba << (wa + pw)) |
// (anchor rank << pw) | path, or with pw = 0 the key (lba << wa) | rank and
// the path words apart; lba is (level << 11 | birth pass << 5 | 31 - anchor
// level), nlev << 11 for an unused entry.  counts[level] += valid entries.
__global__ void walk_born(const int32_t* __restrict__ sid, int take, const int32_t* __restrict__ idxE,
                          long long C, const int32_t* __restrict__ node_s,
                          const int32_t* __restrict__ J, const int32_t* __restrict__ R,
                          const WalkForest* __restrict__ f, long long CB, int wa, int pw,
                          long long* __restrict__ key0, int32_t* __restrict__ kp0,
                          int32_t* __restrict__ kp1, int32_t* __restrict__ counts) {
  __shared__ int h[32];
  const int nlev = f->nlev;
  if (threadIdx.x < 32) h[threadIdx.x] = 0;
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < CB) {
    const Born e = born_entry(b, sid, take, idxE, C, node_s, J, R, f);
    const long long lba =
        e.ok ? ((e.lev << 11) | (clamp63(e.bn) << 5) | e.alev5) : ((long long)nlev << 11);
    if (pw) {
      key0[b] = (lba << (wa + pw)) | ((long long)e.arank << pw) | (long long)e.p0;
    } else {
      key0[b] = (lba << wa) | (long long)e.arank;
      kp0[b] = e.p0;
      if (kp1) kp1[b] = e.p1;
    }
    if (e.ok) atomicAdd(&h[e.lev], 1);
  }
  __syncthreads();
  if (threadIdx.x < nlev && h[threadIdx.x]) atomicAdd(&counts[threadIdx.x], h[threadIdx.x]);
}

// After the insertion sort (perm: sorted position -> born entry): a thread
// per list entry (born entries in sorted order, then the roots) writes its
// walk rank into wbuf, its payload word and its walk-sort key
// ((rank, tcap for an unused entry) << pw0 | path word 0; path word 1 into
// key1).  Walk rank: the entries of the levels above, then the level's own
// insertion rank (roots first: off0).
__global__ void walk_entries(const int32_t* __restrict__ perm, const int32_t* __restrict__ counts,
                             const int32_t* __restrict__ sid, int take,
                             const int32_t* __restrict__ idxE, long long C,
                             const int32_t* __restrict__ node_s, const int32_t* __restrict__ J,
                             const int32_t* __restrict__ R, const WalkForest* __restrict__ f,
                             long long CB, int tcap, int pw0, int32_t* __restrict__ wbuf,
                             int32_t* __restrict__ pay, long long* __restrict__ key0,
                             int32_t* __restrict__ key1) {
  __shared__ int s_start[33], s_suffix[33];
  const int nlev = f->nlev;
  if (threadIdx.x == 0) {
    int run = 0;
    for (int L = 0; L < nlev; ++L) {
      s_start[L] = run;
      run += counts[L];
    }
    int suf = 0;
    for (int L = nlev - 1; L >= 0; --L) {
      s_suffix[L] = suf;
      suf += f->off0[L] + counts[L];
    }
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= CB + f->R) return;
  int w, from, s, ok, p0, p1;
  if (i < CB) {
    const Born e = born_entry(perm[i], sid, take, idxE, C, node_s, J, R, f);
    ok = e.ok;
    w = kBig;
    if (ok) {
      w = s_suffix[e.lev] + f->off0[e.lev] + (int)(i - s_start[e.lev]);
      wbuf[e.bid] = w;
    }
    from = ok ? clamp63(e.bn) + 1 : 64;
    s = e.s;
    p0 = e.p0;
    p1 = e.p1;
  } else {
    const int r = (int)(i - CB);
    w = s_suffix[f->rlev[r]] + f->o0[r];
    wbuf[r] = w;
    ok = 1;
    from = 0;
    s = node_s[r];
    p0 = p1 = 0;
  }
  pay[i] = 1 | (clamp63(from) << 1) | (clamp63(s) << 7) | (ok << 17);
  key0[i] = ((long long)(ok ? w : tcap) << pw0) | (long long)p0;
  if (key1) key1[i] = p1;
}

// A thread per compacted parent: the walk-sort keys of its 8 child rows,
// (walk rank of its chain top, tcap for none) << pw0 | child path word 0.
__global__ void walk_rowkeys(const int32_t* __restrict__ sid, int take, long long C,
                             const int32_t* __restrict__ J, const int32_t* __restrict__ wbuf,
                             const WalkForest* __restrict__ f, int tcap, int pw0,
                             long long* __restrict__ key0, int32_t* __restrict__ key1) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int nn = f->nn;
  const int sd = c < take ? sid[c] : nn;
  const bool ok = sd < nn;
  const int q = ok ? sd : nn - 1;
  const int anc = ok ? J[q] : q;
  const int w = wbuf[anc];
  const long long kw = (long long)(w < tcap ? w : tcap) << pw0;
  int r, d, m;
  decode(f, q, r, d, m);
  for (int k = 0; k < 8; ++k) {
    int p0, p1;
    child_path_words(f->S, d, m, k, p0, p1);
    key0[8 * c + k] = kw | (long long)p0;
    if (key1) key1[8 * c + k] = p1;
  }
}

}  // namespace

// The child value table: vtab (nt int32) from s, signs (bytes) and, with
// mags, the magnitudes below bit 23 of each pixel; node_s.
extern "C" int sperr_walk_vtab(const int32_t* s, const uint8_t* sg, const int32_t* mags,
                               const int32_t* node_s, const WalkForest* f, int N, long long nt,
                               int32_t* vtab, cudaStream_t stream) {
  if (N < 2 || (N & (N - 1))) return (int)cudaErrorInvalidValue;
  const long long n = (long long)N * N * N, nbox = n / 8;
  walk_vtab<<<blocks_for(nbox + (nt - n)), kThreads, 0, stream>>>(s, sg, mags, node_s, f, N, nbox,
                                                                   nt, vtab);
  return (int)cudaGetLastError();
}

// K7: J, R (nn int32 each) and the scratch u, jp (nn int32); with sigf
// (nn bytes) and wbuf (nn + 1 int32), the walk's flags and rank table.
// plan: nlevels levels of kLevelInts words on the device (plan_host the
// same on the host), the first nsmall ranked in one block.  keys: the
// largest count of the other levels; zbuf (zwords 4-byte words, zeroed
// here in one memset): every level's bitmap of 2^(12 + wk) bits in plan
// order, then per larger level its 8-word groups' counts (then their
// prefixes), its scan blocks' sums and their counter (16-byte aligned).  A level of
// more than kBitmapBits key bits, or one ranked in one block beyond
// kSmallMax nodes or kSmallBits, is refused: the caller passes the plan's
// bitmap levels and ranks the wider ones after them by sorting
// (sperr_rank_keys, the radix sort, sperr_rank_sorted).
extern "C" int sperr_anchor_ranks(const int32_t* node_s, const WalkForest* f, long long nn,
                                  const int32_t* plan, const int32_t* plan_host, int nsmall,
                                  int nlevels, int32_t* J, int32_t* R, int32_t* u, int32_t* jp,
                                  uint8_t* sigf, int32_t* wbuf, uint32_t* keys, uint32_t* zbuf,
                                  long long zwords, cudaStream_t stream) {
  const long long need = sperr_rank::plan_words(plan_host, nsmall, nlevels);
  if (nn < 1 || need < 0 || zwords < need) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(zbuf, 0, sizeof(uint32_t) * need, stream);
  if (err != cudaSuccess) return (int)err;
  anchor_chain<<<blocks_for(nn), kThreads, 0, stream>>>(node_s, f, nn, J, R, u, jp, sigf, wbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sperr_rank::rank_levels(plan, plan_host, nsmall, nlevels, u, jp, R, keys, zbuf, stream);
}

// The stable radix sort of n keys (4 or 8 bytes, read as signed) with int32
// values (vals null: 0 .. n-1) over the digits at shifts[]: sorted keys in
// kout, values in vout; kbuf, vbuf: n more of each; zbuf: zwords 8-byte
// words, at least sort_scratch_words(n), zeroed here.  The gated form sorts
// only where the device word *gate is nonzero (its launches leave at once
// otherwise): the table walk's rank levels that may overflow their bitmaps.
extern "C" int sperr_radix_sort_gated(const int32_t* gate, const void* keys, int key_bytes,
                                      const int32_t* vals, long long n, const int* shifts, int nshift,
                                      void* kbuf, int32_t* vbuf, void* kout, int32_t* vout,
                                      unsigned long long* zbuf, long long zwords, cudaStream_t stream) {
  if (n < 1 || n > 0x7fffffffLL || nshift < 1 || nshift > kSortPasses ||
      (key_bytes != 4 && key_bytes != 8) || zwords < sort_scratch_words(n))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < nshift; ++p)
    if (shifts[p] < 0 || shifts[p] > 8 * key_bytes - 8) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (key_bytes == 4)
    err = radix_passes<uint32_t>((const uint32_t*)keys, vals, n, shifts, nshift, (uint32_t*)kbuf,
                                 vbuf, (uint32_t*)kout, vout, zbuf, stream, gate);
  else
    err = radix_passes<unsigned long long>(
        (const unsigned long long*)keys, vals, n, shifts, nshift, (unsigned long long*)kbuf, vbuf,
        (unsigned long long*)kout, vout, zbuf, stream, gate);
  return (int)err;
}

extern "C" int sperr_radix_sort(const void* keys, int key_bytes, const int32_t* vals, long long n,
                                const int* shifts, int nshift, void* kbuf, int32_t* vbuf,
                                void* kout, int32_t* vout, unsigned long long* zbuf,
                                long long zwords, cudaStream_t stream) {
  return sperr_radix_sort_gated(nullptr, keys, key_bytes, vals, n, shifts, nshift, kbuf, vbuf, kout, vout,
                                zbuf, zwords, stream);
}

// dst[i] = src[idx[i]] for elements of 4 or 8 bytes.
extern "C" int sperr_gather(const void* src, int bytes, const int32_t* idx, void* dst, long long n,
                            cudaStream_t stream) {
  if (n < 1 || (bytes != 4 && bytes != 8)) return (int)cudaErrorInvalidValue;
  if (bytes == 4)
    gather_kernel<int32_t><<<blocks_for(n), kThreads, 0, stream>>>((const int32_t*)src, idx,
                                                                   (int32_t*)dst, n);
  else
    gather_kernel<long long><<<blocks_for(n), kThreads, 0, stream>>>((const long long*)src, idx,
                                                                     (long long*)dst, n);
  return (int)cudaGetLastError();
}

// The child rows' payload words (pay: 8 C int32) and eligibility (C bytes).
extern "C" int sperr_walk_rows(const int32_t* sid, int take, const int32_t* node_s,
                               const int32_t* vtab, const WalkForest* f, long long C, int32_t* pay,
                               uint8_t* elig, cudaStream_t stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  walk_rows<<<blocks_for(C), kThreads, 0, stream>>>(sid, take, node_s, vtab, f, C, pay, elig);
  return (int)cudaGetLastError();
}

// The born entries' insertion keys (CB of them, maybe none) and per-level
// counts (nlev + 1 int32, zeroed here).
extern "C" int sperr_walk_born(const int32_t* sid, int take, const int32_t* idxE, long long C,
                               const int32_t* node_s, const int32_t* J, const int32_t* R,
                               const WalkForest* f, long long CB, int nlev, int wa, int pw,
                               long long* key0, int32_t* kp0, int32_t* kp1, int32_t* counts,
                               cudaStream_t stream) {
  if (CB < 0 || nlev < 1 || nlev > 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (nlev + 1), stream);
  if (err != cudaSuccess || CB == 0) return (int)err;
  walk_born<<<blocks_for(CB), kThreads, 0, stream>>>(sid, take, idxE, C, node_s, J, R, f, CB, wa, pw,
                                                     key0, kp0, kp1, counts);
  return (int)cudaGetLastError();
}

// The list entries' walk ranks, payloads and walk-sort keys (CB + nroots).
extern "C" int sperr_walk_entries(const int32_t* perm, const int32_t* counts, const int32_t* sid,
                                  int take, const int32_t* idxE, long long C,
                                  const int32_t* node_s, const int32_t* J, const int32_t* R,
                                  const WalkForest* f, long long CB, int nroots, int tcap, int pw0,
                                  int32_t* wbuf, int32_t* pay, long long* key0, int32_t* key1,
                                  cudaStream_t stream) {
  if (CB < 0 || CB + nroots < 1) return (int)cudaErrorInvalidValue;
  walk_entries<<<blocks_for(CB + nroots), kThreads, 0, stream>>>(
      perm, counts, sid, take, idxE, C, node_s, J, R, f, CB, tcap, pw0, wbuf, pay, key0, key1);
  return (int)cudaGetLastError();
}

// The child rows' walk-sort keys (8 C).
extern "C" int sperr_walk_rowkeys(const int32_t* sid, int take, long long C, const int32_t* J,
                                  const int32_t* wbuf, const WalkForest* f, int tcap, int pw0,
                                  long long* key0, int32_t* key1, cudaStream_t stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  walk_rowkeys<<<blocks_for(C), kThreads, 0, stream>>>(sid, take, C, J, wbuf, f, tcap, pw0, key0,
                                                       key1);
  return (int)cudaGetLastError();
}
