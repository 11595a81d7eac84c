// The dense per-level string ranks of the set walks (K7's method), shared by
// the virtual walk (walk.cu: anchor_ranks) and the table and 2D walks
// (walk_table.cu: table_anchors, which rank each level's hop words first:
// the u-rank route at the end of this file).
//
// A ranked level's nodes each carry a key, their hop word u above the rank
// of the next string (a node jp of a level ranked before it), and R is the
// dense rank of the key among the level's keys (equal strings, equal ranks).
// A dense rank is the number of distinct keys below a key, so each level
// sets one bit per key in a presence bitmap of 2^(12 + wk) bits and counts
// the distinct keys of each 8-word group (the first lane of a warp's equal
// keys tries, only if the bit reads unset, and counts only if its atomicOr
// set it: many nodes share a key), takes the exclusive prefix of the groups'
// counts, and ranks each node by its group's prefix and the popcounts below
// its bit.  The levels of at most 4,096 nodes and 21 key bits in one block of
// 1,024 threads (group counts in shared memory); each larger level in three
// launches (mark; the group prefixes within blocks of 1,024 groups and the
// blocks' prefixes, from the last block to finish; rank).  The bitmaps,
// counts and block sums are zeroed by one memset per call.
//
// A level whose keys are wider than kBitmapBits (a bitmap of 2^(12 + wk)
// bits would pass 512 MB: the 2D walk's finest levels from about 26M pixels
// on) is ranked by sorting its keys instead: they are packed in 64 bits
// (rank_sort_keys), the stable radix sort carries each key's position in the
// level, a bitmap over the sorted positions marks the heads (a key unlike
// the one before it: rank_heads, a warp's ballot a word, a block's count a
// group), rank_scan takes the groups' prefixes, and a node's rank is the
// heads at or before its sorted position, less one (rank_sorted).  The
// plan's bitmap levels come first (wk grows along the plan), the sorted
// levels after them, each in its own call.
//
// A level of the plan (kLevelInts words): its node count, the bit width wk of
// the low field of its keys, its number of id spans, their starts and ends.
// The low field is R[jp] + 1 for jp >= 0, and -1 - jp for jp < 0 (0 for a
// string that ends with the node; the 2D walk's group anchors put their
// static rank there).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sperr_rank {

constexpr int kMaxSpans = 16;
constexpr int kLevelInts = 3 + 2 * kMaxSpans;
constexpr int kSmallMax = 4096;  // nodes of a level ranked in one block
constexpr int kSmallBits = 21;   // key bits of a level ranked in one block
constexpr int kSmallGroups = 1 << (kSmallBits - 8);  // its 8-word groups
constexpr int kSmallShared = kSmallMax * 4 + kSmallGroups * 4;
// a larger level's group scan: 4 groups' counts (one int4) per thread
constexpr int kScanThreads = 256;
constexpr int kScanGroups = kScanThreads * 4;
constexpr int kRankThreads = 256;
constexpr int kBitmapBits = 32;  // widest keys a level ranks by its presence bitmap

namespace {

// Exclusive scan of one int per thread over the block (all threads call
// it); *total gets the block's sum.
__device__ int block_excl_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) ws[lane] = w;
  }
  __syncthreads();
  const int out = (warp ? ws[warp - 1] : 0) + x - v;
  if (total) *total = ws[nw - 1];
  __syncthreads();
  return out;
}

// The i-th node of a level of the rank plan.
__device__ __forceinline__ int level_node(const int32_t* __restrict__ L, int i) {
  const int ns = L[2];
  for (int k = 0; k < ns; ++k) {
    const int lo = L[3 + k], len = L[3 + kMaxSpans + k] - lo;
    if (i < len) return lo + i;
    i -= len;
  }
  return -1;
}

// A level's key: the node's hop word above the rank of the next string + 1
// (jp >= 0), or -1 - jp (jp < 0).
__device__ __forceinline__ uint32_t level_key(const int32_t* __restrict__ L, int i,
                                              const int32_t* __restrict__ u,
                                              const int32_t* __restrict__ jp, const int32_t* R,
                                              int& z) {
  z = level_node(L, i);
  const int j = jp[z];
  return ((uint32_t)u[z] << L[1]) | (j < 0 ? (uint32_t)(-1 - j) : (uint32_t)(R[j] + 1));
}

// The set bits of a bitmap below bit `key`, within the key's 8-word group.
__device__ __forceinline__ int bits_below_in_group(const uint32_t* bm, uint32_t key) {
  const uint4* g = reinterpret_cast<const uint4*>(bm + ((size_t)(key >> 8) << 3));
  const uint4 a = __ldcg(g), b = __ldcg(g + 1);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int k = (key >> 5) & 7;
  const uint32_t below = (1u << (key & 31)) - 1u;
  int c = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) c += __popc(w[q] & (q < k ? 0xffffffffu : (q == k ? below : 0u)));
  return c;
}

// Sets the bit of `key` in bm and, where this thread set it, adds one to
// its group's count: only the first lane of the warp's equal keys (act:
// the lanes that call) tries, and only if the bit reads unset.
__device__ __forceinline__ void mark_key(uint32_t* bm, int* gcnt, uint32_t key, unsigned act) {
  const unsigned peers = __match_any_sync(act, key);
  if ((threadIdx.x & 31) != __ffs(peers) - 1) return;
  uint32_t* w = bm + (key >> 5);
  const uint32_t bit = 1u << (key & 31);
  if (!(__ldcg(w) & bit) && !(atomicOr(w, bit) & bit)) atomicAdd(gcnt + (key >> 8), 1);
}

// Levels of at most kSmallMax nodes and kSmallBits key bits, in order, in
// one block of 1,024 threads: each level's bits set in its bitmap (global,
// zeroed by the caller, read past L1) with its groups' counts in shared
// memory, their exclusive scan, then R = the group's prefix + the bits
// below in the group.  R is written and read across levels (no read-only
// loads).
__global__ void __launch_bounds__(1024) anchor_small(const int32_t* __restrict__ plan, int nlv,
                                                     const int32_t* __restrict__ u,
                                                     const int32_t* __restrict__ jp, int32_t* R,
                                                     uint32_t* __restrict__ bm) {
  extern __shared__ uint32_t smem[];
  __shared__ int ws[32];
  uint32_t* K = smem;
  int* G = reinterpret_cast<int*>(smem + kSmallMax);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = 0; l < nlv; ++l) {
    const int32_t* L = plan + l * kLevelInts;
    const int cnt = L[0], groups = 1 << (4 + L[1]);
    for (int g = tid; g < groups; g += nt) G[g] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < cnt; i0 += nt) {
      const int i = i0 + tid;
      const unsigned act = __ballot_sync(0xffffffffu, i < cnt);
      if (i < cnt) {
        int z;
        const uint32_t key = level_key(L, i, u, jp, R, z);
        K[i] = key;
        mark_key(bm, G, key, act);
      }
    }
    __syncthreads();
    const int per = (groups + nt - 1) / nt;
    const int lo = min(tid * per, groups), hi = min(lo + per, groups);
    int c = 0;
    for (int g = lo; g < hi; ++g) c += G[g];
    int run = block_excl_scan(c, ws, nullptr);
    for (int g = lo; g < hi; ++g) {
      const int v = G[g];
      G[g] = run;
      run += v;
    }
    __syncthreads();
    for (int i = tid; i < cnt; i += nt) {
      const uint32_t key = K[i];
      R[level_node(L, i)] = G[key >> 8] + bits_below_in_group(bm, key);
    }
    __syncthreads();
    bm += 8 * groups;
  }
}

// A larger level, launch 1 of 3: each node's key kept, its bit set, its
// group's count of distinct keys (gcnt, zeroed by the caller) raised.
__global__ void rank_mark(const int32_t* __restrict__ L, const int32_t* __restrict__ u,
                          const int32_t* __restrict__ jp, const int32_t* __restrict__ R,
                          uint32_t* __restrict__ keys, uint32_t* __restrict__ bm,
                          int32_t* __restrict__ gcnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned act = __ballot_sync(0xffffffffu, i < L[0]);
  if (i >= L[0]) return;
  int z;
  const uint32_t key = level_key(L, i, u, jp, R, z);
  keys[i] = key;
  mark_key(bm, gcnt, key, act);
}

// Launch 2 of 3: the groups' counts turned in place into exclusive prefixes
// within scan blocks of kScanGroups groups (4 a thread), and the blocks'
// sums; the last block to finish (done, zeroed by the caller) turns the
// sums into the blocks' exclusive prefixes.
__global__ void __launch_bounds__(kScanThreads) rank_scan(int32_t* __restrict__ gcnt, long long groups,
                                                          int32_t* bsum, unsigned* done,
                                                          const int32_t* __restrict__ gate) {
  __shared__ int ws[32];
  __shared__ bool s_last;
  if (gate && !*gate) return;
  const long long g0 = (long long)blockIdx.x * kScanGroups + (long long)threadIdx.x * 4;
  const int4 c = g0 < groups ? *reinterpret_cast<const int4*>(gcnt + g0) : make_int4(0, 0, 0, 0);
  int agg;
  const int run = block_excl_scan(c.x + c.y + c.z + c.w, ws, &agg);
  if (g0 < groups)
    *reinterpret_cast<int4*>(gcnt + g0) =
        make_int4(run, run + c.x, run + c.x + c.y, run + c.x + c.y + c.z);
  if (threadIdx.x == 0) bsum[blockIdx.x] = agg;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int carry = 0;
  for (int b0 = 0; b0 < (int)gridDim.x; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int v = b < (int)gridDim.x ? __ldcg(&bsum[b]) : 0;
    int t;
    const int e = block_excl_scan(v, ws, &t);
    if (b < (int)gridDim.x) bsum[b] = carry + e;
    carry += t;
  }
}

// Launch 3 of 3: R = the distinct keys below the node's key (its scan
// block's prefix, its group's prefix in the block, the bits below it in
// the group).
__global__ void rank_bits(const int32_t* __restrict__ L, const uint32_t* __restrict__ keys,
                          const uint32_t* __restrict__ bm, const int32_t* __restrict__ gpre,
                          const int32_t* __restrict__ bsum, int32_t* __restrict__ R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L[0]) return;
  const uint32_t key = keys[i];
  R[level_node(L, i)] = bsum[(key >> 8) / kScanGroups] + gpre[key >> 8] + bits_below_in_group(bm, key);
}

// A sorted level, launch 1 of 4: each node's key packed in 64 bits, in
// level order (u < 2^12 above a low field of wk <= 31 bits).
__global__ void rank_sort_keys(const int32_t* __restrict__ L, const int32_t* __restrict__ u,
                               const int32_t* __restrict__ jp, const int32_t* __restrict__ R,
                               long long* __restrict__ keys, const int32_t* __restrict__ gate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L[0] || (gate && !*gate)) return;
  const int z = level_node(L, i);
  const int j = jp[z];
  keys[i] = ((long long)u[z] << L[1]) | (j < 0 ? (long long)(-1 - j) : (long long)R[j] + 1);
}

// Launch 2 of 4, after the sort (sk: the sorted keys): bit i of hb set where
// sk[i] is a head.  One block of 256 threads per 8-word group writes the
// group's words and its count of heads (every word of the padded groups
// written: no memset).
__global__ void __launch_bounds__(256) rank_heads(const long long* __restrict__ sk, long long cnt,
                                                  uint32_t* __restrict__ hb, int32_t* __restrict__ gcnt,
                                                  const int32_t* __restrict__ gate) {
  if (gate && !*gate) return;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const bool h = i < cnt && (i == 0 || sk[i] != sk[i - 1]);
  const unsigned w = __ballot_sync(0xffffffffu, h);
  if ((threadIdx.x & 31) == 0) hb[i >> 5] = w;
  const int c = __syncthreads_count(h);
  if (threadIdx.x == 0) gcnt[blockIdx.x] = c;
}

// Launch 4 of 4 (after rank_scan on the groups' counts): the node at sorted
// position i (sv: the sort's positions in the level) takes the heads at or
// before i, less one: equal keys, equal ranks, dense from 0.
__global__ void rank_sorted(const int32_t* __restrict__ L, const int32_t* __restrict__ sv,
                            const uint32_t* __restrict__ hb, const int32_t* __restrict__ gpre,
                            const int32_t* __restrict__ bsum, int32_t* __restrict__ R,
                            const int32_t* __restrict__ gate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L[0] || (gate && !*gate)) return;
  const uint32_t k = (uint32_t)i;
  const int head = (int)((__ldcg(hb + (k >> 5)) >> (k & 31)) & 1u);
  R[level_node(L, sv[i])] = bsum[(k >> 8) / kScanGroups] + gpre[k >> 8] + bits_below_in_group(hb, k) + head - 1;
}

// A larger level's scan blocks' sums and their counter, in 4-byte words
// padded to 16 bytes (the next level's counts are read as int4).
long long sums_words(long long nblk) { return (nblk + 1 + 3) & ~3LL; }

// The 4-byte words of the zeroed scratch of a plan (every level's bitmap of
// 2^(12 + wk) bits in plan order, then per larger level its 8-word groups'
// counts, its scan blocks' sums and their counter), or -1 for a plan the
// bitmaps refuse: a level of more than kBitmapBits key bits (its caller
// sorts those), or one ranked in one block beyond kSmallMax nodes or
// kSmallBits.
long long plan_words(const int32_t* plan_host, int nsmall, int nlevels) {
  if (nsmall < 0 || nsmall > nlevels) return -1;
  long long need = 0;
  for (int l = 0; l < nlevels; ++l) {
    const int32_t* Lh = plan_host + l * kLevelInts;
    const int bits = 12 + Lh[1];
    if (Lh[1] < 0 || bits > kBitmapBits || (l < nsmall && (bits > kSmallBits || Lh[0] > kSmallMax))) return -1;
    const long long words = 1LL << (bits - 5), groups = words >> 3;
    need += words + (l < nsmall ? 0 : groups + sums_words((groups + kScanGroups - 1) / kScanGroups));
  }
  return need;
}

// Ranks the bitmap levels of a plan (u and jp written by the caller's
// earlier launch on the stream; zbuf zeroed by the caller): the first
// nsmall in one block, each other in three launches.
cudaError_t rank_levels(const int32_t* plan, const int32_t* plan_host, int nsmall, int nlevels,
                        const int32_t* u, const int32_t* jp, int32_t* R, uint32_t* keys,
                        uint32_t* zbuf, cudaStream_t stream) {
  cudaError_t err;
  long long boff = 0;
  for (int l = 0; l < nsmall; ++l) boff += 1LL << (7 + plan_host[l * kLevelInts + 1]);
  if (nsmall > 0) {
    err = cudaFuncSetAttribute(anchor_small, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmallShared);
    if (err != cudaSuccess) return err;
    anchor_small<<<1, 1024, kSmallShared, stream>>>(plan, nsmall, u, jp, R, zbuf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  long long soff = boff;
  for (int l = nsmall; l < nlevels; ++l) soff += 1LL << (7 + plan_host[l * kLevelInts + 1]);
  for (int l = nsmall; l < nlevels; ++l) {
    const int32_t* Ld = plan + l * kLevelInts;
    const long long cnt = plan_host[l * kLevelInts];
    const long long words = 1LL << (7 + plan_host[l * kLevelInts + 1]), groups = words >> 3;
    const long long nblk = (groups + kScanGroups - 1) / kScanGroups;
    int32_t* gcnt = reinterpret_cast<int32_t*>(zbuf + soff);
    int32_t* bsum = gcnt + groups;
    const unsigned nb = (unsigned)((cnt + kRankThreads - 1) / kRankThreads);
    rank_mark<<<nb, kRankThreads, 0, stream>>>(Ld, u, jp, R, keys, zbuf + boff, gcnt);
    rank_scan<<<(unsigned)nblk, kScanThreads, 0, stream>>>(gcnt, groups, bsum,
                                                           reinterpret_cast<unsigned*>(bsum + nblk), nullptr);
    rank_bits<<<nb, kRankThreads, 0, stream>>>(Ld, keys, zbuf + boff, gcnt, bsum, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    boff += words;
    soff += groups + sums_words(nblk);
  }
  return cudaSuccess;
}

// The scratch of a sorted level of cnt nodes, in 4-byte words: the heads'
// bitmap over 8-word groups padded to a multiple of 4 groups, the groups'
// counts (then prefixes), the scan blocks' sums and their counter.
long long sorted_words(long long cnt, long long* groups_out) {
  const long long groups = (((cnt + 255) >> 8) + 3) & ~3LL;
  if (groups_out) *groups_out = groups;
  return groups * 9 + sums_words((groups + kScanGroups - 1) / kScanGroups);
}

// A sorted level's keys (L: the level's plan words on the device; cnt: its
// nodes; gate: a device word, the level is sorted only where it is nonzero;
// null: always).
cudaError_t sort_keys_level(const int32_t* L, long long cnt, const int32_t* u, const int32_t* jp,
                            const int32_t* R, long long* keys, cudaStream_t stream,
                            const int32_t* gate = nullptr) {
  if (cnt < 1) return cudaErrorInvalidValue;
  rank_sort_keys<<<(unsigned)((cnt + kRankThreads - 1) / kRankThreads), kRankThreads, 0, stream>>>(
      L, u, jp, R, keys, gate);
  return cudaGetLastError();
}

// A sorted level's ranks from its sorted keys sk and their positions sv
// (scratch: sorted_words(cnt) 4-byte words, 16-byte aligned; its counter
// zeroed here).
cudaError_t sorted_level(const int32_t* L, long long cnt, const long long* sk, const int32_t* sv,
                         uint32_t* scratch, long long words, int32_t* R, cudaStream_t stream,
                         const int32_t* gate = nullptr) {
  long long groups;
  if (cnt < 1 || words < sorted_words(cnt, &groups) || reinterpret_cast<uintptr_t>(scratch) % 16)
    return cudaErrorInvalidValue;
  const long long nblk = (groups + kScanGroups - 1) / kScanGroups;
  uint32_t* hb = scratch;
  int32_t* gcnt = reinterpret_cast<int32_t*>(scratch + groups * 8);
  int32_t* bsum = gcnt + groups;
  cudaError_t err = cudaMemsetAsync(bsum + nblk, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  rank_heads<<<(unsigned)groups, 256, 0, stream>>>(sk, cnt, hb, gcnt, gate);
  rank_scan<<<(unsigned)nblk, kScanThreads, 0, stream>>>(gcnt, groups, bsum, reinterpret_cast<unsigned*>(bsum + nblk),
                                                         gate);
  rank_sorted<<<(unsigned)((cnt + kRankThreads - 1) / kRankThreads), kRankThreads, 0, stream>>>(L, sv, hb, gcnt,
                                                                                              bsum, R, gate);
  return cudaGetLastError();
}


// -- the table and 2D walks' levels: each level's hop words ranked first ----
// A level's key is then ur * D + low: ur the dense rank of the node's hop
// word among the hop words its level holds (a 4,096-bit presence bitmap per
// level, marked by the anchors launch, its words' prefixes taken by
// urank_prep), low as above, and D one more than the largest low any node
// of the level can hold (the lows of strings that end with the node stay
// below dlow0; a rank field is at most the distinct strings of a coarser
// level, each level's count written by its scan).  The keys keep the
// order of u << wk | low, so the ranks are the same, but a level's keys span
// nu D bits, not 2^(12 + wk): a few thousand on the walks' fields.  The
// small levels share one region of kSmallBits bits, each zeroed up to its
// need by the one block before it marks; each larger level marks into one of
// two regions of at most 2^cap bits (the level before it, or the small
// block, or urank_prep, zeroes the words and group counts it will use), so
// no call zeroes a bitmap it does not read.  A larger level whose keys
// would pass its region (possible only where 12 + wk passes the cap; on
// none of the walks' fields so far) sets its overflow word, skips its three
// launches, and is ranked by the sorted route, whose launches every call
// issues for those levels and which run only where the word is set.
constexpr int kUWords = 128;  // a level's hop-word bitmap (u < 2^12)
constexpr int kULay = 8;      // int32 words per level of a u-rank layout
// a u-rank layout's words: the region's groups, the
// bitmap's offset in 4-byte words, the group counts' offset, the block
// sums' offset, the scan's blocks, whether the sorted route may take it
enum { kLayGroups = 0, kLayBm, kLayGc, kLayBs, kLayScan, kLayGated };
// state words per level: hop words, the multiplier D, the groups used,
// overflow, distinct keys, the scan's counter
enum { kStNu = 0, kStD, kStGroups, kStOver, kStNd, kStDone, kStInts = 8 };

struct URank {
  const int32_t* plan;  // kLevelInts per level, on the device
  const int32_t* lay;   // kULay per level
  uint32_t* ubm;        // [levels][kUWords]: zero on entry and left zero
  uint32_t* uw;         // the bitmaps' copy
  int32_t* upre;        // their words' exclusive prefixes
  int32_t* st;          // [levels][kStInts]
  uint32_t* sbm;        // the small levels' region (2^kSmallBits bits)
  uint32_t* bm;         // the larger levels' regions (lay offsets)
  int32_t* gc;
  int32_t* bs;
  uint32_t* keys;       // a larger level's keys in level order
  const int32_t* u;
  const int32_t* jp;
  int32_t* R;
  int nsmall, nlevels, dlow0;
};

// A level's key from its hop-word rank (uw, upre: the level's rows) and the
// low field.
__device__ __forceinline__ uint32_t urank_key(const int32_t* __restrict__ L, int i, const URank& r,
                                              const uint32_t* uw, const int32_t* upre, uint32_t D) {
  const int z = level_node(L, i);
  const int uu = r.u[z], j = r.jp[z];
  const uint32_t ur = (uint32_t)upre[uu >> 5] + __popc(uw[uu >> 5] & ((1u << (uu & 31)) - 1u));
  const uint32_t low = j < 0 ? (uint32_t)(-1 - j) : (uint32_t)(r.R[j] + 1);
  return ur * D + low;
}

// Readies larger level l for its three launches: the multiplier D, the
// groups its keys span (a multiple of 4) or the overflow flag, and its
// region's used words and group counts zeroed by threads first, first +
// stride, ... (thread 0 of the caller's grid writes the state).
__device__ void urank_setup(const URank& r, int l, long long D, long long nu, long long first,
                            long long stride) {
  const int32_t* Ly = r.lay + l * kULay;
  int32_t* st = r.st + l * kStInts;
  const long long groups = (((nu * D + 255) >> 8) + 3) & ~3LL;
  const bool over = groups > Ly[kLayGroups];
  if (first == 0) {
    st[kStD] = (int32_t)D;
    st[kStGroups] = over ? 0 : (int32_t)groups;
    st[kStOver] = over ? 1 : 0;
  }
  if (over) return;
  uint4* w = reinterpret_cast<uint4*>(r.bm + Ly[kLayBm]);
  int4* g = reinterpret_cast<int4*>(r.gc + Ly[kLayGc]);
  for (long long i = first; i < groups * 2; i += stride) w[i] = make_uint4(0, 0, 0, 0);
  for (long long i = first; i < groups / 4; i += stride) g[i] = make_int4(0, 0, 0, 0);
}

// One block of kUWords threads per level: the hop-word bitmap copied and
// cleared, its words' exclusive prefixes, the level's count of hop words;
// block 0 readies larger level 0 where no level is small.
__global__ void __launch_bounds__(kUWords) urank_prep(URank r) {
  __shared__ int ws[32];
  const int l = blockIdx.x, t = threadIdx.x;
  const uint32_t w = r.ubm[l * kUWords + t];
  r.ubm[l * kUWords + t] = 0;
  r.uw[l * kUWords + t] = w;
  int nu;
  r.upre[l * kUWords + t] = block_excl_scan(__popc(w), ws, &nu);
  if (t == 0) r.st[l * kStInts + kStNu] = nu;
  if (l == 0 && r.nsmall == 0 && r.nlevels > 0) urank_setup(r, 0, r.dlow0, nu, t, kUWords);
}

// The small levels (at most kSmallMax nodes and kSmallBits bits at 2^(12 +
// wk)) in order in one block of 1,024 threads, as anchor_small ranks them,
// each in the shared region zeroed up to its need; then larger level nsmall
// readied.
__global__ void __launch_bounds__(1024) urank_small(URank r) {
  extern __shared__ uint32_t smem[];
  __shared__ int ws[32];
  uint32_t* K = smem;
  int* G = reinterpret_cast<int*>(smem + kSmallMax);
  const int tid = threadIdx.x, nt = blockDim.x;
  long long D = r.dlow0;
  for (int l = 0; l < r.nsmall; ++l) {
    const int32_t* L = r.plan + l * kLevelInts;
    const uint32_t* uw = r.uw + l * kUWords;
    const int32_t* upre = r.upre + l * kUWords;
    const int cnt = L[0];
    const int groups = (int)((r.st[l * kStInts + kStNu] * D + 255) >> 8);
    for (int g = tid; g < groups; g += nt) {
      G[g] = 0;
      reinterpret_cast<uint4*>(r.sbm)[2 * g] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(r.sbm)[2 * g + 1] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    for (int i0 = 0; i0 < cnt; i0 += nt) {
      const int i = i0 + tid;
      const unsigned act = __ballot_sync(0xffffffffu, i < cnt);
      if (i < cnt) {
        const uint32_t key = urank_key(L, i, r, uw, upre, (uint32_t)D);
        K[i] = key;
        mark_key(r.sbm, G, key, act);
      }
    }
    __syncthreads();
    const int per = (groups + nt - 1) / nt;
    const int lo = min(tid * per, groups), hi = min(lo + per, groups);
    int c = 0;
    for (int g = lo; g < hi; ++g) c += G[g];
    int nd;
    int run = block_excl_scan(c, ws, &nd);
    for (int g = lo; g < hi; ++g) {
      const int v = G[g];
      G[g] = run;
      run += v;
    }
    __syncthreads();
    for (int i = tid; i < cnt; i += nt) {
      const uint32_t key = K[i];
      r.R[level_node(L, i)] = G[key >> 8] + bits_below_in_group(r.sbm, key);
    }
    if (tid == 0) r.st[l * kStInts + kStNd] = nd;
    D = max(D, (long long)nd + 1);
    __syncthreads();
  }
  if (r.nsmall < r.nlevels) urank_setup(r, r.nsmall, D, r.st[r.nsmall * kStInts + kStNu], tid, nt);
}

// A larger level, launch 1 of 3 (skipped on overflow): each node's key
// kept, its bit set, its group's count of distinct keys raised.
__global__ void urank_mark(URank r, int l) {
  const int32_t* L = r.plan + l * kLevelInts;
  const int32_t* Ly = r.lay + l * kULay;
  const int32_t* st = r.st + l * kStInts;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned act = __ballot_sync(0xffffffffu, i < L[0]);
  if (i >= L[0] || st[kStOver]) return;
  const uint32_t key = urank_key(L, i, r, r.uw + l * kUWords, r.upre + l * kUWords, (uint32_t)st[kStD]);
  r.keys[i] = key;
  mark_key(r.bm + Ly[kLayBm], r.gc + Ly[kLayGc], key, act);
}

// Launch 2 of 3: rank_scan over the groups the level's keys span (the
// blocks past them leave at once); the last block also writes the level's
// count of distinct keys and leaves the counter zero.
__global__ void __launch_bounds__(kScanThreads) urank_scan(URank r, int l) {
  __shared__ int ws[32];
  __shared__ bool s_last;
  const int32_t* Ly = r.lay + l * kULay;
  int32_t* st = r.st + l * kStInts;
  if (st[kStOver]) return;
  const long long groups = st[kStGroups];
  const unsigned nact = (unsigned)((groups + kScanGroups - 1) / kScanGroups);
  if (blockIdx.x >= nact) return;
  int32_t* gcnt = r.gc + Ly[kLayGc];
  int32_t* bsum = r.bs + Ly[kLayBs];
  unsigned* done = reinterpret_cast<unsigned*>(st + kStDone);
  const long long g0 = (long long)blockIdx.x * kScanGroups + (long long)threadIdx.x * 4;
  const int4 c = g0 < groups ? *reinterpret_cast<const int4*>(gcnt + g0) : make_int4(0, 0, 0, 0);
  int agg;
  const int run = block_excl_scan(c.x + c.y + c.z + c.w, ws, &agg);
  if (g0 < groups)
    *reinterpret_cast<int4*>(gcnt + g0) = make_int4(run, run + c.x, run + c.x + c.y, run + c.x + c.y + c.z);
  if (threadIdx.x == 0) bsum[blockIdx.x] = agg;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == nact - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int carry = 0;
  for (unsigned b0 = 0; b0 < nact; b0 += kScanThreads) {
    const unsigned b = b0 + threadIdx.x;
    const int v = b < nact ? __ldcg(&bsum[b]) : 0;
    int t;
    const int e = block_excl_scan(v, ws, &t);
    if (b < nact) bsum[b] = carry + e;
    carry += t;
  }
  if (threadIdx.x == 0) {
    st[kStNd] = carry;
    *done = 0;
  }
}

// Launch 3 of 3: R = the distinct keys below the node's key (skipped on
// overflow); every block then readies larger level l + 1 (its D from this
// level's count, or 2^wk of l + 1 where this level overflowed).
__global__ void urank_bits(URank r, int l) {
  const int32_t* L = r.plan + l * kLevelInts;
  const int32_t* Ly = r.lay + l * kULay;
  const int32_t* st = r.st + l * kStInts;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool over = st[kStOver] != 0;
  if (i < L[0] && !over) {
    const uint32_t key = r.keys[i];
    r.R[level_node(L, i)] = r.bs[Ly[kLayBs] + (key >> 8) / kScanGroups] + r.gc[Ly[kLayGc] + (key >> 8)] +
                            bits_below_in_group(r.bm + Ly[kLayBm], key);
  }
  if (l + 1 < r.nlevels) {
    const long long D = over ? (1LL << r.plan[(l + 1) * kLevelInts + 1])
                             : max((long long)st[kStD], (long long)st[kStNd] + 1);
    urank_setup(r, l + 1, D, r.st[(l + 1) * kStInts + kStNu], (long long)blockIdx.x * blockDim.x + threadIdx.x,
                (long long)gridDim.x * blockDim.x);
  }
}

}  // namespace
}  // namespace sperr_rank
