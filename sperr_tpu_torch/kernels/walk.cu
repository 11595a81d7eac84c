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
//     rank): the levels of at most 4,096 nodes in one block of 1,024
//     threads (a bitonic sort of 32-bit keys in shared memory, a scan of
//     the distinct keys, a binary search per node); each larger level by
//     its keys, the radix sort and two rank launches.  (One block sorting
//     the 32,768-node level as well took 0.70 ms on an H100 80GB HBM3; with
//     that level on the grid route all of K7 takes 0.27 ms.)
//   * walk_rows: a thread per compacted parent decodes its id, loads its
//     8-value row in one 32-byte load, and writes the row items' payloads;
//     the skip rule's "an earlier sibling turned significant" is a bit test
//     on the row's 8-bit significance mask.
//   * walk_born / walk_entries / walk_rowkeys: the born entries' insertion
//     keys and per-level counts (shared-memory histogram, integer atomics),
//     then after their sort the level starts as an exclusive prefix of the
//     counts, the walk ranks as arithmetic, the walk rank table, and the
//     walk-sort keys of every item.
//   * the radix sort: 8-bit digits, three launches per pass (block
//     histograms; one scan per digit over the blocks; a stable scatter whose
//     block-local ranks come from __match_any_sync within a warp and a
//     per-digit prefix over the warps), passes only over the digits that the
//     keys' static widths leave nonzero, the sign bit flipped so that int32
//     and int64 keys sort as torch.sort sorts them.  Keys are packed so that
//     one 64-bit key holds what the plain version sorts as (hi, lo) pairs
//     and path words, where the widths fit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNever = 0x7FFF;
constexpr int kBig = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kMaxRoots = 64;
constexpr int kMaxDepth = 14;  // entries of the per-depth tables
// a level of the rank plan: count, key width of the parent ranks, spans
constexpr int kMaxSpans = 16;
constexpr int kLevelInts = 3 + 2 * kMaxSpans;
constexpr int kSmallMax = 4096;  // nodes of a level ranked in one block
constexpr int kSmallShared = kSmallMax * 4 + kSmallMax * 2;
// radix sort: 256 threads, 16 rounds of one item each per block
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kTile = 4096;

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

// Walk-key path words of the node (d, m): one word of 4-bit digits (depth j
// at 4 (S - 1 - j)) when S <= 7, else two words of 5-bit digits (depth j at
// 5 (5 - j), then 5 (11 - j)), as codec/speck_sorted.py lays them out.
__device__ __forceinline__ void path_words(int S, int d, int m, int& w0, int& w1) {
  w0 = w1 = 0;
  for (int j = 0; j < d; ++j) {
    const int dig = ((m >> (3 * (d - 1 - j))) & 7) + 1;
    if (S <= 7)
      w0 |= dig << (4 * (S - 1 - j));
    else if (j < 6)
      w0 |= dig << (5 * (5 - j));
    else
      w1 |= dig << (5 * (11 - j));
  }
}

// The path words of child slot k of the node (d, m).
__device__ __forceinline__ void child_path_words(int S, int d, int m, int k, int& w0, int& w1) {
  path_words(S, d, m, w0, w1);
  if (S <= 7)
    w0 += (k + 1) << (4 * (S - 1 - d));
  else if (d < 6)
    w0 += (k + 1) << (5 * (5 - d));
  else if (d < 12)
    w1 += (k + 1) << (5 * (11 - d));
}

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

// Levels of at most kSmallMax nodes, in order, in one block of 1,024
// threads: key (u << wk) | (rank of the parent's chain top + 1, or 0 at a
// root), bitonic sort, distinct-key prefix, a binary search per node.  R is
// written and read across levels (no read-only loads).
__global__ void __launch_bounds__(1024) anchor_small(const int32_t* __restrict__ plan, int nlv,
                                                     const int32_t* __restrict__ u,
                                                     const int32_t* __restrict__ jp, int32_t* R) {
  extern __shared__ uint32_t smem[];
  __shared__ int ws[32];
  uint32_t* S = smem;
  uint16_t* Dc = reinterpret_cast<uint16_t*>(smem + kSmallMax);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = 0; l < nlv; ++l) {
    const int32_t* L = plan + l * kLevelInts;
    const int cnt = L[0], wk = L[1];
    int P = 1;
    while (P < cnt) P <<= 1;
    for (int i = tid; i < P; i += nt) {
      uint32_t key = 0xFFFFFFFFu;
      if (i < cnt) {
        const int z = level_node(L, i), j = jp[z];
        key = ((uint32_t)u[z] << wk) | (j < 0 ? 0u : (uint32_t)(R[j] + 1));
      }
      S[i] = key;
    }
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < P; i += nt) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const uint32_t a = S[i], b = S[ixj];
            if (((i & k) == 0) ? a > b : a < b) {
              S[i] = b;
              S[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    const int per = (cnt + nt - 1) / nt;
    const int lo = min(tid * per, cnt), hi = min(lo + per, cnt);
    int c = 0;
    for (int i = lo; i < hi; ++i) c += (i == 0 || S[i] != S[i - 1]);
    int run = block_excl_scan(c, ws, nullptr);
    for (int i = lo; i < hi; ++i) {
      run += (i == 0 || S[i] != S[i - 1]);
      Dc[i] = (uint16_t)run;
    }
    __syncthreads();
    for (int i = tid; i < cnt; i += nt) {
      const int z = level_node(L, i), j = jp[z];
      const uint32_t key = ((uint32_t)u[z] << wk) | (j < 0 ? 0u : (uint32_t)(R[j] + 1));
      int a = 0, b = cnt;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (S[mid] < key)
          a = mid + 1;
        else
          b = mid;
      }
      R[z] = (int)Dc[a] - 1;
    }
    __syncthreads();
  }
}

// A larger level: its keys and node ids, for the radix sort.
template <typename KT>
__global__ void rank_keys(const int32_t* __restrict__ L, const int32_t* __restrict__ u,
                          const int32_t* __restrict__ jp, const int32_t* __restrict__ R,
                          KT* __restrict__ keys, int32_t* __restrict__ ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L[0]) return;
  const int z = level_node(L, i), j = jp[z];
  keys[i] = ((KT)(uint32_t)u[z] << L[1]) | (j < 0 ? (KT)0 : (KT)(uint32_t)(R[j] + 1));
  ids[i] = z;
}

// Per tile of sorted keys: the positions where the key changes.
template <typename KT>
__global__ void __launch_bounds__(kSortThreads) rank_count(const KT* __restrict__ ks, long long n,
                                                           int32_t* __restrict__ bsum) {
  __shared__ int ws[32];
  const long long t0 = (long long)blockIdx.x * kTile;
  int c = 0;
  for (int r = 0; r < kTile / kSortThreads; ++r) {
    const long long i = t0 + (long long)r * kSortThreads + threadIdx.x;
    if (i > 0 && i < n) c += ks[i] != ks[i - 1];
  }
  int tot;
  block_excl_scan(c, ws, &tot);
  if (threadIdx.x == 0) bsum[blockIdx.x] = tot;
}

// Dense ranks: the changes before each sorted position, scattered to the
// node ids.
template <typename KT>
__global__ void __launch_bounds__(kSortThreads) rank_scatter(const KT* __restrict__ ks,
                                                             const int32_t* __restrict__ ids,
                                                             long long n,
                                                             const int32_t* __restrict__ bsum,
                                                             int32_t* __restrict__ R) {
  __shared__ int ws[32];
  int p = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kSortThreads) p += bsum[b];
  int carry;
  block_excl_scan(p, ws, &carry);
  const long long t0 = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kTile / kSortThreads; ++r) {
    const long long i = t0 + (long long)r * kSortThreads + threadIdx.x;
    const int fl = (i > 0 && i < n) ? (ks[i] != ks[i - 1]) : 0;
    int tot;
    const int ex = block_excl_scan(fl, ws, &tot);
    if (i < n) R[ids[i]] = carry + ex + fl;
    carry += tot;
  }
}

// -- the radix sort ---------------------------------------------------------------
template <typename KT>
__device__ __forceinline__ int digit_of(KT k, int shift) {
  const KT flip = (KT)1 << (sizeof(KT) * 8 - 1);
  return (int)(((k ^ flip) >> shift) & 255);
}

// Block histograms: counts[digit * nblocks + block].
template <typename KT>
__global__ void __launch_bounds__(kSortThreads) radix_hist(const KT* __restrict__ keys, long long n,
                                                           int shift, int32_t* __restrict__ counts,
                                                           int nblocks) {
  __shared__ int h[256];
  const int tid = threadIdx.x, lane = tid & 31;
  h[tid] = 0;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1;
  const long long t0 = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kTile / kSortThreads; ++r) {
    const long long i = t0 + (long long)r * kSortThreads + tid;
    const int dg = i < n ? digit_of(keys[i], shift) : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (dg < 256 && (peers & lt) == 0) atomicAdd(&h[dg], __popc(peers));
  }
  __syncthreads();
  counts[(long long)tid * nblocks + blockIdx.x] = h[tid];
}

// One block per digit: the exclusive scan of its row over the blocks, and
// the digit's total.
__global__ void __launch_bounds__(1024) radix_scan(int32_t* __restrict__ counts, int nblocks,
                                                   int32_t* __restrict__ totals) {
  __shared__ int ws[32];
  int32_t* row = counts + (long long)blockIdx.x * nblocks;
  int carry = 0;
  for (int base = 0; base < nblocks; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < nblocks ? row[i] : 0;
    int tot;
    const int ex = block_excl_scan(v, ws, &tot);
    if (i < nblocks) row[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Stable scatter: each round of 256 items, the rank among the warp's items
// of the same digit (__match_any_sync) plus the digit's count in earlier
// warps and rounds and the block's base.  vin null: the values are the
// items' indices.
template <typename KT>
__global__ void __launch_bounds__(kSortThreads) radix_scatter(
    const KT* __restrict__ kin, const int32_t* __restrict__ vin, KT* __restrict__ kout,
    int32_t* __restrict__ vout, long long n, int shift, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ totals, int nblocks) {
  __shared__ int s_base[256];
  __shared__ int s_cnt[kSortWarps][256];
  __shared__ int s_off[kSortWarps][256];
  __shared__ int ws[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dbase = block_excl_scan(totals[tid], ws, nullptr);
  s_base[tid] = dbase + counts[(long long)tid * nblocks + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) s_cnt[w][tid] = 0;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1;
  const long long t0 = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kTile / kSortThreads; ++r) {
    const long long i = t0 + (long long)r * kSortThreads + tid;
    const bool ok = i < n;
    const KT key = ok ? kin[i] : (KT)0;
    const int dg = ok ? digit_of(key, shift) : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    const int rank = __popc(peers & lt);
    if (ok && rank == 0) s_cnt[warp][dg] = __popc(peers);
    __syncthreads();
    int run = s_base[tid];
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = s_cnt[w][tid];
      s_off[w][tid] = run;
      s_cnt[w][tid] = 0;
      run += c;
    }
    s_base[tid] = run;
    __syncthreads();
    if (ok) {
      const int pos = s_off[warp][dg] + rank;
      kout[pos] = key;
      vout[pos] = vin ? vin[i] : (int32_t)i;
    }
  }
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ src, const int32_t* __restrict__ idx,
                              T* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[idx[i]];
}

// nshift passes over the digits at shifts[]; the last pass writes kout and
// vout, the others alternate with kbuf and vbuf.  vals null: the values are
// the input positions.
template <typename KT>
cudaError_t radix_passes(const KT* keys, const int32_t* vals, long long n, const int* shifts,
                         int nshift, KT* kbuf, int32_t* vbuf, KT* kout, int32_t* vout,
                         int32_t* counts, int32_t* totals, cudaStream_t st) {
  const int nb = (int)((n + kTile - 1) / kTile);
  const KT* ks = keys;
  const int32_t* vs = vals;
  for (int p = 0; p < nshift; ++p) {
    const bool last = (nshift - 1 - p) % 2 == 0;
    KT* kd = last ? kout : kbuf;
    int32_t* vd = last ? vout : vbuf;
    radix_hist<KT><<<nb, kSortThreads, 0, st>>>(ks, n, shifts[p], counts, nb);
    radix_scan<<<256, 1024, 0, st>>>(counts, nb, totals);
    radix_scatter<KT><<<nb, kSortThreads, 0, st>>>(ks, vs, kd, vd, n, shifts[p], counts, totals, nb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ks = kd;
    vs = vd;
  }
  return cudaSuccess;
}

int shifts_for(int bits, int* shifts) {
  const int ns = (bits + 7) / 8;
  for (int p = 0; p < ns; ++p) shifts[p] = 8 * p;
  return ns;
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
// same on the host), the first nsmall ranked in one block.  keys, ids,
// kbuf, vbuf, kout, vout, counts, totals, bsum: the larger levels' sort.
extern "C" int sperr_anchor_ranks(const int32_t* node_s, const WalkForest* f, long long nn,
                                  const int32_t* plan, const int32_t* plan_host, int nsmall,
                                  int nlevels, int32_t* J, int32_t* R, int32_t* u, int32_t* jp,
                                  uint8_t* sigf, int32_t* wbuf, void* keys, int32_t* ids,
                                  void* kbuf, int32_t* vbuf, void* kout, int32_t* vout,
                                  int32_t* counts, int32_t* totals, int32_t* bsum,
                                  cudaStream_t stream) {
  if (nn < 1 || nsmall < 0 || nsmall > nlevels) return (int)cudaErrorInvalidValue;
  anchor_chain<<<blocks_for(nn), kThreads, 0, stream>>>(node_s, f, nn, J, R, u, jp, sigf, wbuf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nsmall > 0) {
    err = cudaFuncSetAttribute(anchor_small, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmallShared);
    if (err != cudaSuccess) return (int)err;
    anchor_small<<<1, 1024, kSmallShared, stream>>>(plan, nsmall, u, jp, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int l = nsmall; l < nlevels; ++l) {
    const int32_t* Lh = plan_host + l * kLevelInts;
    const int32_t* Ld = plan + l * kLevelInts;
    const long long cnt = Lh[0];
    const int bits = 12 + Lh[1];
    int shifts[8];
    const int ns = shifts_for(bits, shifts);
    const unsigned nb = blocks_for(cnt, kTile);
    if (bits <= 31) {
      rank_keys<uint32_t><<<blocks_for(cnt), kThreads, 0, stream>>>(Ld, u, jp, R, (uint32_t*)keys, ids);
      err = radix_passes<uint32_t>((const uint32_t*)keys, ids, cnt, shifts, ns, (uint32_t*)kbuf, vbuf,
                                   (uint32_t*)kout, vout, counts, totals, stream);
      if (err != cudaSuccess) return (int)err;
      rank_count<uint32_t><<<nb, kSortThreads, 0, stream>>>((const uint32_t*)kout, cnt, bsum);
      rank_scatter<uint32_t><<<nb, kSortThreads, 0, stream>>>((const uint32_t*)kout, vout, cnt, bsum, R);
    } else {
      typedef unsigned long long u64;
      rank_keys<u64><<<blocks_for(cnt), kThreads, 0, stream>>>(Ld, u, jp, R, (u64*)keys, ids);
      err = radix_passes<u64>((const u64*)keys, ids, cnt, shifts, ns, (u64*)kbuf, vbuf, (u64*)kout,
                              vout, counts, totals, stream);
      if (err != cudaSuccess) return (int)err;
      rank_count<u64><<<nb, kSortThreads, 0, stream>>>((const u64*)kout, cnt, bsum);
      rank_scatter<u64><<<nb, kSortThreads, 0, stream>>>((const u64*)kout, vout, cnt, bsum, R);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The stable radix sort of n keys (4 or 8 bytes, read as signed) with int32
// values (vals null: 0 .. n-1) over the digits at shifts[]: sorted keys in
// kout, values in vout; kbuf, vbuf: n more of each; counts: 256 per block
// of kTile keys; totals: 256.
extern "C" int sperr_radix_sort(const void* keys, int key_bytes, const int32_t* vals, long long n,
                                const int* shifts, int nshift, void* kbuf, int32_t* vbuf,
                                void* kout, int32_t* vout, int32_t* counts, int32_t* totals,
                                cudaStream_t stream) {
  if (n < 1 || n > 0x7fffffffLL || nshift < 1 || nshift > 8 || (key_bytes != 4 && key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < nshift; ++p)
    if (shifts[p] < 0 || shifts[p] > 8 * key_bytes - 8) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (key_bytes == 4)
    err = radix_passes<uint32_t>((const uint32_t*)keys, vals, n, shifts, nshift, (uint32_t*)kbuf,
                                 vbuf, (uint32_t*)kout, vout, counts, totals, stream);
  else
    err = radix_passes<unsigned long long>(
        (const unsigned long long*)keys, vals, n, shifts, nshift, (unsigned long long*)kbuf, vbuf,
        (unsigned long long*)kout, vout, counts, totals, stream);
  return (int)err;
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
