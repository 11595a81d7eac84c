// The table walks of the device SPECK encoder for Hopper: K15's set walk
// over a child table (3D chunks that are not power-of-two cubes) and K14's
// quad/I-set walk (2D fields), with the node passes of both.
//
// Replaces the XLA programs of sperr_tpu/ops/speck_lis_jax.py
// lis_segments_device (:375, the table form of its items) and
// sperr_tpu/ops/speck_lis2_jax.py lis2_segments_device (:154).  (Its
// iset_significance_device (:134), the I-set maxima, is a part of the
// child-table schedule's pixel pass, kernels/schedule.cu.)  For a tree given by its tables (parent
// and level per node, the static path ranks, the packed child table) they
// give one payload word per walk item (the born list entries, the roots or,
// in 2D, the walk root and the I-set group heads, the child rows, and the 2D
// walk's pending-I and group-arrival items), in walk order: sorted by (walk
// rank, path), ties in the plain version's input order.  Every result is an
// integer and equals the plain versions (ops/speck_lis.py
// _lis_items_table_ref, ops/speck_lis2.py _lis2_items_ref) bit for bit,
// padding items included.
//
// Bound: the walk reads the node passes, the child table and the pixel
// passes it reaches once and writes one word per item; the plain version
// spends a ladder of int64 torch.sort calls on the string ranks, one more
// sort for the walk ranks, and scatters.  The designs:
//   * one int64 key per sort.  A path enters a key as its static path rank
//     (ops/speck_lis.py path_ranks: a dense rank over every path value an
//     item can carry, made once per index; values repeat across roots, so
//     some 18-24 bits), read as ptab[pidx[z] (MC + 1)] for node z and
//     ptab[pidx[q] (MC + 1) + 1 + k] for child slot k of parent q, padding
//     slots included.  The insertion sort and the walk sort are then one
//     radix sort each (7 and 5-6 digit passes), the walk sort carrying the
//     payload words: no second key, no gather.
//   * table_anchors: one thread per node walks its parent chain (at most
//     depth_max hops, through L1) for its chain top J and the top of its
//     parent's chain, the next node of its hop-word string, and forms its
//     hop word (the table form's u; the 2D form's class word, packed to 12
//     bits in the same order), whose bit it sets in its level's 4,096-bit
//     hop-word bitmap; the ranks of the strings then come level by level,
//     coarse levels first, from rank.cuh's presence bitmaps over keys of
//     each level's hop-word rank times D plus the next string's rank field
//     (the u-rank route: the keys of the walks' fields span a few thousand
//     bits, not 2^(12 + wk)), with no sort and no memset.  A larger level
//     whose keys could pass its region (2^27 bits) has its sorted route
//     issued behind it, gated on the device by its overflow word.  Ranks
//     are compared only between anchors of one level (the insertion key
//     holds the anchor's level or class first), and equal hop words continue
//     on one level (the word holds the next node's level), so a rank per
//     level orders the strings as the plain version's global ladder does.
//   * table_rows: a thread per compacted parent (K12: ascending ids) reads
//     its child rows from the child table and the passes they point at,
//     tests the sibling rule on the row's significance bits and writes the
//     rows' payload words and the born-row flags K12 compacts.
//   * table_born / table_entries: the born entries' insertion keys (level,
//     birth pass, anchor level or class; anchor rank; path rank) and
//     per-level counts (shared-memory histogram,
//     integer atomics); after the one-sweep radix sort, each entry's
//     insertion rank O and its walk rank are arithmetic: the level's start
//     is an exclusive prefix of the counts, and the walk runs levels
//     descending, O ascending, so a valid entry's walk rank is the entries
//     of the finer levels plus O, an unused entry's its sorted position past
//     them.
//   * table_rowkeys: the rows' walk keys from their anchor's walk rank (in
//     2D the I-space block rank for a group anchor that partitions at its
//     own birth), and the 2D walk's pending-I and arrival items.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank.cuh"

namespace {

constexpr int kNever = 0x7FFF;
constexpr int kBig = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;   // tree levels (per-level counts in shared memory)
constexpr int kMaxChildren = 8;  // child slots of a node

}  // namespace

// The walk's tables, buffers and sizes, as kernels/__init__.py TableArgs
// lays them out: every field 8 bytes (a pointer or a long long), so the
// host's ctypes structure and this one agree field for field.  The host
// fills one per cached call buffer and sets only the inputs per call.
struct TableArgs {
  // the index's static tables
  const int32_t* parent;
  const int32_t* level;
  const int32_t* pidx;  // [nn] the node's distinct path value
  const int32_t* ptab;  // [values][MC + 1]: the value's path rank, then its MC child slots' path ranks
  const int32_t* ch_start;
  const int32_t* ch_count;
  const int32_t* ctab;  // child rows: (pixel linear id, or n + node id) << 1 | is pixel
  const int32_t* O0;    // table form: roots' pre-assigned per-level ranks
  const int32_t* off0;  // table form: roots per level
  const int32_t* root_ids;
  const int32_t* root_levels;
  const uint8_t* is_group;  // 2D form: the I-set groups
  const int32_t* k_of;
  const int32_t* irank_of;
  const int32_t* block_rank_of;
  const int32_t* group_ids;
  const int32_t* group_k;
  const int32_t* gbit_rank;
  const uint8_t* lev_plan;  // [nlev]: 1 + the level's index in the rank plan, 0 where it is not ranked
  const int32_t* plan;      // the rank plan (rank.cuh's kLevelInts per level)
  const int32_t* ulay;      // its u-rank layout (kULay per level)
  // the call's inputs
  const int32_t* node_s;
  const int32_t* s_lin;
  const uint8_t* signs;
  const int32_t* iset_s;  // 2D form: [xf + 1]
  const int32_t* num_bp;
  // anchors and ranks
  int32_t* J;
  int32_t* R;
  int32_t* u;
  int32_t* jp;
  uint8_t* sigf;
  int32_t* wbuf;  // [nn + 1] walk ranks by node id
  // the rank levels' scratch (rank.cuh URank), and the sorted route's of the
  // levels that may overflow their bitmaps
  uint32_t* ubm;
  uint32_t* uw;
  int32_t* upre;
  int32_t* rst;
  uint32_t* sbm;
  uint32_t* rbm;
  int32_t* rgc;
  int32_t* rbs;
  uint32_t* rkeys;
  long long* gkeys;  // a gated level's keys, then its sort's output or scratch (the passes' parity)
  long long* gkbuf;
  int32_t* gvbuf;
  int32_t* gvout;
  unsigned long long* gzbuf;
  uint32_t* gscr;
  // the compactions (K12) and the born entries
  const int32_t* sid;
  const int32_t* sid_count;
  uint8_t* bflag;  // [R] born rows
  const int32_t* born_idx;
  const int32_t* born_count;
  int32_t* counts;      // [nlev + 1] valid entries per level
  int32_t* n_sig_out;   // [1]
  long long* ikey;      // [NE] insertion keys
  const int32_t* perm;  // [NE] sorted position -> entry
  int32_t* pay;         // [T] payload words
  long long* wkey;      // [T] walk keys
  // sizes
  long long form;  // 0: table (3D), 1: 2D
  long long nn, n, nrows, MC, nlev, xf, G, nroots;
  long long C, take, CB, NE, E, rows;  // rows: the child rows, C MC
  long long tcap;   // the walk rank of "none" in the walk keys
  long long wbase;  // 2D form: the I item space's first rank
  long long wa;     // bits of the anchor rank in the insertion key
  long long pb;     // bits of a path rank (the low field of both keys)
  long long nsmall, dlow0;  // the rank plan's levels ranked in one block; 1 + the largest end field
  long long gzwords, gswords;        // the sorted route's sort and rank scratch
};

namespace {

unsigned blocks_for(long long count, int threads = kThreads) {
  return (unsigned)((count + threads - 1) / threads);
}

__device__ __forceinline__ int clamp63(int v) { return v < 0 ? 0 : (v > 63 ? 63 : v); }

// iset_s at a clipped level (2D)
__device__ __forceinline__ int kpass(const TableArgs& a, int k) {
  k = k < 0 ? 0 : (k > (int)a.xf ? (int)a.xf : k);
  return a.iset_s[k];
}

// -- the anchors -----------------------------------------------------------------
// For each node z: J[z], its hop word u[z] and the next node of its string
// jp[z] (-1 - t where the string ends: t = 0, or a 2D group anchor's static
// rank), sigf[z] = node_s[z] < NEVER, wbuf = BIG, R[z] = 0 on the levels
// that are not ranked, and on a ranked level u's bit in the level's hop-word
// bitmap.
//   table form: u = O0 at a root, else 1 << 11 | clip(pass of the parent) << 5
//               | 31 - level of the parent's chain top (the next node);
//   2D form:    0 at the walk root, else clip(birth pass) << 6 | class << 1 |
//               not root-anchored, the class nlev - level of the anchor, or
//               nlev + 1 for a group anchor (whose static rank ends the
//               string) -- the plain version's 26-bit word in its order.
__global__ void table_anchors(TableArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.nn) return;
  const int z = (int)t, nn = (int)a.nn;
  const int s = a.node_s[z];
  a.sigf[z] = s < kNever;
  a.wbuf[z] = kBig;
  if (z == 0) a.wbuf[nn] = kBig;
  const int p = a.parent[z];
  int Jz = z, cur = z, sp = 0;
  if (p >= 0) {
    sp = a.node_s[p];
    cur = p;
    for (;;) {
      const int g = a.parent[cur];
      if (g < 0 || a.node_s[g] != sp) break;
      cur = g;
    }
    if (sp == s) Jz = cur;
  }
  a.J[z] = Jz;
  int u, jp;
  if (a.form == 0) {
    if (p < 0) {
      u = a.O0[z];
      jp = -1;
    } else {
      u = (1 << 11) | (clamp63(sp) << 5) | (31 - a.level[cur]);
      jp = cur;
    }
  } else if (z == 0) {
    u = 0;
    jp = -1;
  } else {
    const bool grp = a.is_group[z] != 0;
    const int ar = (grp || p < 0) ? z : cur;
    const bool ganc = a.is_group[ar] != 0 && (z == ar || kpass(a, a.k_of[ar]) == a.node_s[ar]);
    const bool root_anc = ar == 0;
    const int bn = grp ? kpass(a, a.k_of[z]) : (p >= 0 ? sp : 0);
    const int acode = ganc ? (int)a.nlev + 1 : (int)a.nlev - a.level[ar];
    u = (clamp63(bn) << 6) | (acode << 1) | (root_anc ? 0 : 1);
    if (ganc) {
      const int ir = a.irank_of[ar];
      jp = -1 - (ir < 0 ? 0 : (ir > 2047 ? 2047 : ir));
    } else {
      jp = (root_anc || p < 0) ? -1 : ar;
    }
  }
  a.u[z] = u;
  a.jp[z] = jp;
  const int pl = a.lev_plan[a.level[z]];
  if (!pl) {
    a.R[z] = 0;
    return;
  }
  // the hop word's bit in its level's presence bitmap (tried only where it
  // reads unset: a level holds few hop words)
  uint32_t* w = a.ubm + (pl - 1) * sperr_rank::kUWords + (u >> 5);
  const uint32_t bit = 1u << (u & 31);
  if (!(__ldcg(w) & bit)) atomicOr(w, bit);
}

// -- the child rows ---------------------------------------------------------------
// A thread per parent slot c < C (sid[c] for c < take, else none): the
// payload words of its MC child rows and their born flags.  Payload bits as
// ops/speck_lis.py _walk_order.
__global__ void table_rows(TableArgs a) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const int nn = (int)a.nn, MC = (int)a.MC;
  const int sd = c < a.take ? a.sid[c] : nn;
  const bool ok = sd < nn;
  const int q = ok ? sd : nn - 1;
  const int cnt = ok ? a.ch_count[q] : 0;
  const int rowpass = ok ? a.node_s[q] : kNever;
  const long long st = a.ch_start[q];
  int val[kMaxChildren];
  bool px[kMaxChildren], nd[kMaxChildren];
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < kMaxChildren; ++k) {
    val[k] = 0;
    px[k] = nd[k] = false;
    if (k < cnt) {
      const int crow = a.ctab[st + k];
      const int vidx = crow >> 1;
      px[k] = (crow & 1) != 0;
      nd[k] = !px[k];
      val[k] = px[k] ? (a.s_lin[vidx] | ((int)a.signs[vidx] << 15)) : a.node_s[vidx - a.n];
      if ((val[k] & kNever) == rowpass) mask |= 1u << k;
    }
  }
  const int base = clamp63(rowpass) << 1;
  int32_t* pay = a.pay + a.E + c * MC;
  uint8_t* bf = a.bflag + c * MC;
#pragma unroll
  for (int k = 0; k < kMaxChildren; ++k) {
    if (k >= MC) break;
    const int sig = (mask >> k) & 1;
    const bool prev = (mask & ((1u << k) - 1)) != 0;
    const int emitted = (k < cnt && (prev || k != cnt - 1)) ? 1 : 0;
    const int ispx = px[k] ? 1 : 0;
    const int sign = (val[k] >> 15) & 1;
    pay[k] = base | ((sign & ispx) << 13) | (sig << 14) | ((ispx & sig) << 15) | (emitted << 16);
    bf[k] = nd[k] ? 1 : 0;
  }
}

// -- the list entries -------------------------------------------------------------
struct Entry {
  bool ok;
  int bid, bn, an;
};

// Entry b of the insertion sort: the born rows (K12's compaction, slots b <
// CB), then in 2D the walk root and the G group heads (born at iset_s[k];
// unused when their region never partitions).  Unused: (nn, BIG, nn).
__device__ __forceinline__ Entry entry_of(const TableArgs& a, long long b) {
  Entry e{false, (int)a.nn, kBig, (int)a.nn};
  if (b < a.CB) {
    const int bi = a.born_idx[b];
    if (bi < a.rows) {
      const int MC = (int)a.MC;
      const int q = a.sid[bi / MC];
      const int crow = a.ctab[(long long)a.ch_start[q] + bi % MC];
      e = Entry{true, (crow >> 1) - (int)a.n, a.node_s[q], a.J[q]};
    }
  } else {
    const int j = (int)(b - a.CB);
    if (j == 0) {
      e = Entry{true, 0, 0, 0};
    } else {
      const int id = a.group_ids[j - 1];
      const int bn = kpass(a, a.group_k[j - 1]);
      if (bn < kNever) e = Entry{true, id, bn, id};
    }
  }
  return e;
}

// The 2D anchor classes of an entry: (group anchor, walk root itself,
// root-anchored).
__device__ __forceinline__ void classes2d(const TableArgs& a, const Entry& e, bool& ganc, bool& rself,
                                          bool& ranc) {
  const int arl = e.an < (int)a.nn ? e.an : (int)a.nn - 1;
  ganc = a.is_group[arl] != 0 && (e.bid == e.an || kpass(a, a.k_of[arl]) == a.node_s[arl]);
  rself = e.bid == 0;
  ranc = e.an == 0 && !rself;
}

// The path rank of node z (its path value's dense rank; the zero path's is 0).
__device__ __forceinline__ long long path_rank(const TableArgs& a, int z) {
  return a.ptab[(long long)a.pidx[z] * (a.MC + 1)];
}

// A thread per entry of the insertion sort: its key(s) and the per-level
// count of valid entries; thread 0 writes n_sig (BIG past the born cap).
//   table form: (level << 11 | clip(birth) << 5 | 31 - anchor level, anchor
//               rank, path), the plain version's (k_lba, rank, path);
//   2D form:    (level << 12 | clip(birth) << 6 | class << 1 | not a root
//               class, the group's static rank, 0 for the root classes or
//               the anchor rank, path), its (k_lba, a_ord, path) in order.
// An unused entry takes nlev above the fields, after every valid one.
__global__ void table_born(TableArgs a) {
  __shared__ int h[kMaxLevels + 1];
  const int nlev = (int)a.nlev, nn = (int)a.nn;
  if (threadIdx.x <= kMaxLevels) h[threadIdx.x] = 0;
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) *a.n_sig_out = *a.born_count > a.CB ? kBig : *a.sid_count;
  if (b < a.NE) {
    const Entry e = entry_of(a, b);
    const int bidc = e.bid < nn ? e.bid : nn - 1;
    const int lev = a.level[bidc];
    long long lba;
    int arank = 0;
    if (a.form == 0) {
      const int alev = a.level[e.an < nn ? e.an : nn - 1];
      lba = e.ok ? (((long long)lev << 11) | (clamp63(e.bn) << 5) | (31 - alev)) : ((long long)nlev << 11);
      if (e.ok) arank = a.R[e.an];
    } else {
      bool ganc, rself, ranc;
      classes2d(a, e, ganc, rself, ranc);
      const int arl = e.an < nn ? e.an : nn - 1;
      const int acode = rself ? 0 : (ganc ? nlev + 1 : nlev - a.level[arl]);
      lba = e.ok ? (((long long)lev << 12) | (clamp63(e.bn) << 6) | (acode << 1) | ((rself || ranc) ? 0 : 1))
                 : ((long long)nlev << 12);
      if (e.ok) arank = ganc ? a.irank_of[arl] : ((rself || ranc) ? 0 : a.R[e.an]);
    }
    a.ikey[b] = (((lba << a.wa) | (long long)arank) << a.pb) | path_rank(a, bidc);
    if (e.ok) atomicAdd(&h[lev], 1);
  }
  __syncthreads();
  if (threadIdx.x < nlev && h[threadIdx.x]) atomicAdd(&a.counts[threadIdx.x], h[threadIdx.x]);
}

// After the insertion sort (perm: sorted position -> entry): a thread per
// list entry (the sorted entries, then the table form's roots) writes its
// walk rank into wbuf, its payload word and its walk keys.  Walk rank of a
// valid entry: the entries of the finer levels, then its insertion rank O in
// its level (table form: the level's roots first, off0); of an unused one,
// its place after every valid entry.
__global__ void table_entries(TableArgs a) {
  __shared__ int s_start[kMaxLevels + 1], s_suffix[kMaxLevels + 1];
  const int nlev = (int)a.nlev, nn = (int)a.nn;
  if (threadIdx.x == 0) {
    int run = 0;
    for (int L = 0; L < nlev; ++L) {
      s_start[L] = run;
      run += a.counts[L];
    }
    int suf = 0;
    for (int L = nlev - 1; L >= 0; --L) {
      s_suffix[L] = suf;
      suf += (a.form == 0 ? a.off0[L] : 0) + a.counts[L];
    }
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nroots = a.form == 0 ? a.nroots : 0;
  if (i >= a.NE + nroots) return;
  int w, from, s, ok;
  long long pr;
  if (i < a.NE) {
    const Entry e = entry_of(a, a.perm[i]);
    const int bidc = e.bid < nn ? e.bid : nn - 1;
    const int lev = a.level[bidc];
    ok = e.ok ? 1 : 0;
    if (e.ok) {
      w = s_suffix[lev] + (a.form == 0 ? a.off0[lev] : 0) + (int)(i - s_start[lev]);
      a.wbuf[e.bid] = w;
    } else {
      w = (int)(i + nroots);
    }
    // the plain version's c_bn + 1 wraps for an unused entry (BIG) and
    // clips to 0, as the 2D walk root's 0
    from = (e.ok && !(a.form == 1 && e.bid == 0)) ? e.bn + 1 : 0;
    s = a.node_s[bidc];
    pr = path_rank(a, bidc);
  } else {
    const int r = (int)(i - a.NE);
    const int id = a.root_ids[r];
    w = s_suffix[a.root_levels[r]] + a.O0[id];
    a.wbuf[id] = w;
    ok = 1;
    from = 0;
    s = a.node_s[id];
    pr = 0;  // a root's path is the zero path
  }
  a.pay[i] = 1 | (clamp63(from) << 1) | (clamp63(s) << 7) | (ok << 17);
  a.wkey[i] = ((long long)w << a.pb) | pr;
}

// A thread per parent slot c < C: the walk keys of its MC child rows (the
// walk rank of its chain top, tcap for none, or in 2D the I-space block
// rank of a group anchor that partitions at its own birth; the child
// path).  In 2D the threads past C write the I items: a pending-I entry per
// level k = xf .. 1, then each group's arrival bit.
__global__ void table_rowkeys(TableArgs a) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nn = (int)a.nn, MC = (int)a.MC;
  if (c < a.C) {
    const int sd = c < a.take ? a.sid[c] : nn;
    const bool ok = sd < nn;
    const int q = ok ? sd : nn - 1;
    const int anc = ok ? a.J[q] : q;
    long long w;
    if (a.form == 1 && ok && a.is_group[anc] && kpass(a, a.k_of[anc]) == a.node_s[anc]) {
      w = a.wbase + a.block_rank_of[anc];
    } else {
      w = a.wbuf[anc];
      if (w > a.tcap) w = a.tcap;
    }
    // the child slots' path ranks follow the parent's value's own (padding
    // slots included)
    const int32_t* pr = a.ptab + (long long)a.pidx[q] * (MC + 1) + 1;
    long long* wk = a.wkey + a.E + c * MC;
    for (int k = 0; k < MC; ++k) wk[k] = (w << a.pb) | (long long)pr[k];
    return;
  }
  if (a.form != 1) return;
  const long long j = c - a.C;
  if (j >= a.xf + a.G) return;
  const int xf = (int)a.xf, G = (int)a.G;
  const int nb = *a.num_bp;
  const long long i = a.E + a.rows + j;
  long long w;
  if (j < xf) {
    const int kj = xf - (int)j;
    const int birth = kj == xf ? 0 : kpass(a, kj + 1);
    bool any = false;
    for (int g = 0; g < G; ++g)
      any |= a.group_k[g] == kj + 1 && a.node_s[a.group_ids[g]] == kpass(a, a.group_k[g]);
    const int lo = birth + ((kj < xf && !any) ? 1 : 0);
    const int ok = (birth < kNever && lo < nb) ? 1 : 0;
    a.pay[i] = 1 | (clamp63(lo) << 1) | (clamp63(kpass(a, kj)) << 7) | (ok << 17);
    w = a.wbase + 8LL * (xf - kj);
  } else {
    const int g = (int)j - xf;
    const int gbn = kpass(a, a.group_k[g]);
    const int gsig = a.node_s[a.group_ids[g]] == gbn ? 1 : 0;
    a.pay[i] = (clamp63(gbn) << 1) | (gsig << 14) | ((gbn < nb ? 1 : 0) << 16);
    w = a.wbase + a.gbit_rank[g];
  }
  a.wkey[i] = w << a.pb;  // the I items' paths are the zero path
}

// -- the node passes ---------------------------------------------------------------
__global__ void node_passes_kernel(const int32_t* __restrict__ nm, const int32_t* __restrict__ num_bp,
                                   long long nn, int32_t* __restrict__ node_s) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nn) return;
  const int m = nm[i];
  node_s[i] = m > 0 ? *num_bp - m : kNever;
}

cudaError_t launch(void (*k)(TableArgs), long long count, const TableArgs* a, cudaStream_t st) {
  if (count < 1) return cudaSuccess;
  void* args[] = {const_cast<TableArgs*>(a)};
  return cudaLaunchKernel(reinterpret_cast<const void*>(k), dim3(blocks_for(count)), dim3(kThreads), args, 0, st);
}

bool args_ok(const TableArgs* a) {
  return a && a->nn >= 1 && a->MC >= 1 && a->MC <= kMaxChildren && a->nlev >= 1 &&
         a->nlev <= kMaxLevels - 2 && (a->form == 0 || a->form == 1) && a->C >= 1 && a->take >= 1 &&
         a->rows == a->C * a->MC && a->pb >= 0 && a->nsmall >= 0;
}

}  // namespace

extern "C" int sperr_radix_sort_gated(const int32_t* gate, const void* keys, int key_bytes,
                                      const int32_t* vals, long long n, const int* shifts, int nshift,
                                      void* kbuf, int32_t* vbuf, void* kout, int32_t* vout,
                                      unsigned long long* zbuf, long long zwords, cudaStream_t stream);

// The anchors and the string ranks: J, R, u, jp, sigf, wbuf of a (node_s
// in), the hop words ranked per level (urank_prep), then the rank plan's
// levels: the first nsmall in one block, each other in three launches,
// and after each level that may overflow its bitmap (its u-rank layout's
// kLayGated word) that level's sorted route, gated on its overflow word.
// plan_host and lay_host: the plan (nlevels levels) and its layout on the
// host.  Leaves the hop-word bitmaps and the scans' counters zero.
extern "C" int sperr_table_anchors(const TableArgs* a, const int32_t* plan_host, const int32_t* lay_host,
                                   int nlevels, cudaStream_t stream) {
  using namespace sperr_rank;
  if (!args_ok(a) || nlevels < a->nsmall || nlevels > kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch(table_anchors, a->nn, a, stream);
  if (err != cudaSuccess || nlevels == 0) return (int)err;
  const URank r{a->plan, a->ulay, a->ubm, a->uw, a->upre, a->rst, a->sbm, a->rbm, a->rgc, a->rbs, a->rkeys,
                a->u, a->jp, a->R, (int)a->nsmall, nlevels, (int)a->dlow0};
  urank_prep<<<nlevels, kUWords, 0, stream>>>(r);
  if (a->nsmall > 0) {
    err = cudaFuncSetAttribute(urank_small, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmallShared);
    if (err != cudaSuccess) return (int)err;
    urank_small<<<1, 1024, kSmallShared, stream>>>(r);
  }
  for (int l = (int)a->nsmall; l < nlevels; ++l) {
    const int32_t* Lh = plan_host + l * kLevelInts;
    const int32_t* Ly = lay_host + l * kULay;
    const long long cnt = Lh[0];
    const unsigned nb = (unsigned)((cnt + kRankThreads - 1) / kRankThreads);
    urank_mark<<<nb, kRankThreads, 0, stream>>>(r, l);
    urank_scan<<<(unsigned)Ly[kLayScan], kScanThreads, 0, stream>>>(r, l);
    urank_bits<<<nb, kRankThreads, 0, stream>>>(r, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (!Ly[kLayGated]) continue;
    // the level's sorted route, run only where its keys overflowed the bitmap
    const int32_t* gate = a->rst + l * kStInts + kStOver;
    const int32_t* L = a->plan + l * kLevelInts;
    err = sort_keys_level(L, cnt, a->u, a->jp, a->R, a->gkeys, stream, gate);
    if (err != cudaSuccess) return (int)err;
    int shifts[8], nshift = 0;
    for (int sh = 0; sh < 12 + Lh[1]; sh += 8) shifts[nshift++] = sh;
    // only the first pass reads the keys: they take turns with the scratch
    long long* kout = nshift % 2 ? a->gkbuf : a->gkeys;
    long long* kbuf = nshift % 2 ? a->gkeys : a->gkbuf;
    const int e = sperr_radix_sort_gated(gate, a->gkeys, 8, nullptr, cnt, shifts, nshift, kbuf, a->gvbuf, kout,
                                         a->gvout, a->gzbuf, a->gzwords, stream);
    if (e != 0) return e;
    err = sorted_level(L, cnt, kout, a->gvout, a->gscr, a->gswords, a->R, stream, gate);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// A level of a rank plan ranked by sorting (keys past the bitmaps' 32
// bits; the table and virtual walks both call it): its keys packed in 64
// bits in level order (L: the level's plan words on the device, cnt its
// nodes; u, jp and R of the coarser levels written earlier on the stream).
extern "C" int sperr_rank_keys(const int32_t* L, long long cnt, const int32_t* u, const int32_t* jp,
                               const int32_t* R, long long* keys, cudaStream_t stream) {
  return (int)sperr_rank::sort_keys_level(L, cnt, u, jp, R, keys, stream);
}

// After the stable sort of those keys carrying their positions (sk, sv): the
// level's dense ranks into R.  scratch: sperr_rank_scratch_words(cnt)
// 4-byte words, 16-byte aligned.
extern "C" int sperr_rank_sorted(const int32_t* L, long long cnt, const long long* sk, const int32_t* sv,
                                 uint32_t* scratch, long long words, int32_t* R, cudaStream_t stream) {
  return (int)sperr_rank::sorted_level(L, cnt, sk, sv, scratch, words, R, stream);
}

extern "C" long long sperr_rank_scratch_words(long long cnt) { return sperr_rank::sorted_words(cnt, nullptr); }

// The child rows' payload words and born flags.
extern "C" int sperr_table_rows(const TableArgs* a, cudaStream_t stream) {
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)launch(table_rows, a->C, a, stream);
}

// The entries' insertion keys and per-level counts (zeroed here), and n_sig.
extern "C" int sperr_table_born(const TableArgs* a, cudaStream_t stream) {
  if (!args_ok(a) || a->NE < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(a->counts, 0, sizeof(int32_t) * (a->nlev + 1), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(table_born, a->NE, a, stream);
}

// The entries' walk ranks, payload words and walk keys (after the sort).
extern "C" int sperr_table_entries(const TableArgs* a, cudaStream_t stream) {
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)launch(table_entries, a->NE + (a->form == 0 ? a->nroots : 0), a, stream);
}

// The child rows' walk keys (and the 2D I items).
extern "C" int sperr_table_rowkeys(const TableArgs* a, cudaStream_t stream) {
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)launch(table_rowkeys, a->C + (a->form == 1 ? a->xf + a->G : 0), a, stream);
}

// node_s = nm > 0 ? num_bp - nm : NEVER (nn int32).
extern "C" int sperr_node_passes(const int32_t* nm, const int32_t* num_bp, long long nn, int32_t* node_s,
                                 cudaStream_t stream) {
  if (nn < 1) return (int)cudaErrorInvalidValue;
  node_passes_kernel<<<blocks_for(nn), kThreads, 0, stream>>>(nm, num_bp, nn, node_s);
  return (int)cudaGetLastError();
}
