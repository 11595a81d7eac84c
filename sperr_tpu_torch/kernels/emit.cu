// The emission's pixel stage (K9) for Hopper: the exposed-pixel compaction
// of a power-of-two cube and the LIP, LIS and refinement planes of every
// emission (emit_stage): two launches on a cube, one for the other 3D forms,
// and one for each half of the 2D program's emission (its pixel classes,
// then its walk's LIS class).
//
// Replaces the XLA program of sperr_tpu/ops/wave_pack.py wave_emit_3d
// (:102) between the set walk and the masked pack: the uniform forest's
// exposure compaction (:195-263: a box minimum, K12 over the box flags, row
// gathers and a sort of 8 take_b keys back into pixel order) and the
// per-class 32-pass masks (lis_masks :177, lip_masks :303, ref_masks :316)
// with their bit transposes (_emit_words :66, _emit_words_pair :85); the
// same masks serve wave_emit_2d_pixels (:339) and the 2D walk's LIS class.
// Every result is an integer and equals the plain versions
// (ops/wave_pack.py emit_cube_ref, emit_fields_ref) bit for bit, sentinels
// and padding included.
//
// Bound: device memory.  The stage reads its inputs once (the box-major
// table, the walk's payloads) and writes its outputs once (the exposure
// view, the planes), with a few dozen integer operations per word; no
// pixel field is stored.
//   rows  (cube only) one warp per box row reads its row of pv_bm (two
//         16-byte loads a box, four boxes in flight), takes each box's
//         minimum of the s field (= the clipped box minimum of s: clipping
//         commutes with min), ballots the flags (minimum < num_bp) into one
//         word per 32 boxes and counts them.  A block's 64 rows are a tile:
//         its id comes from a ticket, its count is published and prefixed
//         by a decoupled look-back whose windows are the block's 256
//         threads (a window of 32 left the 256 tiles of a 256^3 chunk
//         waiting some 8 round trips on the prefixes ahead), and each row's
//         base, the kept boxes before it clamped by take_b, is written; the
//         last tile writes n_exp and the overflow flag.  "Kept" is among the
//         first take_b exposed boxes in box order.
//   planes  one launch for the three classes.  Blocks [0, nbp) each own
//         1024 consecutive LIP/REF items (64 LIP and 32 REF words), the rest
//         64 LIS words each.
//         A cube's items are ranks.  Boxes are numbered (zb, yb, xb), xb
//         fastest, each 8 contiguous words (slots dz dy dx) of pv_bm
//         (clip(s, 0, 127) | sign << 7 [| mag << 8]); with k the kept boxes
//         of the box's row (zb, yb), K those of its slab, B the kept boxes
//         of earlier slabs, R of earlier rows of the slab and j the box's
//         rank in its row, slot (dz, dy, dx) has rank
//           8 B + dz 4 K + 4 R + dy 2 k + 2 j + dx,
//         ascending pixel order.  A block inverts it for each of its
//         ranks: the slab by a search in the slab bases, the row by a
//         search in the slab's row bases, j and dx, dy, dz by arithmetic,
//         the box by a select in the row's flag words; the 32-byte box gives
//         e (its minimum), s, sign and magnitude (or mags[lin] when they are
//         apart).  The block writes exp_idx and exp_ll at its ranks, and
//         past the kept pixels the sentinels (the plain version's pad rule).
//         The other forms hand the four fields in device memory: the 3D
//         forms that are not cubes both halves in one launch; the 2D
//         program its pixel fields (no LIS block), then its walk's
//         payloads (no pixel block), each half in a launch of its own, so
//         that s is read once for LIP and REF together.
//         The fields go to shared memory; each warp builds its words' 32-pass
//         valid and bit masks in registers (K10's lane mapping: pair form,
//         word w holds items 16 w .. 16 w + 15, lane l the decision (even
//         l) or sign cell of item 16 w + l / 2; single form, lane l item
//         32 w + l), transposes them with K10's five shuffle stages
//         (bits.cuh), and every 32-pass window leaves through a shared tile
//         as lines of 64 (32 for REF) consecutive words, straight into the
//         planes K11 reads.  LIS blocks load each payload word once (8-byte
//         loads) and hand it to its two lanes by shuffle.
//   The look-back's status words and ticket live in a buffer the caller
//   keeps zeroed: the planes launch zeroes them again for the next call.
// Shifts are spelt out for counts at and past 32 (undefined in C++): the
// plain version's _safe_rsh and ones_low32 give 0 and all ones there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bits.cuh"

namespace {

using sperr_bits::transpose32_shfl;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kNever = 0x7FFF;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The cube's exposure: rows, flags and clamped row bases in one launch
// ---------------------------------------------------------------------------
constexpr int kRowsPerWarp = 8;
constexpr int kRowTile = kWarps * kRowsPerWarp;  // box rows per tile
constexpr int kRowLoads = 4;                     // boxes in flight per lane
constexpr unsigned long long kStateAggregate = 1, kStatePrefix = 2;

__device__ __forceinline__ void load_box(const int32_t* p, int32_t (&v)[8]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// the box minimum of the s field (bits 0-6)
__device__ __forceinline__ int box_min7(const int32_t (&v)[8]) {
  int m = 127;
#pragma unroll
  for (int k = 0; k < 8; ++k) m = min(m, v[k] & 127);
  return m;
}

// linear index of slot (dz dy dx) of box (zb, yb, xb) in an N^3 cube
__device__ __forceinline__ long long slot_lin(long long zb, long long yb, long long xb, int slot,
                                              int N) {
  return ((2 * zb + (slot >> 2)) * N + 2 * yb + ((slot >> 1) & 1)) * N + 2 * xb + (slot & 1);
}

// the plain version's flag when num_bp is outside [1, 127]: the box minimum
// of (s < NEVER ? s : NEVER), read from the linear schedule
__device__ __forceinline__ bool flag_from_s(const int32_t* __restrict__ s, long long row, int b,
                                            int N, int nb) {
  const long long Nh = N >> 1, zb = row / Nh, yb = row - zb * Nh;
  int m = kNever;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x = __ldg(s + slot_lin(zb, yb, b, k, N));
    m = min(m, x < kNever ? x : kNever);
  }
  return m < nb;
}

__device__ __forceinline__ unsigned long long row_status(unsigned long long state,
                                                         unsigned count) {
  return (state << 32) | count;
}

// status: ntiles words, then the ticket.  base[r] = min(exposed boxes
// before row r, take_b) for r in [0, NR]; n_exp = 8 * all exposed boxes;
// over = more than take_b.
__global__ void __launch_bounds__(kThreads)
exposed_rows(const int32_t* __restrict__ pv, const int32_t* __restrict__ s,
             const int32_t* __restrict__ num_bp, int N, long long NR, int fw, long long take_b,
             uint32_t* __restrict__ flags, int32_t* __restrict__ base,
             int32_t* __restrict__ n_exp, uint8_t* __restrict__ over,
             unsigned long long* status, long long ntiles) {
  __shared__ int s_cnt[kRowTile];
  __shared__ long long s_tile, s_sum[kWarps];
  __shared__ int s_agg, s_first[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (long long)atomicAdd(status + ntiles, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const int nb = __ldg(num_bp);
  const int Nh = N >> 1;
  const bool from_pv = nb >= 1 && nb <= 127;
  const long long row0 = tile * kRowTile + warp * kRowsPerWarp;
  // the warp's rows x flag words, kRowLoads boxes in flight per lane
  int cnt = 0;
  const int nwork = kRowsPerWarp * fw;
  for (int w0 = 0; w0 < nwork; w0 += kRowLoads) {
    int32_t v[kRowLoads][8];
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      const int w = w0 + q, i = w / fw, c = w - i * fw, b = 32 * c + lane;
      const long long row = row0 + i;
      if (w < nwork && row < NR && b < Nh && from_pv) load_box(pv + (row * Nh + b) * 8, v[q]);
    }
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      const int w = w0 + q, i = w / fw, c = w - i * fw, b = 32 * c + lane;
      const long long row = row0 + i;
      if (w >= nwork) break;  // warp-uniform
      bool f = false;
      if (row < NR && b < Nh) f = from_pv ? box_min7(v[q]) < nb : flag_from_s(s, row, b, N, nb);
      const unsigned bal = __ballot_sync(kFull, f);
      if (row < NR && lane == 0) flags[row * fw + c] = bal;
      cnt += __popc(bal);
      if (c == fw - 1) {
        if (lane == 0) s_cnt[warp * kRowsPerWarp + i] = cnt;
        cnt = 0;
      }
    }
  }
  __syncthreads();
  // the tile's scan: warp 0, two rows a lane
  int a = 0, b = 0, x = 0;
  if (warp == 0) {
    a = s_cnt[2 * lane];
    b = s_cnt[2 * lane + 1];
    x = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) {
      s_agg = x;
      atomicExch(status + tile, row_status(tile == 0 ? kStatePrefix : kStateAggregate, (unsigned)x));
    }
  }
  __syncthreads();
  const int agg = s_agg;
  // the look-back: thread i reads the i-th nearest predecessor of each
  // window of kThreads tiles, and the window's nearest inclusive prefix ends
  // it
  long long prefix = 0;
  for (long long j = tile - 1; j >= 0; j -= kThreads) {  // uniform
    const long long q = j - threadIdx.x;
    unsigned long long w = row_status(kStatePrefix, 0u);  // before tile 0: an empty prefix
    if (q >= 0) {
      do {
        w = *reinterpret_cast<volatile unsigned long long*>(status + q);
      } while (((w >> 32) & 3) == 0);
    }
    const unsigned pm = __ballot_sync(kFull, ((w >> 32) & 3) == kStatePrefix);
    if (lane == 0) s_first[warp] = pm ? 32 * warp + __ffs(pm) - 1 : kThreads;
    __syncthreads();
    int first = kThreads;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) first = min(first, s_first[k]);
    long long add = (int)threadIdx.x <= first ? (long long)(w & 0xffffffffull) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(kFull, add, o);
    if (lane == 0) s_sum[warp] = add;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWarps; ++k) prefix += s_sum[k];
    __syncthreads();  // s_first and s_sum are read before the next window
    if (first < kThreads) break;
  }
  if (warp != 0) return;
  if (tile > 0 && lane == 0) atomicExch(status + tile, row_status(kStatePrefix, (unsigned)(prefix + agg)));
  const long long e = prefix + x - (a + b);
  const long long r = tile * kRowTile + 2 * lane;
  if (r < NR) base[r] = (int32_t)(e < take_b ? e : take_b);
  if (r + 1 < NR) base[r + 1] = (int32_t)(e + a < take_b ? e + a : take_b);
  if (tile == ntiles - 1 && lane == 0) {
    const long long total = prefix + agg;
    base[NR] = (int32_t)(total < take_b ? total : take_b);
    *n_exp = (int32_t)(8 * total);
    *over = total > take_b;
  }
}

// ---------------------------------------------------------------------------
// The masks of one cell
// ---------------------------------------------------------------------------
enum { kLip = 0, kLis = 1, kRef = 2 };

// int32 arithmetic that wraps as the plain version's does
__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

// (1 << k) - 1 for k in [0, 32], 0 below, all ones above (ones_low32)
__device__ __forceinline__ uint32_t ones_low(int k) {
  return k <= 0 ? 0u : k >= 32 ? 0xffffffffu : (1u << k) - 1u;
}

// bits [lo - base, hi - base] (ones_span32)
__device__ __forceinline__ uint32_t ones_span(int lo, int hi, int base) {
  return ones_low(wadd(wadd(hi, -base), 1)) & ~ones_low(wadd(lo, -base));
}

// bit p - base when in [0, 32) (bit_at32)
__device__ __forceinline__ uint32_t bit_at(int p, int base) {
  const int r = wadd(p, -base);
  return r >= 0 && r < 32 ? 1u << r : 0u;
}

// logical right shift, 0 at 32 and past (_safe_rsh)
__device__ __forceinline__ uint32_t srl(uint32_t x, int k) {
  return k >= 32 ? 0u : k <= 0 ? x : x >> k;
}

// the valid (mv) and bit (mb) 32-pass masks of one cell from pass base:
// the plain version's lip_masks, lis_masks and ref_masks
template <int kClass>
__device__ __forceinline__ void cell_masks(int a, int b, int c, bool odd, int nb, int base,
                                           uint32_t& mv, uint32_t& mb) {
  if (kClass == kLip) {  // a = s, b = e, c = sign
    if (!odd) {
      mv = ones_span(wadd(b, 1), min(a, wadd(nb, -1)), base);
      mb = bit_at(a, base);
    } else {
      mv = b < a ? bit_at(a, base) : 0u;
      mb = c == 1 ? 0xffffffffu : 0u;
    }
  } else if (kClass == kLis) {  // a = the payload word
    const bool ent = a & 1;
    const int lo = (a >> 1) & 63, s6 = (a >> 7) & 63;
    if (!odd) {
      mv = ent ? (((a >> 17) & 1) ? ones_span(lo, min(s6, wadd(nb, -1)), base) : 0u)
               : (((a >> 16) & 1) ? bit_at(lo, base) : 0u);
      mb = ent ? bit_at(s6, base) : (((a >> 14) & 1) ? 0xffffffffu : 0u);
    } else {
      mv = ent ? 0u : (((a >> 15) & 1) ? bit_at(lo, base) : 0u);
      mb = ((a >> 13) & 1) ? 0xffffffffu : 0u;
    }
  } else {  // a = s, b = magnitude
    mv = ones_span(wadd(a, 1), wadd(nb, -1), base);
    mb = srl(srl(__brev((uint32_t)b), wadd(32, -nb)), base);
  }
}

// ---------------------------------------------------------------------------
// The planes launch
// ---------------------------------------------------------------------------
constexpr int kStageItems = 1024;                 // LIP/REF items per pixel block
constexpr int kStageLip = kStageItems / 16;       // 64 LIP words
constexpr int kStageRef = kStageItems / 32;       // 32 REF words
constexpr int kStageLis = 64;                     // LIS words per LIS block
constexpr int kItemsPerThread = kStageItems / kThreads;
constexpr int kTileCols = 65;                     // 64 words and a pad column

// the cube's inputs to the planes launch (the rows launch's outputs)
struct CubeSrc {
  const int32_t* pv;
  const int32_t* mags;  // null: magnitudes in pv above bit 8
  const uint32_t* flags;
  const int32_t* base;
  const int32_t* n_exp;
  long long NR, Lv, wexp_cap;
  int N, fw;
  int32_t* exp_idx;
  int32_t* exp_ll;
  unsigned long long* status;  // zeroed here for the next call
  long long nstatus;
};

// the other forms' fields: items from n_real on are padding
struct FieldSrc {
  const int32_t* s;
  const int32_t* e;
  const void* g;  // int32, or bytes when g_bytes == 1
  const int32_t* m;
  long long n_real;
  int g_bytes;
};

struct StageOut {
  uint32_t* lip;  // (2, P, W_lip): valid planes, then bit planes
  uint32_t* lis;  // (2, P, W_lis)
  uint32_t* ref;  // (2, P, W_ref)
  const int32_t* pay;
  const int32_t* num_bp;
  long long items, n_pay, W_lis, nbp;  // items: LIP/REF items, a multiple of 256
  int P;
};

// the position of the j-th (from 0) set bit of w; j < popc(w)
__device__ __forceinline__ int select32(uint32_t w, int j) {
  int pos = 0;
#pragma unroll
  for (int sh = 16; sh; sh >>= 1) {
    const int c = __popc(w & ((1u << sh) - 1u));
    if (j >= c) {
      j -= c;
      w >>= sh;
      pos += sh;
    }
  }
  return pos;
}

// for each of the thread's items, the largest i in [0, Nh) with
// scale * (a[start + i * stride] - off) <= r, by halving (Nh a power of two,
// a nondecreasing, its first entry scaled <= r): the items' loads go out
// together.  Ranks and bases are below 2^31 (n < 2^31, 8 take_b <= wexp_cap).
__device__ __forceinline__ void search_bases(const int32_t* __restrict__ a,
                                             const int (&start)[kItemsPerThread], int stride,
                                             int Nh, const int (&off)[kItemsPerThread], int scale,
                                             const int (&r)[kItemsPerThread],
                                             int (&idx)[kItemsPerThread]) {
#pragma unroll
  for (int i = 0; i < kItemsPerThread; ++i) idx[i] = 0;
  for (int step = Nh >> 1; step; step >>= 1) {
#pragma unroll
    for (int i = 0; i < kItemsPerThread; ++i) {
      const int v = __ldg(a + start[i] + (idx[i] + step) * stride);
      if (scale * (v - off[i]) <= r[i]) idx[i] += step;
    }
  }
}

// rank r < min(8 base[NR], Lv) of a cube from its slab zb (B kept boxes
// before it) and row yb, q its offset in the slab's dz plane: its (s, e,
// sign, magnitude), with exp_idx and exp_ll written
__device__ __forceinline__ void cube_rank(const CubeSrc& c, int r, int zb, int dz, int yb, int B,
                                          int q, int& sv, int& ev, int& gv, int& mv) {
  const int Nh = c.N >> 1;
  const int row = zb * Nh + yb;
  const int b0 = __ldg(c.base + row);
  const int k = __ldg(c.base + row + 1) - b0;
  q -= 4 * (b0 - B);
  const int dy = q >= 2 * k;
  q -= dy * 2 * k;
  int j = q >> 1;
  const int dx = q & 1;
  int xb = 0;
  for (int w = 0; w < c.fw; ++w) {
    const uint32_t f = __ldg(c.flags + (long long)row * c.fw + w);
    const int pc = __popc(f);
    if (j < pc) {
      xb = 32 * w + select32(f, j);
      break;
    }
    j -= pc;
  }
  int32_t v[8];
  load_box(c.pv + ((long long)row * Nh + xb) * 8, v);
  const int slot = 4 * dz + 2 * dy + dx;
  int32_t val = v[0];
#pragma unroll
  for (int t = 1; t < 8; ++t) val = t == slot ? v[t] : val;
  const long long lin = slot_lin(zb, yb, xb, slot, c.N);
  sv = val & 127;
  ev = box_min7(v);
  gv = (val >> 7) & 1;
  mv = c.mags ? __ldg(c.mags + lin) : (val >> 8);
  c.exp_idx[r] = (int32_t)lin;
  c.exp_ll[r] = gv == 1 ? mv : (int32_t)(0u - (uint32_t)mv);
}

// the thread's items of a cube's pixel block: the fields of the kept ranks
// (below lo), the sentinels past them
__device__ __forceinline__ void cube_items(const CubeSrc& c, const int (&r)[kItemsPerThread], int lo,
                                           int Rk, int ne, int items, int (&sv)[kItemsPerThread],
                                           int (&ev)[kItemsPerThread], int (&gv)[kItemsPerThread],
                                           int (&mv)[kItemsPerThread]) {
  const int Nh = c.N >> 1;
  int rr[kItemsPerThread], zero[kItemsPerThread], slab0[kItemsPerThread];
#pragma unroll
  for (int i = 0; i < kItemsPerThread; ++i) {
    rr[i] = r[i] < lo ? r[i] : 0;
    zero[i] = 0;
  }
  int zb[kItemsPerThread], yb[kItemsPerThread], dz[kItemsPerThread], B[kItemsPerThread],
      q[kItemsPerThread];
  search_bases(c.base, zero, Nh, Nh, zero, 8, rr, zb);
#pragma unroll
  for (int i = 0; i < kItemsPerThread; ++i) {
    slab0[i] = zb[i] * Nh;
    B[i] = __ldg(c.base + slab0[i]);
    const int K = __ldg(c.base + slab0[i] + Nh) - B[i];
    q[i] = rr[i] - 8 * B[i];
    dz[i] = q[i] >= 4 * K;
    q[i] -= dz[i] * 4 * K;
  }
  search_bases(c.base, slab0, 1, Nh, B, 4, q, yb);
#pragma unroll
  for (int i = 0; i < kItemsPerThread; ++i) {
    sv[i] = ev[i] = kNever;
    gv[i] = mv[i] = 0;
    if (r[i] < lo) {
      cube_rank(c, r[i], zb[i], dz[i], yb[i], B[i], q[i], sv[i], ev[i], gv[i], mv[i]);
    } else if (r[i] < items) {
      // past the kept pixels: (0, 0, 0, 0) while under n_exp (an overflow:
      // the plain version pads its kept pixels with 0 there), else the
      // sentinels
      if (r[i] < ne) sv[i] = ev[i] = 0;
      if (r[i] < c.wexp_cap) c.exp_ll[r[i]] = 0;
      if (r[i] >= Rk && r[i] < c.Lv) c.exp_idx[r[i]] = c.N * c.N * c.N;
    }
  }
}

struct StageShared {
  int32_t f[4][kStageItems];  // s, e, sign, magnitude
  uint32_t tv[32][kTileCols], tb[32][kTileCols];
};

// the tile's planes [0, take) of words [0, nw) into rows base .. of a
// (P, W) pair of planes at column w0
__device__ __forceinline__ void tile_out(StageShared& sm, uint32_t* vw, uint32_t* bw, long long W,
                                         long long w0, int nw, int base, int take) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < take; p += kWarps) {
    for (int w = lane; w < nw; w += 32) {
      vw[(long long)(base + p) * W + w0 + w] = sm.tv[p][w];
      bw[(long long)(base + p) * W + w0 + w] = sm.tb[p][w];
    }
  }
}

// zeros into words [w0, w0 + nw) of rows 0 .. P-1 of a (P, W) pair of
// planes (W, w0 and nw multiples of 4, the planes 16-byte aligned)
__device__ __forceinline__ void zero_words(uint32_t* vw, uint32_t* bw, long long W, long long w0,
                                           int nw, int P) {
  const int per = nw >> 2;
  for (int i = threadIdx.x; i < P * per; i += kThreads) {
    const int p = i / per;
    const long long at = (long long)p * W + w0 + 4 * (i - p * per);
    *reinterpret_cast<uint4*>(vw + at) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(bw + at) = make_uint4(0, 0, 0, 0);
  }
}

// one word's transposed masks into the tile's column w; a word whose masks
// are all zero (padding items, sentinels) skips the transposes
__device__ __forceinline__ void tile_word(StageShared& sm, int w, uint32_t mv, uint32_t mb) {
  const int lane = threadIdx.x & 31;
  const bool any = __any_sync(kFull, (mv | mb) != 0u);
  sm.tv[lane][w] = any ? transpose32_shfl(mv, lane) : 0u;  // plane lane of word w
  sm.tb[lane][w] = any ? transpose32_shfl(mb, lane) : 0u;
}

template <bool kCube>
__device__ __forceinline__ void pixel_block(StageShared& sm, const CubeSrc& c, const FieldSrc& f,
                                            const StageOut& o, long long blk, int nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = blk * kStageItems;
  const long long W_lip = o.items / 16, W_ref = o.items / 32;
  const long long wl0 = r0 / 16, wr0 = r0 / 32;
  const int nlw = (int)(W_lip - wl0 < kStageLip ? W_lip - wl0 : kStageLip);
  const int nrw = (int)(W_ref - wr0 < kStageRef ? W_ref - wr0 : kStageRef);
  uint32_t* lip_b = o.lip + (long long)o.P * W_lip;
  uint32_t* ref_b = o.ref + (long long)o.P * W_ref;
  int r[kItemsPerThread];  // items < 2^31 (the wrappers check)
#pragma unroll
  for (int i = 0; i < kItemsPerThread; ++i) r[i] = (int)r0 + threadIdx.x + i * kThreads;
  int sv[kItemsPerThread], ev[kItemsPerThread], gv[kItemsPerThread], mv[kItemsPerThread];
  if (kCube) {
    const int Rk = 8 * __ldg(c.base + c.NR);
    const int ne = __ldg(c.n_exp);
    const int lo = Rk < c.Lv ? Rk : (int)c.Lv;
    if (r0 >= (lo > ne ? lo : ne) && nb <= kNever && o.P <= kNever - 32) {
      // sentinels only: every mask is zero (whole blocks branch)
#pragma unroll
      for (int i = 0; i < kItemsPerThread; ++i) {
        if (r[i] < c.wexp_cap) c.exp_ll[r[i]] = 0;
        if (r[i] >= Rk && r[i] < c.Lv) c.exp_idx[r[i]] = c.N * c.N * c.N;
      }
      zero_words(o.lip, lip_b, W_lip, wl0, nlw, o.P);
      zero_words(o.ref, ref_b, W_ref, wr0, nrw, o.P);
      return;
    }
    cube_items(c, r, lo, Rk, ne, (int)o.items, sv, ev, gv, mv);
  } else {
#pragma unroll
    for (int i = 0; i < kItemsPerThread; ++i) {
      sv[i] = ev[i] = kNever;
      gv[i] = mv[i] = 0;
      if (r[i] < f.n_real) {
        sv[i] = __ldg(f.s + r[i]);
        ev[i] = __ldg(f.e + r[i]);
        gv[i] = f.g_bytes == 1 ? (int)__ldg(static_cast<const uint8_t*>(f.g) + r[i])
                               : __ldg(static_cast<const int32_t*>(f.g) + r[i]);
        mv[i] = __ldg(f.m + r[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kItemsPerThread; ++i) {
    const int li = threadIdx.x + i * kThreads;
    sm.f[0][li] = sv[i];
    sm.f[1][li] = ev[i];
    sm.f[2][li] = gv[i];
    sm.f[3][li] = mv[i];
  }
  __syncthreads();
  for (int base = 0; base < o.P; base += 32) {
    const int take = o.P - base < 32 ? o.P - base : 32;
    // LIP: 8 words a warp, pair form
#pragma unroll
    for (int i = 0; i < kStageLip / kWarps; ++i) {
      const int w = warp * (kStageLip / kWarps) + i, it = 16 * w + (lane >> 1);
      uint32_t m0, m1;
      cell_masks<kLip>(sm.f[0][it], sm.f[1][it], sm.f[2][it], lane & 1, nb, base, m0, m1);
      tile_word(sm, w, m0, m1);
    }
    __syncthreads();
    tile_out(sm, o.lip, lip_b, W_lip, wl0, nlw, base, take);
    __syncthreads();
    // REF: 4 words a warp, single form
#pragma unroll
    for (int i = 0; i < kStageRef / kWarps; ++i) {
      const int w = warp * (kStageRef / kWarps) + i, it = 32 * w + lane;
      uint32_t m0, m1;
      cell_masks<kRef>(sm.f[0][it], sm.f[3][it], 0, false, nb, base, m0, m1);
      tile_word(sm, w, m0, m1);
    }
    __syncthreads();
    tile_out(sm, o.ref, ref_b, W_ref, wr0, nrw, base, take);
    __syncthreads();
  }
}

__device__ __forceinline__ void lis_block(StageShared& sm, const StageOut& o, long long blk, int nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPerWarp = kStageLis / kWarps;  // 8 words: 128 items
  const long long w0 = blk * kStageLis;
  const int nw = (int)(o.W_lis - w0 < kStageLis ? o.W_lis - w0 : kStageLis);
  // lane l loads items 2 l, 2 l + 1 and 64 + 2 l, 65 + 2 l of the warp's 128
  const long long i0 = 16 * (w0 + warp * kPerWarp) + 2 * lane;
  const bool vec = (reinterpret_cast<uintptr_t>(o.pay) & 7) == 0;
  int x[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i = i0 + 64 * h;
    if (vec && i + 1 < o.n_pay) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(o.pay + i));
      x[2 * h] = v.x, x[2 * h + 1] = v.y;
    } else {
      x[2 * h] = i < o.n_pay ? __ldg(o.pay + i) : 0;
      x[2 * h + 1] = i + 1 < o.n_pay ? __ldg(o.pay + i + 1) : 0;
    }
  }
  // word i's lane l takes item 16 i + l / 2: lane 8 (i & 3) + l / 4's
  int a[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int src = 8 * (i & 3) + (lane >> 2);
    const int ya = __shfl_sync(kFull, x[i < 4 ? 0 : 2], src);
    const int yb = __shfl_sync(kFull, x[i < 4 ? 1 : 3], src);
    a[i] = (lane & 2) ? yb : ya;
  }
  uint32_t* lis_b = o.lis + (long long)o.P * o.W_lis;
  for (int base = 0; base < o.P; base += 32) {
    const int take = o.P - base < 32 ? o.P - base : 32;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      uint32_t mv, mb;
      cell_masks<kLis>(a[i], 0, 0, lane & 1, nb, base, mv, mb);
      tile_word(sm, warp * kPerWarp + i, mv, mb);
    }
    __syncthreads();
    tile_out(sm, o.lis, lis_b, o.W_lis, w0, nw, base, take);
    __syncthreads();
  }
}

// three blocks an SM at least (85 registers a thread): the blocks wait on
// loads and shuffles, and more of them hide it (108 registers, two blocks,
// took 20% longer on the card)
template <bool kCube>
__global__ void __launch_bounds__(kThreads, 3)
emit_stage_planes(const CubeSrc c, const FieldSrc f, const StageOut o) {
  __shared__ StageShared sm;
  const int nb = __ldg(o.num_bp);
  if (kCube) {
    // the rows launch has ended: leave its status words and ticket zeroed
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < c.nstatus;
         i += (long long)gridDim.x * kThreads)
      c.status[i] = 0;
  }
  const long long blk = blockIdx.x;  // whole blocks branch: the syncs stay uniform
  if (blk < o.nbp)
    pixel_block<kCube>(sm, c, f, o, blk, nb);
  else
    lis_block(sm, o, blk - o.nbp, nb);
}

cudaError_t stage_planes(bool cube, const CubeSrc& c, const FieldSrc& f, const StageOut& o,
                         cudaStream_t stream) {
  const long long nbl = (o.W_lis + kStageLis - 1) / kStageLis;
  const long long grid = o.nbp + nbl;
  if (grid < 1) return cudaSuccess;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (cube)
    emit_stage_planes<true><<<(unsigned)grid, kThreads, 0, stream>>>(c, f, o);
  else
    emit_stage_planes<false><<<(unsigned)grid, kThreads, 0, stream>>>(c, f, o);
  return cudaGetLastError();
}

bool stage_ok(long long items, long long n_pay, long long W_lis, int P) {
  return items >= 0 && items % 256 == 0 && items < (1LL << 31) - kStageItems && n_pay >= 0 &&
         W_lis >= 0 && 16 * W_lis >= n_pay &&
         P >= 1;
}

}  // namespace

// The words the look-back of sperr_emit_cube needs in its zeroed status
// buffer, for an N^3 cube.
extern "C" long long sperr_emit_status_words(int N) {
  const long long Nh = N / 2, NR = Nh * Nh;
  return (NR + kRowTile - 1) / kRowTile + 1;
}

// The pixel stage of an N^3 cube (N a power of two, 2 <= N <= 1024), two launches:
// pv the box-major table, mags the linear magnitudes (null: packed in pv
// above bit 8), s the linear schedule, num_bp one int32.  take_b kept boxes
// at most; Lv = min(8 take_b, wexp_cap) indices placed; npad (a multiple of
// 256, >= wexp_cap) LIP/REF items.  pay: n_pay payload words, W_lis LIS
// words.  scratch: NR * fw flag words and NR + 1 row bases (NR = (N/2)^2,
// fw = ceil(N / 64)); status: sperr_emit_status_words(N) words, zero on
// entry and on exit.  planes: the LIP (2, P, npad / 16), LIS (2, P, W_lis)
// and REF (2, P, npad / 32) planes, one after the other.
extern "C" int sperr_emit_cube(const int32_t* pv, const int32_t* mags, const int32_t* s,
                               const int32_t* num_bp, int N, long long take_b, long long Lv,
                               long long wexp_cap, long long npad, const int32_t* pay,
                               long long n_pay, long long W_lis, int P, int32_t* scratch,
                               unsigned long long* status, int32_t* exp_idx, int32_t* exp_ll,
                               int32_t* n_exp, uint8_t* over, uint32_t* planes,
                               cudaStream_t stream) {
  if (N < 2 || N > 1024 || (N & (N - 1)) || take_b < 1 || Lv < 1 || wexp_cap < Lv || npad < wexp_cap ||
      !stage_ok(npad, n_pay, W_lis, P))
    return (int)cudaErrorInvalidValue;
  const long long Nh = N / 2, NR = Nh * Nh;
  const int fw = (int)((Nh + 31) / 32);
  const long long ntiles = (NR + kRowTile - 1) / kRowTile;
  uint32_t* flags = reinterpret_cast<uint32_t*>(scratch);
  int32_t* base = scratch + NR * fw;
  exposed_rows<<<(unsigned)ntiles, kThreads, 0, stream>>>(pv, s, num_bp, N, NR, fw, take_b, flags,
                                                          base, n_exp, over, status, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const CubeSrc c = {pv, mags, flags, base, n_exp, NR, Lv, wexp_cap, N, fw, exp_idx, exp_ll,
                     status, ntiles + 1};
  const FieldSrc f = {};
  const StageOut o = {planes, planes + 2LL * P * (npad / 16), planes + 2LL * P * (npad / 16 + W_lis),
                      pay, num_bp, npad, n_pay, W_lis, (npad + kStageItems - 1) / kStageItems, P};
  return (int)stage_planes(true, c, f, o, stream);
}

// The planes of the forms that hand their pixel fields (the other 3D forms,
// and each half of a 2D emission), one launch: the fields s, e, sign (int32,
// or bytes when g_bytes == 1) and magnitudes of n_real items, padded to
// items (a multiple of 256); pay, W_lis, P and planes as for
// sperr_emit_cube.  Either half may be empty: n_real = items = 0 (the field
// pointers may be null) launches LIS blocks only, n_pay = W_lis = 0 (pay may
// be null) pixel blocks only.
extern "C" int sperr_emit_fields(const int32_t* s_p, const int32_t* e_p, const void* g_p,
                                 int g_bytes, const int32_t* m_p, long long n_real,
                                 long long items, const int32_t* pay, long long n_pay,
                                 long long W_lis, const int32_t* num_bp, int P, uint32_t* planes,
                                 cudaStream_t stream) {
  if (!stage_ok(items, n_pay, W_lis, P) || n_real < 0 || n_real > items ||
      !(g_bytes == 1 || g_bytes == 4) || (n_real > 0 && !(s_p && e_p && g_p && m_p)) ||
      (n_pay > 0 && !pay) || !num_bp || (items + W_lis > 0 && !planes))
    return (int)cudaErrorInvalidValue;
  const CubeSrc c = {};
  const FieldSrc f = {s_p, e_p, g_p, m_p, n_real, g_bytes};
  const StageOut o = {planes, planes + 2LL * P * (items / 16), planes + 2LL * P * (items / 16 + W_lis),
                      pay, num_bp, items, n_pay, W_lis, (items + kStageItems - 1) / kStageItems, P};
  return (int)stage_planes(false, c, f, o, stream);
}
