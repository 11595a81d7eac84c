// The 3D emission's pixel stage (K9) for Hopper: the exposed-pixel
// compaction of a power-of-two cube (K9a, emit_exposed) and the LIP, LIS
// and refinement planes of every emission (K9b, emit_planes).
//
// Replaces the XLA program of sperr_tpu/ops/wave_pack.py wave_emit_3d
// (:102) between the set walk and the masked pack: the uniform forest's
// exposure compaction (:195-263: a box minimum, K12 over the box flags, row
// gathers and a sort of 8 take_b keys back into pixel order) and the
// per-class 32-pass masks (lis_masks :177, lip_masks :303, ref_masks :316)
// with their bit transposes (_emit_words :66, _emit_words_pair :85); the
// same masks serve wave_emit_2d_pixels (:339).  Every result is an integer
// and equals the plain versions (ops/wave_pack.py emit_exposed_ref,
// emit_planes_ref) bit for bit, sentinels and padding included.
//
// Bound: device memory.  Both kernels read their inputs once and write
// their outputs once, with a few dozen integer operations per word.
//   K9a  three launches, no sort.  Boxes are numbered (zb, yb, xb), xb
//        fastest, each 8 contiguous words (slots dz dy dx) of the box-major
//        table pv_bm (clip(s, 0, 127) | sign << 7 [| mag << 8]).  Ascending
//        pixel order of the kept boxes' pixels is then arithmetic: with k
//        the kept boxes of the box's row (zb, yb), K those of its slab, B
//        the kept boxes of earlier slabs, R of earlier rows of the slab and
//        j the box's rank in its row, slot (dz, dy, dx) goes to
//          8 B + dz 4 K + 4 R + dy 2 k + 2 j + dx.
//        "Kept" is among the first take_b exposed boxes in box order.
//        rows: one warp per box row reads its row of pv_bm (two 16-byte
//          loads a box), takes each box's minimum of the s field (= the
//          clipped box minimum of s: clipping commutes with min), ballots
//          the flags (minimum < num_bp) into one word per 32 boxes and
//          writes the row's count;
//        scan: one block scans the row counts, clamped by take_b, into each
//          row's first kept box, and writes n_exp and the overflow flag;
//        place: one warp per row with kept boxes ranks each box by a
//          popcount below its lane in the row's flag words, re-reads only
//          those boxes, and writes their eight pixels' s, e, sign,
//          magnitude, linear index and signed value at their ranks; the
//          same launch writes the sentinels past them (grid-stride).
//        The flag is read from s itself when num_bp is outside [1, 127],
//        where the clipped minimum and the minimum give different flags.
//   K9b  one launch per class.  A block makes 32 consecutive words of each
//        of the class's (P, W) valid and bit planes: each warp loads the
//        items of 4 words with K10's lane mapping (pair form: word w holds
//        items 16 w .. 16 w + 15, lane l the decision (even l) or sign cell
//        of item 16 w + l / 2; single form: lane l item 32 w + l), builds
//        each cell's 32-pass valid and bit masks in registers, transposes
//        them with K10's five shuffle stages (bits.cuh), and every 32-pass
//        window leaves through a [32][33] shared tile as 128-byte lines of
//        32 consecutive words, straight into the planes K11 reads.  The
//        masks are never stored: the plain version writes four int32 masks
//        per item and window and reads them back in the transposes.
// Shifts are spelt out for counts at and past 32 (undefined in C++): the
// plain version's _safe_rsh and ones_low32 give 0 and all ones there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bits.cuh"

namespace {

using sperr_bits::block_scan64;
using sperr_bits::transpose32_shfl;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kNever = 0x7FFF;

long long grid_for(long long work, long long per_block) {
  long long g = (work + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 65535LL * 32) g = 65535LL * 32;
  return g;
}

// ---------------------------------------------------------------------------
// K9a: the exposed-pixel compaction
// ---------------------------------------------------------------------------

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

// one warp per box row: the flag words (bit b of word c: box 32 c + b is
// exposed) and the row's count
__global__ void __launch_bounds__(kThreads)
exposed_rows(const int32_t* __restrict__ pv, const int32_t* __restrict__ s,
             const int32_t* __restrict__ num_bp, int N, long long NR, int fw,
             uint32_t* __restrict__ flags, int32_t* __restrict__ kraw) {
  const int lane = threadIdx.x & 31;
  const int nb = __ldg(num_bp);
  const int Nh = N >> 1;
  const bool from_pv = nb >= 1 && nb <= 127;
  const long long nwarps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5; row < NR;
       row += nwarps) {  // whole warps
    const int32_t* rp = pv + row * Nh * 8;
    int cnt = 0;
    for (int c = 0; c < fw; ++c) {
      const int b = c * 32 + lane;
      bool f = false;
      if (b < Nh) {
        if (from_pv) {
          int32_t v[8];
          load_box(rp + 8 * b, v);
          f = box_min7(v) < nb;
        } else {
          // the plain version's flag: min over the box of (s < NEVER ? s : NEVER)
          const long long zb = row / Nh, yb = row - zb * Nh;
          int m = kNever;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int x = __ldg(s + slot_lin(zb, yb, b, k, N));
            m = min(m, x < kNever ? x : kNever);
          }
          f = m < nb;
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (lane == 0) flags[row * fw + c] = bal;
      cnt += __popc(bal);
    }
    if (lane == 0) kraw[row] = cnt;
  }
}

// one block: base[r] = min(exposed boxes before row r, take_b) for r in
// [0, NR]; n_exp = 8 * all exposed boxes; over = more than take_b.  The
// counts go through shared memory in chunks, loaded and stored coalesced,
// each thread scanning a run of kERun consecutive rows in between (the
// padded index keeps the runs' reads free of bank conflicts).
constexpr int kEScanThreads = 1024;
constexpr int kERun = 8;
constexpr int kEChunk = kEScanThreads * kERun;

__device__ __forceinline__ int spad(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kEScanThreads)
exposed_scan(const int32_t* __restrict__ kraw, long long NR, long long take_b,
             int32_t* __restrict__ base, int32_t* __restrict__ n_exp, uint8_t* __restrict__ over) {
  __shared__ int stage[kEChunk + kEChunk / 32];
  __shared__ long long sh[32];
  const int tid = threadIdx.x;
  long long carry = 0;
  for (long long c0 = 0; c0 < NR; c0 += kEChunk) {
#pragma unroll
    for (int j = 0; j < kERun; ++j) {
      const long long i = c0 + j * kEScanThreads + tid;
      stage[spad(j * kEScanThreads + tid)] = i < NR ? kraw[i] : 0;
    }
    __syncthreads();
    int x[kERun];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kERun; ++k) {
      x[k] = stage[spad(kERun * tid + k)];
      sum += x[k];
    }
    long long total;
    long long run = carry + block_scan64<kEScanThreads>(sum, &total, sh);  // its syncs end the reads
#pragma unroll
    for (int k = 0; k < kERun; ++k) {
      stage[spad(kERun * tid + k)] = (int)(run < take_b ? run : take_b);
      run += x[k];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kERun; ++j) {
      const long long i = c0 + j * kEScanThreads + tid;
      if (i < NR) base[i] = stage[spad(j * kEScanThreads + tid)];
    }
    carry += total;
    __syncthreads();
  }
  if (tid == 0) {
    base[NR] = (int)(carry < take_b ? carry : take_b);
    *n_exp = (int32_t)(8 * carry);
    *over = carry > take_b;
  }
}

// the kept boxes' pixels at their ranks, then the sentinels past them
__global__ void __launch_bounds__(kThreads)
exposed_place(const int32_t* __restrict__ pv, const int32_t* __restrict__ mags,
              const uint32_t* __restrict__ flags, const int32_t* __restrict__ base,
              const int32_t* __restrict__ n_exp, int N, long long NR, int fw, long long Lv,
              long long wexp_cap, long long npad, int32_t* __restrict__ exp_idx,
              int32_t* __restrict__ exp_ll, int32_t* __restrict__ s_p, int32_t* __restrict__ e_p,
              int32_t* __restrict__ g_i, int32_t* __restrict__ m_p) {
  const int lane = threadIdx.x & 31;
  const long long Nh = N >> 1;
  const long long n = (long long)N * N * N;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  for (long long row = tid >> 5; row < NR; row += nthreads >> 5) {
    const int b0 = base[row];
    const int k = base[row + 1] - b0;
    if (k == 0) continue;  // whole warps
    const long long zb = row / Nh, yb = row - zb * Nh;
    const long long B = base[zb * Nh];
    const long long K = base[(zb + 1) * Nh] - B;
    const long long R = b0 - B;
    int seen = 0;
    for (int c = 0; c < fw && seen < k; ++c) {
      const uint32_t m = flags[row * fw + c];
      const int j = seen + __popc(m & ((1u << lane) - 1u));
      if (((m >> lane) & 1u) && j < k) {
        const long long xb = 32LL * c + lane;
        int32_t v[8];
        load_box(pv + (row * Nh + xb) * 8, v);
        const int eb = box_min7(v);
#pragma unroll
        for (int slot = 0; slot < 8; ++slot) {
          const long long rank = 8 * B + (slot >> 2) * 4 * K + 4 * R +
                                 ((slot >> 1) & 1) * 2LL * k + 2LL * j + (slot & 1);
          if (rank < Lv) {
            const long long lin = slot_lin(zb, yb, xb, slot, N);
            const int g = (v[slot] >> 7) & 1;
            const int32_t mag = mags ? __ldg(mags + lin) : (v[slot] >> 8);
            s_p[rank] = v[slot] & 127;
            e_p[rank] = eb;
            g_i[rank] = g;
            m_p[rank] = mag;
            exp_idx[rank] = (int32_t)lin;
            exp_ll[rank] = g == 1 ? mag : (int32_t)(0u - (uint32_t)mag);
          }
        }
      }
      seen += __popc(m);
    }
  }
  // past the kept pixels: (0, 0, 0, 0) while under n_exp (an overflow: the
  // plain version pads its kept pixels with 0 there), else the sentinels
  const long long Rk = 8LL * base[NR];
  const long long ne = *n_exp;
  const long long lo = Rk < Lv ? Rk : Lv;
  for (long long r = lo + tid; r < npad; r += nthreads) {
    const bool z = r < ne;
    s_p[r] = z ? 0 : kNever;
    e_p[r] = z ? 0 : kNever;
    g_i[r] = 0;
    m_p[r] = 0;
    if (r < wexp_cap) exp_ll[r] = 0;
    if (r >= Rk && r < Lv) exp_idx[r] = (int32_t)n;
  }
}

// ---------------------------------------------------------------------------
// K9b: the planes
// ---------------------------------------------------------------------------
constexpr int kPlWords = 32;                   // output words per block
constexpr int kPlPerWarp = kPlWords / kWarps;  // 4
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

// f0, f1, f2: LIP s, e, sign (int32, or bytes when g_bytes == 1); LIS the
// payloads; REF s, magnitudes.  Items from n_real on take the padding
// (NEVER, NEVER, 0) / 0 / (NEVER, 0).  vw, bw: (P, W) planes.
template <int kClass>
__global__ void __launch_bounds__(kThreads)
emit_planes_kernel(const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
                   const void* __restrict__ f2, int g_bytes, long long n_real, long long W,
                   const int32_t* __restrict__ num_bp, int P, uint32_t* __restrict__ vw,
                   uint32_t* __restrict__ bw) {
  __shared__ uint32_t tv[32][33], tb[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool odd = kClass != kRef && (lane & 1);
  const int nb = __ldg(num_bp);
  for (long long w0 = (long long)blockIdx.x * kPlWords; w0 < W;
       w0 += (long long)gridDim.x * kPlWords) {
    int a[kPlPerWarp], b[kPlPerWarp], c[kPlPerWarp];
#pragma unroll
    for (int i = 0; i < kPlPerWarp; ++i) {
      const long long w = w0 + warp + i * kWarps;
      const long long item = kClass == kRef ? 32 * w + lane : 16 * w + (lane >> 1);
      a[i] = kClass == kLis ? 0 : kNever;
      b[i] = kClass == kLip ? kNever : 0;
      c[i] = 0;
      if (w < W && item < n_real) {
        a[i] = __ldg(f0 + item);
        if (kClass != kLis) b[i] = __ldg(f1 + item);
        if (kClass == kLip)
          c[i] = g_bytes == 1 ? (int)__ldg(static_cast<const uint8_t*>(f2) + item)
                              : __ldg(static_cast<const int32_t*>(f2) + item);
      }
    }
    for (int base = 0; base < P; base += 32) {
      const int take = P - base < 32 ? P - base : 32;
#pragma unroll
      for (int i = 0; i < kPlPerWarp; ++i) {
        uint32_t mv, mb;
        cell_masks<kClass>(a[i], b[i], c[i], odd, nb, base, mv, mb);
        tv[lane][warp + i * kWarps] = transpose32_shfl(mv, lane);  // plane lane, word warp + 8 i
        tb[lane][warp + i * kWarps] = transpose32_shfl(mb, lane);
      }
      __syncthreads();
      const long long w = w0 + lane;
      if (w < W) {
        for (int p = warp; p < take; p += kWarps) {
          vw[(long long)(base + p) * W + w] = tv[p][lane];
          bw[(long long)(base + p) * W + w] = tb[p][lane];
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// K9a on an N^3 cube (N a power of two, >= 2): pv the box-major table,
// mags the linear magnitudes (null: packed in pv above bit 8), s the linear
// schedule, num_bp one int32.  take_b kept boxes at most; Lv = min(8 take_b,
// wexp_cap) indices and pixels placed; npad >= Lv pixel slots.  scratch:
// NR * fw flag words, NR row counts, NR + 1 row bases (NR = (N/2)^2, fw =
// ceil(N / 64)).  Three launches.
extern "C" int sperr_emit_exposed(const int32_t* pv, const int32_t* mags, const int32_t* s,
                                  const int32_t* num_bp, int N, long long take_b, long long Lv,
                                  long long wexp_cap, long long npad, int32_t* scratch,
                                  int32_t* exp_idx, int32_t* exp_ll, int32_t* n_exp, uint8_t* over,
                                  int32_t* s_p, int32_t* e_p, int32_t* g_i, int32_t* m_p,
                                  cudaStream_t stream) {
  if (N < 2 || (N & (N - 1)) || take_b < 1 || Lv < 1 || wexp_cap < Lv || npad < wexp_cap)
    return (int)cudaErrorInvalidValue;
  const long long Nh = N / 2, NR = Nh * Nh;
  const int fw = (int)((Nh + 31) / 32);
  uint32_t* flags = reinterpret_cast<uint32_t*>(scratch);
  int32_t* kraw = scratch + NR * fw;
  int32_t* base = kraw + NR;
  const unsigned grid = (unsigned)grid_for(NR, kWarps);
  exposed_rows<<<grid, kThreads, 0, stream>>>(pv, s, num_bp, N, NR, fw, flags, kraw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exposed_scan<<<1, kEScanThreads, 0, stream>>>(kraw, NR, take_b, base, n_exp, over);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exposed_place<<<grid, kThreads, 0, stream>>>(pv, mags, flags, base, n_exp, N, NR, fw, Lv,
                                               wexp_cap, npad, exp_idx, exp_ll, s_p, e_p, g_i, m_p);
  return (int)cudaGetLastError();
}

// K9b: one class's (P, W) valid and bit planes (cls 0 LIP, 1 LIS, 2 REF;
// W words of 16 items for LIP and LIS, of 32 for REF).  One launch.
extern "C" int sperr_emit_planes(int cls, const int32_t* f0, const int32_t* f1, const void* f2,
                                 int g_bytes, long long n_real, long long W, const int32_t* num_bp,
                                 int P, uint32_t* vw, uint32_t* bw, cudaStream_t stream) {
  if (cls < 0 || cls > 2 || W < 1 || P < 1 || n_real < 0 || !(g_bytes == 1 || g_bytes == 4))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)grid_for(W, kPlWords);
  if (cls == kLip)
    emit_planes_kernel<kLip><<<grid, kThreads, 0, stream>>>(f0, f1, f2, g_bytes, n_real, W, num_bp,
                                                            P, vw, bw);
  else if (cls == kLis)
    emit_planes_kernel<kLis><<<grid, kThreads, 0, stream>>>(f0, f1, f2, g_bytes, n_real, W, num_bp,
                                                            P, vw, bw);
  else
    emit_planes_kernel<kRef><<<grid, kThreads, 0, stream>>>(f0, f1, f2, g_bytes, n_real, W, num_bp,
                                                            P, vw, bw);
  return (int)cudaGetLastError();
}
