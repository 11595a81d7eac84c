// K13: the device half of the hybrid SPECK decode for Hopper.  Refinement
// bits are spread onto their pixels and the magnitudes rebuilt in closed form.
//
// Replaces sperr_tpu/ops/wave_unpack.py reconstruct_mags (:82, with pdep32
// :47), run per chunk by sperr_tpu/parallel/batched.py _hybrid_mags_batched.
// The JAX form is shaped by static shapes and by the TPU's lack of lane-level
// bit operations: it transposes per-pixel membership masks into per-pass
// member words, compacts the active (pass, word) slots up to a cap, deposits
// each slot's stream bits with a 5-stage software PDEP, scatters the planes
// and transposes them back.  On Hopper a warp of 32 lanes is one member
// word: lane i holds pixel 32 w + i, __ballot_sync(s < p) is pass p's member
// word and __popc of the lanes below is a member's rank in it.  A pass's
// members in one word take consecutive body bits, so no PDEP, no planes and
// no transpose are needed.  Inputs per chunk b: spass (n bytes, 255 = never
// significant), the stream body as words, ref_off / ref_avail (32 per chunk)
// and num_bp.
//
// Two launches, no torch op between them.  A segment is 32 member words
// (1024 pixels).
//   count: a block takes a tile of 32 segments, four a warp, all its 16-byte
//     loads in flight first; each pair of segments gives a histogram of s
//     (lane-private columns of shared memory, the two segments in the
//     halves of a word: no atomics, no bank conflicts; s >= 32 is left out,
//     no pass past 31), whose exclusive prefix over the bins is every
//     pass's members, #{s < p}.  The tile's 32 per-pass totals are published
//     and prefixed by a decoupled look-back: warp w takes passes w, w + 8,
//     w + 16 and w + 24 together, lane l reading the l-th nearest
//     predecessor of each window of 32 tiles (four predecessors a lane, a
//     window of 128, took longer on the card); a 32-bit status word holds the
//     state in its top two bits and the count below 2^30.  Tiles take their
//     id from a ticket.  It writes each segment's first rank of every pass
//     (rank0, 128-byte rows), the last tile the chunk's per-pass totals mc,
//     and tile 0 zeroes the chunk's active-word count and overflow flag.
//   mags: a block of 8 warps stages its 8 segments' spass in shared memory
//     with 16-byte loads, and each warp walks its segment word by word.
//     Four words with no significant pixel are four words of zeros.  Lane p
//     holds the rank of the word's first member of pass p and, before the
//     word's pass loop, loads the (at most two) body words that hold pass
//     p's bits for this word, aligned to that rank: bit ref_off[p] + rank +
//     k.  For each pass past the word's smallest s the warp ballots the
//     member word; a member lane of rank k in it whose bit is present (rank
//     + k < ref_avail[p]) takes bit k of lane p's aligned word by shuffle.
//     The closed form of wave_unpack.py
//     (init(s) + (2A - M)/2 + the T == 1 bit, A = __brev of the received
//     bits) follows; the chunk's scalars pF, p* and T* come from mc and
//     ref_avail in each block's prologue.  The warp counts its active
//     (pass, word) slots (members present and rank < ref_avail[p]) into an
//     atomic per chunk, and the block that carries the count past the cap
//     sets overflow, exactly as the reference does.  The kernel itself has
//     no cap: its magnitudes are right even then.  Block t zeroes count
//     tile t's look-back words (block 0 the ticket) for the next call: the
//     caller keeps that buffer zeroed between calls.
// Bound: device memory.  One read of spass (1 byte per pixel) and of the
// stream words, one write of int32 magnitudes: 84.0 MB, 0.0251 ms per 256^3
// chunk of the 512^3 PWE 1e-2 container.  This design reads spass twice
// (+16.8 MB at 256^3) and writes and reads rank0 once (2.1 MB each for 32
// passes), so its own floor is about 105 MB, 0.0313 ms.  Per word with
// significant pixels it loops over the passes after the word's first
// significance, a ballot, two popcounts and two shuffles each.
// Integer only; results equal reconstruct_mags_batched_ref in
// sperr_tpu_torch/ops/wave_unpack.py bit for bit where overflow is not set.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSegWords = 32;                  // member words per segment
constexpr int kSegPixels = 32 * kSegWords;     // 1024
constexpr int kTileSegs = kWarps;                   // a mags block: a segment a warp
constexpr int kTilePixels = kTileSegs * kSegPixels;
constexpr int kCountPairs = 2;                      // a count tile: two pairs of segments a warp
constexpr int kCountTileSegs = 2 * kCountPairs * kWarps;
constexpr int kPassesPerWarp = 32 / kWarps;         // the look-back's passes a warp
static_assert(kPassesPerWarp == 4, "the look-back's loop names four passes");
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kStateAggregate = 1u << 30, kStatePrefix = 2u << 30;
constexpr unsigned kCountMask = (1u << 30) - 1u;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the 16 bytes of spass at i (255 past n) as four words; i + 16 <= n and
// 16-byte alignment take one load
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ sp, long long i, long long n,
                                        bool aligned) {
  if (aligned && i + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(sp + i));
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long j = i + 4 * q + k;
      w[q] |= (j < n ? (unsigned)__ldg(sp + j) : 255u) << (8 * k);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// status: B chunks x 32 passes x ntiles count tiles, then B tickets; zero on
// entry.  rank0: (B, nseg, 32), each segment's first rank of every pass.
__global__ void __launch_bounds__(kThreads) k13_count(const uint8_t* __restrict__ spass,
                                                      const int* __restrict__ nbps, long long n,
                                                      int nseg, int ntiles,
                                                      int* __restrict__ rank0,
                                                      int* __restrict__ mc, int* __restrict__ nact,
                                                      uint8_t* __restrict__ overflow,
                                                      unsigned* status) {
  // [warp][bin][lane]: a pair of the warp's segments' counts, the second's << 16
  __shared__ unsigned hist[kWarps][32][32];
  __shared__ int segc[kCountTileSegs][32];  // [segment][pass]: members before the pass
  __shared__ int s_excl[32];
  __shared__ int s_tile;
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    s_tile = (int)atomicAdd(status + (long long)gridDim.y * ntiles * 32 + b, 1u);
#pragma unroll
  for (int k = 0; k < 32; ++k) hist[warp][k][lane] = 0;
  __syncthreads();
  const int t = s_tile;
  const uint8_t* sp = spass + (long long)b * n;
  const bool aligned = (reinterpret_cast<uintptr_t>(sp) & 15) == 0;
  // the warp's segments 2 kCountPairs w .. : every load in flight first
  uint4 ld[kCountPairs][2][2];
#pragma unroll
  for (int r = 0; r < kCountPairs; ++r) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int seg = t * kCountTileSegs + 2 * (kCountPairs * warp + r) + g;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ld[r][g][h] = seg < nseg ? load16(sp, (long long)seg * kSegPixels + 16 * lane + 512 * h, n, aligned)
                                : make_uint4(~0u, ~0u, ~0u, ~0u);
    }
  }
#pragma unroll
  for (int r = 0; r < kCountPairs; ++r) {
    if (r) {
      __syncwarp();  // the last pair's sums are read
#pragma unroll
      for (int k = 0; k < 32; ++k) hist[warp][k][lane] = 0;
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned w[4] = {ld[r][g][h].x, ld[r][g][h].y, ld[r][g][h].z, ld[r][g][h].w};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const unsigned s = (w[k >> 2] >> (8 * (k & 3))) & 255u;
          if (s < 32) hist[warp][s][lane] += 1u << (16 * g);
        }
      }
    }
    __syncwarp();
    // lane q sums bin q over the lanes (rotated: no bank conflicts), then
    // the exclusive prefix over the bins: lane p counts pass p's members
    unsigned T = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) T += hist[warp][lane][(k + lane) & 31];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int Tg = (int)((T >> (16 * g)) & 0xffffu);
      int x = Tg;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      segc[2 * (kCountPairs * warp + r) + g][lane] = x - Tg;
    }
  }
  __syncthreads();
  // the look-back: warp w takes passes w, w + 8, w + 16, w + 24 together,
  // lane l reading the l-th nearest predecessor of each window of 32 tiles
  // (a pass's words of consecutive tiles are consecutive)
  {
    int agg[kPassesPerWarp], excl[kPassesPerWarp];
    bool done[kPassesPerWarp];
    unsigned* st[kPassesPerWarp];
#pragma unroll
    for (int i = 0; i < kPassesPerWarp; ++i) {
      const int p = warp + kWarps * i;
      int v = lane < kCountTileSegs ? segc[lane][p] : 0;  // 32 segments: one a lane
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      agg[i] = v;
      excl[i] = 0;
      done[i] = t == 0;
      st[i] = status + ((long long)b * 32 + p) * ntiles;
      if (lane == 0) atomicExch(st[i] + t, (t == 0 ? kStatePrefix : kStateAggregate) | (unsigned)v);
    }
    for (int j = t - 1; !(done[0] && done[1] && done[2] && done[3]); j -= 32) {
      const int q = j - lane;
      unsigned v[kPassesPerWarp];
#pragma unroll
      for (int i = 0; i < kPassesPerWarp; ++i)  // before tile 0: an empty prefix
        v[i] = done[i] || q < 0 ? +kStatePrefix : +*reinterpret_cast<volatile unsigned*>(st[i] + q);
#pragma unroll
      for (int i = 0; i < kPassesPerWarp; ++i) {
        while ((v[i] & ~kCountMask) == 0) v[i] = *reinterpret_cast<volatile unsigned*>(st[i] + q);
        if (done[i]) continue;  // warp-uniform
        const unsigned pm = __ballot_sync(kFull, (v[i] & ~kCountMask) == kStatePrefix);
        const int first = pm ? __ffs(pm) - 1 : 32;
        int add = lane <= first ? (int)(v[i] & kCountMask) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(kFull, add, o);
        excl[i] += add;
        done[i] = pm != 0;
      }
    }
    if (lane == 0) {
      const int nb = min(nbps[b], 32);
#pragma unroll
      for (int i = 0; i < kPassesPerWarp; ++i) {
        const int p = warp + kWarps * i;
        if (t > 0) atomicExch(st[i] + t, kStatePrefix | (unsigned)(excl[i] + agg[i]));
        s_excl[p] = excl[i];
        if (t == ntiles - 1) mc[b * 32 + p] = p < nb ? excl[i] + agg[i] : 0;
      }
    }
    if (t == 0 && threadIdx.x == 0) {
      nact[b] = 0;
      overflow[b] = 0;
    }
  }
  __syncthreads();
  // each segment's first rank of every pass: 128-byte rows
  for (int i = threadIdx.x; i < 32 * kCountTileSegs; i += kThreads) {
    const int g = i >> 5, p = i & 31;
    int e = s_excl[p];
    for (int k = 0; k < g; ++k) e += segc[k][p];
    if (t * kCountTileSegs + g < nseg) rank0[((long long)b * nseg + t * kCountTileSegs + g) * 32 + p] = e;
  }
}

__global__ void __launch_bounds__(kThreads) k13_mags(
    const uint8_t* __restrict__ spass, const uint32_t* __restrict__ words, long long W,
    const int* __restrict__ roff, const int* __restrict__ ravail, const int* __restrict__ nbps,
    const int* __restrict__ rank0, const int* __restrict__ mc, int* __restrict__ mags,
    int* __restrict__ nact, uint8_t* __restrict__ overflow, long long n, int nseg, int ntiles,
    long long take, unsigned* __restrict__ status) {
  // ntiles: the count launch's tiles
  __shared__ __align__(16) uint8_t s_sp[kTilePixels];
  __shared__ int s_off[32], s_av[32];
  __shared__ int s_nact;
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the count launch has ended: its look-back words go back to zero
  if (threadIdx.x < 32 && (int)blockIdx.x < ntiles)
    status[((long long)b * 32 + lane) * ntiles + blockIdx.x] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) status[(long long)gridDim.y * ntiles * 32 + b] = 0;
  const int nb = min(nbps[b], 32);
  const int av_l = ravail[b * 32 + lane];
  if (threadIdx.x < 32) {
    s_off[lane] = roff[b * 32 + lane];
    s_av[lane] = av_l;
  }
  if (threadIdx.x == 0) s_nact = 0;
  {
    const uint8_t* sp = spass + (long long)b * n;
    const bool aligned = (reinterpret_cast<uintptr_t>(sp) & 15) == 0;
    const long long t0 = (long long)blockIdx.x * kTilePixels;
#pragma unroll
    for (int h = 0; h < kTilePixels / (16 * kThreads); ++h) {
      const int o = 16 * (threadIdx.x + h * kThreads);
      *reinterpret_cast<uint4*>(s_sp + o) = load16(sp, t0 + o, n, aligned);
    }
  }
  // the chunk's scalars: passes 0 .. pF are fully available, p* = pF + 1
  // may be partial (wave_unpack.py :182-212)
  const unsigned full = __ballot_sync(kFull, lane < nb && av_l >= mc[b * 32 + lane]);
  const int lead = full == kFull ? 32 : __ffs(~full) - 1;
  const int pF = lead - 1, pstar = lead;
  const bool has_star = pstar < nb - 1;
  const int star_avail = has_star ? __shfl_sync(kFull, av_l, pstar) : 0;
  const unsigned T_star = has_star ? 1u << clampi(nb - 1 - pstar, 0, 30) : 0u;
  const bool star_on = has_star && star_avail > 0;
  const int F = min(pF, nb - 2);
  const unsigned below = (1u << lane) - 1u;
  __syncthreads();

  int my_nact = 0;
  const int seg = blockIdx.x * kTileSegs + warp;
  if (seg < nseg) {
    int run = lane < nb ? rank0[((long long)b * nseg + seg) * 32 + lane] : 0;
    const long long base = (long long)seg * kSegPixels;
    const uint8_t* sp = s_sp + warp * kSegPixels;
    int* out = mags + (long long)b * n + base;
    const uint32_t* wd = words + (long long)b * W;
    const long long left = n - base;
    const int my_off = s_off[lane];
    const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    for (int j = 0; j < kSegWords; ++j) {
      if ((j & 3) == 0 && vec && 32 * j + 128 <= left) {
        // four words with no significant pixel (every s >= num_bp: no pass's
        // member either) are four words of zeros
        const unsigned x4 = reinterpret_cast<const unsigned*>(sp)[8 * j + lane];
        if (__all_sync(kFull, __vcmpgeu4(x4, 0x01010101u * (unsigned)nb) == kFull)) {
          *reinterpret_cast<int4*>(out + 32 * j + 4 * lane) = make_int4(0, 0, 0, 0);
          j += 3;
          continue;
        }
      }
      const unsigned s = sp[j * 32 + lane];
      const int smin = (int)__reduce_min_sync(kFull, s);
      // lane p: pass p's bits for this word from its first member's rank on
      uint32_t xw = 0;
      if (lane > smin && lane < nb) {
        const long long bi = (long long)my_off + run;
        const long long q = bi >> 5;
        const int r = (int)(bi & 31);
        const uint32_t w0 = __ldg(wd + min(q, W - 1));
        const uint32_t w1 = __ldg(wd + min(q + 1, W - 1));
        xw = r ? (w0 >> r) | (w1 << (32 - r)) : w0;
      }
      unsigned apw = 0;
      bool pa = false;
      for (int p = smin + 1; p < nb; ++p) {
        const bool member = s < (unsigned)p;
        const unsigned sv = __ballot_sync(kFull, member);
        const int c = __popc(sv);  // >= 1: the lane of smin is a member
        const int rank = __shfl_sync(kFull, run, p);
        const uint32_t xp = __shfl_sync(kFull, xw, p);
        if (lane == p) run += c;
        const int av = s_av[p];
        my_nact += rank < av;
        const int k = __popc(sv & below);
        const bool got = member && rank + k < av;
        if (got) apw |= ((xp >> k) & 1u) << p;
        if (p == pstar) pa = got;
      }
      if (j * 32 + lane < left) {
        int val = 0;
        if (s < (unsigned)nb) {  // significant (255 never is: nb <= 32)
          const int sc = (int)s;
          const unsigned Ts = 1u << clampi(nb - 1 - sc, 0, 30);
          const unsigned init = 2u * Ts - (Ts >> 1) - 1u;
          const unsigned amask = (1u << (nb - 1)) - 1u;  // passes below nb - 1
          const unsigned A = __brev(apw & amask) >> (32 - nb);
          const unsigned last = nb >= 2 ? (apw >> (nb - 1)) & 1u : 0u;
          unsigned M = 0;
          if (F >= sc + 1)
            M = (1u << clampi(nb - 1 - sc, 0, 30)) - (1u << clampi(nb - 1 - F, 0, 30));
          if (star_on && pa) M += T_star;
          // int32 arithmetic with wrap-around, as the reference's
          val = (int)(init + (unsigned)((int)(2u * A - M) >> 1) + last);
        }
        out[j * 32 + lane] = val;
      }
    }
  }
  if (lane == 0 && my_nact) atomicAdd(&s_nact, my_nact);
  __syncthreads();
  if (threadIdx.x == 0 && s_nact) {
    const long long total = (long long)atomicAdd(nact + b, s_nact) + s_nact;
    if (total > take) overflow[b] = 1;
  }
}

}  // namespace

// The words of K13's look-back buffer (zero on entry and on exit) for B
// chunks of n pixels.
extern "C" long long sperr_reconstruct_status_words(long long B, long long n) {
  const long long nseg = (n + kSegPixels - 1) / kSegPixels;
  return B * (32 * ((nseg + kCountTileSegs - 1) / kCountTileSegs) + 1);
}

// K13 over B chunks of n < 2^30 pixels: spass (B, n) bytes, words (B, W),
// roff and ravail (B, 32), nbps (B,) -> mags (B, n) int32, overflow (B,)
// bytes.  scratch: B * (32 * ceil(n / 1024) + 32 + 1) ints; status:
// sperr_reconstruct_status_words(B, n) words.  take: the cap on the active
// (pass, word) slots of a chunk (min(evw_cap, p_cap * words)).
extern "C" int sperr_reconstruct_mags(const uint8_t* spass, const uint32_t* words, long long W,
                                      const int* roff, const int* ravail, const int* nbps,
                                      int* scratch, unsigned* status, int* mags,
                                      uint8_t* overflow, long long B, long long n, long long take,
                                      cudaStream_t stream) {
  if (B <= 0 || B > 65535 || n <= 0 || n >= (1LL << 30) || W <= 0 || take < 0)
    return (int)cudaErrorInvalidValue;
  const long long nseg = (n + kSegPixels - 1) / kSegPixels;
  const long long ntiles = (nseg + kCountTileSegs - 1) / kCountTileSegs;
  int* rank0 = scratch;
  int* mc = rank0 + B * 32 * nseg;
  int* nact = mc + B * 32;
  k13_count<<<dim3((unsigned)ntiles, (unsigned)B), kThreads, 0, stream>>>(
      spass, nbps, n, (int)nseg, (int)ntiles, rank0, mc, nact, overflow, status);
  const dim3 grid((unsigned)((nseg + kTileSegs - 1) / kTileSegs), (unsigned)B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k13_mags<<<grid, kThreads, 0, stream>>>(spass, words, W, roff, ravail, nbps, rank0, mc, mags,
                                          nact, overflow, n, (int)nseg, (int)ntiles, take, status);
  return (int)cudaGetLastError();
}
