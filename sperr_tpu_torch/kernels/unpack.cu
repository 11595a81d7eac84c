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
// word and __popc of the lanes below is a member's rank in it.  Each lane
// reads its own refinement bit, so no PDEP, no planes and no transpose are
// needed.  Inputs per chunk b: spass (n bytes, 255 = never significant), the
// stream body as words, ref_off / ref_avail (32 per chunk) and num_bp.
//
// Three launches, no torch op between them.  A segment is 32 member words
// (1024 pixels), one warp's share; a block of 8 warps takes 8 segments.
//   count: each warp counts, for every pass, its segment's members (lane p
//     accumulates pass p), and the block stores them as cnt[b][p][segment].
//   scan: one block per (chunk, pass) turns that row into its exclusive
//     prefix in place (each segment's first rank) and writes the pass's
//     member total mc[b][p]; the (b, 0) block also zeroes the chunk's
//     active-word count and overflow flag.
//   mags: the warp walks its segment again, word by word.  For each pass
//     past the word's smallest s it ballots the member word, takes the rank
//     from lane p's running count, and a member lane whose bit is present
//     (rank + k < ref_avail[p]) reads bit ref_off[p] + rank + k of the body.
//     The closed form of wave_unpack.py (init(s) + (2A - M)/2 + the T == 1
//     bit, A = __brev of the received bits) follows; the chunk's scalars pF,
//     p* and T* come from mc and ref_avail in each block's prologue.  The
//     warp counts its active (pass, word) slots (members present and rank <
//     ref_avail[p]) into an atomic per chunk, and the block that carries
//     the count past the cap sets overflow, exactly as the reference does.
//     The kernel itself has no cap: its magnitudes are right even then.
// Bound: device memory.  One read of spass (1 byte per pixel) and of the
// stream words, one write of int32 magnitudes: 84.0 MB, 0.0251 ms per 256^3
// chunk of the 512^3 PWE 1e-2 container.  This design reads spass twice
// (+16.8 MB at 256^3) and moves the segment counts (2.1 MB for 32 passes)
// at most four times: written by count, read and written by scan, read by
// mags (at most +8.4 MB), so its own floor is about 109 MB, 0.0326 ms.
// Per word it loops over the passes after the word's first significance, a
// ballot, two popcounts, a shuffle and a load each, which bounds it by
// instructions on dense words.
// Integer only; results equal reconstruct_mags_batched_ref in
// sperr_tpu_torch/ops/wave_unpack.py bit for bit where overflow is not set.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSegWords = 32;                 // member words per segment
constexpr int kSegPixels = 32 * kSegWords;    // 1024
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned spass_at(const uint8_t* sp, long long i, long long n) {
  return i < n ? (unsigned)__ldg(sp + i) : 255u;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__global__ void __launch_bounds__(kThreads) k13_count(const uint8_t* __restrict__ spass,
                                                      const int* __restrict__ nbps,
                                                      int* __restrict__ cnt, long long n,
                                                      int nseg) {
  __shared__ int stage[kWarps][33];
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarps + warp;
  const int nb = min(nbps[b], 32);
  int acc = 0;
  if (seg < nseg) {
    const uint8_t* sp = spass + (long long)b * n + (long long)seg * kSegPixels;
    const long long left = n - (long long)seg * kSegPixels;
    for (int j = 0; j < kSegWords; ++j) {
      const unsigned s = spass_at(sp, j * 32 + lane, left);
      const int smin = (int)__reduce_min_sync(kFull, s);
      for (int p = smin + 1; p < nb; ++p) {
        const int c = __popc(__ballot_sync(kFull, s < (unsigned)p));
        if (lane == p) acc += c;
      }
    }
  }
  stage[warp][lane] = acc;
  __syncthreads();
  // thread t stores pass t / kWarps of segment t % kWarps: 32-byte runs
  const int p = threadIdx.x / kWarps, w = threadIdx.x % kWarps;
  const int sg = blockIdx.x * kWarps + w;
  if (sg < nseg) cnt[((long long)b * 32 + p) * nseg + sg] = stage[w][p];
}

__global__ void __launch_bounds__(kScanThreads) k13_scan(int* __restrict__ cnt,
                                                         int* __restrict__ mc,
                                                         int* __restrict__ nact,
                                                         uint8_t* __restrict__ overflow,
                                                         const int* __restrict__ nbps, int nseg) {
  __shared__ int wsum[32];
  const int p = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (p == 0 && threadIdx.x == 0) {
    nact[b] = 0;
    overflow[b] = 0;
  }
  if (p >= min(nbps[b], 32)) {
    if (threadIdx.x == 0) mc[b * 32 + p] = 0;
    return;
  }
  int* row = cnt + ((long long)b * 32 + p) * nseg;
  int carry = 0;
  for (int t0 = 0; t0 < nseg; t0 += kScanThreads * kScanItems) {
    const int i0 = t0 + threadIdx.x * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = i0 + k < nseg ? row[i0 + k] : 0;
      sum += v[k];
    }
    int x = sum;  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int y = wsum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int z = __shfl_up_sync(kFull, y, d);
        if (lane >= d) y += z;
      }
      wsum[lane] = y;
    }
    __syncthreads();
    int excl = carry + (warp ? wsum[warp - 1] : 0) + x - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (i0 + k < nseg) row[i0 + k] = excl;
      excl += v[k];
    }
    carry += wsum[31];
    __syncthreads();  // wsum is reused by the next tile
  }
  if (threadIdx.x == 0) mc[b * 32 + p] = carry;
}

__global__ void __launch_bounds__(kThreads) k13_mags(
    const uint8_t* __restrict__ spass, const uint32_t* __restrict__ words, long long W,
    const int* __restrict__ roff, const int* __restrict__ ravail, const int* __restrict__ nbps,
    const int* __restrict__ rank0, const int* __restrict__ mc, int* __restrict__ mags,
    int* __restrict__ nact, uint8_t* __restrict__ overflow, long long n, int nseg,
    long long take) {
  __shared__ int s_off[32], s_av[32];
  __shared__ int s_nact;
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = min(nbps[b], 32);
  const int av_l = ravail[b * 32 + lane];
  if (threadIdx.x < 32) {
    s_off[lane] = roff[b * 32 + lane];
    s_av[lane] = av_l;
  }
  if (threadIdx.x == 0) s_nact = 0;
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

  const int seg = blockIdx.x * kWarps + warp;
  int my_nact = 0;
  if (seg < nseg) {
    int run = lane < nb ? rank0[((long long)b * 32 + lane) * nseg + seg] : 0;
    const long long base = (long long)seg * kSegPixels;
    const uint8_t* sp = spass + (long long)b * n + base;
    int* out = mags + (long long)b * n + base;
    const uint32_t* wd = words + (long long)b * W;
    const long long left = n - base;
    for (int j = 0; j < kSegWords; ++j) {
      const unsigned s = spass_at(sp, j * 32 + lane, left);
      const int smin = (int)__reduce_min_sync(kFull, s);
      unsigned apw = 0;
      bool pa = false;
      for (int p = smin + 1; p < nb; ++p) {
        const bool member = s < (unsigned)p;
        const unsigned sv = __ballot_sync(kFull, member);
        const int c = __popc(sv);  // >= 1: the lane of smin is a member
        const int rank = __shfl_sync(kFull, run, p);
        if (lane == p) run += c;
        const int av = s_av[p];
        my_nact += rank < av;
        const int k = __popc(sv & below);
        const bool got = member && rank + k < av;
        if (got) {
          const long long bi = (long long)s_off[p] + rank + k;
          const long long wi = min(bi >> 5, W - 1);
          apw |= ((__ldg(wd + wi) >> (bi & 31)) & 1u) << p;
        }
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

// K13 over B chunks of n pixels: spass (B, n) bytes, words (B, W), roff and
// ravail (B, 32), nbps (B,) -> mags (B, n) int32, overflow (B,) bytes.
// scratch: B * (32 * ceil(n / 1024) + 32 + 1) ints.  take: the cap on the
// active (pass, word) slots of a chunk (min(evw_cap, p_cap * words)).
extern "C" int sperr_reconstruct_mags(const uint8_t* spass, const uint32_t* words, long long W,
                                      const int* roff, const int* ravail, const int* nbps,
                                      int* scratch, int* mags, uint8_t* overflow, long long B,
                                      long long n, long long take, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || n <= 0 || W <= 0 || take < 0) return (int)cudaErrorInvalidValue;
  const long long nseg = (n + kSegPixels - 1) / kSegPixels;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int* cnt = scratch;
  int* mc = cnt + B * 32 * nseg;
  int* nact = mc + B * 32;
  const dim3 grid((unsigned)((nseg + kWarps - 1) / kWarps), (unsigned)B);
  k13_count<<<grid, kThreads, 0, stream>>>(spass, nbps, cnt, n, (int)nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k13_scan<<<dim3(32, (unsigned)B), kScanThreads, 0, stream>>>(cnt, mc, nact, overflow, nbps,
                                                              (int)nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k13_mags<<<grid, kThreads, 0, stream>>>(spass, words, W, roff, ravail, nbps, cnt, mc, mags,
                                          nact, overflow, n, (int)nseg, take);
  return (int)cudaGetLastError();
}
