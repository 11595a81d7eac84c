// Fused midtread quantizer (K1) and the PSNR-mode q search (K16) for Hopper.
//
// K1 replaces sperr_tpu/ops/pallas_kernels.py quantize_pallas/_quantize_kernel.
// Per element of row b: ll = rint(c * inv_q[b]) (round half to even, a
// multiply by the reciprocal, never a division), sign = ll >= 0 (so -0.0 is
// positive), mag = |ll| as int32; per row: the max magnitude.
//
// Bound: device memory.  Each element reads 4 bytes and writes 5 (4 for the
// magnitude, 1 for the sign) with two flops in between, far below the card's
// flop-per-byte balance.  The design keeps the pass to one read and one
// write: neighbouring threads touch neighbouring elements, the row maximum is
// reduced in registers and shared memory and leaves the block as one integer
// atomicMax (exact and independent of order, so results are deterministic).
// Built with --fmad=false and without fast math; the outputs equal the plain
// version (sperr_tpu_torch/ops/quantize.py quantize_ref) bit for bit.
//
// K16 replaces the XLA while_loop of sperr_tpu/ops/quantize_jax.py
// estimate_q_psnr_batched: q starts at q0 and shrinks by 2^(-1/4) until the
// row's MSE of c - q rint(c / q) meets t_mse.  The loop as torch ops waits
// on the host for every step's test.  psnr_q tests J candidates in one pass
// over the coefficients instead: each block forms the loop's own q_j
// (q_j = q_{j-1} * shrink in f32, inv_j = 1 / q_j by IEEE division), reads
// each coefficient once and, for every candidate, takes
// d = c - q_j rint(c inv_j) as rounded f32 operations and adds d * d
// (exact in f64) to an f64 sum.  An f64 sum of exact squares is the same to
// about 1e-16 relative in any order, so the test against t_mse does not flip
// between this kernel and the plain version (which sums in f64 too).  The
// row's last block to end (a counter per row in the caller's zeroed words,
// reset by that block) sums the blocks' partial sums in block order and
// takes the first candidate with !(mse > t_mse), the loop's own test (a NaN
// MSE ends it).  A row with no candidate met gets its next start q_J and
// status 0 (open), a row that can no longer shrink (q_J == q_{J-1} in f32)
// status 2.
//
// A round is two launches on one stream, with no host wait between them:
// the lean launch tests the first kPsnrLean candidates of every open row,
// then the full launch, queued behind it, resumes each row it left open at
// its q_next and tests kPsnrCand more; the blocks of a row that the lean
// launch met or found stuck exit at entry on the row's status word (stream
// order gives them the lean launch's status, q_next and zeroed counter).
// The host reads the status words once a round.  On real coefficients the
// search meets in 0-2 shrinks (q0 = 2 sqrt(3 t_mse) puts the uniform
// error's q^2 / 12 at the target), so the lean launch meets nearly every
// row, and its registers hold only kPsnrLean candidates' q, reciprocals and
// f64 sums: the candidate count is a template parameter.  In exact
// arithmetic MSE(q) <= q^2 / 4 meets the target by the fifth candidate, so
// one round of 3 + 8 is the rule.
//
// Bound: device memory, one read of the coefficients a launch that has the
// row open (the candidates' arithmetic is about 4 f32 operations and one
// f64 FMA each, below the card's balance); the f32 -> f64 conversions are
// the busiest unit, so a launch that tests fewer candidates comes nearer
// its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void quantize_kernel(const float* __restrict__ coeffs,
                                const float* __restrict__ inv_q,
                                int32_t* __restrict__ mags,
                                uint8_t* __restrict__ signs,
                                int32_t* __restrict__ maxmag, long long n) {
  const int b = blockIdx.y;
  const float inv = inv_q[b];
  const long long row = (long long)b * n;
  int m = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float ll = rintf(coeffs[row + i] * inv);
    signs[row + i] = ll >= 0.0f;
    const int mag = (int)fabsf(ll);
    mags[row + i] = mag;
    m = max(m, mag);
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  __shared__ int warp_max[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      m = max(m, __shfl_down_sync(0xffffffffu, m, off));
    }
    if (lane == 0) atomicMax(&maxmag[b], m);
  }
}


// -- K16 ----------------------------------------------------------------------
constexpr int kPsnrCand = 8;     // the full launch's candidates: the most a launch tests
constexpr int kPsnrLean = 3;     // the lean launch's candidates (0-2 shrinks meet)
constexpr int kPsnrParts = kThreads / kPsnrCand;  // partial sums per candidate in the last block
constexpr float kShrink = 0.840896427631378173828125f;  // f32(2^(-1/4)), as the plain loop's
constexpr float kRound = 12582912.0f;  // 1.5 2^23

// kCand: the candidates a thread keeps in registers (J <= kCand are
// tested).  A block's slots and the last block's parts keep the layout of
// kPsnrCand candidates whatever kCand is, so the sums' order does not
// depend on the launch.
template <int kCand>
__global__ void __launch_bounds__(kThreads) psnr_q_kernel(
    const float* __restrict__ coeffs, const float* q_in, const float* __restrict__ t_mse,
    float* __restrict__ q_out, float* q_next, int32_t* status, double* __restrict__ slots,
    unsigned* __restrict__ counters, long long n, int J, int first) {
  const int b = blockIdx.y;
  // rows met or stuck in an earlier launch take no part (status is written
  // by a row's last block only after every block of the row has read it)
  if (!first && status[b] != 0) return;
  __shared__ float s_q[kCand + 1];
  __shared__ double s_warp[kThreads / 32][kCand];
  __shared__ double s_part[kPsnrParts][kPsnrCand];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  if (t == 0) {
    float q = q_in[b];
    for (int j = 0; j <= J; ++j) {
      s_q[j] = q;
      q = __fmul_rn(q, kShrink);
    }
  }
  __syncthreads();
  float qj[kCand], inv[kCand];
  double acc[kCand];
#pragma unroll
  for (int j = 0; j < kCand; ++j) {
    qj[j] = s_q[j < J ? j : 0];
    inv[j] = __fdiv_rn(1.0f, qj[j]);
    acc[j] = 0.0;
  }
  const float* row = coeffs + (long long)b * n;
  // the largest |c inv_j| of an element is |c| inv_{J-1}: below 2^21 (with
  // room for the product's rounding), every p = c inv_j has |p| < 2^22, where
  // (p + 1.5 2^23) - 1.5 2^23 rounds p to the nearest integer, ties to even,
  // as rintf does (the sign of a zero aside, which d does not see); rintf
  // goes to the conversion unit, the card's busiest here with the f64
  // conversion
  const float small = __fdiv_rn(0x1p21f, inv[J - 1]);
  auto add = [&](float c, bool fast) {
#pragma unroll
    for (int j = 0; j < kCand; ++j) {
      if (j < J) {
        const float p = __fmul_rn(c, inv[j]);
        const float r = fast ? __fsub_rn(__fadd_rn(p, kRound), kRound) : rintf(p);
        const double d = (double)__fsub_rn(c, __fmul_rn(qj[j], r));
        acc[j] = __fma_rn(d, d, acc[j]);  // d * d is exact in f64: one rounding, as d * d + acc
      }
    }
  };
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first_i = (long long)blockIdx.x * kThreads + t;
  // 16-byte loads where every row starts on 16 bytes (n % 4 == 0), else one float a load
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(coeffs) & 15) == 0;
  const long long nv = vec ? n >> 2 : 0;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  for (long long v = first_i; v < nv; v += stride) {
    const float4 c = __ldg(row4 + v);
    const float m = fmaxf(fmaxf(fabsf(c.x), fabsf(c.y)), fmaxf(fabsf(c.z), fabsf(c.w)));
    // one branch for the warp: the fast rounding where every lane may take it
    if (__all_sync(__activemask(), m < small)) {
      add(c.x, true);
      add(c.y, true);
      add(c.z, true);
      add(c.w, true);
    } else {
      add(c.x, false);
      add(c.y, false);
      add(c.z, false);
      add(c.w, false);
    }
  }
  for (long long i = 4 * nv + first_i; i < n; i += stride) {
    const float c = __ldg(row + i);
    add(c, fabsf(c) < small);
  }
  // the block's sums, in a fixed order: warp shuffles, then the warps in turn
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int j = 0; j < kCand; ++j) {
    double v = acc[j];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_warp[warp][j] = v;
  }
  __syncthreads();
  double* my = slots + ((long long)b * gridDim.x + blockIdx.x) * kPsnrCand;
  if (t < J) {
    double v = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) v += s_warp[w][t];
    my[t] = v;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) s_last = atomicAdd(counters + b, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the row's last block: the blocks' sums in block order
  {
    const int j = t % kPsnrCand, part = t / kPsnrCand;
    double v = 0.0;
    if (j < J) {
      const double* rs = slots + (long long)b * gridDim.x * kPsnrCand + j;
      for (unsigned k = part; k < gridDim.x; k += kPsnrParts) v += __ldcg(rs + (long long)k * kPsnrCand);
    }
    s_part[part][j] = v;
  }
  __syncthreads();
  if (t == 0) {
    const double target = (double)t_mse[b];
    int met = -1;
    for (int j = 0; j < J && met < 0; ++j) {
      double sum = 0.0;
      for (int p = 0; p < kPsnrParts; ++p) sum += s_part[p][j];
      if (!(sum / (double)n > target)) met = j;
    }
    if (met >= 0) {
      q_out[b] = s_q[met];
      status[b] = 1;
    } else {
      q_next[b] = s_q[J];
      status[b] = s_q[J] == s_q[J - 1] ? 2 : 0;
    }
    counters[b] = 0;
  }
}

}  // namespace

// coeffs (B, n) f32, inv_q (B,) f32 -> mags (B, n) i32, signs (B, n) bool,
// maxmag (B,) i32, which the caller zeroes.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int sperr_quantize(const float* coeffs, const float* inv_q,
                              int32_t* mags, uint8_t* signs, int32_t* maxmag,
                              long long B, long long n, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  long long per_row = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (per_row > 4096) per_row = 4096;
  dim3 grid((unsigned)per_row, (unsigned)B);
  quantize_kernel<<<grid, kThreads, 0, stream>>>(coeffs, inv_q, mags, signs,
                                                 maxmag, n);
  return (int)cudaGetLastError();
}

// One launch of K16 over the rows of coeffs (B, n) f32 whose status is 0
// (every row when first != 0), J candidates each (the lean kernel for J <=
// kPsnrLean, the full one above): q_in (B,) each row's first candidate; a
// met row gets q_out and status 1, an open one q_next and status 0, a row
// that can no longer shrink status 2.  slots: B * blocks * kPsnrCand
// doubles; counters: B zeroed words, left zeroed.  q_in may be q_next, so
// a round's second launch, queued behind the first, resumes its open rows.
// blocks: per row, a function of n alone (the sums' order does not depend
// on the batch).  Returns the cudaError_t of the launch.
extern "C" int sperr_psnr_q(const float* coeffs, const float* q_in, const float* t_mse, float* q_out,
                            float* q_next, int32_t* status, double* slots, unsigned* counters,
                            long long B, long long n, int blocks, int J, int first,
                            cudaStream_t stream) {
  if (B <= 0 || n <= 0 || B > 65535 || blocks < 1 || J < 1 || J > kPsnrCand)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  if (J <= kPsnrLean)
    psnr_q_kernel<kPsnrLean><<<grid, kThreads, 0, stream>>>(coeffs, q_in, t_mse, q_out, q_next, status,
                                                            slots, counters, n, J, first);
  else
    psnr_q_kernel<kPsnrCand><<<grid, kThreads, 0, stream>>>(coeffs, q_in, t_mse, q_out, q_next, status,
                                                            slots, counters, n, J, first);
  return (int)cudaGetLastError();
}
