// Per-level CDF 9/7 transforms of a batch of 2D planes for Hopper: one fused
// pass (rows and columns) over each level's corner, out of place.
//
// Replaces the Pallas kernels K2 and K3 of sperr_tpu/ops/pallas_kernels.py
// (:168-238):
//   dwt2d_level  <- dwt2d_pallas  / _dwt2d_full_kernel  (pallas_call :217)
//   idwt2d_level <- idwt2d_pallas / _idwt2d_full_kernel (pallas_call :231)
// which compute what sperr_tpu/ops/cdf97_jax.py dwt2d/idwt2d compute: the
// forward level lev lifts the rows (x) of the (ly, lx) approximation corner,
// then its columns (y); the inverse undoes levels in reverse, columns then
// rows.  Each line is one lifting level in the order of operations of the
// plain version (sperr_tpu_torch/ops/cdf97.py _analysis/_synthesis), with
// the clamped neighbours of _neighbors at the edges of the corner:
// even[min(j+1, el-1)], odd[max(i-1, 0)], odd[min(i, ol-1)].
//
// Data flow, one launch per level, in stream order:
//   forward level k reads the corner LL_{k-1} (the input plane at k = 0),
//     writes its three detail bands to their final places in the output and
//     its approximation LL_k to a compact scratch plane (to the output's
//     corner at the last level);
//   inverse level k reads LL_k (the coefficients' corner at the first level
//     of the call, the scratch after that) and level k's detail bands from
//     the coefficients, and writes LL_{k-1} to the scratch (at the last level
//     to the caller's output).
// No launch reads what it writes, so blocks need no barrier across the grid;
// a level waits for the previous one at griddepcontrol.wait (programmatic
// dependent launch), which lets its launch overlap the previous level's end.
//
// Bound: device memory.  A level reads its corner once and writes it once,
// with ~20 flops per sample.  A block owns a tile of 28 x 28 output pairs
// (56 x 56 samples) and loads it with a halo of two pairs on each side
// (64 x 64 samples): a forward even output depends on x[2i-4 .. 2i+4], an
// odd one on x[2j-2 .. 2j+4]; an inverse output pair on the input pairs
// i-2 .. i+2 of both halves.  The halo is lifted again by each tile that
// loads it, from the same inputs by the same operations, so it gets the same
// bits as in the tile that owns it; only the owned pairs are stored.
//   load:    16-byte loads where the rows are aligned (4-byte ones where
//            not) staged through registers and split into even and odd
//            halves on both axes on the way to shared memory (rows of the
//            tile at [y half][y pair], samples at [x half * 48 + x pair];
//            the row pitch is 81 floats, so a walk down a column is free of
//            bank conflicts);
//   lift:    one warp per line, lane = pair: the four lifting steps run in
//            registers, each clamped neighbour is one __shfl_sync from the
//            lane that holds it, and each warp lifts its 7 or 8 lines at
//            once so that their shuffles overlap; rows then columns
//            (forward), columns then rows (inverse), written back in place;
//   store:   16-byte stores of each band's rows (forward) or of the
//            interleaved plane (inverse) where aligned.
// One block per tile: 20.7 KB of shared memory and at most 40 registers a
// thread (__launch_bounds__ asks for six blocks per SM; no spills) let six
// blocks share an SM, so one block's loads overlap another's lifting.
// Built with --fmad=false and without fast math: each product and sum rounds
// on its own as in the plain version, and nothing sums across lines, so the
// result equals the plain version bit for bit whatever B is and however tiles
// fall on blocks.
//
// Forms tried on one H100 80GB HBM3 at 700 W, (16, 1024^2), K2 / K3 device
// ms (chip_smoke.py phase 3; PERF.md has every run):
//   the design this replaced: one cooperative launch for all levels, a row
//     and a column pass over the whole corner per level through device
//     memory, grid.sync() between passes, 64 KB tiles of whole lines with
//     scalar accesses: 0.6455 / 0.6597 (the per-axis path through the 3D
//     lifting kernel: 0.2686 / 0.2903);
//   4-byte cp.async loads, one line per warp at a time, a persistent grid
//     double-buffering its tiles: 0.2210 / 0.2216; one block per tile
//     0.2061 / 0.2066 (dropped: the persistent grid lost);
//   16-byte loads and stores staged through registers, each warp's lines
//     lifted together: 0.1137 / 0.1432; the inverse's tiles shifted to
//     x pair -2 (aligned loads): 0.1141 / 0.1166;
//   at most 48 registers (five blocks per SM): 0.1080 / 0.1114; at most 40
//     (six): 0.1065 / 0.1100, kept;
//   the levels after the first as programmatic dependent launches (their
//     blocks become resident during the previous level's last wave):
//     0.1022-0.1032 / 0.1020-0.1024 against 0.1065-0.1070 / 0.1097-0.1102
//     without, in the same call; kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kN = 32;                 // pairs per tile axis, halo included: one per lane
constexpr int kHalo = 2;               // halo pairs on each side
constexpr int kT = kN - 2 * kHalo;     // output pairs per tile axis
constexpr int kOdd = 48;               // the odd half of a shared row starts here
constexpr int kPitch = 81;             // shared row pitch, in floats
constexpr int kBuf = 2 * kN * kPitch;  // floats of one tile buffer (64 rows)
constexpr int kDescWords = 15;         // long longs per launch descriptor

struct Lift {
  float alpha, beta, gamma, delta, epsilon, inv_epsilon;
};

// One launch: the level's corner (ly, lx).  Forward: src is LL_{k-1} (the
// corner), dst receives LL_k, det the three detail bands.  Inverse: src is
// LL_k, det holds the detail bands, dst receives the corner.  Pitches and
// plane strides in floats.
struct Level {
  const float* src;
  long long src_pitch, src_plane;
  float* dst;
  long long dst_pitch, dst_plane;
  float* det;
  long long det_pitch, det_plane;
  int ly, lx;
  int tiles_x, tiles_y;
  int shift;  // the first tile's first pair along x is -shift
  long long ntiles;
};

struct Tile {
  long long b;
  int i0, j0;  // first output pair along x and y
};

__device__ __forceinline__ Tile tile_of(const Level& L, long long t) {
  const long long per = (long long)L.tiles_x * L.tiles_y;
  Tile r;
  r.b = t / per;
  const int u = (int)(t - r.b * per);
  r.j0 = (u / L.tiles_x) * kT;
  r.i0 = (u % L.tiles_x) * kT - L.shift;
  return r;
}

// Lanes of the clamped neighbours along a line of n samples whose tile
// starts at output pair p0 (lane p holds pair p0 - kHalo + p):
// even[min(p+1, el-1)], odd[min(p, ol-1)], odd[max(p-1, 0)].  Lanes whose
// pair lies outside the line compute values that no owned pair reads.
struct Clamp {
  int e_lim, o_lim, o_lo;
};

__device__ __forceinline__ Clamp clamp_of(int n, int p0) {
  const int g0 = p0 - kHalo, el = n - n / 2, ol = n / 2;
  Clamp c;
  c.e_lim = min(el - 1 - g0, kN - 1);
  c.o_lim = min(ol - 1 - g0, kN - 1);
  c.o_lo = max(-g0, 0);
  return c;
}

// One forward lifting level on the pair (e, o) of lane p.
__device__ __forceinline__ void forward_pair(float& e, float& o, int p, const Clamp& c, const Lift& k) {
  const int er = min(p + 1, c.e_lim), ol = max(p - 1, c.o_lo), orr = min(p, c.o_lim);
  o = o + k.alpha * (e + __shfl_sync(kFull, e, er));
  e = e + k.beta * (__shfl_sync(kFull, o, ol) + __shfl_sync(kFull, o, orr));
  o = o + k.gamma * (e + __shfl_sync(kFull, e, er));
  e = k.epsilon * (e + k.delta * (__shfl_sync(kFull, o, ol) + __shfl_sync(kFull, o, orr)));
  o = o * (-k.inv_epsilon);
}

// One inverse lifting level on the pair (even[p], odd[p]) of lane p.
__device__ __forceinline__ void inverse_pair(float& e, float& o, int p, const Clamp& c, const Lift& k) {
  const int er = min(p + 1, c.e_lim), ol = max(p - 1, c.o_lo), orr = min(p, c.o_lim);
  o = o * (-k.epsilon);
  e = e * k.inv_epsilon - k.delta * (__shfl_sync(kFull, o, ol) + __shfl_sync(kFull, o, orr));
  o = o - k.gamma * (e + __shfl_sync(kFull, e, er));
  e = e - k.beta * (__shfl_sync(kFull, o, ol) + __shfl_sync(kFull, o, orr));
  o = o - k.alpha * (e + __shfl_sync(kFull, e, er));
}

// Every lane of a warp lifts R lines at once (independent chains, so their
// shuffles overlap): line i's pair p sits at s[off(i) + p * step], its odd
// partner `odd` floats further.  Lines whose pairs lie outside the level
// are lifted too: they hold values no owned pair reads.
template <int R, bool kInverse, typename Off>
__device__ __forceinline__ void lift_lines(float* s, Off off, int step, int odd, const Clamp& c,
                                           const Lift& k) {
  const int lane = threadIdx.x & 31;
  float e[R], o[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float* b = s + off(i) + lane * step;
    e[i] = b[0];
    o[i] = b[odd];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (kInverse) inverse_pair(e[i], o[i], lane, c, k); else forward_pair(e[i], o[i], lane, c, k);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float* b = s + off(i) + lane * step;
    b[0] = e[i];
    b[odd] = o[i];
  }
}

// Levels after the first are launched with programmatic stream
// serialization: their blocks may become resident while the previous level
// still runs, and wait here until it has finished and its writes are
// visible.  Each block lets the next level's launch begin as soon as it
// starts, so that launch overlaps the previous level's last wave.  Both are
// no-ops for a launch without the attribute.
__device__ __forceinline__ void after_previous_level() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// 16-byte accesses need the pointer, the pitch and the plane stride on
// 16-byte boundaries.
__device__ __forceinline__ bool aligned(const float* p, long long pitch, long long plane) {
  return ((reinterpret_cast<uintptr_t>(p) & 15) == 0) && (pitch & 3) == 0 && (plane & 3) == 0;
}

// Four samples from row p, columns g .. g+3; those outside [0, n) read as 0.
__device__ __forceinline__ float4 load4(const float* p, int g, int n, bool vec) {
  if (vec && g >= 0 && g + 4 <= n) return *reinterpret_cast<const float4*>(p + g);
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = (g + t >= 0 && g + t < n) ? p[g + t] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Four samples to row p, columns g .. g+3 (g >= 0); those at or past n are
// dropped.
__device__ __forceinline__ void store4(float* p, int g, int n, bool vec, float4 v) {
  if (vec && g + 4 <= n) {
    *reinterpret_cast<float4*>(p + g) = v;
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (g + t < n) p[g + t] = w[t];
  }
}

// ---------------------------------------------------------------------------
// Forward: the tile's 64 x 64 input samples from rows 2 (j0 - 2) .. and
// columns 2 (i0 - 2) .. of the corner, 16 bytes at a time (the first column
// is 56 tx - 4, a multiple of 4).  Input row r goes to shared row
// (r & 1) * kN + r / 2, sample c to (c & 1) * kOdd + c / 2.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void forward_tile(float* s, const Level& L, const Tile& t, const Lift& k) {
  after_previous_level();
  const int warp = threadIdx.x >> 5;
  const int ely = L.ly - L.ly / 2, oly = L.ly / 2, elx = L.lx - L.lx / 2, olx = L.lx / 2;
  {
    const int r0 = 2 * (t.j0 - kHalo), c0 = 2 * (t.i0 - kHalo);
    const float* base = L.src + t.b * L.src_plane;
    const bool vec = aligned(L.src, L.src_pitch, L.src_plane);
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = threadIdx.x + q * kThreads, gr = r0 + (idx >> 4);
      v[q] = (gr >= 0 && gr < L.ly)
                 ? load4(base + (long long)gr * L.src_pitch, c0 + 4 * (idx & 15), L.lx, vec)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = threadIdx.x + q * kThreads, r = idx >> 4, p = 2 * (idx & 15);
      float* row = s + ((r & 1) * kN + (r >> 1)) * kPitch;
      row[p] = v[q].x;
      row[kOdd + p] = v[q].y;
      row[p + 1] = v[q].z;
      row[kOdd + p + 1] = v[q].w;
    }
  }
  __syncthreads();
  // rows (x): every loaded row, 8 per warp
  lift_lines<2 * kN / kWarps, false>(
      s, [&](int i) { return (warp + kWarps * i) * kPitch; }, 1, kOdd, clamp_of(L.lx, t.i0), k);
  __syncthreads();
  // columns (y): the owned columns of both x halves, 7 per warp
  lift_lines<2 * kT / kWarps, false>(
      s,
      [&](int i) {
        const int col = warp + kWarps * i;
        return (col / kT) * kOdd + kHalo + col % kT;
      },
      kPitch, kN * kPitch, clamp_of(L.ly, t.j0), k);
  __syncthreads();
  // the four bands of the owned pairs, 16 bytes at a time where aligned
  // (i0 = 28 tx is a multiple of 4): LL to dst, the details to det
  const bool vdst = aligned(L.dst, L.dst_pitch, L.dst_plane);
  const bool vdet = aligned(L.det, L.det_pitch, L.det_plane);
  const bool vdet1 = vdet && (elx & 3) == 0;  // the odd x half starts at elx
  for (int idx = threadIdx.x; idx < 2 * kT * 2 * (kT / 4); idx += kThreads) {
    const int r = idx / (kT / 2), u = idx % (kT / 2);  // u: x half and quad
    const int hy = r / kT, py = r % kT, hx = u / (kT / 4), q = u % (kT / 4);
    const int gy = t.j0 + py, gx = t.i0 + 4 * q;
    if (gy >= (hy ? oly : ely)) continue;
    const float* v = s + (hy * kN + kHalo + py) * kPitch + hx * kOdd + kHalo + 4 * q;
    const float4 w = make_float4(v[0], v[1], v[2], v[3]);
    if (hy | hx) {
      float* row = L.det + t.b * L.det_plane + (long long)(hy ? ely + gy : gy) * L.det_pitch;
      if (hx) {
        store4(row + elx, gx, olx, vdet1, w);
      } else {
        store4(row, gx, elx, vdet, w);
      }
    } else {
      store4(L.dst + t.b * L.dst_plane + (long long)gy * L.dst_pitch, gx, elx, vdst, w);
    }
  }
}

// ---------------------------------------------------------------------------
// Inverse: input pairs j0 - 2 .. j0 + 29 and i0 - 2 .. i0 + 29 of both
// halves; (y half, y pair) -> shared row hy * kN + py, (x half, x pair) ->
// hx * kOdd + px.  The even-even quarter comes from src, the rest from det.
// The tiles start at x pair -2 (i0 = 28 tx - 2), so each (row, x half) is 8
// quads from pair i0 - 2, a multiple of 4, and the interleaved output row
// from sample 2 i0, also one.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void inverse_tile(float* s, const Level& L, const Tile& t, const Lift& k) {
  after_previous_level();
  const int warp = threadIdx.x >> 5;
  const int ely = L.ly - L.ly / 2, oly = L.ly / 2, elx = L.lx - L.lx / 2, olx = L.lx / 2;
  {
    const bool vsrc = aligned(L.src, L.src_pitch, L.src_plane);
    const bool vdet = aligned(L.det, L.det_pitch, L.det_plane);
    const bool vdet1 = vdet && (elx & 3) == 0;  // the odd x half starts at elx
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = threadIdx.x + q * kThreads, r = idx >> 4, hx = (idx >> 3) & 1;
      const int hy = r / kN, gy = t.j0 - kHalo + r % kN, g = t.i0 - kHalo + 4 * (idx & 7);
      v[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gy >= 0 && gy < (hy ? oly : ely)) {
        if (hy | hx) {
          const float* row = L.det + t.b * L.det_plane + (long long)(hy ? ely + gy : gy) * L.det_pitch;
          v[q] = hx ? load4(row + elx, g, olx, vdet1) : load4(row, g, elx, vdet);
        } else {
          v[q] = load4(L.src + t.b * L.src_plane + (long long)gy * L.src_pitch, g, elx, vsrc);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      float* row = s + (idx >> 4) * kPitch + ((idx >> 3) & 1) * kOdd + 4 * (idx & 7);
      row[0] = v[q].x;
      row[1] = v[q].y;
      row[2] = v[q].z;
      row[3] = v[q].w;
    }
  }
  __syncthreads();
  // columns (y) first: every loaded column, since the rows need the x halo
  lift_lines<2 * kN / kWarps, true>(
      s,
      [&](int i) {
        const int col = warp + kWarps * i;
        return (col / kN) * kOdd + col % kN;
      },
      kPitch, kN * kPitch, clamp_of(L.ly, t.j0), k);
  __syncthreads();
  // then rows (x): the owned rows of both y halves, 7 per warp
  lift_lines<2 * kT / kWarps, true>(
      s,
      [&](int i) {
        const int row = warp + kWarps * i;
        return ((row / kT) * kN + kHalo + row % kT) * kPitch;
      },
      1, kOdd, clamp_of(L.lx, t.i0), k);
  __syncthreads();
  // the owned 56 x 56 samples, interleaved, 16 bytes at a time where
  // aligned: sample (2 gy + hy, 2 gx + hx)
  const bool vdst = aligned(L.dst, L.dst_pitch, L.dst_plane);
  for (int idx = threadIdx.x; idx < 2 * kT * (kT / 2); idx += kThreads) {
    const int r = idx / (kT / 2), q = idx % (kT / 2);
    const int Y = 2 * t.j0 + r, X = 2 * t.i0 + 4 * q;
    if (Y >= L.ly || X < 0) continue;
    const float* v = s + ((r & 1) * kN + kHalo + (r >> 1)) * kPitch + kHalo + 2 * q;
    store4(L.dst + t.b * L.dst_plane + (long long)Y * L.dst_pitch, X, L.lx, vdst,
           make_float4(v[0], v[kOdd], v[1], v[kOdd + 1]));
  }
}

__global__ void __launch_bounds__(kThreads, 6) dwt2d_level(Level L, Lift k) {
  __shared__ float s[kBuf];
  forward_tile(s, L, tile_of(L, blockIdx.x), k);
}

__global__ void __launch_bounds__(kThreads, 6) idwt2d_level(Level L, Lift k) {
  __shared__ float s[kBuf];
  inverse_tile(s, L, tile_of(L, blockIdx.x), k);
}

}  // namespace

// Every level of one 2D transform of B planes, one launch per level in
// stream order, one block per tile.  desc: n launch descriptors of 15 long
// longs each:
//   src offset, src pitch, src plane stride, dst offset, dst pitch, dst
//   plane stride, det offset, det pitch, det plane stride, ly, lx, grid,
//   src base, dst base, det base
// (offsets in bytes from the base that the last three words name: 0 x, 1
// scratch, 2 out; pitches and strides in floats; (ly, lx) the level's
// corner; grid the launch's blocks, which must be its tiles).  inverse = 0:
// forward levels (src the corner LL_{k-1}, dst LL_k, det the detail bands
// written); inverse = 1: src LL_k, det the detail bands read, dst the
// corner.  consts: host {alpha, beta, gamma, delta, epsilon, inv_epsilon}.
// Returns the cudaError_t of the first launch that failed, or 0.
extern "C" int sperr_cdf97_2d(int inverse, int n, const long long* desc, const float* x,
                              float* scratch, float* out, long long B, const float* consts,
                              cudaStream_t stream) {
  if (n <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const Lift k = {consts[0], consts[1], consts[2], consts[3], consts[4], consts[5]};
  char* const bases[3] = {reinterpret_cast<char*>(const_cast<float*>(x)),
                          reinterpret_cast<char*>(scratch), reinterpret_cast<char*>(out)};
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + (long long)i * kDescWords;
    if (d[12] < 0 || d[12] > 2 || d[13] < 0 || d[13] > 2 || d[14] < 0 || d[14] > 2) {
      return (int)cudaErrorInvalidValue;
    }
    Level L;
    L.src = reinterpret_cast<const float*>(bases[d[12]] + d[0]);
    L.src_pitch = d[1];
    L.src_plane = d[2];
    L.dst = reinterpret_cast<float*>(bases[d[13]] + d[3]);
    L.dst_pitch = d[4];
    L.dst_plane = d[5];
    L.det = reinterpret_cast<float*>(bases[d[14]] + d[6]);
    L.det_pitch = d[7];
    L.det_plane = d[8];
    L.ly = (int)d[9];
    L.lx = (int)d[10];
    L.shift = inverse ? kHalo : 0;
    L.tiles_x = (L.lx - L.lx / 2 + L.shift + kT - 1) / kT;
    L.tiles_y = (L.ly - L.ly / 2 + kT - 1) / kT;
    L.ntiles = B * L.tiles_x * L.tiles_y;
    if (L.ly < 2 || L.lx < 2 || d[11] != L.ntiles || L.ntiles > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)L.ntiles);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = pdl;
    cfg.numAttrs = i > 0 ? 1 : 0;  // the first level waits for the stream as usual
    cudaError_t err = cudaLaunchKernelEx(&cfg, inverse ? idwt2d_level : dwt2d_level, L, k);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
