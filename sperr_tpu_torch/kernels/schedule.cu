// The device SPECK schedule (K5, K6 and the schedule half of K14/K15) for
// Hopper.
//
// Replaces the XLA programs of sperr_tpu/ops/speck_jax.py msbp1_device
// (K5), sperr_tpu/ops/speck_virtual.py pixel_schedule_virtual (K6, with
// box_reduce_max and _morton_flatten), and speck_jax.py node_max +
// pixel_schedule (K15's child-table form, and every 2D field of K14, with
// sperr_tpu/ops/speck_lis2_jax.py iset_significance_device, the 2D I-set
// maxima) and pixel_schedule_pyramid (K15's pyramid form, :638).  For magnitudes
// mags they give
//   pm  = msb position + 1 of each magnitude (0 for zero),
//   num_bp = max pm,
//   s   = num_bp - pm, or NEVER (0x7FFF) where pm = 0,
//   e   = the same of the pixel's parent set's maximum,
//   nm  = each partition node's maximum pm, in the tree's BFS order,
//   iset_s = (2D) the same of each I level's region maximum.
// Every result is an integer and equals the plain versions beside the
// callers (ops/speck_virtual.py, ops/speck.py, ops/speck_lis2.py) bit for
// bit.
//
// Bound: device memory.  The work per pixel is a count of leading zeros
// and a few maxima; what costs is reading the int32 magnitudes once and
// writing s and e (int32 each).  The designs:
//   * power-of-two cubes (two launches): sched_boxmax takes one aligned
//     2x2x2 box per thread (four 8-byte row loads, coalesced across the
//     warp's x-adjacent boxes), writes pm as one byte per pixel, the box
//     maximum to its morton slot of the half grid, and the maxima of the
//     morton sub-cubes its block covers (a block is an aligned cube of
//     8 x 8 x 8 boxes, a contiguous morton range), and raises num_bp by one
//     integer atomicMax per block (order-free, so deterministic).
//     sched_virtual reads num_bp on the device (no host wait), writes s and
//     e from the byte copy (8-byte row stores), gathers nm through a static
//     table of (grid, lo, hi, output offset) segments, and one block of it
//     finishes the small levels of the pyramid and their segments;
//   * child tables (two launches): the tree's depths are ordered by parent,
//     so the descendants of a run of nodes at any deeper depth are one id
//     range and their child rows one row range.  table_subtrees takes a run
//     of consecutive nodes of a static cut depth per block (about
//     1,024-4,096 child rows): it reads every child row of their subtrees,
//     coalesced, with each pixel child's msb+1 from mags as it is read (no
//     pm in device memory), into shared memory, then reduces the subtrees'
//     depths deepest first in shared memory, a thread per node, and writes
//     each node's maximum once; the leaves (the deepest depth: boxes of at
//     most 2 x 2 x 2 pixels) are not staged, each one's thread reading its
//     box from a static table (4 bytes a leaf, not 4 a child row) and its
//     magnitudes (the table's entries int32, or int64 for a field whose
//     boxes start at or past pixel 2^28).  Where the depths above that cut
//     hold more rows than one
//     block should take, runs of a shallower cut's nodes form groups: the
//     block that ends last among those reaching a group (a done counter per
//     group) reduces the group's subtrees down to the first cut (that cut's
//     maxima read from nm).  The last block to end (a done counter) reduces
//     the depths above the top cut, with the pixels that hang from them,
//     and writes num_bp, the roots' maximum; the counters are zeroed words
//     that their last users reset.  table_pixels then writes s and e
//     (through each pixel's parent node) in one linear pass (no pm); on a 2D
//     field it also takes each I level's region maximum (a block takes part
//     of one row at a time, so the rows' test is uniform), reduced by warp,
//     block and guarded integer atomics, and its last block writes iset_s;
//   * pyramids (two launches, no fill): the pixels embed in a box of
//     2^depth slots per axis (static per-axis slot tables), and the
//     partition's boxes at depth d are the cells of level d, a max-pool of
//     level d + 1 along the axes still halving.  pyramid_tiles takes one
//     cell of a static level ("top", at most 4,096 deep cells) per block:
//     each of its deep cells finds its pixel through three small per-axis
//     tables (slot -> coordinate or none; no n-entry index), takes msb+1
//     (empty cells 0, so nothing is zeroed first), the block pools its
//     levels down to top in shared memory and writes the levels that a node
//     or a pixel's parent lies on (the deepest one never holds either).
//     The launch waits on its loads and its per-cell arithmetic, not on
//     bytes: a cube tile's thread keeps one (y, x) column, so only its z
//     lookup is per cell, and all its loads are issued before the first
//     use.  The tiles also leave each pixel's msb+1 as a byte (n bytes in
//     place of mags' 4n read again).  The last block to end (a done counter
//     in a zeroed word it resets) pools the levels above top and writes
//     num_bp, level 0's one cell.  pyramid_finish writes s from the tiles'
//     bytes, e (each pixel's parent box from its axes' slots and single
//     depths, three more small tables, so no n-entry table of boxes is
//     read; four pixels a thread, 16-byte stores) and nm (a gather through
//     the nodes' cells, four a thread).
// The pyramids are kept as bytes (values <= 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNever = 0x7FFF;
constexpr int kThreads = 256;
constexpr int kMaxSegs = 256;  // segments of the virtual nm table

__device__ __forceinline__ int msbp1(int m) { return m > 0 ? 32 - __clz(m) : 0; }

__device__ __forceinline__ int sched_of(int v, int nb) { return v > 0 ? nb - v : kNever; }

// The bits of v (< 2^10) moved to every third bit.
__device__ __forceinline__ unsigned spread3(unsigned v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// Morton index, x lowest, then y, then z; the coarser digit more significant.
__device__ __forceinline__ unsigned morton3(unsigned x, unsigned y, unsigned z) {
  return spread3(x) | (spread3(y) << 1) | (spread3(z) << 2);
}

// Offset of grid g's cells in the concatenated morton pyramid: (8^g - 1) / 7.
__device__ __forceinline__ long long level_off(int g) {
  return ((1LL << (3 * g)) - 1) / 7;
}

// -- power-of-two cubes ------------------------------------------------------
// mags (N, N, N), N = 2^K; a block is an aligned cube of S^3 boxes, S = 2^j.
__global__ void sched_boxmax(const int32_t* __restrict__ mags, uint8_t* __restrict__ pm8,
                             uint8_t* __restrict__ M, int32_t* __restrict__ num_bp, int K,
                             int j) {
  __shared__ uint8_t cell[512];
  const int Kh = K - 1, bb = Kh - j;
  const long long N = 1LL << K;
  const unsigned t = threadIdx.x, S1 = (1u << j) - 1;
  const unsigned tx = t & S1, ty = (t >> j) & S1, tz = t >> (2 * j);
  const unsigned b = blockIdx.x, B1 = (1u << bb) - 1;
  const unsigned Bx = b & B1, By = (b >> bb) & B1, Bz = b >> (2 * bb);
  const unsigned bx = (Bx << j) | tx, by = (By << j) | ty, bz = (Bz << j) | tz;
  int bm = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long row = ((2LL * bz + (r >> 1)) * N + (2LL * by + (r & 1))) * N + 2LL * bx;
    const int2 v = *reinterpret_cast<const int2*>(mags + row);
    const int a = msbp1(v.x), c = msbp1(v.y);
    *reinterpret_cast<uint16_t*>(pm8 + row) = (uint16_t)(a | (c << 8));
    bm = max(bm, max(a, c));
  }
  const unsigned ml = morton3(tx, ty, tz);
  const long long mb = (long long)morton3(Bx, By, Bz);
  M[level_off(Kh) + (mb << (3 * j)) + ml] = (uint8_t)bm;
  cell[ml] = (uint8_t)bm;
  __syncthreads();
  // the block's morton sub-cubes: grids Kh-1 .. Kh-j
  unsigned cnt = 1u << (3 * j);
  for (int l = 1; l <= j; ++l) {
    cnt >>= 3;
    int v = 0;
    if (t < cnt) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v = max(v, (int)cell[8 * t + k]);
    }
    __syncthreads();
    if (t < cnt) {
      cell[t] = (uint8_t)v;
      M[level_off(Kh - l) + (mb << (3 * (j - l))) + t] = (uint8_t)v;
    }
    __syncthreads();
  }
  // cell[0] is now the maximum over the block's boxes
  if (t == 0) atomicMax(num_bp, (int)cell[0]);
}

// Block 0: grids gmin-1 .. 0 of the pyramid and the nm segments on them.
// Blocks 1 .. nb_se: s and e, one 2x2x2 box per thread.  The rest: nm for
// the segments on grids >= gmin, one node per thread.
__global__ void sched_virtual(const uint8_t* __restrict__ pm8, uint8_t* __restrict__ M,
                              const int32_t* __restrict__ num_bp, const int32_t* __restrict__ segs,
                              int nseg, int32_t* __restrict__ s, int32_t* __restrict__ e,
                              int32_t* __restrict__ nm, int K, int gmin, long long nb_se,
                              long long nn) {
  __shared__ int4 seg[kMaxSegs];
  const unsigned t = threadIdx.x;
  const long long b = blockIdx.x;
  if (b == 0) {
    for (int g = gmin - 1; g >= 0; --g) {
      const long long cnt = 1LL << (3 * g), src = level_off(g + 1), dst = level_off(g);
      for (long long c = t; c < cnt; c += blockDim.x) {
        int v = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) v = max(v, (int)M[src + 8 * c + k]);
        M[dst + c] = (uint8_t)v;
      }
      __syncthreads();
    }
    for (int q = 0; q < nseg; ++q) {
      const int g = segs[4 * q], lo = segs[4 * q + 1], hi = segs[4 * q + 2], out = segs[4 * q + 3];
      if (g >= gmin) continue;
      for (int i = t; i < hi - lo; i += blockDim.x) nm[out + i] = M[level_off(g) + lo + i];
    }
    return;
  }
  if (b <= nb_se) {
    const int Kh = K - 1;
    const long long N = 1LL << K, Nh1 = (1LL << Kh) - 1;
    const long long box = (b - 1) * blockDim.x + t;
    if (box >> (3 * Kh)) return;
    const long long bx = box & Nh1, by = (box >> Kh) & Nh1, bz = box >> (2 * Kh);
    const int nb = *num_bp;
    int p[8], bm = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long row = ((2 * bz + (r >> 1)) * N + (2 * by + (r & 1))) * N + 2 * bx;
      const unsigned w = *reinterpret_cast<const uint16_t*>(pm8 + row);
      p[2 * r] = w & 0xff;
      p[2 * r + 1] = w >> 8;
      bm = max(bm, max(p[2 * r], p[2 * r + 1]));
    }
    const int ev = sched_of(bm, nb);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long row = ((2 * bz + (r >> 1)) * N + (2 * by + (r & 1))) * N + 2 * bx;
      *reinterpret_cast<int2*>(s + row) = make_int2(sched_of(p[2 * r], nb), sched_of(p[2 * r + 1], nb));
      *reinterpret_cast<int2*>(e + row) = make_int2(ev, ev);
    }
    return;
  }
  for (int q = t; q < nseg; q += blockDim.x) {
    seg[q] = make_int4(segs[4 * q], segs[4 * q + 1], segs[4 * q + 2], segs[4 * q + 3]);
  }
  __syncthreads();
  const long long i = (b - 1 - nb_se) * blockDim.x + t;
  if (i >= nn) return;
  int q = 0;
  while (q + 1 < nseg && seg[q + 1].w <= i) ++q;
  const int4 sg = seg[q];
  if (sg.x >= gmin) nm[i] = M[level_off(sg.x) + sg.y + (i - sg.w)];
}

// -- child tables ------------------------------------------------------------
constexpr int kMaxDepth = 32;      // depths of a tree
constexpr int kMaxIset = 16;       // I levels of a 2D field
constexpr int kMaxChildren = 8;    // child rows of a node
constexpr int kMaxGroups = 32;     // upper groups a block of the deep cut reaches
constexpr int kNodeMark = 64;      // a staged row >= kNodeMark: a node child, its slot + kNodeMark
constexpr int kRowBatch = 4;       // child rows a thread has in flight
constexpr int kSubtreeBlocks = 8;  // blocks of table_subtrees an SM holds (its registers' cap)
constexpr int kPixTile = 1024;     // pixels a block of the pixel pass takes from one row
constexpr int kZeroWords = 2 + kMaxIset + 1;  // the done counters, the I maxima at [2 + k]; then the groups'
constexpr int kPyrLevels = 30;       // levels of a pyramid
constexpr int kPyrTileCells = 4096;  // deep cells of a pyramid tile

}  // namespace

// The child-table schedule's arguments, as kernels/__init__.py SchedTable
// lays them out (the host fills one per call; by value to each kernel).
struct SchedTable {
  const int32_t* mags;       // (n,)
  const int32_t* ch_src;     // each child row: a pixel's linear index, or -(node id + 1)
  const int32_t* ch_bounds;  // (nn + 1,): node k's rows ch_bounds[k] .. ch_bounds[k + 1] - 1
  const int32_t* px_parent;  // (n,)
  const int32_t* sub[2];     // per cut level v: (2, nsub[v], nblk[v] + 1), at depth cut[v] + j each
                             // block's (v = 0) or group's (v = 1) first node, then first row (its end
                             // the next one's first)
  const int32_t* links;      // two levels: each block's first and last group (2 nblk[0]), then each
                             // group's blocks (nblk[1])
  const void* leaf;          // each node of the deepest depth (a box of pixels, at most 2 a side): its
                             // first pixel's linear index << 3 | (its sides - 1) as x, y << 1, z << 2;
                             // int32, or int64 where leaf64
  int32_t* nm;               // (nn,)
  int32_t* num_bp;           // one word
  int32_t* s;                // (n,)
  int32_t* e;                // (n,)
  int32_t* iset_s;           // (xf + 1,) or null
  int32_t* zw;               // kZeroWords + nblk[1] zeroed words, left zeroed
  long long n;
  int levels;                // cut levels: 1, or 2 (groups from cut[1] < cut[0] down to cut[0])
  int cut[2], nblk[2], nsub[2];
  int smem;                  // dynamic shared bytes of a block of table_subtrees
  int nroots, ny, nx;        // the pixel grid: (ny, nx) for a 2D field, (1, n) for a 3D chunk
  int xf;                    // I levels (with iset_s)
  int depth;                 // depths of the tree
  int row, plane;            // a pixel's y and z strides (the field's or chunk's nx, nx ny)
  int leaf64;                // the leaf table's entries are int64
  int depth_lo[kMaxDepth + 1];             // the first node of each depth
  int ax[kMaxIset + 1], ay[kMaxIset + 1];  // level k's corner: its region is y >= ay[k] or x >= ax[k]
};

// The pyramid schedule's arguments, as kernels/__init__.py SchedPyramid lays
// them out (the host fills one per call; by value to each kernel).
struct SchedPyramid {
  const int32_t* mags;    // (n,): x fastest, then y, then z
  const int32_t* axes;    // per axis (z, y, x): inv, its slots' pixel coordinates (-1: none), 2^depth;
                          // px, its pixels' slot << 8 | the depth where the pixel's interval is single
  const int32_t* nm_src;  // (nn,): each node's cell in flat
  uint8_t* flat;          // the levels 0 .. max(lmax, top), depth 0 first; level d is 2^min(d, depth[k])
                          // cells along axis k
  uint8_t* pm;            // (n,): each pixel's msb+1, from the tiles to the finish
  int32_t* num_bp;        // one word
  int32_t* s;             // (n,)
  int32_t* e;             // (n,)
  int32_t* nm;            // (nn,)
  int32_t* zw;            // a zeroed word (the tiles' done counter), left zeroed
  long long n, nn;
  long long off[kPyrLevels + 2];  // level d's first cell in flat
  int inv[3], px[3];      // each axis's two tables in axes
  int dims[3];            // nz, ny, nx
  int depth[3];           // each axis's depth (its intervals single at it)
  int levels;             // L, the largest depth: the deepest level
  int top;                // the tiles' level: a tile is one of its cells, at most kPyrTileCells deep cells
  int lmax;               // the deepest level a node or a pixel's parent lies on
};

namespace {

// A set of depths of the tree, each a node range and a row range, staged
// into one block's shared memory: rows at row slots rb[j] .., nodes at node
// slots nb[j] ...  A node child with an id at or past gfrom is read from nm
// (written by other blocks); the others are the next depth's, in shared
// memory.  rng[0 .. 3][j]: depth j's first node, its end, its first row and
// its end.
struct Depths {
  int nd, gfrom;
  int rng[4][kMaxDepth];
  int nb[kMaxDepth + 1], rb[kMaxDepth + 1];
};

// Stage the rows and the nodes' row starts of sd (nd, gfrom and rng filled,
// the block synchronized), then reduce its depths deepest first, a thread
// per node; every node's maximum to nm and to its slot.  The staging loop
// keeps 2 kRowBatch loads a thread in flight (the nodes' row starts beside
// the rows' sources), then the values; a depth tracker per kind (the slots
// of a thread rise) finds each slot's depth.  With ``leaves`` the deepest
// depth is the tree's: its nodes are boxes of pixels, neither their rows
// nor their row starts are staged, and each one's thread reads its box
// (a.leaf) and its magnitudes itself.  Ends with the block synchronized.
__device__ __forceinline__ void reduce_depths(const SchedTable& a, Depths& sd, unsigned char* smem, bool leaves) {
  const int t = threadIdx.x;
  const int* nlo = sd.rng[0];
  const int* rlo = sd.rng[2];
  if (t == 0) {
    sd.nb[0] = sd.rb[0] = 0;
    for (int j = 0; j < sd.nd; ++j) {
      sd.nb[j + 1] = sd.nb[j] + sd.rng[1][j] - nlo[j];
      sd.rb[j + 1] = sd.rb[j] + sd.rng[3][j] - rlo[j];
    }
  }
  __syncthreads();
  const int nd = sd.nd, all_nodes = sd.nb[nd];
  const int rows = leaves ? sd.rb[nd - 1] : sd.rb[nd];      // the staged ones
  const int nodes = leaves ? sd.nb[nd - 1] : all_nodes;    // those whose row starts are staged
  uint16_t* srow = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sstart = srow + rows;
  uint8_t* snm = reinterpret_cast<uint8_t*>(sstart + nodes + 1);
  for (int q0 = t, jr = 0, jn = 0; q0 < rows; q0 += kRowBatch * kThreads) {  // nodes <= rows
    const int jr0 = jr, jn0 = jn;
    int c[kRowBatch], v[kRowBatch], m[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int q = q0 + u * kThreads;
      c[u] = 0;
      if (q < rows) {
        while (q >= sd.rb[jr + 1]) ++jr;
        c[u] = __ldg(a.ch_src + rlo[jr] + (q - sd.rb[jr]));
      }
      if (q < nodes) {
        while (q >= sd.nb[jn + 1]) ++jn;
        v[u] = __ldg(a.ch_bounds + nlo[jn] + (q - sd.nb[jn]));
      }
    }
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int id = -(c[u] + 1);
      m[u] = 0;
      if (q0 + u * kThreads < rows) {
        if (c[u] >= 0) m[u] = __ldg(a.mags + c[u]);
        else if (id >= sd.gfrom) m[u] = __ldcg(a.nm + id);
      }
    }
    jr = jr0;
    jn = jn0;
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int q = q0 + u * kThreads;
      if (q < rows) {
        while (q >= sd.rb[jr + 1]) ++jr;
        const int id = -(c[u] + 1);
        const int x = c[u] >= 0 ? msbp1(m[u]) : id >= sd.gfrom ? m[u] : kNodeMark + sd.nb[jr + 1] + id - nlo[jr + 1];
        srow[q] = (uint16_t)x;
      }
      if (q < nodes) {
        while (q >= sd.nb[jn + 1]) ++jn;
        sstart[q] = (uint16_t)(sd.rb[jn] + v[u] - rlo[jn]);
      }
    }
  }
  if (t == 0) sstart[nodes] = (uint16_t)rows;
  __syncthreads();
  if (leaves) {
    // the leaves: a box of at most 2 x 2 x 2 pixels each
    const int j = nd - 1, leaf0 = nlo[j] - a.depth_lo[a.depth - 1];
    for (int L = sd.nb[j] + t; L < all_nodes; L += kThreads) {
      const long long i = leaf0 + (L - sd.nb[j]);
      const long long lb = a.leaf64 ? __ldg(static_cast<const long long*>(a.leaf) + i)
                                    : (long long)__ldg(static_cast<const int32_t*>(a.leaf) + i);
      const int box = (int)(lb & 7), base = (int)(lb >> 3);
      int w = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if ((k & ~box & 7) == 0) {  // the side bits of k within the box's
          const int px = base + ((k >> 2) & 1) * a.plane + ((k >> 1) & 1) * a.row + (k & 1);
          w = max(w, msbp1(__ldg(a.mags + px)));
        }
      }
      snm[L] = (uint8_t)w;
      a.nm[nlo[j] + (L - sd.nb[j])] = w;
    }
    __syncthreads();
  }
  for (int j = nd - 1 - (leaves ? 1 : 0); j >= 0; --j) {
    for (int L = sd.nb[j] + t; L < sd.nb[j + 1]; L += kThreads) {
      const int r0 = sstart[L], cnt = sstart[L + 1] - r0;
      int x[kMaxChildren];
#pragma unroll
      for (int u = 0; u < kMaxChildren; ++u) x[u] = u < cnt ? srow[r0 + u] : 0;
      int w = 0;
#pragma unroll
      for (int u = 0; u < kMaxChildren; ++u) w = max(w, x[u] < kNodeMark ? x[u] : (int)snm[x[u] - kNodeMark]);
      snm[L] = (uint8_t)w;
      a.nm[nlo[j] + (L - sd.nb[j])] = w;
    }
    __syncthreads();
  }
}

// Fill sd with depths cut + j (j < nd) of block or group b of the cut level
// whose table is sub (nblk + 1 columns); gfrom as given.
__device__ __forceinline__ void load_depths(Depths& sd, const int32_t* sub, int nd, int nblk, int b, int gfrom) {
  const int t = threadIdx.x;
  if (t < 4 * nd) {  // sd.rng[f][j] from sub[f / 2][j][b + f % 2]
    const int f = t / nd, j = t - f * nd;
    sd.rng[f][j] = __ldg(sub + ((f >> 1) * nd + j) * (nblk + 1) + b + (f & 1));
  }
  if (t == 0) {
    sd.nd = nd;
    sd.gfrom = gfrom;
  }
  __syncthreads();
}

// One block per run of nodes of cut[0]: their subtrees, deepest depth
// first.  With two cut levels, the block that ends last among those that
// reach a group of cut[1] nodes (a done counter per group) reduces that
// group's subtrees down to cut[0].  The last block to end its units (the
// blocks, or the groups) reduces the depths above the top cut (their pixel
// children too; the cut's nodes from nm) and writes num_bp, the roots'
// maximum.  Every counter is left zeroed.
__global__ void __launch_bounds__(kThreads, kSubtreeBlocks) table_subtrees(SchedTable a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Depths sd;
  __shared__ int s_groups[kMaxGroups], s_n;
  __shared__ bool s_last;
  const int b = blockIdx.x, t = threadIdx.x;
  load_depths(sd, a.sub[0], a.nsub[0], a.nblk[0], b, 0x7FFFFFFF);
  reduce_depths(a, sd, smem, true);
  int units = 1;
  if (a.levels == 2) {
    __threadfence();
    __syncthreads();
    unsigned* cnt = reinterpret_cast<unsigned*>(a.zw + kZeroWords);
    if (t == 0) {
      int k = 0;
      for (int g = a.links[b]; g <= a.links[a.nblk[0] + b]; ++g)
        if (atomicAdd(cnt + g, 1u) + 1 == (unsigned)a.links[2 * a.nblk[0] + g]) s_groups[k++] = g;
      s_n = k;
    }
    __syncthreads();
    units = s_n;
    if (units == 0) return;
    __threadfence();
    for (int i = 0; i < units; ++i) {
      const int g = s_groups[i];
      load_depths(sd, a.sub[1], a.nsub[1], a.nblk[1], g, a.depth_lo[a.cut[0]]);
      reduce_depths(a, sd, smem, false);
      if (t == 0) cnt[g] = 0;
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(reinterpret_cast<unsigned*>(a.zw), (unsigned)units) + units == (unsigned)a.nblk[a.levels - 1];
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int cut = a.cut[a.levels - 1];
  if (t < 4 * cut) {  // depth d's nodes depth_lo[d] .. depth_lo[d + 1] - 1, and their rows
    const int f = t / cut, d = t - f * cut;
    const int k = a.depth_lo[d + (f & 1)];
    sd.rng[f][d] = f < 2 ? k : __ldg(a.ch_bounds + k);
  }
  if (t == 0) {
    sd.nd = cut;
    sd.gfrom = a.depth_lo[cut];
  }
  __syncthreads();
  if (cut > 0) reduce_depths(a, sd, smem, false);
  if (t < 32) {
    // the roots: node slots 0 .. nroots-1 of the depths above the cut, or the blocks' nodes in nm
    int m = 0;
    if (cut > 0) {
      const uint8_t* snm = smem + 2 * (sd.rb[sd.nd] + sd.nb[sd.nd] + 1);
      for (int k = t; k < a.nroots; k += 32) m = max(m, (int)snm[k]);
    } else {
      for (int k = t; k < a.nroots; k += 32) m = max(m, __ldcg(a.nm + k));
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (t == 0) {
      *a.num_bp = m;
      a.zw[0] = 0;
    }
  }
}

// s and e of kPixTile pixels of one row, for rows blockIdx.y, + gridDim.y,
// ...; on a 2D field (kIset) the I levels' region maxima, and the last
// block writes iset_s.  The row's test (y >= ay_k) is uniform in a block,
// and so is x >= ax_k but in the block that holds the corner's edge.
template <bool kIset>
__global__ void __launch_bounds__(kThreads) table_pixels(SchedTable a) {
  constexpr int kPer = kPixTile / kThreads;
  const int t = threadIdx.x;
  const int xb = blockIdx.x * kPixTile, x0 = xb + t;
  __shared__ int sm[kMaxIset + 1];  // the block's maximum of each I level's region
  __shared__ bool s_last;
  if (kIset) {
    if (t <= kMaxIset) sm[t] = 0;
    __syncthreads();
  }
  for (int y = blockIdx.y; y < a.ny; y += gridDim.y) {
    const long long row = (long long)y * a.nx;
    int mv[kPer], par[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int x = x0 + u * kThreads;
      mv[u] = x < a.nx ? __ldg(a.mags + row + x) : 0;
      par[u] = x < a.nx ? __ldg(a.px_parent + row + x) : 0;
    }
    const int nb = __ldg(a.num_bp);
    int pv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) pv[u] = __ldg(a.nm + par[u]);
    int mall = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int x = x0 + u * kThreads;
      mv[u] = msbp1(mv[u]);  // 0 past the row's end
      mall = max(mall, mv[u]);
      if (x >= a.nx) continue;
      a.s[row + x] = sched_of(mv[u], nb);
      a.e[row + x] = sched_of(pv[u], nb);
    }
    if (!kIset) continue;
#pragma unroll
    for (int k = 1; k <= kMaxIset; ++k) {
      if (k > a.xf) break;
      int r = mall;
      if (y < a.ay[k] && xb < a.ax[k]) {
        r = 0;
#pragma unroll
        for (int u = 0; u < kPer; ++u) r = max(r, x0 + u * kThreads >= a.ax[k] ? mv[u] : 0);
      }
      r = __reduce_max_sync(0xffffffffu, r);
      if ((t & 31) == 0 && r) atomicMax(&sm[k], r);
    }
  }
  if (!kIset) return;
  __syncthreads();
  const int nb = __ldg(a.num_bp);
  int* g = a.zw + 2;
  // a level's maximum is one of 33 values: most blocks find it raised already
  if (t >= 1 && t <= a.xf) {
    if (sm[t] > __ldcg(g + t)) atomicMax(g + t, sm[t]);
    __threadfence();
  }
  __syncthreads();
  if (t == 0) s_last = atomicAdd(reinterpret_cast<unsigned*>(a.zw + 1), 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (t <= a.xf) {
    const int v = t == 0 ? 0 : __ldcg(g + t);
    a.iset_s[t] = sched_of(v, nb);
    if (t > 0) g[t] = 0;
  }
  if (t == 0) a.zw[1] = 0;
}

// -- pyramids ------------------------------------------------------------------
// The global index of cell c (local sides 2^cb[k]) of a tile whose origin at
// level d is tile coordinate o[k] << cb[k], in level d's array.
__device__ __forceinline__ long long pyr_cell(const SchedPyramid& a, int d, const int* o, const int* cb,
                                              int c) {
  const int gy = min(d, a.depth[1]), gx = min(d, a.depth[2]);
  const long long cx = c & ((1 << cb[2]) - 1), cy = (c >> cb[2]) & ((1 << cb[1]) - 1), cz = c >> (cb[1] + cb[2]);
  const long long z = ((long long)o[0] << cb[0]) + cz, y = ((long long)o[1] << cb[1]) + cy,
                  x = ((long long)o[2] << cb[2]) + cx;
  return a.off[d] + ((z << (gy + gx)) | (y << gx) | x);
}

// The maximum of a cell's children in a level of (2^fb[0], 2^fb[1],
// 2^fb[2]) cells, the axes with f[k] = 1 halving: eight reads at fixed
// offsets (an axis that does not halve reads its child twice).
template <typename Load>
__device__ __forceinline__ int pool8(Load ld, const int* fb, const int* f, int cz, int cy, int cx) {
  const int base = ((((cz << f[0]) << fb[1]) | (cy << f[1])) << fb[2]) | (cx << f[2]);
  const int ox = f[2], oy = f[1] << fb[2], oz = f[0] << (fb[1] + fb[2]);
  return max(max(max(ld(base), ld(base + ox)), max(ld(base + oy), ld(base + oy + ox))),
             max(max(ld(base + oz), ld(base + oz + ox)), max(ld(base + oz + oy), ld(base + oz + oy + ox))));
}

// Launch 1: a block per tile, one cell of level top: its cells of the
// deepest level from the pixels the axes' slot tables name (empty cells 0),
// each pixel's msb+1 byte, then its levels L-1 .. top pooled in shared
// memory; the levels a node or a pixel's parent lies on (<= lmax) and level
// top written.  The last block to end pools levels top-1 .. 0 from level
// top; num_bp is level 0's one cell, the whole box's maximum.
__global__ void __launch_bounds__(kThreads, 4) pyramid_tiles(const SchedPyramid a) {
  __shared__ uint8_t cell[2 * kPyrTileCells];  // the tile's levels, the deepest first
  __shared__ bool s_last;
  const int t = threadIdx.x;
  int tb[3], fb[3], o[3];
  for (int k = 0; k < 3; ++k) {
    tb[k] = min(a.top, a.depth[k]);
    fb[k] = a.depth[k] - tb[k];
  }
  const unsigned tile = blockIdx.x;
  o[2] = tile & ((1u << tb[2]) - 1);
  o[1] = (tile >> tb[2]) & ((1u << tb[1]) - 1);
  o[0] = tile >> (tb[1] + tb[2]);
  const int32_t* iz = a.axes + a.inv[0] + (o[0] << fb[0]);
  const int32_t* iy = a.axes + a.inv[1] + (o[1] << fb[1]);
  const int32_t* ix = a.axes + a.inv[2] + (o[2] << fb[2]);
  const int xy = fb[1] + fb[2], cells = 1 << (fb[0] + xy);
  const int plane = a.dims[1] * a.dims[2];
  // every magnitude of the thread's cells loaded before any is used: the
  // loads are the latency this launch waits on.  Where a plane of the tile
  // has at most a block's threads of cells (a cube tile: 16 x 16), each
  // thread keeps one (y, x) column, so its y and x lookups are made once.
  constexpr int kPer = kPyrTileCells / kThreads;
  int v[kPer], pix[kPer];  // each cell's magnitude and pixel (n < 2^31; -1: none)
  if (xy <= 8) {
    const int col = t & ((1 << xy) - 1);
    const int py = __ldg(iy + (col >> fb[2])), px = __ldg(ix + (col & ((1 << fb[2]) - 1)));
    const int at = py * a.dims[2] + px;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = t + u * kThreads;
      const int pz = c < cells ? __ldg(iz + (c >> xy)) : -1;
      pix[u] = (pz | py | px) >= 0 ? pz * plane + at : -1;
      v[u] = pix[u] >= 0 ? __ldg(a.mags + pix[u]) : 0;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = t + u * kThreads;
      pix[u] = -1;
      if (c < cells) {
        const int pz = __ldg(iz + (c >> xy)), py = __ldg(iy + ((c >> fb[2]) & ((1 << fb[1]) - 1))),
                  px = __ldg(ix + (c & ((1 << fb[2]) - 1)));
        if ((pz | py | px) >= 0) pix[u] = pz * plane + py * a.dims[2] + px;
      }
      v[u] = pix[u] >= 0 ? __ldg(a.mags + pix[u]) : 0;
    }
  }
  const bool keep_deep = a.levels <= a.lmax || a.levels == a.top;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int c = t + u * kThreads;
    if (c < cells) {
      const int p = msbp1(v[u]);
      cell[c] = (uint8_t)p;
      if (pix[u] >= 0) a.pm[pix[u]] = (uint8_t)p;
      if (keep_deep) a.flat[pyr_cell(a, a.levels, o, fb, c)] = (uint8_t)p;
    }
  }
  uint8_t* fine = cell;
  for (int d = a.levels - 1; d >= a.top; --d) {
    int cb[3], f[3];
    for (int k = 0; k < 3; ++k) {
      cb[k] = min(d, a.depth[k]) - tb[k];
      f[k] = fb[k] - cb[k];  // 1 where the axis halves
    }
    uint8_t* coarse = fine + (1 << (fb[0] + fb[1] + fb[2]));
    const bool keep = d <= a.lmax || d == a.top;
    __syncthreads();
    for (int c = t; c < 1 << (cb[0] + cb[1] + cb[2]); c += kThreads) {
      const int v = pool8([&](int i) { return (int)fine[i]; }, fb, f, c >> (cb[1] + cb[2]),
                          (c >> cb[2]) & ((1 << cb[1]) - 1), c & ((1 << cb[2]) - 1));
      coarse[c] = (uint8_t)v;
      if (keep) a.flat[pyr_cell(a, d, o, cb, c)] = (uint8_t)v;
    }
    fine = coarse;
    for (int k = 0; k < 3; ++k) fb[k] = cb[k];
  }
  // the done counter, as a grid barrier takes it: the block's writes, then
  // one thread's fence and atomic
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(reinterpret_cast<unsigned*>(a.zw), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: levels top-1 .. 0 from level top, each read from device memory
  for (int d = a.top - 1; d >= 0; --d) {
    int cb[3], f[3], gb[3];
    for (int k = 0; k < 3; ++k) {
      cb[k] = min(d, a.depth[k]);
      gb[k] = min(d + 1, a.depth[k]);
      f[k] = gb[k] - cb[k];
    }
    const uint8_t* src = a.flat + a.off[d + 1];
    for (int c = t; c < 1 << (cb[0] + cb[1] + cb[2]); c += kThreads) {
      const int v = pool8([&](int i) { return (int)__ldcg(src + i); }, gb, f, c >> (cb[1] + cb[2]),
                          (c >> cb[2]) & ((1 << cb[1]) - 1), c & ((1 << cb[2]) - 1));
      a.flat[a.off[d] + c] = (uint8_t)v;
    }
    __syncthreads();
  }
  if (t == 0) {
    *a.num_bp = __ldcg(a.flat + a.off[0]);
    a.zw[0] = 0;
  }
}

// Launch 2: thread k < ceil(n / 4) takes pixels 4k .. 4k+3: s from the
// tiles' msb+1 bytes, e from the level and box of each pixel's parent (its
// axes' slots and single depths), with 16-byte stores where the rows
// allow; the threads past them four nodes' maxima each, through nm_src.
__global__ void __launch_bounds__(kThreads) pyramid_finish(const SchedPyramid a) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long quads = (a.n + 3) >> 2;
  if (k < quads) {
    const int nb = *a.num_bp;
    const unsigned nx = a.dims[2], ny = a.dims[1];
    const long long i0 = 4 * k;
    unsigned r = (unsigned)i0 / nx, x = (unsigned)i0 - r * nx, z = r / ny, y = r - z * ny;
    int wz = __ldg(a.axes + a.px[0] + z), wy = __ldg(a.axes + a.px[1] + y);
    const bool whole = i0 + 4 <= a.n;
    unsigned pw = 0;  // the four pixels' msb+1, a byte each
    if (whole) {
      pw = *reinterpret_cast<const unsigned*>(a.pm + i0);
    } else {
      for (int j = 0; j < 4; ++j) pw |= i0 + j < a.n ? (unsigned)a.pm[i0 + j] << (8 * j) : 0u;
    }
    int sv[4], ev[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int wx = __ldg(a.axes + a.px[2] + x);
      const int pd = max(wz & 255, max(wy & 255, wx & 255));
      const int p = pd > 0 ? pd - 1 : 0;  // the parent's level
      const int dz = min(p, a.depth[0]), dy = min(p, a.depth[1]), dx = min(p, a.depth[2]);
      const long long bz = (wz >> 8) >> (a.depth[0] - dz), by = (wy >> 8) >> (a.depth[1] - dy),
                      bx = (wx >> 8) >> (a.depth[2] - dx);
      sv[j] = sched_of((pw >> (8 * j)) & 255, nb);
      ev[j] = sched_of(a.flat[a.off[p] + ((bz << (dy + dx)) | (by << dx) | bx)], nb);
      if (j < 3 && ++x == nx) {  // the next pixel starts a row
        x = 0;
        if (++y == ny) y = 0, ++z;
        if (i0 + j + 1 < a.n) {
          wz = __ldg(a.axes + a.px[0] + z);
          wy = __ldg(a.axes + a.px[1] + y);
        }
      }
    }
    if (whole) {
      *reinterpret_cast<int4*>(a.s + i0) = make_int4(sv[0], sv[1], sv[2], sv[3]);
      *reinterpret_cast<int4*>(a.e + i0) = make_int4(ev[0], ev[1], ev[2], ev[3]);
    } else {
      for (int j = 0; j < 4; ++j)
        if (i0 + j < a.n) a.s[i0 + j] = sv[j], a.e[i0 + j] = ev[j];
    }
  } else if (4 * (k - quads) < a.nn) {
    const long long j0 = 4 * (k - quads);
    if (j0 + 4 <= a.nn && (reinterpret_cast<uintptr_t>(a.nm_src) & 15) == 0) {
      const int4 src = __ldg(reinterpret_cast<const int4*>(a.nm_src + j0));
      *reinterpret_cast<int4*>(a.nm + j0) = make_int4(a.flat[src.x], a.flat[src.y], a.flat[src.z], a.flat[src.w]);
    } else {
      for (long long j = j0; j < j0 + 4 && j < a.nn; ++j) a.nm[j] = a.flat[__ldg(a.nm_src + j)];
    }
  }
}

unsigned blocks_for(long long count) { return (unsigned)((count + kThreads - 1) / kThreads); }

}  // namespace

// Launch 1 of the power-of-two cube schedule: mags (2^K)^3 int32 (8-byte
// aligned) -> pm8 (n bytes), grids K-1 .. max(K-4, 0) of the morton pyramid
// M (bytes, grid g at (8^g - 1) / 7), num_bp raised by atomicMax (the
// caller zeroes it).
extern "C" int sperr_sched_boxmax(const int32_t* mags, uint8_t* pm8, uint8_t* M, int32_t* num_bp,
                                  int K, cudaStream_t stream) {
  if (K < 1 || K > 10) return (int)cudaErrorInvalidValue;
  const int j = K - 1 < 3 ? K - 1 : 3;
  const unsigned grid = 1u << (3 * (K - 1 - j));
  sched_boxmax<<<grid, 1u << (3 * j), 0, stream>>>(mags, pm8, M, num_bp, K, j);
  return (int)cudaGetLastError();
}

// Launch 2: s, e (n int32 each) from pm8 and *num_bp; the rest of the
// pyramid; nm (nn int32) through nseg segments (g, lo, hi, out) of segs.
extern "C" int sperr_sched_virtual(const uint8_t* pm8, uint8_t* M, const int32_t* num_bp,
                                   const int32_t* segs, int nseg, int32_t* s, int32_t* e,
                                   int32_t* nm, int K, long long nn, cudaStream_t stream) {
  if (K < 1 || K > 10 || nseg < 1 || nseg > kMaxSegs || nn < 1) return (int)cudaErrorInvalidValue;
  const int gmin = K - 1 < 3 ? 0 : K - 4;
  const long long nb_se = blocks_for(1LL << (3 * (K - 1)));
  const long long grid = 1 + nb_se + blocks_for(nn);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sched_virtual<<<(unsigned)grid, kThreads, 0, stream>>>(pm8, M, num_bp, segs, nseg, s, e, nm, K,
                                                          gmin, nb_se, nn);
  return (int)cudaGetLastError();
}

// The child-table schedule: nm and num_bp (table_subtrees), then s, e and,
// where a->iset_s, iset_s (table_pixels): two launches.
// a->zw: kZeroWords + a->nblk[1] zeroed int32 words, left zeroed.
extern "C" int sperr_sched_table(const SchedTable* a, cudaStream_t stream) {
  bool ok = a->n >= 1 && a->levels >= 1 && a->levels <= 2 && a->nroots >= 1 && a->ny >= 1 && a->nx >= 1
            && a->nx <= 0x7FFFFFFF - kPixTile && (long long)a->ny * a->nx == a->n
            && a->smem >= 0 && a->smem <= 48 * 1024 && (!a->iset_s || (a->xf >= 0 && a->xf <= kMaxIset)) && (a->levels == 1 || a->links)
            && a->leaf && a->depth >= 1 && a->depth <= kMaxDepth && a->cut[0] + a->nsub[0] == a->depth;
  for (int v = 0; v < a->levels && ok; ++v)
    ok = a->nblk[v] >= 1 && a->nsub[v] >= 1 && a->cut[v] >= 0 && a->cut[v] + a->nsub[v] <= kMaxDepth
         && 4 * a->nsub[v] <= kThreads && (v == 0 || a->cut[v] + a->nsub[v] == a->cut[0]);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  table_subtrees<<<a->nblk[0], kThreads, a->smem, stream>>>(*a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a->nx + kPixTile - 1) / kPixTile), (unsigned)(a->ny < 65535 ? a->ny : 65535));
  if (a->iset_s) table_pixels<true><<<grid, kThreads, 0, stream>>>(*a);
  else table_pixels<false><<<grid, kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// The pyramid schedule: two launches (the tiles, then s, e and nm), no fill.
extern "C" int sperr_sched_pyramid(const SchedPyramid* a, cudaStream_t stream) {
  bool ok = a->n >= 1 && a->n < 0x7FFFFFFFLL && a->nn >= 1 && a->levels >= 0 && a->levels <= kPyrLevels
            && a->top >= 0 && a->top <= a->levels && a->lmax >= 0 && a->lmax <= a->levels;
  int tile_bits = 0, top_bits = 0;
  for (int k = 0; k < 3 && ok; ++k) {
    ok = a->depth[k] >= 0 && a->depth[k] <= a->levels && a->dims[k] >= 1;
    const int tb = a->top < a->depth[k] ? a->top : a->depth[k];
    top_bits += tb;
    tile_bits += a->depth[k] - tb;
  }
  if (!ok || (1 << tile_bits) > kPyrTileCells || top_bits > 30) return (int)cudaErrorInvalidValue;
  pyramid_tiles<<<1u << top_bits, kThreads, 0, stream>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pyramid_finish<<<blocks_for((a->n + 3) / 4 + (a->nn + 3) / 4), kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
