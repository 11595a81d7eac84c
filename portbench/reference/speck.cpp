// Native SPECK integer bitplane coders (1D/2D/3D x u8/u16/u32/u64).
//
// The benchmark's copy: the JAX package's sperr_tpu/runtime/native/speck.cpp,
// the reference implementation of the format, cut to its decoder.  The
// encoder's entry point, the sparse 1D coder and the control-only parse are
// removed; the coder classes keep their encoder branches (ENC), which the
// one entry point left, st_speck_decode, never instantiates.
//
// From-scratch implementation of the SPERR stream format for the sperr_tpu
// framework's host entropy stage.  The emitted bit sequence is normative
// (byte-identical to NCAR/SPERR; see NCAR/SPERR src/SPECK_INT.cpp and
// SPECK{1,2,3}D_INT*.cpp for the behavioral spec, and this repo's
// sperr_tpu/codec/speck_int_np.py for the validated reference engine).
//
// Design notes (why this is fast):
//  * significance tests run over an "msb+1" byte array (0 == zero coeff) in
//    Morton order for 3D, scanned 8 bytes at a time with a SWAR
//    any-byte->=t test (values <= 64, so the carry trick is exact);
//  * LIP/LSP are 64-bit bitmap words walked with countr_zero;
//  * the bit buffer is a flat u64 vector, LSB-first (the stream format).
//
// Exposed as a flat C ABI consumed via ctypes; calls release the GIL, so a
// Python thread pool scales chunk encoding across host cores.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#if defined(__GNUC__)
#define ST_INLINE inline __attribute__((always_inline))
#else
#define ST_INLINE inline
#endif

namespace {

// Allocator that default-initializes (no zeroing for trivial types): big
// scratch buffers that are fully overwritten skip a redundant memory sweep.
template <typename T>
class NoInit {
 public:
  using value_type = T;
  NoInit() = default;
  template <class U>
  constexpr NoInit(const NoInit<U>&) noexcept {}
  T* allocate(size_t n) { return std::allocator<T>{}.allocate(n); }
  void deallocate(T* p, size_t n) { std::allocator<T>{}.deallocate(p, n); }
  template <class U>
  void construct(U* p) noexcept {
    ::new (static_cast<void*>(p)) U;
  }
  template <class U, class... Args>
  void construct(U* p, Args&&... args) {
    ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
  }
};
template <class T, class U>
bool operator==(const NoInit<T>&, const NoInit<U>&) {
  return true;
}
template <class T, class U>
bool operator!=(const NoInit<T>&, const NoInit<U>&) {
  return false;
}
template <typename T>
using rvec = std::vector<T, NoInit<T>>;

// ----------------------------------------------------------------- bit io --
struct BitSink {
  std::vector<uint64_t> words;
  uint64_t cur = 0;
  unsigned fill = 0;
  size_t nbits = 0;

  void reserve_bits(size_t n) { words.reserve((n + 63) / 64); }
  ST_INLINE void put(bool b) {
    cur |= uint64_t(b) << fill;
    ++nbits;
    if (++fill == 64) {
      words.push_back(cur);
      cur = 0;
      fill = 0;
    }
  }
  void seal() {
    if (fill) {
      words.push_back(cur);
      cur = 0;
      fill = 0;
    }
  }
  // Copy the first `bits` bits into `dst` as bytes.
  void emit(uint8_t* dst, size_t bits) const {
    size_t nbytes = (bits + 7) / 8;
    size_t full = nbytes / 8;
    if (full) std::memcpy(dst, words.data(), full * 8);
    if (size_t rem = nbytes - full * 8) {
      uint64_t w = full < words.size() ? words[full] : 0;
      std::memcpy(dst + full * 8, &w, rem);
    }
  }
};

struct BitSource {
  std::vector<uint64_t> words;  // zero-padded past avail
  size_t pos = 0;

  void load(const uint8_t* p, size_t avail_bits, size_t total_bits) {
    size_t need = (total_bits + 63) / 64 + 4;  // slack: reads never exceed total
    words.assign(need, 0);
    std::memcpy(words.data(), p, (avail_bits + 7) / 8);
    if (avail_bits < total_bits) {
      // Zero any tail bits of the last partial byte beyond avail.
      size_t w = avail_bits / 64, r = avail_bits % 64;
      if (r) words[w] &= (uint64_t(1) << r) - 1;
      for (size_t i = w + 1; i < need; i++) words[i] = 0;
    }
  }
  ST_INLINE bool get() {
    bool b = (words[pos >> 6] >> (pos & 63)) & 1;
    ++pos;
    return b;
  }
};

// -------------------------------------------------------------- utilities --
ST_INLINE int msb_pos(uint64_t v) { return 63 - __builtin_clzll(v); }  // v != 0

// Any byte in [p, p+n) >= t?  (bytes <= 64, 1 <= t <= 65)
ST_INLINE bool any_byte_ge(const uint8_t* p, size_t n, unsigned t) {
  const uint64_t k = uint64_t(128 - t) * 0x0101010101010101ull;
  const uint64_t hi = 0x8080808080808080ull;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    if ((w + k) & hi) return true;
    p += 8;
    n -= 8;
  }
  for (size_t i = 0; i < n; i++)
    if (p[i] >= t) return true;
  return false;
}

// Max byte in [p, p+n).  Auto-vectorizes to packed unsigned byte max.
ST_INLINE uint8_t max_byte(const uint8_t* p, size_t n) {
  uint8_t m = 0;
  for (size_t i = 0; i < n; i++) m = p[i] > m ? p[i] : m;
  return m;
}

// First index with byte >= t, or -1.
ST_INLINE int64_t first_byte_ge(const uint8_t* p, size_t n, unsigned t) {
  const uint64_t k = uint64_t(128 - t) * 0x0101010101010101ull;
  const uint64_t hi = 0x8080808080808080ull;
  size_t i = 0;
  while (i + 8 <= n) {
    uint64_t w;
    std::memcpy(&w, p + i, 8);
    uint64_t m = (w + k) & hi;
    if (m) return int64_t(i) + (__builtin_ctzll(m) >> 3);
    i += 8;
  }
  for (; i < n; i++)
    if (p[i] >= t) return int64_t(i);
  return -1;
}

size_t num_of_xforms(size_t len) {
  size_t num = 0;
  while (len >= 9) {
    ++num;
    len -= len / 2;
  }
  return num < 6 ? num : 6;
}

size_t num_of_partitions(size_t len) {
  size_t num = 0;
  while (len > 1) {
    ++num;
    len -= len / 2;
  }
  return num;
}

void approx_detail(size_t len, size_t lev, size_t* lo, size_t* hi) {
  size_t l = len, h = 0;
  for (size_t i = 0; i < lev; i++) {
    h = l / 2;
    l -= h;
  }
  *lo = l;
  *hi = h;
}

bool can_use_dyadic(size_t nx, size_t ny, size_t nz, size_t* lev) {
  if (nz < 2 || ny < 2) return false;
  size_t xy = num_of_xforms(nx < ny ? nx : ny);
  size_t z = num_of_xforms(nz);
  if (xy == z || (xy >= 5 && z >= 5)) {
    *lev = xy < z ? xy : z;
    return true;
  }
  return false;
}

// ------------------------------------------------------------- bitmask ops --
struct Mask {
  std::vector<uint64_t> w;
  size_t nbits = 0;
  void init(size_t n) {
    nbits = n;
    w.assign((n + 63) / 64, 0);
  }
  ST_INLINE void set(size_t i) { w[i >> 6] |= uint64_t(1) << (i & 63); }
  ST_INLINE void clr(size_t i) { w[i >> 6] &= ~(uint64_t(1) << (i & 63)); }
};

// =================================================================== 3D ====
struct Set3 {
  uint64_t morton = 0;
  uint16_t sx = 0, sy = 0, sz = 0, lx = 0, ly = 0, lz = 0;
  // ENC only: memoized max of msb+1 over the set (static during encode), so
  // per-bitplane significance decisions are O(1) instead of re-scanning the
  // morton range every pass.
  uint8_t mx = 0;
  ST_INLINE size_t nelem() const { return size_t(lx) * ly * lz; }
};

ST_INLINE void split2(uint32_t len, uint32_t* a, uint32_t* d) {
  *d = len / 2;
  *a = len - *d;
}

// Partition into 8 octants, x fastest; returns next level.
ST_INLINE uint32_t partition_xyz(const Set3& s, uint32_t lev, Set3 out[8]) {
  uint32_t ax, dx, ay, dy, az, dz;
  split2(s.lx, &ax, &dx);
  split2(s.ly, &ay, &dy);
  split2(s.lz, &az, &dz);
  lev += (dx != 0) + (dy != 0) + (dz != 0);
  const uint16_t x0 = s.sx, x1 = s.sx + ax, y0 = s.sy, y1 = s.sy + ay, z0 = s.sz,
                 z1 = s.sz + az;
  out[0] = {0, x0, y0, z0, (uint16_t)ax, (uint16_t)ay, (uint16_t)az, 0};
  out[1] = {0, x1, y0, z0, (uint16_t)dx, (uint16_t)ay, (uint16_t)az, 0};
  out[2] = {0, x0, y1, z0, (uint16_t)ax, (uint16_t)dy, (uint16_t)az, 0};
  out[3] = {0, x1, y1, z0, (uint16_t)dx, (uint16_t)dy, (uint16_t)az, 0};
  out[4] = {0, x0, y0, z1, (uint16_t)ax, (uint16_t)ay, (uint16_t)dz, 0};
  out[5] = {0, x1, y0, z1, (uint16_t)dx, (uint16_t)ay, (uint16_t)dz, 0};
  out[6] = {0, x0, y1, z1, (uint16_t)ax, (uint16_t)dy, (uint16_t)dz, 0};
  out[7] = {0, x1, y1, z1, (uint16_t)dx, (uint16_t)dy, (uint16_t)dz, 0};
  uint64_t m = s.morton;
  for (int i = 0; i < 8; i++) {
    out[i].morton = m;
    m += out[i].nelem();
  }
  return lev;
}

template <bool ENC, typename U>
struct Codec3D {
  size_t nx, ny, nz, n;
  // ENC: working values (mutated by refinement) — borrowed from the caller
  // when the buffer is disposable, else copied into coeff_store.
  // DEC: the caller's output buffer.
  U* cf = nullptr;
  rvec<U> coeff_store;
  rvec<uint8_t> msb;             // ENC only: msb+1 per coeff, Morton order
  const uint8_t* signs_in = nullptr;  // ENC
  uint8_t* signs_out = nullptr;       // DEC (preset to 1)
  Mask lip, lsp;
  std::vector<uint64_t> lsp_new;
  std::vector<std::vector<Set3>> lis;
  BitSink sink;
  BitSource src;
  size_t budget = SIZE_MAX;
  size_t avail_bits = 0;
  uint64_t total_bits = 0;
  U threshold = 0;
  unsigned thr_msbp1 = 0;  // msb(threshold)+1
  uint8_t num_bitplanes = 0;
  // DEC control-only mode (hybrid device decode): parse LIP/LIS control
  // bits, SKIP refinement segments (their lengths are the LSP population,
  // known from state), and record per-pixel significance passes + each
  // pass's refinement bit offset/availability — the device reconstructs
  // magnitudes from these (reference decode loop: SPECK_INT.cpp:166-228;
  // here only the set walk stays bit-serial).
  uint8_t* spass_out = nullptr;       // 255 = never significant
  uint64_t* ref_off_out = nullptr;    // [num_bitplanes] bit offsets
  uint64_t* ref_avail_out = nullptr;  // [num_bitplanes] bits present
  unsigned cur_bp = 0;

  // ---- initialization ----------------------------------------------------
  void init_lists() {
    size_t levels =
        num_of_partitions(nx) + num_of_partitions(ny) + num_of_partitions(nz) + 1;
    lis.assign(levels, {});
    Set3 big{0, 0, 0, 0, (uint16_t)nx, (uint16_t)ny, (uint16_t)nz};
    uint32_t cur = 0;
    size_t dy_lev = 0;
    Set3 subs[8];
    if (can_use_dyadic(nx, ny, nz, &dy_lev)) {
      for (size_t i = 0; i < dy_lev; i++) {
        uint32_t nl = partition_xyz(big, cur, subs);
        big = subs[0];
        for (int k = 1; k < 8; k++) lis[nl].push_back(subs[k]);
        cur = nl;
      }
    } else {
      size_t xf_xy = num_of_xforms(nx < ny ? nx : ny);
      size_t xf_z = num_of_xforms(nz);
      size_t xf = 0;
      while (xf < xf_xy && xf < xf_z) {
        uint32_t nl = partition_xyz(big, cur, subs);
        big = subs[0];
        for (int k = 1; k < 8; k++) lis[nl].push_back(subs[k]);
        cur = nl;
        xf++;
      }
      while (xf < xf_xy) {  // split X and Y only
        uint32_t ax, dx, ay, dy_;
        split2(big.lx, &ax, &dx);
        split2(big.ly, &ay, &dy_);
        uint32_t nl = cur + (dx != 0) + (dy_ != 0);
        Set3 s1{0, (uint16_t)(big.sx + ax), big.sy, big.sz, (uint16_t)dx, (uint16_t)ay, big.lz};
        Set3 s2{0, big.sx, (uint16_t)(big.sy + ay), big.sz, (uint16_t)ax, (uint16_t)dy_, big.lz};
        Set3 s3{0, (uint16_t)(big.sx + ax), (uint16_t)(big.sy + ay), big.sz, (uint16_t)dx,
                (uint16_t)dy_, big.lz};
        big.lx = ax;
        big.ly = ay;
        lis[nl].push_back(s1);
        lis[nl].push_back(s2);
        lis[nl].push_back(s3);
        cur = nl;
        xf++;
      }
      while (xf < xf_z) {  // split Z only
        uint32_t az, dz;
        split2(big.lz, &az, &dz);
        uint32_t nl = cur + (dz != 0);
        Set3 s1{0, big.sx, big.sy, (uint16_t)(big.sz + az), big.lx, big.ly, (uint16_t)dz};
        big.lz = az;
        lis[nl].push_back(s1);
        cur = nl;
        xf++;
      }
    }
    lis[cur].insert(lis[cur].begin(), big);

    if constexpr (ENC) {  // assign Morton ranges + deposit msb values
      msb.resize(n);
      uint64_t off = 0;
      for (size_t t = lis.size(); t-- > 0;) {
        for (auto& s : lis[t]) {
          s.morton = off;
          s.mx = deposit(s);
          off += s.nelem();
        }
      }
    }
  }

  uint8_t deposit(const Set3& s) {
    // Lay msb+1 of every coeff in `s` into msb[] in recursive-partition order;
    // returns the max over the set (memoized significance).
    const size_t ne = s.nelem();
    if (ne == 0) return 0;
    if (s.lx == 2 && s.ly == 2 && s.lz <= 2) {
      // Common tails: unrolled x-fastest order per z-layer.
      size_t base = size_t(s.sz) * nx * ny + size_t(s.sy) * nx + s.sx;
      uint64_t m = s.morton;
      uint8_t mx = 0;
      for (unsigned z = 0; z < s.lz; z++) {
        size_t id = base + z * nx * ny;
        uint8_t a = val_msbp1(id), b = val_msbp1(id + 1), c = val_msbp1(id + nx),
                d = val_msbp1(id + nx + 1);
        msb[m++] = a;
        msb[m++] = b;
        msb[m++] = c;
        msb[m++] = d;
        uint8_t ab = a > b ? a : b, cd = c > d ? c : d;
        uint8_t e = ab > cd ? ab : cd;
        mx = e > mx ? e : mx;
      }
      return mx;
    }
    if (ne == 1) {
      uint8_t v = val_msbp1(size_t(s.sz) * nx * ny + size_t(s.sy) * nx + s.sx);
      msb[s.morton] = v;
      return v;
    }
    Set3 subs[8];
    partition_xyz(s, 0, subs);
    uint8_t mx = 0;
    for (int i = 0; i < 8; i++) {
      uint8_t v = deposit(subs[i]);
      mx = v > mx ? v : mx;
    }
    return mx;
  }

  ST_INLINE uint8_t val_msbp1(size_t idx) const {
    U v = cf[idx];
    return v ? uint8_t(msb_pos(v) + 1) : 0;
  }

  // ---- passes --------------------------------------------------------------
  ST_INLINE void process_p(size_t idx, uint64_t morton, size_t& counter, bool decide) {
    bool sig;
    if constexpr (ENC) {
      sig = decide ? (msb[morton] >= thr_msbp1) : true;
      if (decide) sink.put(sig);
      if (sig) {
        ++counter;
        sink.put(signs_in[idx] != 0);
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    } else {
      sig = decide ? src.get() : true;
      if (sig) {
        ++counter;
        signs_out[idx] = src.get();
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    }
  }

  ST_INLINE void process_p_lite(size_t idx) {
    if constexpr (ENC) {
      bool sig = cf[idx] >= threshold;
      sink.put(sig);
      if (sig) {
        sink.put(signs_in[idx] != 0);
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    } else {
      if (src.get()) {
        signs_out[idx] = src.get();
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    }
  }

  void process_s(size_t lev, size_t i, size_t& counter, bool decide) {
    Set3& s = lis[lev][i];
    bool sig;
    if constexpr (ENC) {
      sig = decide ? (s.mx >= thr_msbp1) : true;
      if (decide) sink.put(sig);
    } else {
      sig = decide ? src.get() : true;
    }
    if (sig) {
      ++counter;
      code_s(lev, i);
      lis[lev][i].lx = 0;  // mark empty (code_s may reallocate; re-index)
    }
  }

  void code_s(size_t lev, size_t i) {
    Set3 s = lis[lev][i];
    if (s.lx == 2 && s.ly == 2 && s.lz == 2) {
      size_t counter = 0;
      size_t id = size_t(s.sz) * nx * ny + size_t(s.sy) * nx + s.sx;
      uint64_t m = s.morton;
      const size_t off[8] = {0,           1,           nx,          nx + 1,
                             nx * ny,     nx * ny + 1, nx * ny + nx, nx * ny + nx + 1};
      for (int k = 0; k < 8; k++) {
        bool decide = k < 7 ? true : (counter != 0);
        lip.set(id + off[k]);
        process_p(id + off[k], m + k, counter, decide);
      }
      return;
    }
    Set3 subs[8];
    uint32_t nl = partition_xyz(s, (uint32_t)lev, subs);
    Set3 keep[8];
    int nk = 0;
    for (int k = 0; k < 8; k++)
      if (subs[k].nelem() != 0) keep[nk++] = subs[k];
    size_t counter = 0;
    for (int k = 0; k < nk; k++) {
      bool decide = (counter != 0) || (k + 1 != nk);
      if (keep[k].nelem() == 1) {
        size_t idx =
            size_t(keep[k].sz) * nx * ny + size_t(keep[k].sy) * nx + keep[k].sx;
        lip.set(idx);
        process_p(idx, keep[k].morton, counter, decide);
      } else {
        if constexpr (ENC)  // one scan at creation; O(1) tests thereafter
          keep[k].mx = max_byte(msb.data() + keep[k].morton, keep[k].nelem());
        lis[nl].push_back(keep[k]);
        process_s(nl, lis[nl].size() - 1, counter, decide);
      }
    }
  }

  void sorting_pass() {
    // LIP first: 64-bit word walk in ascending index order.
    const size_t nw = lip.w.size();
    for (size_t wi = 0; wi < nw; wi++) {
      uint64_t v = lip.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        process_p_lite(wi * 64 + j);
        v &= v - 1;
      }
    }
    // LIS: finest level (largest index) to coarsest.
    for (size_t t = lis.size(); t-- > 0;) {
      for (size_t i = 0; i < lis[t].size(); i++) {
        size_t dummy = 0;
        process_s(t, i, dummy, true);
      }
    }
  }

  void refinement_encode() {
    const U thr = threshold;
    const size_t nw = lsp.w.size();
    for (size_t wi = 0; wi < nw; wi++) {
      uint64_t v = lsp.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        size_t i = wi * 64 + j;
        bool o1 = cf[i] >= thr;
        cf[i] -= o1 ? thr : U(0);
        sink.put(o1);
        v &= v - 1;
      }
    }
    for (uint64_t i : lsp_new) cf[i] -= thr;  // refinement_extra
    for (uint64_t i : lsp_new) lsp.set(i);
    lsp_new.clear();
  }

  // Returns false when available bits were exhausted mid-pass.
  bool refinement_decode() {
    if (spass_out) return refinement_skip();
    size_t read_pos = src.pos;
    bool exhausted = false;
    const U half = threshold / U(2);
    const size_t nw = lsp.w.size();
    for (size_t wi = 0; wi < nw && !exhausted; wi++) {
      uint64_t v = lsp.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        size_t i = wi * 64 + j;
        if (threshold >= U(2)) {
          if (src.get())
            cf[i] += half;
          else
            cf[i] -= half;
        } else {
          if (src.get()) ++cf[i];
        }
        if (++read_pos == avail_bits) {
          exhausted = true;
          break;
        }
        v &= v - 1;
      }
    }
    U init_val = U(threshold + threshold - threshold / U(2) - U(1));
    for (uint64_t i : lsp_new) cf[i] = init_val;
    for (uint64_t i : lsp_new) lsp.set(i);
    lsp_new.clear();
    return !exhausted;
  }

  // Control-only refinement: advance past the pass's bits (the LSP
  // population, tracked incrementally — re-popcounting the mask words
  // every pass cost ~10% of the whole control parse at 256^3) without
  // touching values; record offset + availability.
  size_t lsp_cnt = 0;
  bool refinement_skip() {
    size_t cnt = lsp_cnt;
    lsp_cnt += lsp_new.size();
    size_t remain = avail_bits - src.pos;
    size_t take = cnt < remain ? cnt : remain;
    ref_off_out[cur_bp] = src.pos;
    ref_avail_out[cur_bp] = take;
    src.pos += take;
    bool exhausted = take < cnt;
    for (uint64_t i : lsp_new) spass_out[i] = uint8_t(cur_bp);
    for (uint64_t i : lsp_new) lsp.set(i);
    lsp_new.clear();
    return !exhausted;
  }

  void clean_lis() {
    for (auto& lst : lis) {
      size_t k = 0;
      for (size_t i = 0; i < lst.size(); i++)
        if (lst[i].lx != 0) lst[k++] = lst[i];
      lst.resize(k);
    }
  }

  // ---- top level -----------------------------------------------------------
  void encode() {
    auto t0 = std::chrono::steady_clock::now();
    lip.init(n);
    lsp.init(n);
    lsp_new.clear();
    lsp_new.reserve(n / 16);
    sink.reserve_bits(n);
    init_lists();
    if (std::getenv("SPERR_TPU_PROFILE"))
      std::fprintf(stderr, "[sperr_tpu] 3d init+deposit    %7.1f ms\n",
                   std::chrono::duration<double, std::milli>(
                       std::chrono::steady_clock::now() - t0).count());

    // num_bitplanes = msb(max coeff)+1, from the deposit's memoized
    // per-set maxima (no extra full scan)
    unsigned maxb = 0;
    for (auto& lst : lis)
      for (auto& s : lst) maxb = s.mx > maxb ? s.mx : maxb;
    if (maxb == 0) {
      num_bitplanes = 0;
      total_bits = 0;
      return;
    }
    num_bitplanes = uint8_t(maxb);
    threshold = U(maxb >= 64 ? ~U(0) - (~U(0) >> 1) : U(U(1) << (maxb - 1)));
    for (unsigned bp = 0; bp < num_bitplanes; bp++) {
      thr_msbp1 = msb_pos(uint64_t(threshold)) + 1;
      sorting_pass();
      if (sink.nbits >= budget) break;
      refinement_encode();
      if (sink.nbits >= budget) break;
      threshold = U(threshold / U(2));
      clean_lis();
    }
    total_bits = sink.nbits;
    sink.seal();
  }

  void decode() {
    lip.init(n);
    lsp.init(n);
    lsp_new.clear();
    if (!spass_out) std::memset(cf, 0, n * sizeof(U));
    init_lists();
    if (num_bitplanes == 0) return;
    threshold = 1;
    for (unsigned i = 1; i < num_bitplanes; i++) threshold = U(threshold * U(2));
    for (unsigned bp = 0; bp < num_bitplanes; bp++) {
      cur_bp = bp;
      sorting_pass();
      if (src.pos >= avail_bits) break;
      if (!refinement_decode()) break;
      if (src.pos >= avail_bits) break;
      threshold = U(threshold / U(2));
      clean_lis();
    }
    if (!lsp_new.empty()) {
      if (spass_out) {
        for (uint64_t i : lsp_new) spass_out[i] = uint8_t(cur_bp);
      } else {
        U init_val = U(threshold + threshold - threshold / U(2) - U(1));
        for (uint64_t i : lsp_new) cf[i] = init_val;
      }
      lsp_new.clear();
    }
  }
};

// =================================================================== 2D ====
struct Set2 {
  uint32_t sx = 0, sy = 0, lx = 0, ly = 0;
  uint8_t mx = 0;  // ENC only: memoized max msb+1 over the set
};

template <bool ENC, typename U>
struct Codec2D {
  size_t nx, ny, n;
  std::vector<U> coeff;
  rvec<uint8_t> msb;  // row-major msb+1 (ENC)
  const uint8_t* signs_in = nullptr;
  uint8_t* signs_out = nullptr;
  Mask lip, lsp;
  std::vector<uint64_t> lsp_new;
  std::vector<std::vector<Set2>> lis;
  // I-set state
  uint32_t i_sx = 0, i_sy = 0;
  int i_lev = 0;
  uint8_t i_mx = 0;  // ENC: memoized max over the I-set (recomputed on shrink)
  BitSink sink;
  BitSource src;
  size_t budget = SIZE_MAX;
  size_t avail_bits = 0;
  uint64_t total_bits = 0;
  U threshold = 0;
  unsigned thr_msbp1 = 0;
  uint8_t num_bitplanes = 0;

  void init_lists() {
    size_t levels = num_of_partitions(nx > ny ? nx : ny) + 1;
    lis.assign(levels, {});
    size_t xf = num_of_xforms(nx < ny ? nx : ny);
    size_t ax, dx_, ay, dy_;
    approx_detail(nx, xf, &ax, &dx_);
    approx_detail(ny, xf, &ay, &dy_);
    lis[xf].push_back({0, 0, (uint32_t)ax, (uint32_t)ay});
    i_sx = ax;
    i_sy = ay;
    i_lev = (int)xf;
    if constexpr (ENC) {
      msb.resize(n);
      for (size_t i = 0; i < n; i++) {
        U v = coeff[i];
        msb[i] = v ? uint8_t(msb_pos(uint64_t(v)) + 1) : 0;
      }
      lis[xf][0].mx = rect_max(lis[xf][0]);
      i_mx = iset_max();
    }
  }

  ST_INLINE uint8_t rect_max(const Set2& s) const {
    uint8_t m = 0;
    for (uint32_t y = s.sy; y < s.sy + s.ly; y++) {
      uint8_t v = max_byte(msb.data() + size_t(y) * nx + s.sx, s.lx);
      m = v > m ? v : m;
    }
    return m;
  }

  uint8_t iset_max() const {
    size_t start = size_t(i_sy) * nx;
    uint8_t m = max_byte(msb.data() + start, n - start);
    size_t len = nx - i_sx;
    for (uint32_t y = 0; y < i_sy; y++) {
      uint8_t v = max_byte(msb.data() + size_t(y) * nx + i_sx, len);
      m = v > m ? v : m;
    }
    return m;
  }

  ST_INLINE void process_p(size_t idx, size_t& counter, bool decide) {
    bool sig;
    if constexpr (ENC) {
      sig = decide ? (msb[idx] >= thr_msbp1) : true;
      if (decide) sink.put(sig);
      if (sig) {
        ++counter;
        sink.put(signs_in[idx] != 0);
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    } else {
      sig = decide ? src.get() : true;
      if (sig) {
        ++counter;
        signs_out[idx] = src.get();
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    }
  }

  void process_s(size_t lev, size_t i, size_t& counter, bool decide) {
    bool sig;
    if constexpr (ENC) {
      sig = decide ? (lis[lev][i].mx >= thr_msbp1) : true;
      if (decide) sink.put(sig);
    } else {
      sig = decide ? src.get() : true;
    }
    if (sig) {
      ++counter;
      code_s(lev, i);
      lis[lev][i].lx = 0;
    }
  }

  void process_i(bool decide) {
    if (i_lev <= 0) return;
    bool sig;
    if constexpr (ENC) {
      sig = decide ? (i_mx >= thr_msbp1) : true;
      if (decide) sink.put(sig);
    } else {
      sig = decide ? src.get() : true;
    }
    if (sig) code_i();
  }

  void code_s(size_t lev, size_t i) {
    Set2 s = lis[lev][i];
    uint32_t ax, dx_, ay, dy_;
    split2(s.lx, &ax, &dx_);
    split2(s.ly, &ay, &dy_);
    // QccPack order: BR, BL, TR, TL.
    Set2 subs[4] = {
        {s.sx + ax, s.sy + ay, dx_, dy_},
        {s.sx, s.sy + ay, ax, dy_},
        {s.sx + ax, s.sy, dx_, ay},
        {s.sx, s.sy, ax, ay},
    };
    Set2 keep[4];
    int nk = 0;
    for (int k = 0; k < 4; k++)
      if (size_t(subs[k].lx) * subs[k].ly != 0) keep[nk++] = subs[k];
    size_t counter = 0;
    size_t nl = lev + 1;
    for (int k = 0; k < nk; k++) {
      bool decide = (counter != 0) || (k + 1 != nk);
      if (size_t(keep[k].lx) * keep[k].ly == 1) {
        size_t idx = size_t(keep[k].sy) * nx + keep[k].sx;
        lip.set(idx);
        process_p(idx, counter, decide);
      } else {
        if constexpr (ENC) keep[k].mx = rect_max(keep[k]);
        lis[nl].push_back(keep[k]);
        process_s(nl, lis[nl].size() - 1, counter, decide);
      }
    }
  }

  void code_i() {
    size_t ax, dx_, ay, dy_;
    approx_detail(nx, i_lev, &ax, &dx_);
    approx_detail(ny, i_lev, &ay, &dy_);
    // Order from the format: BR, TR, BL; all at the current I level.
    Set2 subs[3] = {
        {(uint32_t)ax, (uint32_t)ay, (uint32_t)dx_, (uint32_t)dy_},
        {(uint32_t)ax, 0, (uint32_t)dx_, (uint32_t)ay},
        {0, (uint32_t)ay, (uint32_t)ax, (uint32_t)dy_},
    };
    size_t part_lev = i_lev;
    i_sx += dx_;
    i_sy += dy_;
    i_lev--;
    if constexpr (ENC) i_mx = i_lev > 0 ? iset_max() : 0;
    size_t counter = 0;
    for (int k = 0; k < 3; k++) {
      if (size_t(subs[k].lx) * subs[k].ly != 0) {
        if constexpr (ENC) subs[k].mx = rect_max(subs[k]);
        lis[part_lev].push_back(subs[k]);
        process_s(part_lev, lis[part_lev].size() - 1, counter, true);
      }
    }
    process_i(counter != 0);
  }

  void process_p_lite(size_t idx) {
    if constexpr (ENC) {
      bool sig = coeff[idx] >= threshold;
      sink.put(sig);
      if (sig) {
        sink.put(signs_in[idx] != 0);
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    } else {
      if (src.get()) {
        signs_out[idx] = src.get();
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    }
  }

  void sorting_pass() {
    const size_t nw = lip.w.size();
    for (size_t wi = 0; wi < nw; wi++) {
      uint64_t v = lip.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        size_t dummy = 0;
        process_p(wi * 64 + j, dummy, true);
        v &= v - 1;
      }
    }
    for (size_t t = lis.size(); t-- > 0;) {
      for (size_t i = 0; i < lis[t].size(); i++) {
        size_t dummy = 0;
        process_s(t, i, dummy, true);
      }
    }
    process_i(true);
  }

  void refinement_encode() {
    const U thr = threshold;
    const size_t nw = lsp.w.size();
    for (size_t wi = 0; wi < nw; wi++) {
      uint64_t v = lsp.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        size_t i = wi * 64 + j;
        bool o1 = coeff[i] >= thr;
        coeff[i] -= o1 ? thr : U(0);
        sink.put(o1);
        v &= v - 1;
      }
    }
    for (uint64_t i : lsp_new) coeff[i] -= thr;
    for (uint64_t i : lsp_new) lsp.set(i);
    lsp_new.clear();
  }

  bool refinement_decode() {
    size_t read_pos = src.pos;
    bool exhausted = false;
    const U half = threshold / U(2);
    const size_t nw = lsp.w.size();
    for (size_t wi = 0; wi < nw && !exhausted; wi++) {
      uint64_t v = lsp.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        size_t i = wi * 64 + j;
        if (threshold >= U(2)) {
          if (src.get())
            coeff[i] += half;
          else
            coeff[i] -= half;
        } else {
          if (src.get()) ++coeff[i];
        }
        if (++read_pos == avail_bits) {
          exhausted = true;
          break;
        }
        v &= v - 1;
      }
    }
    U init_val = U(threshold + threshold - threshold / U(2) - U(1));
    for (uint64_t i : lsp_new) coeff[i] = init_val;
    for (uint64_t i : lsp_new) lsp.set(i);
    lsp_new.clear();
    return !exhausted;
  }

  void clean_lis() {
    for (auto& lst : lis) {
      size_t k = 0;
      for (size_t i = 0; i < lst.size(); i++)
        if (lst[i].lx != 0) lst[k++] = lst[i];
      lst.resize(k);
    }
  }

  void encode() {
    lip.init(n);
    lsp.init(n);
    lsp_new.clear();
    sink.reserve_bits(n);
    init_lists();
    // num_bitplanes = msb(max coeff)+1, from the deposit's memoized
    // per-set maxima (no extra full scan)
    unsigned maxb = i_mx;
    for (auto& lst : lis)
      for (auto& s : lst) maxb = s.mx > maxb ? s.mx : maxb;
    if (maxb == 0) {
      num_bitplanes = 0;
      total_bits = 0;
      return;
    }
    num_bitplanes = uint8_t(maxb);
    threshold = U(maxb >= 64 ? ~U(0) - (~U(0) >> 1) : U(U(1) << (maxb - 1)));
    for (unsigned bp = 0; bp < num_bitplanes; bp++) {
      thr_msbp1 = msb_pos(uint64_t(threshold)) + 1;
      sorting_pass();
      if (sink.nbits >= budget) break;
      refinement_encode();
      if (sink.nbits >= budget) break;
      threshold = U(threshold / U(2));
      clean_lis();
    }
    total_bits = sink.nbits;
    sink.seal();
  }

  void decode() {
    lip.init(n);
    lsp.init(n);
    lsp_new.clear();
    coeff.assign(n, 0);
    init_lists();
    if (num_bitplanes == 0) return;
    threshold = 1;
    for (unsigned i = 1; i < num_bitplanes; i++) threshold = U(threshold * U(2));
    for (unsigned bp = 0; bp < num_bitplanes; bp++) {
      sorting_pass();
      if (src.pos >= avail_bits) break;
      if (!refinement_decode()) break;
      if (src.pos >= avail_bits) break;
      threshold = U(threshold / U(2));
      clean_lis();
    }
    if (!lsp_new.empty()) {
      U init_val = U(threshold + threshold - threshold / U(2) - U(1));
      for (uint64_t i : lsp_new) coeff[i] = init_val;
      lsp_new.clear();
    }
  }
};

// =================================================================== 1D ====
struct Set1 {
  uint64_t start = 0, len = 0;
  uint8_t mx = 0;  // ENC: memoized max msb+1 over the set (set at creation)
};

template <bool ENC, typename U>
struct Codec1D {
  size_t n;
  std::vector<U> coeff;
  rvec<uint8_t> msb;  // ENC: per-coefficient msb+1 (0 for zero)
  const uint8_t* signs_in = nullptr;
  uint8_t* signs_out = nullptr;
  Mask lip, lsp;
  std::vector<uint64_t> lsp_new;
  std::vector<std::vector<Set1>> lis;
  BitSink sink;
  BitSource src;
  size_t budget = SIZE_MAX;
  size_t avail_bits = 0;
  uint64_t total_bits = 0;
  U threshold = 0;
  unsigned thr_msbp1 = 0;
  uint8_t num_bitplanes = 0;

  enum Sig { INSIG = 0, SIG = 1, DUNNO = 2 };

  void init_lists() {
    // +2 slack: a length-1 set splits into [pixel, empty] one level deeper
    // than the partition count suggests (n == 1 needs 3 levels).
    size_t levels = num_of_partitions(n) + 3;
    lis.assign(levels, {});
    uint64_t a = n - n / 2;
    lis[1].push_back({0, a});
    lis[1].push_back({a, n - a});
    if constexpr (ENC) {
      // per-set max memoization (as in the 2D/3D coders): a set's
      // significance test is one byte compare per pass instead of an
      // O(len) rescan of mostly-zero ranges every bitplane.
      msb.resize(n);
      for (size_t i = 0; i < n; i++) {
        U v = coeff[i];
        msb[i] = v ? uint8_t(msb_pos(uint64_t(v)) + 1) : 0;
      }
      lis[1][0].mx = max_byte(msb.data(), a);
      lis[1][1].mx = max_byte(msb.data() + a, n - a);
    }
  }

  void process_p(size_t idx, int sig, size_t& counter, bool output) {
    if constexpr (ENC) {
      bool is_sig = sig == DUNNO ? (coeff[idx] >= threshold) : (sig == SIG);
      if (output) sink.put(is_sig);
      if (is_sig) {
        ++counter;
        sink.put(signs_in[idx] != 0);
        coeff[idx] -= threshold;
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    } else {
      bool is_sig = output ? src.get() : true;
      if (is_sig) {
        ++counter;
        signs_out[idx] = src.get();
        lsp_new.push_back(idx);
        lip.clr(idx);
      }
    }
  }

  void process_s(size_t lev, size_t i, int sig, size_t& counter, bool output) {
    if constexpr (ENC) {
      if (sig == DUNNO)
        sig = lis[lev][i].mx >= thr_msbp1 ? SIG : INSIG;
      if (output) sink.put(sig == SIG);
      if (sig == SIG) {
        ++counter;
        code_s(lev, i);
        lis[lev][i].len = 0;
      }
    } else {
      bool is_sig = output ? src.get() : true;
      if (is_sig) {
        ++counter;
        code_s(lev, i);
        lis[lev][i].len = 0;
      }
    }
  }

  void code_s(size_t lev, size_t i) {
    Set1 s = lis[lev][i];
    uint64_t a = s.len - s.len / 2;
    Set1 s0{s.start, a}, s1{s.start + a, s.len - a};
    if constexpr (ENC) {
      if (s0.len > 1) s0.mx = max_byte(msb.data() + s0.start, s0.len);
      if (s1.len > 1) s1.mx = max_byte(msb.data() + s1.start, s1.len);
    }
    int sub_sigs[2] = {DUNNO, DUNNO};
    size_t nl = lev + 1;
    size_t counter = 0;
    bool output = true;

    if (s0.len == 1) {
      lip.set(s0.start);
      process_p(s0.start, sub_sigs[0], counter, output);
    } else {
      lis[nl].push_back(s0);
      process_s(nl, lis[nl].size() - 1, sub_sigs[0], counter, output);
    }
    if (counter == 0) {
      output = false;
      sub_sigs[1] = SIG;
    }
    if (s1.len == 1) {
      lip.set(s1.start);
      process_p(s1.start, sub_sigs[1], counter, output);
    } else {
      lis[nl].push_back(s1);
      process_s(nl, lis[nl].size() - 1, sub_sigs[1], counter, output);
    }
  }

  void sorting_pass() {
    const size_t nw = lip.w.size();
    for (size_t wi = 0; wi < nw; wi++) {
      uint64_t v = lip.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        size_t dummy = 0;
        process_p(wi * 64 + j, DUNNO, dummy, true);
        v &= v - 1;
      }
    }
    for (size_t t = lis.size(); t-- > 0;) {
      for (size_t i = 0; i < lis[t].size(); i++) {
        size_t dummy = 0;
        process_s(t, i, DUNNO, dummy, true);
      }
    }
  }

  void refinement_encode() {
    const U thr = threshold;
    const size_t nw = lsp.w.size();
    for (size_t wi = 0; wi < nw; wi++) {
      uint64_t v = lsp.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        size_t i = wi * 64 + j;
        bool o1 = coeff[i] >= thr;
        coeff[i] -= o1 ? thr : U(0);
        sink.put(o1);
        v &= v - 1;
      }
    }
    // 1D subtracts the threshold inline at significance time; only merge.
    for (uint64_t i : lsp_new) lsp.set(i);
    lsp_new.clear();
  }

  bool refinement_decode() {
    size_t read_pos = src.pos;
    bool exhausted = false;
    const U half = threshold / U(2);
    const size_t nw = lsp.w.size();
    for (size_t wi = 0; wi < nw && !exhausted; wi++) {
      uint64_t v = lsp.w[wi];
      while (v) {
        unsigned j = __builtin_ctzll(v);
        size_t i = wi * 64 + j;
        if (threshold >= U(2)) {
          if (src.get())
            coeff[i] += half;
          else
            coeff[i] -= half;
        } else {
          if (src.get()) ++coeff[i];
        }
        if (++read_pos == avail_bits) {
          exhausted = true;
          break;
        }
        v &= v - 1;
      }
    }
    U init_val = U(threshold + threshold - threshold / U(2) - U(1));
    for (uint64_t i : lsp_new) coeff[i] = init_val;
    for (uint64_t i : lsp_new) lsp.set(i);
    lsp_new.clear();
    return !exhausted;
  }

  void clean_lis() {
    for (auto& lst : lis) {
      size_t k = 0;
      for (size_t i = 0; i < lst.size(); i++)
        if (lst[i].len != 0) lst[k++] = lst[i];
      lst.resize(k);
    }
  }

  void encode() {
    lip.init(n);
    lsp.init(n);
    lsp_new.clear();
    sink.reserve_bits(n);
    init_lists();
    // num_bitplanes = msb+1 of the max magnitude = max over the msb bytes
    uint8_t mxb = max_byte(msb.data(), n);
    if (mxb == 0) {
      num_bitplanes = 0;
      total_bits = 0;
      return;
    }
    num_bitplanes = mxb;
    threshold = U(U(1) << (num_bitplanes - 1));
    thr_msbp1 = num_bitplanes;
    for (unsigned bp = 0; bp < num_bitplanes; bp++) {
      sorting_pass();
      if (sink.nbits >= budget) break;
      refinement_encode();
      if (sink.nbits >= budget) break;
      threshold = U(threshold / U(2));
      thr_msbp1--;
      clean_lis();
    }
    total_bits = sink.nbits;
    sink.seal();
  }

  void decode() {
    lip.init(n);
    lsp.init(n);
    lsp_new.clear();
    coeff.assign(n, 0);
    init_lists();
    if (num_bitplanes == 0) return;
    threshold = 1;
    for (unsigned i = 1; i < num_bitplanes; i++) threshold = U(threshold * U(2));
    for (unsigned bp = 0; bp < num_bitplanes; bp++) {
      sorting_pass();
      if (src.pos >= avail_bits) break;
      if (!refinement_decode()) break;
      if (src.pos >= avail_bits) break;
      threshold = U(threshold / U(2));
      clean_lis();
    }
    if (!lsp_new.empty()) {
      U init_val = U(threshold + threshold - threshold / U(2) - U(1));
      for (uint64_t i : lsp_new) coeff[i] = init_val;
      lsp_new.clear();
    }
  }
};


// ------------------------------------------------------------ entrypoints --
template <typename U>
int64_t decode_any(int ndim, const uint8_t* stream, uint64_t len, uint64_t nx,
                   uint64_t ny, uint64_t nz, void* mags_out, uint8_t* signs_out) {
  if (len < 9) return -2;
  size_t n = size_t(nx) * ny * nz;
  uint8_t nbp = stream[0];
  uint64_t total_bits;
  std::memcpy(&total_bits, stream + 1, 8);
  size_t avail = (len - 9) * 8;
  if (avail > total_bits) avail = total_bits;

  std::memset(signs_out, 1, n);

  auto run = [&](auto& c) {
    c.num_bitplanes = nbp;
    c.total_bits = total_bits;
    c.avail_bits = avail;
    c.signs_out = signs_out;
    c.src.load(stream + 9, avail, total_bits);
    c.decode();
    std::memcpy(mags_out, c.coeff.data(), n * sizeof(U));
  };

  if (ndim == 3) {
    Codec3D<false, U> c;
    c.nx = nx;
    c.ny = ny;
    c.nz = nz;
    c.n = n;
    c.cf = static_cast<U*>(mags_out);  // decode in place: no copy-out
    c.num_bitplanes = nbp;
    c.total_bits = total_bits;
    c.avail_bits = avail;
    c.signs_out = signs_out;
    c.src.load(stream + 9, avail, total_bits);
    c.decode();
  } else if (ndim == 2) {
    Codec2D<false, U> c;
    c.nx = nx;
    c.ny = ny;
    c.n = n;
    run(c);
  } else {
    Codec1D<false, U> c;
    c.n = n;
    run(c);
  }
  return 0;
}

}  // namespace

extern "C" {

int64_t st_speck_decode(int ndim, int width, const uint8_t* stream, uint64_t len,
                        uint64_t nx, uint64_t ny, uint64_t nz, void* mags_out,
                        uint8_t* signs_out) {
  switch (width) {
    case 8:
      return decode_any<uint8_t>(ndim, stream, len, nx, ny, nz, mags_out, signs_out);
    case 16:
      return decode_any<uint16_t>(ndim, stream, len, nx, ny, nz, mags_out, signs_out);
    case 32:
      return decode_any<uint32_t>(ndim, stream, len, nx, ny, nz, mags_out, signs_out);
    case 64:
      return decode_any<uint64_t>(ndim, stream, len, nx, ny, nz, mags_out, signs_out);
  }
  return -3;
}

}  // extern "C"
