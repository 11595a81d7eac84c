"""Prefix-pack bit emission: PyTorch port of sperr_tpu/ops/packemit.py.

The SPECK bits of a chunk are dense [pass, position] matrices of
(valid, bit) cells packed 32 to a word.  This module holds the bit
machinery that builds and packs them:

  * ``transpose_bits32`` / ``transpose_bits32_pair`` (K10): per-item 32-pass
    masks -> packed per-pass words;
  * ``masked_pack`` (K11): each word's valid bits, compacted and written at
    its byte-aligned row's stream offset;
  * ``compact_flags_rows`` (K12): ascending indices of the set flags of each
    row.

A 32-bit word is carried as the bit pattern of an int32 (torch has no
usable uint32): ``&``, ``|``, ``^``, ``~`` and ``<<`` act on the pattern as
on the unsigned word (a left shift by 32 gives 0), and ``_srl`` is the
logical right shift.  On a CUDA tensor each of K10-K12 launches its kernel
(kernels/bits.cu); on a CPU tensor it runs its plain version (the ``_ref``
functions, which the kernels equal bit for bit); elsewhere it raises.

The TPU-only helpers (``_mm_pack``, ``pack_cells_*``, ``cells_to_words``,
``_merge_level``) are not ported: the first three serve only the JAX
package's tests and its device bench, and the kernels replace the piece
merge.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels

_I32 = torch.int32


ALL_ONES = -1  # 0xFFFFFFFF


def _srl(x: torch.Tensor, k) -> torch.Tensor:
    """Logical right shift of int32 words by k in [0, 32] (an int or an
    int32 tensor); a shift by 32 gives 0."""
    if isinstance(k, int):
        if k == 0:
            return x
        if k >= 32:
            return torch.zeros_like(x)
        return (x >> k) & ((1 << (32 - k)) - 1)
    keep = ~torch.bitwise_left_shift(torch.full_like(k, ALL_ONES), 32 - k)
    return (x >> k) & keep


def _safe_rsh(x: torch.Tensor, k) -> torch.Tensor:
    """Logical x >> k with k allowed to reach 32 (yields 0 there)."""
    return _srl(x, k)


def _safe_lsh(x: torch.Tensor, k) -> torch.Tensor:
    """x << k with k allowed to reach 32 (yields 0 there)."""
    return x << k


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same low 32 bits."""
    return (v - (((v >> 31) & 1) << 32)).to(_I32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 word (SWAR, in int64 lanes), as int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).to(_I32)


def pext32(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Parallel bit extract: the bits of ``x`` at the set positions of ``m``,
    packed toward the LSB in order (Hacker's Delight 7-4, 'compress')."""
    x = x & m
    mk = (~m) << 1
    for i in range(5):
        mp = mk ^ (mk << 1)
        mp = mp ^ (mp << 2)
        mp = mp ^ (mp << 4)
        mp = mp ^ (mp << 8)
        mp = mp ^ (mp << 16)
        mv = mp & m
        m = (m ^ mv) | _srl(mv, 1 << i)
        t = x & mv
        x = (x ^ t) | _srl(t, 1 << i)
        mk = mk & ~mp
    return x


_TR_MASKS = (
    (16, 0x0000FFFF),
    (8, 0x00FF00FF),
    (4, 0x0F0F0F0F),
    (2, 0x33333333),
    (1, 0x55555555),
)


def _tr32_stages(x: torch.Tensor) -> torch.Tensor:
    """The 5 masked-swap stages over flat words (blocks of 32): exchange
    element (l, p) with (l ^ j, p ^ j) when l bit j == 0, p bit j == 1."""
    lane = torch.arange(x.shape[0], dtype=_I32, device=x.device) & 31
    for j, m in _TR_MASKS:
        sel = (lane & j) == 0
        fwd = torch.roll(x, -j)                        # x[i + j]
        t = (_srl(x, j) ^ fwd) & m                     # valid at sel positions
        tb = torch.roll(t, j)                          # t[i - j]
        x = torch.where(sel, x ^ (t << j), x ^ tb)
    return x


def _planes_into(full: torch.Tensor, out, row0: int, take: int) -> torch.Tensor:
    """Rows 0 .. take-1 of the 32 planes ``full`` into rows row0 .. row0+take-1
    of out (a new (take, W) tensor when out is None)."""
    if out is None:
        assert row0 == 0
        return full[:take].contiguous()
    out[row0 : row0 + take] = full[:take]
    return out


def transpose_bits32_ref(x: torch.Tensor, out=None, row0: int = 0, take: int = 32) -> torch.Tensor:
    """Plain K10: flat int32 x (M % 32 == 0), x[i] bit p = cell (p, i) ->
    planes 0 .. take-1 of the (32, M // 32) transpose, out[p, w] bit l =
    x[32 w + l] bit p, written into rows row0 .. row0+take-1 of out."""
    M = x.shape[0]
    assert M % 32 == 0 and 1 <= take <= 32
    full = _tr32_stages(x.to(_I32)).reshape(M // 32, 32).T
    return _planes_into(full, out, row0, take)


def transpose_bits32_pair_ref(a: torch.Tensor, b: torch.Tensor, out=None, row0: int = 0,
                              take: int = 32) -> torch.Tensor:
    """Plain K10, pair form: the transpose of the interleaved cell array
    v[2i] = a[i], v[2i+1] = b[i] (M % 16 == 0), without building it: stages
    j in {16, 8, 4, 2} act on a and b alone at half the positional
    distance, the j = 1 stage pairs (a_i, b_i) in place.  Planes 0 ..
    take-1 go to rows row0 .. row0+take-1 of out."""
    M = a.shape[0]
    assert M % 16 == 0 and 1 <= take <= 32
    a = a.to(_I32)
    b = b.to(_I32)
    lane = torch.arange(M, dtype=_I32, device=a.device) & 15
    for j, m in _TR_MASKS[:-1]:
        h = j >> 1
        sel = (lane & h) == 0
        outs = []
        for x in (a, b):
            fwd = torch.roll(x, -h)
            t = (_srl(x, j) ^ fwd) & m
            tb = torch.roll(t, h)
            outs.append(torch.where(sel, x ^ (t << j), x ^ tb))
        a, b = outs
    t = (_srl(a, 1) ^ b) & 0x55555555
    a = a ^ (t << 1)
    b = b ^ t
    ar = a.reshape(M // 16, 16).T
    br = b.reshape(M // 16, 16).T
    return _planes_into(torch.stack([ar, br], dim=1).reshape(32, M // 16), out, row0, take)


def _words32(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous int32 words (t itself when it already is: the checks
    cost less host time than the no-op conversions)."""
    return t if t.dtype == _I32 and t.is_contiguous() else t.to(_I32).contiguous()


def _dispatch(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no {what} kernel for tensors on {t.device}")
    return False


def transpose_bits32(x: torch.Tensor, out=None, row0: int = 0, take: int = 32) -> torch.Tensor:
    """K10 on a CUDA tensor, the plain version on a CPU tensor: planes 0 ..
    take-1 of x's transpose into rows row0 .. row0+take-1 of out (a new
    (take, M // 32) tensor when out is None); returns out."""
    if _dispatch(x, "transpose_bits32"):
        if out is None:
            out = torch.empty((take, x.shape[0] // 32), dtype=_I32, device=x.device)
        return kernels.transpose_bits32(_words32(x), out, row0, take)
    return transpose_bits32_ref(x, out, row0, take)


def transpose_bits32_pair(a: torch.Tensor, b: torch.Tensor, out=None, row0: int = 0,
                          take: int = 32) -> torch.Tensor:
    """K10, pair form, on a CUDA tensor; the plain version on a CPU tensor
    (arguments as for ``transpose_bits32``, out (R, M // 16))."""
    if _dispatch(a, "transpose_bits32_pair"):
        if out is None:
            out = torch.empty((take, a.shape[0] // 16), dtype=_I32, device=a.device)
        return kernels.transpose_bits32_pair(_words32(a), _words32(b), out, row0, take)
    return transpose_bits32_pair_ref(a, b, out, row0, take)


def untranspose_bits32(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of transpose_bits32: (32, W) planes -> flat (32 W,) per-item
    words (item i's bit p == planes[p, i // 32] bit (i % 32))."""
    return _tr32_stages(planes.T.reshape(-1).to(_I32))


def ones_low32(k: torch.Tensor) -> torch.Tensor:
    """(1 << k) - 1 for k in [0, 32] (all ones at k >= 32), as int32 words."""
    kc = torch.clamp(k, 0, 32).to(_I32)
    return ~torch.bitwise_left_shift(torch.full_like(kc, ALL_ONES), kc)


def ones_span32(lo: torch.Tensor, hi: torch.Tensor, base: int = 0) -> torch.Tensor:
    """Word with bits [lo - base, hi - base] set (window-clipped); empty when
    hi < lo.  lo/hi are int32 tensors of any range."""
    return ones_low32(hi - base + 1) & ~ones_low32(lo - base)


def bit_at32(p: torch.Tensor, base: int = 0) -> torch.Tensor:
    """Word with bit (p - base) set when in [0, 32), else 0."""
    r = p - base
    ok = (r >= 0) & (r < 32)
    w = torch.bitwise_left_shift(torch.ones_like(r, dtype=_I32), torch.clamp(r, 0, 31).to(_I32))
    return torch.where(ok, w, torch.zeros_like(w))


def bitrev32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 32 bits of each word (classic swap ladder)."""
    x = x.to(_I32)
    x = (_srl(x, 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = (_srl(x, 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = (_srl(x, 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = (_srl(x, 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return _srl(x, 16) | (x << 16)


def blocked_cumsum_excl(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Exclusive cumsum of a flat integer vector, in the two-level form of
    the JAX package (within-block cumsums plus a block-sum cumsum)."""
    n = x.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    xp = torch.cat([x, x.new_zeros(pad)]) if pad else x
    xb = xp.reshape(nb, block)
    incl = torch.cumsum(xb, dim=1)
    bs = incl[:, -1]
    base = torch.cumsum(bs, dim=0) - bs
    excl = incl - xb + base[:, None]
    return excl.reshape(-1)[:n].to(x.dtype)


# ---------------------------------------------------------------------------
# K12: flag compaction
# ---------------------------------------------------------------------------
def compact_flags_rows_ref(flags: torch.Tensor, take: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K12: flags (B, n) bool -> (idx (B, take) int32, the ascending
    indices of the set flags with the sentinel n at unused slots; count (B,)
    int32).  Rows with more than ``take`` flags keep the first ``take``."""
    B, n = flags.shape
    f = flags.to(torch.int64)
    incl = torch.cumsum(f, dim=1)
    pos = incl - f
    slot = torch.where(flags & (pos < take), pos, torch.full_like(pos, take))
    out = torch.full((B, take + 1), n, dtype=_I32, device=flags.device)
    src = torch.arange(n, dtype=_I32, device=flags.device).expand(B, n)
    out.scatter_(1, slot, src)  # the slot `take` collects the rest; dropped
    return out[:, :take].contiguous(), incl[:, -1].to(_I32)


def compact_flags_rows(flags: torch.Tensor, take: int, out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12 on a CUDA tensor (into ``out``, as ``kernels.compact_flags_rows``
    takes it, where given), the plain version on a CPU tensor."""
    if _dispatch(flags, "compact_flags_rows"):
        return kernels.compact_flags_rows(flags.to(torch.bool).contiguous(), take, out)
    return compact_flags_rows_ref(flags.to(torch.bool), take)


# ---------------------------------------------------------------------------
# K11: masked pack
# ---------------------------------------------------------------------------
class PackResult(NamedTuple):
    out_words: torch.Tensor    # int32 (out_cap_bytes // 4,) packed stream buffer
    counts: torch.Tensor       # int32 (nrows,) per-row bit counts (part order)
    total_bytes: torch.Tensor  # int64 () sum of per-row byte sizes
    overflow: torch.Tensor     # bool () piece cap or byte cap exceeded
    n_nz: torch.Tensor         # int64 () non-empty pieces (tier-sizing signal)


def _pack_layout(parts, tile: int) -> List[Tuple[int, int, int]]:
    """(rows, W, tiles per row) of each part: a tile is ``tile`` words of one
    row, the last tile of a row short when W is not a multiple."""
    return [(v.shape[0], v.shape[1], -(-v.shape[1] // tile)) for v, _ in parts]


def _tiles(w: torch.Tensor, tpr: int, tile: int) -> torch.Tensor:
    """(rows, W) words -> (rows * tpr, tile), zero past each row's end."""
    rows, W = w.shape
    if tpr * tile != W:
        w = torch.cat([w, w.new_zeros((rows, tpr * tile - W))], dim=1)
    return w.reshape(rows * tpr, tile)


def pack_count_ref(parts, piece_words: int, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K11 count: each tile's valid bits and non-empty pieces (runs of
    piece_words words with a valid bit), int32, in tile order (part by part,
    row by row)."""
    assert tile % piece_words == 0
    bits_l, nz_l = [], []
    for (v, _), (rows, W, tpr) in zip(parts, _pack_layout(parts, tile)):
        t = _tiles(v.to(_I32), tpr, tile)
        bits_l.append(popcount32(t).sum(dim=1, dtype=torch.int32))
        nz_l.append((t.reshape(-1, tile // piece_words, piece_words) != 0).any(dim=2)
                    .sum(dim=1, dtype=torch.int32))
    return torch.cat(bits_l), torch.cat(nz_l)


def pack_scan_ref(tile_bits: torch.Tensor, tile_nz: torch.Tensor, layout, take: int,
                  out_cap_bytes: int):
    """Plain K11 scan: (counts int32 per row, tile_base int64 per tile: the
    stream bit of its first valid bit, total_bytes, overflow, n_nz).  Rows
    start on a byte boundary, in order across parts."""
    tb = tile_bits.to(torch.int64)
    counts_l, within_l = [], []
    t0 = 0
    for rows, _, tpr in layout:
        rt = tb[t0 : t0 + rows * tpr].reshape(rows, tpr)
        counts_l.append(rt.sum(dim=1))
        within_l.append(torch.cumsum(rt, dim=1) - rt)  # prefix inside the row
        t0 += rows * tpr
    counts = torch.cat(counts_l)
    bc = (counts + 7) >> 3
    row_base = (torch.cumsum(bc, dim=0) - bc) << 3
    bases, r0 = [], 0
    for (rows, _, tpr), within in zip(layout, within_l):
        bases.append((within + row_base[r0 : r0 + rows, None]).reshape(-1))
        r0 += rows
    total_bytes = bc.sum()
    n_nz = tile_nz.to(torch.int64).sum()
    overflow = (n_nz > take) | (total_bytes > out_cap_bytes)
    return counts.to(_I32), torch.cat(bases), total_bytes, overflow, n_nz


def pack_tiles_ref(parts, tile_base: torch.Tensor, tile: int, out_cap_bytes: int) -> torch.Tensor:
    """Plain K11 pack: each word's valid bits (pext32) at its tile's base
    plus the valid bits of the words before it in the tile, ORed into a
    zeroed buffer of out_cap_bytes // 4 words; words past it are dropped."""
    n_out = out_cap_bytes // 4
    acc = torch.zeros(n_out + 1, dtype=torch.int64, device=tile_base.device)
    t0 = 0
    for (v, b), (rows, W, tpr) in zip(parts, _pack_layout(parts, tile)):
        tv = _tiles(v.to(_I32), tpr, tile)
        c = popcount32(tv).to(torch.int64)
        off = (tile_base[t0 : t0 + rows * tpr, None] + torch.cumsum(c, dim=1) - c).reshape(-1)
        cw = pext32(_tiles(b.to(_I32), tpr, tile), tv).reshape(-1).to(torch.int64) & 0xFFFFFFFF
        w, r = off >> 5, off & 31
        for d, part in ((0, (cw << r) & 0xFFFFFFFF), (1, cw >> (32 - r))):
            pos = torch.where(w + d < n_out, w + d, torch.full_like(w, n_out))
            acc.index_add_(0, pos, part)  # contributions are bit-disjoint: add == or
        t0 += rows * tpr
    return _to_i32(acc[:n_out])


def masked_pack_ref(parts, evb_cap: int, out_cap_bytes: int, piece_words: int = 8,
                    tile: int = kernels.PACK_TILE) -> PackResult:
    """Plain K11 (see ``masked_pack``), in the kernel's three stages; the
    result does not depend on ``tile`` (a multiple of piece_words)."""
    assert out_cap_bytes % 4 == 0
    assert piece_words in (2, 4, 8, 16)
    for v, b in parts:
        assert v.dim() == 2 and v.shape == b.shape and v.shape[1] % piece_words == 0
    layout = _pack_layout(parts, tile)
    take = min(evb_cap, sum(rows * W for rows, W, _ in layout) // piece_words)
    tile_bits, tile_nz = pack_count_ref(parts, piece_words, tile)
    counts, tile_base, total_bytes, overflow, n_nz = pack_scan_ref(
        tile_bits, tile_nz, layout, take, out_cap_bytes
    )
    out = pack_tiles_ref(parts, tile_base, tile, out_cap_bytes)
    return PackResult(out, counts, total_bytes, overflow, n_nz)


def masked_pack(
    parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    evb_cap: int,
    out_cap_bytes: int,
    piece_words: int = 8,
) -> PackResult:
    """Pack masked bits into byte-aligned per-row segments, stream order.

    ``parts``: per-class (valid_w, bit_w) int32 word arrays of shape
    [rows_c, Wc] (Wc a multiple of piece_words).  Rows concatenate across
    parts in order; each row's compacted bits start at the next byte
    boundary; bytes follow LSB-first bit order.  ``overflow`` is set when
    the non-empty pieces (runs of piece_words words) outnumber
    min(evb_cap, pieces) or the bytes exceed ``out_cap_bytes``, exactly as
    in the JAX package; ``out_words`` is valid only when it is False.

    K11 on CUDA tensors (three launches, count, scan and pack, with no torch
    op between them), the plain version on CPU tensors."""
    if _dispatch(parts[0][0], "masked_pack"):
        parts = [(_words32(v), _words32(b)) for v, b in parts]
        return PackResult(*kernels.masked_pack(parts, evb_cap, out_cap_bytes, piece_words))
    return masked_pack_ref(parts, evb_cap, out_cap_bytes, piece_words)


def words_to_bytes(out_words: torch.Tensor) -> torch.Tensor:
    """int32 word buffer -> uint8 byte view (little-endian, LSB-first bits)."""
    return out_words.contiguous().view(torch.uint8)


def masked_pack_reference(
    parts_np: Sequence[Tuple[np.ndarray, np.ndarray]]
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy oracle for masked_pack: returns (bytes, per-row bit counts).
    parts: (valid, bits) 0/1 arrays of shape [rows, L] (cell granularity)."""
    out_bits: List[np.ndarray] = []
    counts = []
    for valid, bits in parts_np:
        for r in range(valid.shape[0]):
            v = valid[r].astype(bool)
            row = bits[r][v].astype(np.uint8)
            counts.append(row.size)
            pad = (-row.size) % 8
            out_bits.append(np.concatenate([row, np.zeros(pad, np.uint8)]))
    allb = np.concatenate(out_bits) if out_bits else np.zeros(0, np.uint8)
    return np.packbits(allb, bitorder="little"), np.asarray(counts, np.int64)


__all__ = [
    "pext32",
    "transpose_bits32",
    "transpose_bits32_pair",
    "untranspose_bits32",
    "blocked_cumsum_excl",
    "compact_flags_rows",
    "masked_pack",
    "words_to_bytes",
    "masked_pack_reference",
    "PackResult",
]
