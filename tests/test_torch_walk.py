"""The 3D set walk's hand kernels (sperr_tpu_torch/kernels/walk.cu: K7
``anchor_ranks``, K8's ``walk_rows`` and key kernels, the stable radix sort)
as far as the CPU can hold them: their plain versions against sperr_tpu
(``dense_anchor_ranks``, ``lis_segments_device(..., return_events="items")``)
at N = 16, 32 and 64, and numpy emulations of what the kernels compute
against the plain versions:

  * the one-sweep radix sort (one histogram of every digit, then per digit
    pass and tile the in-warp stable ranks, the warps' offsets, the
    look-back's exclusive prefix, the staging in digit order) with the
    digits that the static widths (``walk_layout``) leave, on the real keys
    of the walk's two sorts as the kernels pack them, against
    ``np.lexsort`` of the plain version's keys; the widths against the
    largest key each sort sees; the sign flip on keys of both signs; one,
    a tile's worth and tiles of one repeated key;
  * K7's bitmap ranks (the presence bitmap, its 8-word group prefixes, the
    bits below a key) on the real keys of every ranked level against
    ``_level_ranks``, and the bitmaps' widths (``rank_layout``);
  * the walk kernels' arithmetic (chain walk, ranks, rows, born entries,
    walk ranks, keys) against ``_lis_items_virtual_ref`` bit for bit;
  * ``walk_rows``' significance-mask bit test against the scan form;
  * walk.cu's tile and thread constants against their Python mirrors.

The kernels themselves run only on the card (``chip_smoke.py`` phase 3)."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import speck_jax as sj
from sperr_tpu.ops import speck_lis_jax as jsl
from sperr_tpu.ops import speck_virtual as jsv
from sperr_tpu_torch import kernels
from sperr_tpu_torch.ops import speck_lis as tsl
from sperr_tpu_torch.ops import speck_virtual as tsv

_NEVER = 0x7FFF
_BIG = 2**31 - 1
_NOOP_PAYLOADS = (126, 1 | (63 << 1) | (63 << 7))
# (N, seed, density, node cap as a fraction of nn): caps that hold every
# significant set, caps below the born slots, and caps above nn
_CASES = [(16, 0, 0.4, 1.0), (16, 1, 0.7, 0.05), (32, 2, 0.05, 1.0), (32, 3, 0.3, 0.05),
          (32, 4, 0.6, 1.3), (64, 5, 0.2, 1.0), (64, 6, 0.02, 0.05)]


def _mags(n, seed, density):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 15, size=n) * (rng.random(n) < density)).astype(np.int32)


def _cap(nn, frac):
    return nn if frac == 1.0 else (max(64, int(nn * frac)) if frac < 1.0 else int(nn * frac))


@functools.lru_cache(maxsize=None)
def _jax_walk(N, cap):
    vj = jsv.virtual_lis_index((N, N, N))

    def run(mags, sgn):
        nb = jnp.max(sj.msbp1_device(mags))
        s, _, nm = jsv.pixel_schedule_virtual(mags, vj, nb)
        node_s = jnp.where(nm > 0, nb - nm, _NEVER).astype(jnp.int32)
        items = jsl.lis_segments_device(node_s, s, sgn, nb, vj, 34, cap, 0, 0, return_events="items")
        return node_s, jsv.dense_anchor_ranks(node_s, vj), items

    return jax.jit(run)


def _inputs(N, seed, density):
    """(vf, node_s, s, signs, num_bp) on the CPU, from the port's schedule."""
    n = N**3
    mags = torch.from_numpy(_mags(n, seed, density))
    sgn = torch.from_numpy(np.random.default_rng(seed + 100).random(n) < 0.5)
    vf = tsv.virtual_lis_index((N, N, N), "cpu")
    nb, s, _, nm = tsv.schedule_virtual(mags, vf)
    node_s = torch.where(nm > 0, nb - nm, _NEVER).to(torch.int32)
    return vf, node_s, s, sgn, nb, mags


# ---------------------------------------------------------------------------
# the plain versions against sperr_tpu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,seed,density,frac", _CASES)
def test_plain_walk_and_anchor_ranks_equal_jax(N, seed, density, frac):
    vf, node_s, s, sgn, nb, mags = _inputs(N, seed, density)
    cap = _cap(vf.nn, frac)
    node_sj, anchors_j, (pj, nsj) = _jax_walk(N, cap)(jnp.asarray(mags.numpy()), jnp.asarray(sgn.numpy()))
    np.testing.assert_array_equal(node_s.numpy(), np.asarray(node_sj))
    for a, b in zip(tsv.dense_anchor_ranks(node_s, vf), anchors_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pt, nst = tsl._lis_items_virtual(node_s, s, sgn, nb, vf, cap)
    assert int(nst) == int(nsj)
    pj, pt = np.asarray(pj), pt.numpy()
    assert pt.shape == pj.shape == (tsl.lis_item_count(vf, cap),)
    # the padding items' order among themselves is not fixed in JAX (its
    # sorts are unstable); every other item sits at the same place
    for p in _NOOP_PAYLOADS:
        assert (pj == p).sum() == (pt == p).sum()
    np.testing.assert_array_equal(pt[~np.isin(pt, _NOOP_PAYLOADS)], pj[~np.isin(pj, _NOOP_PAYLOADS)])


# ---------------------------------------------------------------------------
# the radix sort, emulated
# ---------------------------------------------------------------------------
def _radix_emulate(keys: np.ndarray, width: int, shifts, vals=None) -> np.ndarray:
    """What kernels/walk.cu's one-sweep sort computes, in numpy.  The
    histogram launch: the counts of every digit ((key ^ sign bit) >> shift)
    & 255 of every pass, from the input keys (the counts do not depend on
    the order), and each digit's start.  Then per pass and tile of SORT_TILE
    keys (lane l of warp w holds key w * 32 * SORT_ITEMS + 32 j + l of the
    tile, round j < SORT_ITEMS): a key's rank among its warp's keys of its
    digit (the per-warp counter after the earlier rounds, plus the lanes
    below it in its round), the warps' offsets per digit, the tile's
    exclusive prefix per digit as the look-back returns it, the staging slot
    in digit order, and the write of staged slot i to the digit's start +
    the prefix + i - the digit's offset in the tile.  Returns the values
    (the positions when vals is None) in sorted order."""
    ut = np.uint64 if width == 64 else np.uint32
    k = keys.astype(np.int64 if width == 64 else np.int32).view(ut)
    v = np.arange(k.size, dtype=np.int64) if vals is None else np.asarray(vals, np.int64)
    n, T, I = k.size, kernels.SORT_TILE, kernels.SORT_ITEMS
    W = kernels.SORT_THREADS // 32
    flip = ut(1) << ut(width - 1)

    def digit(x, shift):
        return (((x ^ flip) >> ut(shift)) & ut(255)).astype(np.int64)

    def counts(idx, size):
        return np.bincount(idx, minlength=size)

    starts = []
    for shift in shifts:
        h = counts(digit(k, shift), 256)
        starts.append(np.cumsum(h) - h)
    i = np.arange(n)
    tile, off = i // T, i % T
    warp, rnd, lane = off // (32 * I), (off % (32 * I)) // 32, off % 32
    nt = -(-n // T)
    for p, shift in enumerate(shifts):
        dg = digit(k, shift)
        # in the warp: the counter after the earlier rounds, the lanes below in the round
        twr = (tile * W + warp) * I + rnd
        c_round = counts(twr * 256 + dg, nt * W * I * 256).reshape(nt * W, I, 256)
        before_rounds = (np.cumsum(c_round, axis=1) - c_round).reshape(-1)
        grp = twr * 256 + dg
        order = np.lexsort((lane, grp))
        first = np.r_[True, grp[order][1:] != grp[order][:-1]]
        start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
        in_round = np.empty(n, np.int64)
        in_round[order] = np.arange(n) - start
        rank = before_rounds[twr * 256 + dg] + in_round
        # the warps' offsets, the tile's counts, the look-back's prefix
        c_warp = c_round.reshape(nt, W, I, 256).sum(axis=2)
        warp_off = np.cumsum(c_warp, axis=1) - c_warp
        c_tile = c_warp.sum(axis=1)
        lookback = np.cumsum(c_tile, axis=0) - c_tile
        bex = np.cumsum(c_tile, axis=1) - c_tile
        slot = bex[tile, dg] + warp_off[tile, warp, dg] + rank
        assert np.array_equal(np.sort(slot + tile * T), np.arange(n))
        pos = starts[p][dg] + lookback[tile, dg] + slot - bex[tile, dg]
        assert np.array_equal(np.sort(pos), np.arange(n))
        k2, v2 = np.empty_like(k), np.empty_like(v)
        k2[pos], v2[pos] = k, v
        k, v = k2, v2
    return v


@pytest.mark.parametrize("width", [32, 64])
def test_radix_emulation_sign_flip_and_ties(width):
    rng = np.random.default_rng(width)
    lo, hi = (-(2**31), 2**31) if width == 32 else (-(2**62), 2**62)
    keys = rng.integers(lo, hi, 20_000)
    keys[rng.random(keys.size) < 0.3] = keys[0]  # ties
    keys[:3] = [lo, hi - 1, 0]
    perm = _radix_emulate(keys, width, kernels.radix_shifts(width))
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    # the CPU branch of lexsort (the chained torch.sort) sorts the same
    np.testing.assert_array_equal(
        tsl.lexsort([torch.from_numpy(keys.astype(np.int32 if width == 32 else np.int64))]).numpy(), perm)


def test_radix_shifts_skip_the_zero_digits():
    assert kernels.radix_shifts(1) == [0]
    assert kernels.radix_shifts(8) == [0]
    assert kernels.radix_shifts(51) == [0, 8, 16, 24, 32, 40, 48]
    assert kernels.radix_shifts(64) == [8 * p for p in range(8)]
    keys = np.random.default_rng(0).integers(0, 2**20, 9_000)
    np.testing.assert_array_equal(_radix_emulate(keys, 64, kernels.radix_shifts(20)),
                                  np.argsort(keys, kind="stable"))


_T = 4096  # kernels.SORT_TILE, checked in test_walk_cu_constants_match_their_mirrors


@pytest.mark.parametrize("n", [1, _T - 1, _T, _T + 1, 3 * _T + 1])
@pytest.mark.parametrize("width", [32, 64])
def test_radix_emulation_small_and_tile_edges(n, width):
    rng = np.random.default_rng(n + width)
    lo, hi = (-(2**31), 2**31) if width == 32 else (-(2**62), 2**62)
    keys = rng.integers(lo, hi, n)
    keys[rng.random(n) < 0.2] = keys[0]
    np.testing.assert_array_equal(_radix_emulate(keys, width, kernels.radix_shifts(width)),
                                  np.argsort(keys, kind="stable"))
    small = rng.integers(0, 2**13, n)  # reduced bits: 2 digits
    vals = rng.integers(0, 2**31, n)
    np.testing.assert_array_equal(_radix_emulate(small, width, kernels.radix_shifts(13), vals),
                                  vals[np.argsort(small, kind="stable")])


@pytest.mark.parametrize("width,key", [(32, -7), (64, 2**40 + 3), (64, 0)])
def test_radix_emulation_tiles_of_one_repeated_key(width, key):
    n = 5 * _T + 17
    keys = np.full(n, key)
    np.testing.assert_array_equal(_radix_emulate(keys, width, kernels.radix_shifts(width)), np.arange(n))


def _base9(w: np.ndarray, S: int) -> np.ndarray:
    """A one-word path of 4-bit digits (depth j at 4 (S - 1 - j)), as the
    plain walk keeps it, in base 9 (depth j's digit times 9^(S - 1 - j)), as
    the walk kernels pack it; the digits are 0 .. 8."""
    out = np.zeros_like(w)
    for j in range(S):
        dig = (w >> (4 * (S - 1 - j))) & 15
        assert int(dig.max()) <= 8
        out += dig * 9 ** (S - 1 - j)
    return out


def _radix_chain(keys, bits) -> np.ndarray:
    """The emulated radix sort over int64 keys of the given widths, the
    last key first (as kernels.radix_lexsort chains them): the permutation.
    Every key must lie below 2^bits of its width."""
    perm = None
    for k, b in zip(reversed(keys), reversed(bits)):
        assert k.min() >= 0 and int(k.max()) < 2**b, (int(k.max()), b)
        sub = _radix_emulate(k if perm is None else k[perm], 64, kernels.radix_shifts(b))
        perm = sub if perm is None else perm[sub]
    return perm


@pytest.mark.parametrize("N,seed,density,frac", _CASES)
def test_walk_sort_keys_fit_their_widths_and_sort_as_lexsort(N, seed, density, frac, monkeypatch):
    vf, node_s, s, sgn, nb, _ = _inputs(N, seed, density)
    cap = _cap(vf.nn, frac)
    lay = tsl.walk_layout(vf, cap)
    # the plain walk's two lexsort calls (insertion, walk), captured
    calls = []
    orig = tsl.lexsort

    def rec(keys):
        calls.append([k.numpy().astype(np.int64) for k in keys])
        return orig(keys)

    monkeypatch.setattr(tsl, "lexsort", rec)
    tsl._lis_items_virtual_ref(node_s, s, sgn, nb, vf, cap)
    ins, walk = calls
    # insertion sort: [pack2(k_lba, anchor rank)] + path words
    k_lba, arank = ins[0] >> 32, ins[0] & 0xFFFFFFFF
    assert int(arank.max()) < 2**lay.wa
    lba = np.where(k_lba == _BIG, vf.nlev << 11, k_lba)
    assert int(lba.max()) < 2**lay.lba_bits
    head = (lba << lay.wa) | arank
    # the kernels' path word 0: base-9 digits where the plain walk has 4-bit ones
    ins = ins[:1] + [_base9(ins[1], vf.depth_max + 1)] + ins[2:] if lay.path_words == 1 else ins
    packed = [(head << lay.ins_pw) | ins[1]] + ins[2:] if lay.ins_pw else [head] + ins[1:]
    np.testing.assert_array_equal(_radix_chain(packed, lay.ins_bits), np.lexsort(ins[::-1]))
    # walk sort: [pack2(walk rank, path 0)] + more path words; BIG -> tcap
    kw, p0 = walk[0] >> 32, walk[0] & 0xFFFFFFFF
    assert int(kw[kw != _BIG].max()) < lay.tcap
    kwp = np.where(kw == _BIG, lay.tcap, kw)
    p0 = _base9(p0, vf.depth_max + 1) if lay.path_words == 1 else p0
    assert int(p0.max()) < 2**lay.pw0
    packed = [(kwp << lay.pw0) | p0] + walk[1:]
    np.testing.assert_array_equal(_radix_chain(packed, lay.walk_bits), np.lexsort(walk[::-1]))
    assert walk[0].size == lay.T and ins[0].size == lay.CB


def _bitmap_ranks(key: np.ndarray, bits: int, small: bool) -> np.ndarray:
    """K7's dense ranks as kernels/walk.cu computes them: each key's bit set
    in a presence bitmap of 2^bits bits (32-bit words), each 8-word group's
    count of distinct keys (one per bit that a mark set), the exclusive
    prefix of the counts (one block: a scan over the groups; a larger level:
    the prefix within its scan block of RANK_SCAN_GROUPS groups, 4 a
    thread, and the blocks' prefixes), and R = the key's group prefix + the
    set bits below it in its group."""
    key = np.asarray(key, np.int64)
    assert key.min() >= 0 and int(key.max()) < 2**bits
    words = np.zeros(2 ** (bits - 5), np.uint32)
    np.bitwise_or.at(words, key >> 5, (np.int64(1) << (key & 31)).astype(np.uint32))
    pc = np.bitwise_count(words).astype(np.int64)
    grp = np.bincount(np.unique(key) >> 8, minlength=words.size // 8)  # the marks' counts
    assert np.array_equal(grp, pc.reshape(-1, 8).sum(axis=1))
    if small:
        gpre = np.cumsum(grp) - grp
    else:
        per_block = kernels.RANK_SCAN_GROUPS
        nblk = -(-grp.size // per_block)
        padded = np.zeros(nblk * per_block, np.int64)
        padded[: grp.size] = grp
        blocks = padded.reshape(nblk, per_block)
        agg = blocks.sum(axis=1)
        bsum = np.cumsum(agg) - agg  # the last block's scan of the sums
        thread = blocks.reshape(nblk, -1, 4)  # 4 groups per thread
        tsum = thread.sum(axis=2)
        ex = ((np.cumsum(tsum, axis=1) - tsum)[:, :, None] + np.cumsum(thread, axis=2) - thread).reshape(-1)
        gpre = bsum[np.arange(grp.size) // per_block] + ex[: grp.size]
    g, w, b = key >> 8, (key >> 5) & 7, key & 31
    within = np.bitwise_count(words[key >> 5] & ((np.int64(1) << b) - 1).astype(np.uint32)).astype(np.int64)
    for q in range(7):
        within += np.where(q < w, pc[np.minimum(g * 8 + q, pc.size - 1)], 0)
    return gpre[g] + within


def _sorted_ranks(key: np.ndarray, bits: int) -> np.ndarray:
    """The dense ranks of a level too wide for a bitmap, as rank.cuh's
    sorted route computes them: the stable radix sort of the keys carrying
    their positions, the heads (a sorted key unlike the one before it) as
    bits over the sorted positions in 8-word groups padded to a multiple of
    4, each group's count (one block a group), their exclusive prefix, and
    each node's rank = the heads at or before its sorted position - 1."""
    key = np.asarray(key, np.int64)
    assert key.min() >= 0 and int(key.max()) < 2**bits <= 2**43
    cnt = key.size
    order = np.argsort(key, kind="stable")
    sk = key[order]
    groups = (((cnt + 255) >> 8) + 3) & ~3
    head = np.zeros(groups * 256, np.int64)
    head[:cnt] = np.r_[True, sk[1:] != sk[:-1]]
    per = head.reshape(groups, 256)
    gcnt = per.sum(axis=1)
    below = ((np.cumsum(gcnt) - gcnt)[:, None] + np.cumsum(per, axis=1) - per).reshape(-1)
    rank = np.empty(cnt, np.int64)
    rank[order] = below[:cnt] + head[:cnt] - 1
    return rank


def _level_keys(vf, node_s, monkeypatch):
    """The real keys of every ranked level (the plain K7's _level_ranks
    calls) and their ranks."""
    seen = []
    orig = tsv._level_ranks

    def rec(key):
        rank = orig(key)
        seen.append((key.numpy().copy(), rank.numpy().copy()))
        return rank

    monkeypatch.setattr(tsv, "_level_ranks", rec)
    tsv.dense_anchor_ranks(node_s, vf)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("N,seed,density", [(16, 0, 0.4), (32, 3, 0.3), (64, 5, 0.2)])
def test_level_sort_keys_fit_their_widths(N, seed, density, monkeypatch):
    vf, node_s, *_ = _inputs(N, seed, density)
    plan = vf.rank_plan()
    seen = _level_keys(vf, node_s, monkeypatch)
    assert [k.size for k, _ in seen] == list(plan.counts)
    for lvl, ((key, rank), wk) in enumerate(zip(seen, plan.wks)):
        u, k1 = key >> 32, key & 0xFFFFFFFF
        assert int(u.max()) < 2**12 and int(k1.max()) < 2**wk
        packed = (u << wk) | k1
        np.testing.assert_array_equal(_bitmap_ranks(packed, 12 + wk, lvl < plan.nsmall), rank)


@pytest.mark.parametrize("N,seed,density", [(64, 7, 0.3), (64, 8, 0.02), (128, 9, 0.1), (128, 10, 0.6)])
def test_bitmap_ranks_equal_level_ranks(N, seed, density, monkeypatch):
    """Every ranked level's real keys, on the route the plan gives it (one
    block, or the three launches); the 32,768-node level (wk 13) first
    appears at N = 128."""
    vf, node_s, *_ = _inputs(N, seed, density)
    plan = vf.rank_plan()
    lay = kernels.rank_layout(plan.host, plan.nsmall)
    seen = _level_keys(vf, node_s, monkeypatch)
    routes = []
    for lvl, ((key, rank), wk) in enumerate(zip(seen, plan.wks)):
        packed = ((key >> 32) << wk) | (key & 0xFFFFFFFF)
        small = lvl < plan.nsmall
        assert lay.bits[lvl] == 12 + wk and lay.words[lvl] == 2 ** (7 + wk)
        np.testing.assert_array_equal(_bitmap_ranks(packed, 12 + wk, small), rank)
        routes.append((key.size, "block" if small else "grid"))
    if N == 128:
        assert (32768, "grid") in routes and plan.wks[routes.index((32768, "grid"))] == 13


@pytest.mark.parametrize("N,seed,density", [(32, 3, 0.3), (64, 7, 0.3), (64, 8, 0.02)])
def test_sorted_ranks_equal_level_ranks(N, seed, density, monkeypatch):
    """Every ranked level's real keys through the sorted route (the one
    the plan gives levels wider than the bitmaps take; here every level, as
    a bitmap_bits of 12 makes it on the card) equal the plain ranks."""
    vf, node_s, *_ = _inputs(N, seed, density)
    plan = vf.rank_plan()
    lay = kernels.rank_layout(plan.host, plan.nsmall, 12)
    assert lay.nbitmap == sum(w == 0 for w in plan.wks) and lay.nsmall == min(plan.nsmall, lay.nbitmap)
    for (key, rank), wk in zip(_level_keys(vf, node_s, monkeypatch), plan.wks):
        packed = ((key >> 32) << wk) | (key & 0xFFFFFFFF)
        np.testing.assert_array_equal(_sorted_ranks(packed, 12 + wk), rank)


def test_bitmap_widths_at_256():
    vf = tsv.virtual_lis_index((256, 256, 256), "cpu")
    plan = vf.rank_plan()
    assert plan.counts == (7, 63, 511, 4095, 32768, 262144) and plan.wks == (0, 3, 6, 9, 12, 16)
    lay = kernels.rank_layout(plan.host, plan.nsmall)
    assert lay.bits == (12, 15, 18, 21, 24, 28) and plan.nsmall == 4
    # the two levels of the three launches: 2^24 and 2^28 bits (2 MB, 32 MB)
    assert [2 ** b for b in lay.bits[plan.nsmall:]] == [2**24, 2**28]
    assert [4 * w for w in lay.words[plan.nsmall:]] == [2 * 2**20, 32 * 2**20]
    assert lay.scan_blocks[plan.nsmall:] == (2**16 // kernels.RANK_SCAN_GROUPS, 2**20 // kernels.RANK_SCAN_GROUPS)
    assert lay.zwords == sum(lay.words) + (2**16 + 68) + (2**20 + 1028)  # sums + counter, 16-byte padded
    assert lay.keys == 262144
    # the one-block levels' group prefixes fit its shared memory
    assert max(lay.words[: plan.nsmall]) // 8 <= 2 ** (kernels.RANK_SMALL_BITS - 8)
    with pytest.raises(ValueError):
        kernels.rank_layout(plan.host, 5)  # the 32,768-node level in one block
    # a level of 33 key bits (the 2D walk's finest at 3600 x 7200) sorts its
    # keys; the bitmaps before it keep their layout
    wide = plan.host.reshape(-1, kernels.RANK_LEVEL_INTS).copy()
    wide[-1, 1] = 21
    lw = kernels.rank_layout(wide.reshape(-1), plan.nsmall)
    assert lw.nbitmap == len(lay.bits) - 1 and lw.bits[-1] == 33 and lw.words == lay.words[:-1]
    assert lw.zwords == sum(lw.words) + (2**16 + 68) and lw.keys == 32768
    assert kernels.rank_layout(plan.host, plan.nsmall, 24).nbitmap == len(lay.bits) - 1
    wide[-1, 1] = 32  # past a rank + 1 below 2^31
    with pytest.raises(ValueError):
        kernels.rank_layout(wide.reshape(-1), plan.nsmall)


def test_walk_cu_constants_match_their_mirrors():
    # the ranks' constants live in rank.cuh, which walk.cu includes
    src = "".join(open(os.path.join(os.path.dirname(kernels.__file__), f)).read()
                  for f in ("rank.cuh", "walk.cu"))
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    mirrors = {"kSortThreads": kernels.SORT_THREADS, "kSortItems": kernels.SORT_ITEMS,
               "kTile": kernels.SORT_TILE, "kSortPasses": kernels.SORT_PASSES,
               "kMaxSpans": kernels.RANK_SPANS, "kLevelInts": kernels.RANK_LEVEL_INTS,
               "kSmallMax": kernels.RANK_SMALL_MAX, "kSmallBits": kernels.RANK_SMALL_BITS,
               "kScanGroups": kernels.RANK_SCAN_GROUPS, "kBitmapBits": kernels.RANK_BITMAP_BITS,
               "kMaxDepth": kernels.FOREST_DEPTHS,
               "kMaxRoots": kernels.FOREST_ROOTS}
    assert {k: consts[k] for k in mirrors} == mirrors
    assert kernels.SORT_TILE == _T
    # the sort's 8-byte scratch words: 256 status words per tile, the counts, the counters
    assert kernels.sort_scratch_words(1) == 256 + 1024 + 8
    assert kernels.sort_scratch_words(7_190_220) == 1756 * 256 + 1024 + 8


# ---------------------------------------------------------------------------
# the walk kernels' arithmetic, emulated
# ---------------------------------------------------------------------------
class _Forest:
    """kernels/walk.cu's struct Forest, read back from walk_forest()."""

    def __init__(self, vf):
        a = vf.walk_forest().numpy().astype(np.int64)
        (self.K, self.N, self.n, self.nn, self.D, self.R, self.nlev, self.S) = (int(x) for x in a[:8])
        o = 8
        self.db, self.r0, self.a8 = (a[o + 14 * i: o + 14 * (i + 1)] for i in range(3))
        o += 42
        self.slog, self.ox, self.oy, self.oz, self.rlev, self.o0 = (a[o + 64 * i: o + 64 * (i + 1)]
                                                                   for i in range(6))
        self.off0 = a[o + 384: o + 416]

    def decode(self, ids):
        ids = np.asarray(ids, np.int64)
        d = np.zeros_like(ids)
        for k in range(1, self.D + 2):
            d += ids >= self.db[k]
        rem = ids - self.db[d]
        return self.r0[d] + (rem >> (3 * d)), d, rem & ((1 << (3 * d)) - 1)

    def node_id(self, r, d, m):
        d = np.maximum(d, 0)
        return self.db[d] + ((r - self.r0[d]) << (3 * d)) + m

    def level(self, r, d):
        return 3 * (self.K - self.slog[r] + d)

    def paths(self, d, m):
        w0, w1 = np.zeros_like(m), np.zeros_like(m)
        for j in range(self.S):
            dig = np.where(j < d, ((m >> np.maximum(3 * (d - 1 - j), 0)) & 7) + 1, 0)
            if self.S <= 7:
                w0 += dig * 9 ** (self.S - 1 - j)
            elif j < 6:
                w0 |= dig << (5 * (5 - j))
            else:
                w1 |= dig << (5 * (11 - j))
        return w0, w1

    def child_paths(self, d, m, k):
        w0, w1 = self.paths(d, m)
        if self.S <= 7:
            return w0 + (k + 1) * 9 ** np.maximum(self.S - 1 - d, 0), w1
        return (w0 + np.where(d < 6, (k + 1) << np.clip(5 * (5 - d), 0, 25), 0),
                w1 + np.where((d >= 6) & (d < 12), (k + 1) << np.clip(5 * (11 - d), 0, 25), 0))


def _emulate_anchor_ranks(F, vf, node_s):
    """anchor_chain, then the bitmap ranks level by level."""
    nn = F.nn
    z = np.arange(nn)
    r, d, m = F.decode(z)
    s = node_s[z]
    slog = F.slog[r]
    ranked = slog - d >= 2
    has = d > 0
    cd, cm = np.where(has, d - 1, 0), m >> 3
    cur = np.where(has, F.node_id(r, cd, cm), z)
    sp = node_s[cur]
    act = has & (cd > 0)
    for _ in range(F.D):
        gd, gm = np.maximum(cd - 1, 0), cm >> 3
        g = F.node_id(r, gd, gm)
        same = act & (node_s[g] == sp)
        cur, cd, cm = np.where(same, g, cur), np.where(same, gd, cd), np.where(same, gm, cm)
        act = same & (cd > 0)
    J = np.where(has & (sp == s), cur, z)
    u = np.where(has, (1 << 11) | (np.clip(sp, 0, 63) << 5) | (31 - 3 * (F.K - slog + cd)), F.o0[r])
    jp = np.where(has, cur, -1)
    R = np.zeros(nn, np.int64)
    plan = vf.rank_plan()
    rows = plan.host.reshape(-1, kernels.RANK_LEVEL_INTS)
    for row in rows:
        cnt, wk, ns = (int(x) for x in row[:3])
        ids = np.concatenate([np.arange(row[3 + k], row[3 + kernels.RANK_SPANS + k]) for k in range(ns)])
        assert ids.size == cnt and ranked[ids].all()
        key = (u[ids] << wk) | np.where(jp[ids] < 0, 0, R[np.maximum(jp[ids], 0)] + 1)
        R[ids] = _bitmap_ranks(key, 12 + wk, cnt <= kernels.RANK_SMALL_MAX and 12 + wk <= kernels.RANK_SMALL_BITS)
    return J, R


def _emulate_walk(vf, node_s_t, s_t, sgn_t, cap):
    F = _Forest(vf)
    lay = tsl.walk_layout(vf, cap)
    node_s = node_s_t.numpy().astype(np.int64)
    vtab = tsv.child_value_table(vf, s_t, sgn_t, node_s_t).numpy().astype(np.int64)
    J, R = _emulate_anchor_ranks(F, vf, node_s)
    nn, C, take = F.nn, lay.C, lay.take
    sig_ids = np.nonzero(node_s < _NEVER)[0]
    sid = np.full(take, nn, np.int64)
    sid[: min(take, sig_ids.size)] = sig_ids[:take]
    n_sig = sig_ids.size
    pay = np.zeros(lay.T, np.int64)
    key0 = np.zeros(lay.T, np.int64)
    key1 = np.zeros(lay.T, np.int64)
    slot = np.arange(8)

    def parent(c):
        sd = np.where(c < take, sid[np.minimum(c, take - 1)], nn)
        ok = sd < nn
        return ok, np.where(ok, sd, nn - 1)

    # walk_rows
    c = np.arange(C)
    ok, q = parent(c)
    r, d, m = F.decode(q)
    pxp = F.slog[r] - d == 1
    rowpass = np.where(ok, node_s[q], _NEVER)
    bx = by = bz = 0
    for t in range(F.D + 1):
        bx = bx | (((m >> (3 * t)) & 1) << t)
        by = by | (((m >> (3 * t + 1)) & 1) << t)
        bz = bz | (((m >> (3 * t + 2)) & 1) << t)
    Nh = F.N // 2
    tbp = (((F.oz[r] >> 1) + bz) * Nh + (F.oy[r] >> 1) + by) * Nh + (F.ox[r] >> 1) + bx
    dc = np.minimum(d + 1, F.D)
    tbn = F.a8[dc] + ((r - F.r0[dc]) << np.minimum(3 * d, 30)) + m
    v = vtab.reshape(-1, 8)[np.where(ok, np.where(pxp, tbp, tbn), 0)]
    rs = np.where(pxp[:, None], v & 127, v & _NEVER)
    sig = (ok[:, None] & (rs == rowpass[:, None])).astype(np.int64)
    mask = (sig << slot).sum(axis=1)
    prev = (mask[:, None] & ((1 << slot) - 1)) != 0
    emitted = (ok[:, None] & (prev | (slot != 7))).astype(np.int64)
    ispx = (ok & pxp).astype(np.int64)[:, None]
    pay[lay.E:] = ((np.clip(rowpass, 0, 63) << 1)[:, None] | ((((v >> 7) & 1) & ispx) << 13)
                   | (sig << 14) | ((ispx & sig) << 15) | (emitted << 16)).reshape(-1)
    elig = ok & ~pxp
    idxE = None
    if lay.C2 < C:
        e_ids = np.nonzero(elig)[0]
        idxE = np.full(lay.C2, C, np.int64)
        idxE[: min(lay.C2, e_ids.size)] = e_ids[: lay.C2]

    # walk_born
    def born(b):
        j, k = b >> 3, b & 7
        cc = j if idxE is None else idxE[j]
        okb, q = parent(np.minimum(cc, C - 1))
        okb &= cc < C
        r, d, m = F.decode(q)
        okb &= F.slog[r] - d != 1
        rn, dn, mn = F.decode(np.full_like(q, nn - 1))
        cd, cm = np.where(okb, d + 1, dn), np.where(okb, (m << 3) | k, mn)
        bid = np.where(okb, F.node_id(np.where(okb, r, rn), cd, cm), nn)
        anc = J[q]
        ar, ad, _ = F.decode(anc)
        p0, p1 = F.paths(cd, cm)
        return dict(ok=okb, bid=bid, bn=np.where(okb, node_s[q], _BIG),
                    arank=np.where(okb, R[anc], 0), alev5=np.where(okb, 31 - F.level(ar, ad), 0),
                    s=np.where(okb, node_s[np.minimum(bid, nn - 1)] & _NEVER, _NEVER),
                    lev=F.level(np.where(okb, r, rn), cd), p0=p0, p1=p1)

    e = born(np.arange(lay.CB))
    lba = np.where(e["ok"], (e["lev"] << 11) | (np.clip(e["bn"], 0, 63) << 5) | e["alev5"], F.nlev << 11)
    if lay.ins_pw:
        ins = [(lba << (lay.wa + lay.ins_pw)) | (e["arank"] << lay.ins_pw) | e["p0"]]
    else:
        ins = [(lba << lay.wa) | e["arank"], e["p0"]] + ([e["p1"]] if lay.path_words == 2 else [])
    counts = np.bincount(e["lev"][e["ok"]], minlength=F.nlev + 1)
    perm = _radix_chain(ins, lay.ins_bits) if lay.CB else np.zeros(0, np.int64)

    # walk_entries
    start = np.cumsum(counts[: F.nlev]) - counts[: F.nlev]
    suffix = np.r_[np.cumsum((F.off0[: F.nlev] + counts[: F.nlev])[::-1])[::-1][1:], 0]
    wbuf = np.full(nn + 1, _BIG, np.int64)
    i = np.arange(lay.CB)
    es = born(perm)
    lev = np.where(es["ok"], es["lev"], 0)
    w = np.where(es["ok"], suffix[lev] + F.off0[lev] + i - start[lev], _BIG)
    wbuf[np.where(es["ok"], es["bid"], nn)] = w
    wbuf[nn] = _BIG
    rr = np.arange(F.R)
    w_root = suffix[F.rlev[:F.R]] + F.o0[:F.R]
    wbuf[rr] = w_root
    frm = np.where(es["ok"], np.clip(es["bn"], 0, 63) + 1, 64)
    pay[: lay.CB] = (1 | (np.clip(frm, 0, 63) << 1) | (np.clip(es["s"], 0, 63) << 7)
                     | (es["ok"].astype(np.int64) << 17))
    pay[lay.CB: lay.E] = 1 | (np.clip(node_s[rr], 0, 63) << 7) | (1 << 17)
    key0[: lay.CB] = (np.where(es["ok"], w, lay.tcap) << lay.pw0) | es["p0"]
    key1[: lay.CB] = es["p1"]
    key0[lay.CB: lay.E] = w_root << lay.pw0

    # walk_rowkeys
    anc = np.where(ok, J[q], q)
    wa = wbuf[anc]
    kw = np.minimum(wa, lay.tcap) << lay.pw0
    rdq, ddq, mdq = F.decode(q)
    cp0, cp1 = F.child_paths(ddq[:, None], mdq[:, None], slot[None, :])
    key0[lay.E:] = (kw[:, None] | cp0).reshape(-1)
    key1[lay.E:] = np.broadcast_to(cp1, (C, 8)).reshape(-1)
    perm = _radix_chain([key0] + ([key1] if lay.path_words == 2 else []), lay.walk_bits)
    return pay[perm], n_sig, J, R


@pytest.mark.parametrize("N,seed,density,frac", _CASES)
def test_walk_kernel_emulation_equals_plain(N, seed, density, frac):
    vf, node_s, s, sgn, nb, _ = _inputs(N, seed, density)
    cap = _cap(vf.nn, frac)
    pay, n_sig, J, R = _emulate_walk(vf, node_s, s, sgn, cap)
    Jr, Rr = tsv.dense_anchor_ranks_ref(node_s, vf)
    np.testing.assert_array_equal(J, Jr.numpy())
    np.testing.assert_array_equal(R, Rr.numpy())
    pr, nsr = tsl._lis_items_virtual_ref(node_s, s, sgn, nb, vf, cap)
    assert n_sig == int(nsr)
    np.testing.assert_array_equal(pay, pr.numpy())  # padding items included


@pytest.mark.parametrize("fill", ["zeros", "single", "ones"])
def test_walk_kernel_emulation_degenerate(fill):
    N = 16
    n = N**3
    m = np.zeros(n, np.int32)
    if fill == "single":
        m[1234] = 7
    elif fill == "ones":
        m[:] = 1
    mags = torch.from_numpy(m)
    vf = tsv.virtual_lis_index((N, N, N), "cpu")
    nb, s, _, nm = tsv.schedule_virtual(mags, vf)
    node_s = torch.where(nm > 0, nb - nm, _NEVER).to(torch.int32)
    sgn = torch.ones(n, dtype=torch.bool)
    pay, n_sig, _, _ = _emulate_walk(vf, node_s, s, sgn, vf.nn)
    pr, nsr = tsl._lis_items_virtual_ref(node_s, s, sgn, nb, vf, vf.nn)
    assert n_sig == int(nsr)
    np.testing.assert_array_equal(pay, pr.numpy())


def test_mask_bit_test_equals_the_scan_form():
    rng = np.random.default_rng(5)
    sig = torch.from_numpy(rng.random((3000, 8)) < 0.3)
    slot = torch.arange(8, dtype=torch.int32)
    sig_i = sig.to(torch.int32)
    scan = (torch.cumsum(sig_i, dim=1) - sig_i) > 0
    assert torch.equal(tsl._earlier_sibling(sig, slot), scan)
    # the kernel's form: one 8-bit mask per row, bit k tested below slot k
    mask = (sig.numpy().astype(np.int64) << np.arange(8)).sum(axis=1)
    np.testing.assert_array_equal((mask[:, None] & ((1 << np.arange(8)) - 1)) != 0, scan.numpy())


def test_rank_plan_and_layout_at_256():
    vf = tsv.virtual_lis_index((256, 256, 256), "cpu")
    plan = vf.rank_plan()
    assert plan.counts == (7, 63, 511, 4095, 32768, 262144) and plan.nsmall == 4
    lay = tsl.walk_layout(vf, 599_185)
    assert (lay.CB, lay.T) == (2_396_704, 7_190_220) and lay.C2 == vf.nn_inner
    # base-9 paths of 7 digits: 23 bits where 4-bit digits take 28
    assert lay.walk_bits == (22 + 23,) and lay.ins_bits == (16 + 19 + 23,) and lay.ins_pw == 23
    lay0 = tsl.walk_layout(vf, 119_837)
    assert (lay0.CB, lay0.T, lay0.C2) == (958_696, 1_917_428, 119_837)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)
    vf, node_s, s, sgn, nb, _ = _inputs(16, 0, 0.4)
    before = {k: kernels.launches[k] for k in ("walk_vtab", "anchor_ranks", "walk_rows", "radix_sort")}
    tsv.child_value_table(vf, s, sgn, node_s)
    tsv.dense_anchor_ranks(node_s, vf)
    tsl._lis_items_virtual(node_s, s, sgn, nb, vf, vf.nn)
    tsl.lexsort([torch.arange(10), torch.arange(10)])
    assert {k: kernels.launches[k] for k in before} == before


def test_meta_and_cuda_less_calls_raise():
    vf = tsv.virtual_lis_index((4, 4, 4), "cpu")
    meta = torch.zeros(vf.nn, dtype=torch.int32, device="meta")
    for call in (lambda: tsv.dense_anchor_ranks(meta, vf),
                 lambda: tsl._lis_items_virtual(meta, meta, meta, 0, vf, vf.nn),
                 lambda: tsv.child_value_table(vf, meta, meta, meta)):
        with pytest.raises(ValueError):
            call()
    # lexsort is the plain chained torch.sort on every device, no dispatcher
    assert tsl.lexsort([meta]).device.type == "meta"
    cpu = torch.zeros(64, dtype=torch.int32)
    for call in (lambda: kernels.radix_sort(cpu),
                 lambda: kernels.gather(cpu, cpu),
                 lambda: kernels.walk_vtab(cpu, cpu.bool(), None, cpu, cpu, 4, 72),
                 lambda: kernels.anchor_ranks(cpu, cpu, cpu, np.zeros(0, np.int32), 0),
                 lambda: kernels.walk_rows(cpu, cpu, cpu, cpu, 8, cpu)):
        with pytest.raises(ValueError):
            call()


def test_launch_names_are_registered():
    for name in ("walk_vtab", "anchor_ranks", "walk_rows", "radix_sort"):
        assert name in kernels.launches
    assert any(src.endswith("walk.cu") for src in kernels.SOURCES)
    kernels.reset_launch_counts()
    assert all(v == 0 for v in kernels.launches.values())
