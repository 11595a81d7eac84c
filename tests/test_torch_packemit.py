"""The port's bit machinery (sperr_tpu_torch/ops/packemit.py) against
sperr_tpu/ops/packemit.py and NumPy oracles, on the CPU (plain versions of
K10, K11 and K12).  Every comparison is bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import packemit as jp
from sperr_tpu_torch.ops import packemit as tp

# the JAX side jitted: one compile per shape instead of one per primitive
_jax_pack = jax.jit(jp.masked_pack, static_argnums=(1, 2, 3))
_jax_compact = jax.jit(jp.compact_flags_rows, static_argnums=1)


def _t(a_u32: np.ndarray) -> torch.Tensor:
    """u32 words -> the int32 tensor with the same bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a_u32, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _words(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _cells_to_words(cells: np.ndarray) -> np.ndarray:
    """[rows, L] 0/1 cells -> [rows, L // 32] u32 words, LSB first."""
    b = np.packbits(cells.astype(np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(b).view("<u4")


def _np_pext32(x, m):
    out = k = 0
    for j in range(32):
        if (m >> j) & 1:
            out |= ((x >> j) & 1) << k
            k += 1
    return out


def test_pext32_random_and_edges():
    rng = np.random.default_rng(0)
    x, m = _words(rng, 4096), _words(rng, 4096)
    m[:4] = [0, 0xFFFFFFFF, 1, 0x80000000]
    got = _u(tp.pext32(_t(x), _t(m)))
    np.testing.assert_array_equal(got, np.asarray(jp.pext32(jnp.asarray(x), jnp.asarray(m))))
    want = np.asarray([_np_pext32(int(a), int(b)) for a, b in zip(x[:512], m[:512])], np.uint32)
    np.testing.assert_array_equal(got[:512], want)


def test_popcount32():
    rng = np.random.default_rng(5)
    x = _words(rng, 4096)
    x[:3] = [0, 0xFFFFFFFF, 0x80000001]
    want = np.asarray(jax.lax.population_count(jnp.asarray(x)))
    np.testing.assert_array_equal(tp.popcount32(_t(x)).numpy(), want)


def test_transpose_bits32_oracle_jax_and_inverse():
    rng = np.random.default_rng(0)
    M = 32 * 17
    x = _words(rng, M)
    y = _u(tp.transpose_bits32(_t(x)))
    np.testing.assert_array_equal(y, np.asarray(jp.transpose_bits32(jnp.asarray(x))))
    bits = ((x[:, None] >> np.arange(32)[None, :]) & 1).astype(np.uint64)
    oracle = (bits.reshape(M // 32, 32, 32) << np.arange(32, dtype=np.uint64)[None, :, None]).sum(1)
    np.testing.assert_array_equal(y, oracle.T.astype(np.uint32))
    np.testing.assert_array_equal(_u(tp.untranspose_bits32(_t(y))), x)
    np.testing.assert_array_equal(
        _u(tp.untranspose_bits32(_t(y))), np.asarray(jp.untranspose_bits32(jnp.asarray(y)))
    )


@pytest.mark.parametrize("M", [16, 16 * 13, 16 * 1000])
def test_transpose_bits32_pair_matches_interleave(M):
    rng = np.random.default_rng(M)
    a, b = _words(rng, M), _words(rng, M)
    got = _u(tp.transpose_bits32_pair(_t(a), _t(b)))
    np.testing.assert_array_equal(got, np.asarray(jp.transpose_bits32_pair(jnp.asarray(a), jnp.asarray(b))))
    v = np.empty(2 * M, np.uint32)
    v[0::2], v[1::2] = a, b
    np.testing.assert_array_equal(got, _u(tp.transpose_bits32(_t(v))))


def test_bit_helpers():
    k = np.arange(-3, 40, dtype=np.int32)
    np.testing.assert_array_equal(
        _u(tp.ones_low32(torch.from_numpy(k))), np.asarray(jp.ones_low32(jnp.asarray(k)))
    )
    rng = np.random.default_rng(7)
    lo = rng.integers(-40, 70, 3000).astype(np.int32)
    hi = rng.integers(-40, 70, 3000).astype(np.int32)
    for base in (0, 32):
        np.testing.assert_array_equal(
            _u(tp.ones_span32(torch.from_numpy(lo), torch.from_numpy(hi), base)),
            np.asarray(jp.ones_span32(jnp.asarray(lo), jnp.asarray(hi), base)),
        )
        np.testing.assert_array_equal(
            _u(tp.bit_at32(torch.from_numpy(lo), base)),
            np.asarray(jp.bit_at32(jnp.asarray(lo), base)),
        )
    sp = _u(tp.ones_span32(torch.tensor([0, 3, 10, 31, 40, -2]), torch.tensor([0, 5, 9, 31, 50, 4])))
    assert list(sp) == [1, 0b111000, 0, 0x80000000, 0, 0b11111]
    assert list(_u(tp.bit_at32(torch.tensor([0, 31, 32, -1, 5])))) == [1, 0x80000000, 0, 0, 32]
    x = _words(rng, 2048)
    x[:3] = [0x1, 0x80000000, 0xDEADBEEF]
    rv = _u(tp.bitrev32(_t(x)))
    np.testing.assert_array_equal(rv, np.asarray(jp.bitrev32(jnp.asarray(x))))
    assert rv[0] == 0x80000000 and rv[1] == 1
    assert rv[2] == int(f"{0xDEADBEEF:032b}"[::-1], 2)
    sh = rng.integers(0, 33, 2048).astype(np.uint32)
    for ours, theirs in ((tp._safe_rsh, jp._safe_rsh), (tp._safe_lsh, jp._safe_lsh)):
        np.testing.assert_array_equal(
            _u(ours(_t(x), torch.from_numpy(sh.astype(np.int32)))),
            np.asarray(theirs(jnp.asarray(x), jnp.asarray(sh))),
        )
    for k in (0, 1, 17, 31, 32):
        np.testing.assert_array_equal(_u(tp._safe_rsh(_t(x), k)), x >> np.uint64(k) if k < 32 else 0 * x)


def test_blocked_cumsum_excl():
    rng = np.random.default_rng(2)
    for n in (1, 7, 256, 1000, 70000):
        x = rng.integers(0, 32, n).astype(np.int32)
        got = tp.blocked_cumsum_excl(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.cumsum(x) - x)
        np.testing.assert_array_equal(got, np.asarray(jax.jit(jp.blocked_cumsum_excl)(jnp.asarray(x))))


@pytest.mark.parametrize(
    "B,n,dens,take",
    [(1, 4096, 0.02, 256), (3, 2048, 0.3, 1024), (2, 8192, 0.0, 64),
     (1, 1024, 1.0, 1024), (2, 4100, 0.05, 64), (2, 3000, 0.5, 100)],
)
def test_compact_flags_rows(B, n, dens, take):
    """Ascending indices, exact counts, sentinel fill, take overflow, widths
    that are not a multiple of the JAX package's block."""
    rng = np.random.default_rng(B * 1000 + n)
    flags = rng.random((B, n)) < dens
    idx, cnt = tp.compact_flags_rows(torch.from_numpy(flags), take)
    jidx, jcnt = _jax_compact(jnp.asarray(flags), take)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    for b in range(B):
        truth = np.flatnonzero(flags[b])
        m = min(take, truth.size)
        assert cnt[b] == truth.size
        np.testing.assert_array_equal(idx[b, :m].numpy(), truth[:m])
        assert (idx[b, m:].numpy() == n).all()


def _pack_both(parts_np, evb_cap=None, out_cap=None, piece_words=8):
    ours, theirs = [], []
    for valid, bits in parts_np:
        vw, bw = _cells_to_words(valid), _cells_to_words(bits)
        ours.append((_t(vw), _t(bw)))
        theirs.append((jnp.asarray(vw), jnp.asarray(bw)))
    tot_cells = sum(v.size for v, _ in parts_np)
    nrows = sum(v.shape[0] for v, _ in parts_np)
    if out_cap is None:
        out_cap = ((tot_cells // 8 + nrows + 7) // 4 + 1) * 4
    if evb_cap is None:
        evb_cap = tot_cells // (32 * piece_words) + 1
    return (
        tp.masked_pack(ours, evb_cap, out_cap, piece_words),
        _jax_pack(theirs, evb_cap, out_cap, piece_words),
    )


def _assert_same(res, jres):
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    assert int(res.total_bytes) == int(jres.total_bytes)
    assert int(res.n_nz) == int(jres.n_nz)
    assert bool(res.overflow) == bool(jres.overflow)
    if not bool(res.overflow):
        np.testing.assert_array_equal(_u(res.out_words), np.asarray(jres.out_words))


@pytest.mark.parametrize("density", [0.0, 0.03, 0.3, 0.8, 1.0])
@pytest.mark.parametrize("piece_words", [4, 8])
def test_masked_pack_matches_jax_and_reference(density, piece_words):
    rng = np.random.default_rng(int(density * 100) + piece_words)
    parts = []
    for rows, L in ((5, 512), (3, 1024), (4, 256)):
        valid = (rng.random((rows, L)) < density).astype(np.uint8)
        bits = rng.integers(0, 2, (rows, L), dtype=np.uint8) & valid
        parts.append((valid, bits))
    res, jres = _pack_both(parts, piece_words=piece_words)
    _assert_same(res, jres)
    assert not bool(res.overflow)
    ref_bytes, ref_counts = tp.masked_pack_reference(parts)
    np.testing.assert_array_equal(res.counts.numpy(), ref_counts)
    got = tp.words_to_bytes(res.out_words).numpy()
    tb = int(res.total_bytes)
    assert tb == ref_bytes.size
    np.testing.assert_array_equal(got[:tb], ref_bytes)
    assert not got[tb:].any()


def test_masked_pack_clustered_and_single_bits():
    rng = np.random.default_rng(9)
    rows, L = 6, 2048
    valid = np.zeros((rows, L), np.uint8)
    valid[0, 100:400] = 1
    valid[1, ::97] = 1
    valid[2] = 1
    valid[4, L - 1] = 1
    valid[5, :64] = 1
    bits = rng.integers(0, 2, (rows, L), dtype=np.uint8) & valid
    res, jres = _pack_both([(valid, bits)])
    _assert_same(res, jres)
    ref_bytes, _ = tp.masked_pack_reference([(valid, bits)])
    np.testing.assert_array_equal(tp.words_to_bytes(res.out_words).numpy()[: ref_bytes.size], ref_bytes)


@pytest.mark.parametrize("evb_cap,out_cap", [(1, None), (None, 16), (3, 4096), (None, 136)])
def test_masked_pack_overflow_flags(evb_cap, out_cap):
    """The piece cap and the byte cap set overflow exactly as in sperr_tpu."""
    valid = np.ones((2, 512), np.uint8)
    bits = np.ones((2, 512), np.uint8)
    res, jres = _pack_both([(valid, bits)], evb_cap=evb_cap, out_cap=out_cap)
    _assert_same(res, jres)
    assert bool(res.overflow) == (evb_cap in (1, 3) or out_cap in (16,))


def test_words_to_bytes_little_endian():
    w = _t(np.asarray([0x04030201, 0xFFFFFFFF], np.uint32))
    assert list(tp.words_to_bytes(w).numpy()) == [1, 2, 3, 4, 255, 255, 255, 255]


# ---------------------------------------------------------------------------
# K10 into the caller's buffer: planes 0 .. take-1 at rows row0 ..
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("row0,take", [(0, 32), (0, 14), (0, 22), (32, 2), (5, 1)])
def test_transpose_bits32_take_row0_matches_jax_slices(pair, row0, take):
    rng = np.random.default_rng(row0 * 40 + take + pair)
    W = 37
    R = row0 + take + 3
    if pair:
        a, b = _words(rng, 16 * W), _words(rng, 16 * W)
        want = np.asarray(jp.transpose_bits32_pair(jnp.asarray(a), jnp.asarray(b)))
    else:
        a = _words(rng, 32 * W)
        want = np.asarray(jp.transpose_bits32(jnp.asarray(a)))
    out = torch.full((R, W), -7, dtype=torch.int32)
    if pair:
        got = tp.transpose_bits32_pair(_t(a), _t(b), out, row0, take)
    else:
        got = tp.transpose_bits32(_t(a), out, row0, take)
    assert got is out
    np.testing.assert_array_equal(_u(out[row0 : row0 + take]), want[:take])
    untouched = torch.cat([out[:row0], out[row0 + take :]])
    assert (untouched == -7).all()
    fresh = tp.transpose_bits32_pair(_t(a), _t(b), take=take) if pair else tp.transpose_bits32(_t(a), take=take)
    np.testing.assert_array_equal(_u(fresh), want[:take])


# ---------------------------------------------------------------------------
# K11 in its three stages (count, scan, pack) on ragged and edge shapes
# ---------------------------------------------------------------------------
def _thin_words(rng, shape, k):
    """u32 words whose bits are set with probability 2^-k (k = 0: all ones;
    None: all zeros)."""
    w = np.full(shape, 0 if k is None else 0xFFFFFFFF, np.uint32)
    for _ in range(k or 0):
        w &= _words(rng, int(np.prod(shape))).reshape(shape)
    return w


def _pack_case(name):
    """(parts as u32 (valid, bits) word pairs, evb_cap, out_cap or None for
    caps that hold everything)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    spec = {
        # rows shorter than a tile and rows that end mid-tile (tile 16 or 64)
        "ragged": [(3, 24, 3), (2, 200, 5), (4, 8, 1)],
        # empty rows, an empty part, all-ones words
        "empty": [(3, 64, None), (0, 32, 2), (2, 48, 0), (1, 16, 2)],
        "dense": [(2, 136, 1), (5, 32, 2)],
        "overflow_pieces": [(3, 24, 3), (2, 200, 5)],
        "overflow_bytes": [(3, 24, 3), (2, 200, 5)],
    }[name]
    parts = [(_thin_words(rng, (r, w), k), _words(rng, r * w).reshape(r, w)) for r, w, k in spec]
    if name == "empty":
        parts[0][0][1, 3] = 0x10001  # one row of the empty part holds two bits
    evb_cap, out_cap = {"overflow_pieces": (3, None), "overflow_bytes": (None, 40)}.get(name, (None, None))
    return parts, evb_cap, out_cap


def _caps(parts, piece_words, evb_cap, out_cap):
    words = sum(v.size for v, _ in parts)
    rows = sum(v.shape[0] for v, _ in parts)
    if out_cap is None:
        out_cap = ((4 * words + rows + 7) // 4 + 1) * 4
    if evb_cap is None:
        evb_cap = words // piece_words + 1
    return evb_cap, out_cap


def _word_cells(w):
    """(rows, W) u32 words -> (rows, 32 W) 0/1 cells, LSB first."""
    return np.unpackbits(np.ascontiguousarray(w).view(np.uint8), axis=1, bitorder="little")


_PACK_CASES = ["ragged", "empty", "dense", "overflow_pieces", "overflow_bytes"]


@pytest.mark.parametrize("tile", [16, 64, 2048])
@pytest.mark.parametrize("piece_words", [4, 8])
@pytest.mark.parametrize("name", _PACK_CASES)
def test_masked_pack_stages_match_jax(name, piece_words, tile):
    parts, evb_cap, out_cap = _pack_case(name)
    evb_cap, out_cap = _caps(parts, piece_words, evb_cap, out_cap)
    tparts = [(_t(v), _t(b)) for v, b in parts]
    jres = _jax_pack([(jnp.asarray(v), jnp.asarray(b)) for v, b in parts], evb_cap, out_cap, piece_words)
    jcounts = np.asarray(jres.counts).astype(np.int64)

    # count: per tile, against NumPy, and summed per row against sperr_tpu
    layout = tp._pack_layout(tparts, tile)
    tile_bits, tile_nz = tp.pack_count_ref(tparts, piece_words, tile)
    want_bits, want_nz = [], []
    for (v, _), (rows, W, tpr) in zip(parts, layout):
        pad = np.zeros((rows, tpr * tile), np.uint32)
        pad[:, :W] = v
        t = pad.reshape(rows * tpr, tile)
        want_bits.append(np.unpackbits(t.view(np.uint8), axis=1).sum(axis=1))
        want_nz.append((t.reshape(rows * tpr, tile // piece_words, piece_words) != 0)
                       .any(axis=2).sum(axis=1))
    np.testing.assert_array_equal(tile_bits.numpy(), np.concatenate(want_bits))
    np.testing.assert_array_equal(tile_nz.numpy(), np.concatenate(want_nz))
    assert int(tile_nz.sum()) == int(jres.n_nz)

    # scan: counts, totals and overflow as sperr_tpu; each tile's base is its
    # row's byte-aligned base plus the bits of the tiles before it in the row
    take = min(evb_cap, sum(v.size for v, _ in parts) // piece_words)
    counts, tile_base, total_bytes, overflow, n_nz = tp.pack_scan_ref(
        tile_bits, tile_nz, layout, take, out_cap
    )
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    assert int(total_bytes) == int(jres.total_bytes)
    assert int(n_nz) == int(jres.n_nz)
    assert bool(overflow) == bool(jres.overflow) == name.startswith("overflow")
    row_base = 8 * (np.cumsum((jcounts + 7) >> 3) - ((jcounts + 7) >> 3))
    want_base, t0, r0 = [], 0, 0
    for rows, _, tpr in layout:
        tb = tile_bits.numpy()[t0 : t0 + rows * tpr].reshape(rows, tpr).astype(np.int64)
        want_base.append((np.cumsum(tb, axis=1) - tb + row_base[r0 : r0 + rows, None]).reshape(-1))
        t0, r0 = t0 + rows * tpr, r0 + rows
    np.testing.assert_array_equal(tile_base.numpy(), np.concatenate(want_base))

    # pack: the words of sperr_tpu and the bytes of the NumPy oracle
    out = tp.pack_tiles_ref(tparts, tile_base, tile, out_cap)
    ref_bytes, ref_counts = tp.masked_pack_reference(
        [(_word_cells(v), _word_cells(b)) for v, b in parts]
    )
    np.testing.assert_array_equal(ref_counts, jcounts)
    got = tp.words_to_bytes(out).numpy()
    n = min(ref_bytes.size, got.size)
    np.testing.assert_array_equal(got[:n], ref_bytes[:n])
    assert not got[n:].any()
    if not bool(jres.overflow):
        np.testing.assert_array_equal(_u(out), np.asarray(jres.out_words))

    # the whole plain K11 is the three stages
    res = tp.masked_pack_ref(tparts, evb_cap, out_cap, piece_words, tile)
    for x, y in zip(res, (out, counts, total_bytes, overflow, n_nz)):
        assert torch.equal(x, y)
    _assert_same(res, jres)


# ---------------------------------------------------------------------------
# the emission's word buffers: every 32-pass window writes into one (P, W)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", [14, 22, 34])
@pytest.mark.parametrize("pair", [False, True])
def test_emit_words_into_one_buffer_match_jax(P, pair):
    from sperr_tpu.ops import wave_pack as jwp
    from sperr_tpu_torch.ops import wave_pack as twp

    rng = np.random.default_rng(P * 2 + pair)
    M = (16 if pair else 32) * 37
    masks = {base: [_words(rng, M) for _ in range(4 if pair else 2)] for base in range(0, P, 32)}
    jfn = (jwp._emit_words_pair if pair else jwp._emit_words)
    tfn = (twp._emit_words_pair if pair else twp._emit_words)
    jv, jb = jfn(lambda base: [jnp.asarray(m) for m in masks[base]], P)
    tv, tb = tfn(lambda base: [_t(m) for m in masks[base]], P)
    assert tv.shape == tb.shape == (P, M // (16 if pair else 32))
    np.testing.assert_array_equal(_u(tv), np.asarray(jv))
    np.testing.assert_array_equal(_u(tb), np.asarray(jb))
