"""The 3D emission's pixel stage (K9, sperr_tpu_torch/ops/wave_pack.py and
kernels/emit.cu) on the CPU.

``wave_emit_3d`` is held against sperr_tpu's on cases the other emission
tests leave out (an exposure that overflows, all-zero and one-pixel chunks,
N = 64 at P = 16 and P = 34), exactly.  The kernels cannot run here, so
their index arithmetic is emulated in numpy as the CUDA code does it and
held against the plain versions bit for bit: the cube's rows launch (flag
words, row counts, the look-back with the tiles' steps interleaved in a
random order, the clamped bases), the planes launch's inversion of the rank
formula (slab and row searches, the select in the flag words), its
sentinels, its block -> class mapping and its LIS loads, against
``emit_cube_ref``; and K9b's lane mapping, register masks and shuffle
transpose against the plain masks through the plain K10.  The 512^3 walk's
static layout (two path words) is checked here too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import speck_lis_jax as jsl
from sperr_tpu.ops import speck_virtual as jsv
from sperr_tpu.ops import wave_pack as jwp
from sperr_tpu_torch import kernels
from sperr_tpu_torch.ops import speck_lis as tsl
from sperr_tpu_torch.ops import speck_virtual as tsv
from sperr_tpu_torch.ops import wave_pack as twp
from sperr_tpu_torch.parallel import batched as tb

_NEVER = 0x7FFF
_NOOP_ROW = 126  # payload of a child row of a padding parent: emits nothing
_FULL = 0xFFFFFFFF


def _schedule(N, mags):
    vt = tsv.virtual_lis_index((N, N, N), "cpu")
    mt = torch.from_numpy(mags)
    nb = tsv.msbp1_device(mt).max()
    s, e, nm = tsv.pixel_schedule_virtual(mt, vt, nb)
    node_s = torch.where(nm > 0, nb - nm, _NEVER).to(torch.int32)
    return vt, nb, s, e, node_s


@functools.lru_cache(maxsize=None)
def _jax_emit(N, P, node_cap, evb_cap, out_cap, wexp_cap):
    vj = jsv.virtual_lis_index((N, N, N))
    return jax.jit(
        lambda m, g, s, e, ns, nb: jwp.wave_emit_3d(
            m, g, s, e, ns, nb, vj, P, node_cap, evb_cap, out_cap, wexp_cap
        )
    )


@functools.lru_cache(maxsize=None)
def _jax_walk(N):
    vj = jsv.virtual_lis_index((N, N, N))
    return jax.jit(
        lambda ns, s, g, nb: jsl.lis_segments_device(
            ns, s, g, nb, vj, 34, vj.nn, 0, 0, return_events="items"
        )[0]
    )


def _tie_swaps(N, node_s, s, sgn, nb, vt):
    """Walk positions where sperr_tpu's unstable sort placed a tied padding
    row elsewhere than the port's stable sort (no stream bit moves; a cell
    may move to another piece, n_nz)."""
    pt = tsl.lis_segments_device(node_s, s, torch.from_numpy(sgn), nb, vt, 34, vt.nn,
                                 return_events="items")[0].numpy()
    pj = np.asarray(_jax_walk(N)(jnp.asarray(node_s.numpy()), jnp.asarray(s.numpy()),
                                 jnp.asarray(sgn), jnp.asarray(nb.numpy())))
    keep = lambda p: p[p != _NOOP_ROW]
    np.testing.assert_array_equal(keep(pt), keep(pj))
    return int(np.count_nonzero(pt != pj))


def _chunk(N, kind, seed):
    rng = np.random.default_rng(seed)
    n = N**3
    mags = np.zeros(n, np.int32)
    if kind == "zero":
        pass
    elif kind == "one":
        mags[rng.integers(n)] = 1 << 13
    else:
        density, hi = kind
        mags = (rng.integers(0, hi, size=n) * (rng.random(n) < density)).astype(np.int32)
    return mags, rng.random(n) < 0.5


# (N, P, wexp_cap, chunk): an exposure that overflows its cap (wexp_cap far
# below the exposed pixels, magnitudes packed and apart), an all-zero and a
# one-pixel chunk with and without the compaction, and N = 64 with the
# compaction at P = 16 (magnitudes in the box-major table) and P = 34
_CASES = [
    (32, 16, 512, (0.3, 1 << 12)),
    (32, 34, 1000, (0.3, 1 << 20)),
    (16, 16, 1024, "zero"),
    (16, 16, 0, "zero"),
    (16, 34, 2048, "one"),
    (16, 16, 0, "one"),
    (64, 16, 65536, (0.05, 1 << 14)),
    (64, 34, 65536, (0.05, 1 << 24)),
]


@pytest.mark.parametrize("N,P,wexp_cap,kind", _CASES)
def test_wave_emit_matches_jax_on_edge_chunks(N, P, wexp_cap, kind):
    mags, sgn = _chunk(N, kind, N + P + wexp_cap)
    vt, nb, s, e, node_s = _schedule(N, mags)
    n = N**3
    node_cap, evb_cap, out_cap = vt.nn, 1 << 20, 8 * n
    ours = twp.wave_emit_3d(
        torch.from_numpy(mags), torch.from_numpy(sgn), s, e, node_s, nb, vt, P,
        node_cap, evb_cap, out_cap, wexp_cap,
    )
    theirs = _jax_emit(N, P, node_cap, evb_cap, out_cap, wexp_cap)(
        jnp.asarray(mags), jnp.asarray(sgn), jnp.asarray(s.numpy()), jnp.asarray(e.numpy()),
        jnp.asarray(node_s.numpy()), jnp.asarray(nb.numpy()),
    )
    for f in ("num_bp", "counts", "total_bytes", "n_sig", "overflow", "exp_idx", "exp_ll", "n_exp"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)), f)
    if wexp_cap and kind not in ("zero", "one") and N == 32:
        assert bool(ours.overflow) and int(ours.n_exp) > wexp_cap  # the exposure overflows
    swaps = _tie_swaps(N, node_s, s, sgn, nb, vt)
    assert abs(int(ours.n_nz) - int(theirs.n_nz)) <= swaps
    tbytes = int(ours.total_bytes)
    if not bool(ours.overflow):
        np.testing.assert_array_equal(ours.seg.numpy()[:tbytes], np.asarray(theirs.seg)[:tbytes])


# ---------------------------------------------------------------------------
# K9 on a cube: the kernels' index arithmetic, emulated
# ---------------------------------------------------------------------------
def _box_major(x, N):
    h = N // 2
    return x.reshape(h, 2, h, 2, h, 2).transpose(0, 2, 4, 1, 3, 5).reshape(-1)


def _pv_table(s, sgn, mags, N, pack_mag):
    pv = np.clip(s, 0, 127).astype(np.int64) | (sgn.astype(np.int64) << 7)
    if pack_mag:
        pv |= np.minimum(mags.astype(np.int64), (1 << 23) - 1) << 8
    return _box_major(pv.astype(np.int32), N)


def _popc(x):
    x = np.asarray(x, np.int64) & _FULL
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _FULL) >> 24


def _run_actors(starts, rng):
    """Run the look-back's actors with their steps interleaved in a random
    order.  ``starts`` are generator functions in ticket order: actor i
    starts only after actor i - 1 has (the ticket); each yield is a point
    where another actor may run (a publish, a read, or a wait on a status
    word not yet published)."""
    live, nxt = [], 0
    while live or nxt < len(starts):
        k = int(rng.integers(len(live) + (nxt < len(starts))))
        if k == len(live):
            live.append(starts[nxt]())
            nxt += 1
        try:
            next(live[k])
        except StopIteration:
            live.pop(k)


_AGG, _PREFIX = 1, 2


def _lookback_tile(t, agg, state, val, excl):
    """The rows kernel's look-back for tile t: publish the aggregate (tile
    0 its inclusive prefix), read 256 predecessors a step (thread i the
    i-th nearest; a word not yet published is waited for) to the nearest
    inclusive prefix, publish its own."""
    if t == 0:
        state[0], val[0], excl[0] = _PREFIX, agg[0], 0
        return
    state[t], val[t] = _AGG, agg[t]
    yield
    prefix, j = 0, t - 1
    while True:
        q = j - np.arange(256)
        while any(state[x] == 0 for x in q if x >= 0):
            yield
        st = np.array([state[x] if x >= 0 else _PREFIX for x in q])
        v = np.array([val[x] if x >= 0 else 0 for x in q])
        pm = st == _PREFIX
        first = int(np.argmax(pm)) if pm.any() else 256
        prefix += int(v[:first + 1].sum())
        if pm.any():
            break
        j -= 256
        yield
    state[t], val[t], excl[t] = _PREFIX, prefix + agg[t], prefix


def _rows_emulated(pv, s, nb, N, take_b, rng):
    """exposed_rows in numpy: the flag words (ballots) and row counts of
    each 64-row tile, its look-back with the tiles' steps interleaved in a
    random order, and the clamped row bases, n_exp and the overflow flag.
    The flag is read from s itself when num_bp is outside [1, 127]."""
    Nh = N // 2
    NR = Nh * Nh
    fw = -(-Nh // 32)
    boxes = pv.reshape(NR, Nh, 8)
    if 1 <= nb <= 127:
        flag = (boxes & 127).min(axis=2) < nb
    else:
        sv = np.where(s < _NEVER, s, _NEVER)
        flag = _box_major(sv, N).reshape(NR, Nh, 8).min(axis=2) < nb
    words = np.zeros((NR, fw), np.int64)
    for c in range(fw):
        for lane in range(32):
            if 32 * c + lane < Nh:
                words[:, c] |= flag[:, 32 * c + lane].astype(np.int64) << lane
    cnt = _popc(words).sum(axis=1)
    ntiles = -(-NR // 64)
    tcnt = np.zeros(ntiles * 64, np.int64)
    tcnt[:NR] = cnt
    tcnt = tcnt.reshape(ntiles, 64)
    agg = tcnt.sum(axis=1)
    state, val, excl = np.zeros(ntiles, int), np.zeros(ntiles, np.int64), np.zeros(ntiles, np.int64)
    _run_actors([lambda t=t: _lookback_tile(t, agg, state, val, excl) for t in range(ntiles)], rng)
    e = (excl[:, None] + np.cumsum(tcnt, axis=1) - tcnt).reshape(-1)[:NR]
    total = int(excl[-1] + agg[-1])
    base = np.minimum(np.append(e, total), take_b)
    return words, base, 8 * total, total > take_b


def _search_base(at, cnt, off, scale, r):
    """search_bases on arrays of ranks: the largest i in [0, cnt) (a power
    of two) with scale * (at(i) - off) <= r, by steps of cnt / 2, cnt / 4,
    .., 1."""
    idx, step = np.zeros_like(r), cnt >> 1
    while step:
        idx = np.where(scale * (at(idx + step) - off) <= r, idx + step, idx)
        step >>= 1
    return idx


def _select32(w, j):
    """select32: the position of the j-th set bit of w, by halving."""
    w, j, pos = np.asarray(w, np.int64), np.asarray(j, np.int64), np.zeros(np.shape(j), np.int64)
    for sh in (16, 8, 4, 2, 1):
        c = _popc(w & ((1 << sh) - 1))
        mv = j >= c
        j = np.where(mv, j - c, j)
        w = np.where(mv, w >> sh, w)
        pos = pos + np.where(mv, sh, 0)
    return pos


def _rank_inverse(words, base, N, r):
    """The planes launch's inversion of the rank formula for ranks r:
    (zb, dz, yb, dy, xb, dx) by the slab search, the row search, arithmetic
    and the select in the row's flag words."""
    Nh = N // 2
    fw = words.shape[1]
    zb = _search_base(lambda m: base[m * Nh], Nh, 0, 8, r)
    B = base[zb * Nh]
    K = base[(zb + 1) * Nh] - B
    q = r - 8 * B
    dz = (q >= 4 * K).astype(np.int64)
    q = q - dz * 4 * K
    yb = _search_base(lambda m: base[zb * Nh + m], Nh, B, 4, q)
    row = zb * Nh + yb
    b0 = base[row]
    k = base[row + 1] - b0
    q = q - 4 * (b0 - B)
    dy = (q >= 2 * k).astype(np.int64)
    q = q - dy * 2 * k
    j, dx = q >> 1, q & 1
    xb = np.full_like(r, -1)
    for c in range(fw):
        f = words[row, c]
        pc = _popc(f)
        hit = (xb < 0) & (j < pc)
        xb = np.where(hit, 32 * c + _select32(f, np.where(hit, j, 0)), xb)
        j = np.where((xb < 0), j - pc, j)
    assert (xb >= 0).all()
    return zb, dz, yb, dy, xb, dx


def _cube_fields_emulated(pv, mags, words, base, n_exp, N, wexp_cap, pack_mag):
    """The planes launch's pixel blocks on a cube: each rank's (s, e, sign,
    magnitude) from its box, exp_idx and exp_ll at the kept ranks, and past
    them the sentinels."""
    n = N**3
    Nh = N // 2
    take_b = max(1, wexp_cap // 8)
    Lv = min(8 * take_b, wexp_cap)
    npad = -(-wexp_cap // 256) * 256
    Rk = 8 * int(base[-1])
    lo = min(Rk, Lv)
    r = np.arange(lo, dtype=np.int64)
    zb, dz, yb, dy, xb, dx = _rank_inverse(words, base, N, r)
    box = pv.reshape(-1, 8)[(zb * Nh + yb) * Nh + xb].astype(np.int64)
    slot = 4 * dz + 2 * dy + dx
    val = box[np.arange(lo), slot]
    lin = ((2 * zb + dz) * N + 2 * yb + dy) * N + 2 * xb + dx
    f = {"s": np.full(npad, _NEVER, np.int64), "e": np.full(npad, _NEVER, np.int64),
         "g": np.zeros(npad, np.int64), "m": np.zeros(npad, np.int64)}
    f["s"][:lo], f["e"][:lo], f["g"][:lo] = val & 127, (box & 127).min(axis=1), (val >> 7) & 1
    f["m"][:lo] = (val >> 8) if pack_mag else mags[lin]
    rt = np.arange(lo, npad)
    f["s"][lo:] = f["e"][lo:] = np.where(rt < n_exp, 0, _NEVER)
    exp_idx = np.zeros(Lv, np.int64)
    exp_ll = np.zeros(wexp_cap, np.int64)
    exp_idx[:lo], exp_ll[:lo] = lin, np.where(f["g"][:lo] == 1, f["m"][:lo], -f["m"][:lo])
    exp_idx[Rk:Lv] = n
    return exp_idx, exp_ll, f


def _stage_blocks(items, W_lis):
    """The planes launch's blocks: pixel block b owns LIP words [64 b, 64 b
    + 64) and REF words [32 b, 32 b + 32) of the items' (1024 a block), the
    rest 64 LIS words each.  Returns {class: [(block, first word, words)]}."""
    nbp = -(-items // kernels.STAGE_ITEMS)
    nbl = -(-W_lis // kernels.STAGE_LIS_WORDS)
    out = {"lip": [], "lis": [], "ref": []}
    for blk in range(nbp + nbl):
        if blk < nbp:
            for kind, per in (("lip", 64), ("ref", 32)):
                W = items // (1024 // per)
                w0 = blk * per
                out[kind].append((blk, w0, min(per, W - w0)))
        else:
            w0 = (blk - nbp) * kernels.STAGE_LIS_WORDS
            out["lis"].append((blk, w0, min(kernels.STAGE_LIS_WORDS, W_lis - w0)))
    return out


def _lis_items_loaded(pay, w0, aligned=True):
    """lis_block's loads for the block at LIS word w0: lane l of warp v
    loads items 2 l, 2 l + 1 and 64 + 2 l, 65 + 2 l of the warp's 128 (one
    8-byte load each when aligned and in range), then word i's lane l takes
    item 16 i + l / 2 from lane 8 (i & 3) + l / 4 by shuffle.  Returns the
    (64 words, 32 lanes) payload the lanes hold."""
    n_pay = pay.shape[0]
    get = lambda i: int(pay[i]) if i < n_pay else 0
    out = np.zeros((64, 32), np.int64)
    for v in range(8):
        x = np.zeros((32, 4), np.int64)
        for lane in range(32):
            for h in range(2):
                i = 16 * (w0 + 8 * v) + 2 * lane + 64 * h
                x[lane, 2 * h], x[lane, 2 * h + 1] = get(i), get(i + 1)
        for i in range(8):
            for lane in range(32):
                src = 8 * (i & 3) + (lane >> 2)
                ya, yb = x[src, 0 if i < 4 else 2], x[src, 1 if i < 4 else 3]
                out[8 * v + i, lane] = yb if lane & 2 else ya
    return out


def _stage_emulated(pv, mags, s, nb, N, wexp_cap, pack_mag, pay, P, rng):
    """emit_cube's two launches in numpy: the rows launch (flags, counts,
    out-of-order look-back, clamped bases), the planes launch's rank
    inversion and sentinels, and the three classes' planes built word by
    word with the blocks' lane mapping.  Returns emit_cube_ref's outputs."""
    take_b = max(1, wexp_cap // 8)
    words, base, n_exp, over = _rows_emulated(pv, s, nb, N, take_b, rng)
    exp_idx, exp_ll, f = _cube_fields_emulated(pv, mags, words, base, n_exp, N, wexp_cap, pack_mag)
    npad = f["s"].shape[0]
    W_lis = -(-pay.shape[0] // 128) * 128 // 16
    blocks = _stage_blocks(npad, W_lis)
    lip = _planes_emulated("lip", (f["s"], f["e"], f["g"]), nb, P, npad)
    ref = _planes_emulated("ref", (f["s"], f["m"]), nb, P, npad)
    lis = np.zeros((2, P, W_lis), np.int64)
    for _, w0, nw in blocks["lis"]:
        held = _lis_items_loaded(pay, w0)[:nw]
        want = np.array([[pay[i] if i < pay.shape[0] else 0 for i in 16 * (w0 + w) + np.arange(32) // 2]
                         for w in range(nw)], np.int64)
        np.testing.assert_array_equal(held, want)
        lis[:, :, w0:w0 + nw] = _planes_emulated("lis", (want.reshape(-1)[::2],), nb, P, 16 * nw)
    return exp_idx, exp_ll, n_exp, over, [lip, tuple(lis), ref]


def _exposed_inputs(N, density, seed, nb=14):
    rng = np.random.default_rng(seed)
    n = N**3
    s = np.where(rng.random(n) < density, rng.integers(0, max(nb, 1), size=n), _NEVER).astype(np.int32)
    sgn = rng.random(n) < 0.5
    mags = rng.integers(0, 1 << 26, size=n).astype(np.int32)
    return s, sgn, mags


def _exposed_boxes(s, nb, N):
    return int(((_box_major(np.where(s < _NEVER, s, _NEVER), N).reshape(-1, 8).min(axis=1)) < nb).sum())


def _payload(rng, n_pay):
    return rng.integers(-(1 << 31), 1 << 31, size=n_pay, dtype=np.int64).astype(np.int32)


def _stage_check(pv, mags, s, nb, N, wexp_cap, pack_mag, pay, P, rng):
    """The emulation against emit_cube_ref, every output bit for bit (the
    refinement class where num_bp is in [0, 32]: the plain version's
    logical shift by 32 - num_bp is defined on [0, 32] only)."""
    want = twp.emit_cube_ref(torch.from_numpy(pv), torch.from_numpy(mags), torch.from_numpy(s),
                             torch.tensor(nb, dtype=torch.int32), N, wexp_cap, pack_mag,
                             torch.from_numpy(pay), P)
    got = _stage_emulated(pv, mags, s, nb, N, wexp_cap, pack_mag, pay, P, rng)
    for name, a, b in zip(("exp_idx", "exp_ll", "n_exp", "overflow"), got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy().astype(np.int64), name)
    for kind, (gv, gb), (wv, wb) in zip(("lip", "lis", "ref"), got[4], want[4]):
        if kind == "ref" and not 0 <= nb <= 32:
            continue
        np.testing.assert_array_equal(gv, _as_u32(wv), f"{kind} valid")
        np.testing.assert_array_equal(gb, _as_u32(wb), f"{kind} bits")
    return want


@pytest.mark.parametrize("N", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
@pytest.mark.parametrize("cut", ["one", "middle", "none"])
def test_exposed_emulation_matches_the_plain_sort(N, density, cut):
    """The cube's two launches, emulated, against the plain version (the
    plain K12 over the boxes, the sort, the masks through the plain K10):
    both magnitude layouts, P = 16 with packed magnitudes and P = 34 (two
    windows) with magnitudes apart."""
    seed = N * 7 + int(density * 100)
    s, sgn, mags = _exposed_inputs(N, density, seed)
    nb = 14
    nbox = _exposed_boxes(s, nb, N)
    n = N**3
    wexp_cap = {"one": 8, "middle": max(8, 8 * (nbox // 2) + 3), "none": n - 1}[cut]
    wexp_cap = min(wexp_cap, n - 1)
    rng = np.random.default_rng(seed)
    for pack_mag, P in ((True, 16), (False, 34)):
        pv = _pv_table(s, sgn, mags, N, pack_mag)
        pay = _payload(rng, int(rng.integers(1, 3000)))
        want = _stage_check(pv, mags, s, nb, N, wexp_cap, pack_mag, pay, P, rng)
        if cut == "one" and nbox > 1:
            assert bool(want[3])


@pytest.mark.parametrize("nb", [0, -3, 200])
def test_exposed_emulation_reads_s_outside_the_clipped_range(nb):
    """num_bp outside [1, 127]: the clipped box minimum gives another flag
    than the box minimum of s (negative s, or s past 127), so the rows
    kernel reads s itself."""
    N = 8
    rng = np.random.default_rng(3 + nb)
    n = N**3
    s = rng.integers(-20, 300, size=n).astype(np.int32)
    s[rng.random(n) < 0.3] = _NEVER
    sgn = rng.random(n) < 0.5
    mags = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    pv = _pv_table(s, sgn, mags, N, True)
    for wexp_cap in (8, 200, n - 1):
        _stage_check(pv, mags, s, nb, N, wexp_cap, True, _payload(rng, 300), 16, rng)


@pytest.mark.parametrize("wexp_cap", [1, 5, 7])
def test_exposed_caps_below_one_box(wexp_cap):
    """wexp_cap < 8 keeps one box (take_b = 1) and places only wexp_cap of
    its pixels; the rest of n_exp reads (0, 0, 0, 0)."""
    N = 8
    s, sgn, mags = _exposed_inputs(N, 0.3, wexp_cap)
    pv = _pv_table(s, sgn, mags, N, False)
    rng = np.random.default_rng(wexp_cap)
    want = _stage_check(pv, mags, s, 14, N, wexp_cap, False, _payload(rng, 100), 16, rng)
    assert want[0].shape == (wexp_cap,) and want[1].shape == (wexp_cap,) and want[4][0][0].shape == (16, 16)


@pytest.mark.parametrize("tiles", [1, 2, 33, 300, 700])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_lookback_out_of_order(tiles, seed):
    """The rows launch's look-back gives every tile its exclusive prefix
    whatever order the tiles' steps interleave in (windows of 256
    predecessors, aggregates and prefixes mixed), and the clamped bases
    equal the plain clamped prefix at every take_b."""
    rng = np.random.default_rng(tiles * 10 + seed)
    agg = rng.integers(0, 50, size=tiles) * (rng.random(tiles) < 0.7)
    state, val, excl = np.zeros(tiles, int), np.zeros(tiles, np.int64), np.zeros(tiles, np.int64)
    _run_actors([lambda t=t: _lookback_tile(t, agg, state, val, excl) for t in range(tiles)], rng)
    np.testing.assert_array_equal(excl, np.cumsum(agg) - agg)
    assert (state == _PREFIX).all() and (val == np.cumsum(agg)).all()
    # whole rows launches on an N = 32 cube (256 rows: 4 tiles) and N = 64 (16)
    for N in (32, 64):
        s, sgn, mags = _exposed_inputs(N, 0.1, seed + N)
        pv = _pv_table(s, sgn, mags, N, True)
        flag = (pv.reshape(-1, 8) & 127).min(axis=1) < 14
        incl = np.concatenate([[0], np.cumsum(flag.reshape(-1, N // 2).sum(axis=1))])
        for take_b in (1, int(incl[-1]) // 3 + 1, int(incl[-1]) + 5):
            _, base, n_exp, over = _rows_emulated(pv, s, 14, N, take_b, rng)
            np.testing.assert_array_equal(base, np.minimum(incl, take_b))
            assert n_exp == 8 * incl[-1] and over == (incl[-1] > take_b)


@pytest.mark.parametrize("N", [2, 8, 32])
@pytest.mark.parametrize("density", [0.05, 0.5])
def test_rank_inversion_inverts_the_rank_formula(N, density):
    """Every kept slot's rank 8 B + dz 4 K + 4 R + dy 2 k + 2 j + dx, from the
    kept boxes enumerated in box order, inverts to its (zb, dz, yb, dy, xb,
    dx), with the cut inside a row, a slab and nowhere."""
    s, sgn, mags = _exposed_inputs(N, density, N + int(density * 10))
    pv = _pv_table(s, sgn, mags, N, True)
    Nh = N // 2
    flag = ((pv.reshape(-1, 8) & 127).min(axis=1) < 14).reshape(Nh, Nh, Nh)
    kept_all = np.argwhere(flag)  # (zb, yb, xb), box order
    rng = np.random.default_rng(N)
    for take_b in sorted({1, max(1, len(kept_all) // 2 + 1), len(kept_all) + 3}):
        words, base, _, _ = _rows_emulated(pv, s, 14, N, take_b, rng)
        kept = kept_all[:take_b]
        if not len(kept):
            continue
        want = []
        for zb, yb, xb in kept:
            row = zb * Nh + yb
            B, K = base[zb * Nh], base[(zb + 1) * Nh] - base[zb * Nh]
            R, k = base[row] - B, base[row + 1] - base[row]
            j = int(np.sum((kept[:, 0] == zb) & (kept[:, 1] == yb) & (kept[:, 2] < xb)))
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        want.append((8 * B + dz * 4 * K + 4 * R + dy * 2 * k + 2 * j + dx, zb, dz, yb, dy, xb, dx))
        want = np.array(sorted(want))
        np.testing.assert_array_equal(want[:, 0], np.arange(8 * len(kept)))  # a bijection onto [0, 8 kept)
        got = np.stack(_rank_inverse(words, base, N, want[:, 0]), axis=1)
        np.testing.assert_array_equal(got, want[:, 1:])


@pytest.mark.parametrize("items,n_pay", [(256, 1), (1024, 128), (1280, 1000), (4096, 4097), (256, 0)])
def test_stage_blocks_cover_each_class_once(items, n_pay):
    """The planes launch's block -> class mapping: every LIP, REF and LIS
    word is made by exactly one block, the pixel blocks first; the LIS
    loads (8-byte pairs, then the shuffle) give each lane its item, aligned
    and not, with the payload's end inside a pair."""
    W_lis = -(-n_pay // 128) * 128 // 16
    blocks = _stage_blocks(items, W_lis)
    for kind, W in (("lip", items // 16), ("ref", items // 32), ("lis", W_lis)):
        seen = np.zeros(W, int)
        for _, w0, nw in blocks[kind]:
            assert nw > 0
            seen[w0:w0 + nw] += 1
        assert (seen == 1).all(), kind
    nbp = -(-items // 1024)
    assert [b for b, _, _ in blocks["lip"]] == list(range(nbp))
    assert [b for b, _, _ in blocks["lis"]] == list(range(nbp, nbp + -(-W_lis // 64)))
    pay = _payload(np.random.default_rng(n_pay), n_pay)
    for _, w0, nw in blocks["lis"]:
        held = _lis_items_loaded(pay, w0)
        item = 16 * (w0 + np.arange(64))[:, None] + np.arange(32)[None, :] // 2
        want = np.where(item < n_pay, pay[np.minimum(item, max(n_pay - 1, 0))] if n_pay else 0, 0)
        np.testing.assert_array_equal(held, want)


# ---------------------------------------------------------------------------
# K9b: the masks in registers and the shuffle transpose, emulated
# ---------------------------------------------------------------------------
def _wrap(x):
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _ones_low(k):
    k = np.asarray(k, np.int64)
    return np.where(k <= 0, 0, np.where(k >= 32, _FULL, (np.int64(1) << np.clip(k, 0, 31)) - 1)).astype(np.int64)


def _ones_span(lo, hi, base):
    return _ones_low(_wrap(_wrap(hi - base) + 1)) & (~_ones_low(_wrap(lo - base)) & _FULL)


def _bit_at(p, base):
    r = _wrap(np.asarray(p, np.int64) - base)
    return np.where((r >= 0) & (r < 32), np.int64(1) << np.clip(r, 0, 31), 0)


def _srl(x, k):
    k = np.asarray(k, np.int64)
    return np.where(k >= 32, 0, np.where(k <= 0, x, np.asarray(x, np.int64) >> np.clip(k, 0, 31)))


def _brev(x):
    x = np.asarray(x, np.int64) & _FULL
    out = np.zeros_like(x)
    for i in range(32):
        out |= ((x >> i) & 1) << (31 - i)
    return out


def _cell_masks(kind, a, b, c, odd, nb, base):
    """emit.cu cell_masks, lane by lane."""
    if kind == "lip":
        mvA = _ones_span(_wrap(b + 1), np.minimum(a, nb - 1), base)
        mbA = _bit_at(a, base)
        mvB = np.where(b < a, _bit_at(a, base), 0)
        mbB = np.where(c == 1, _FULL, 0)
        return np.where(odd, mvB, mvA), np.where(odd, mbB, mbA)
    if kind == "lis":
        ent = (a & 1) == 1
        lo, s6 = (a >> 1) & 63, (a >> 7) & 63
        bit = lambda k: ((a >> k) & 1) == 1
        mvA = np.where(ent, np.where(bit(17), _ones_span(lo, np.minimum(s6, nb - 1), base), 0),
                       np.where(bit(16), _bit_at(lo, base), 0))
        mbA = np.where(ent, _bit_at(s6, base), np.where(bit(14), _FULL, 0))
        mvB = np.where(ent, 0, np.where(bit(15), _bit_at(lo, base), 0))
        mbB = np.where(bit(13), _FULL, 0)
        return np.where(odd, mvB, mvA), np.where(odd, mbB, mbA)
    mv = _ones_span(_wrap(a + 1), nb - 1, base)
    mb = _srl(_srl(_brev(b), 32 - nb), base)
    return mv, mb


def _shfl_transpose(x):
    """transpose32_shfl on (words, 32 lanes): lane p ends with bit l = bit p
    of lane l."""
    lane = np.arange(32)
    for j, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        y = x[:, lane ^ j]
        hi = (lane & j) != 0
        x = np.where(hi, (x & (~m & _FULL)) | ((y >> j) & m), (x & m) | (((y & m) << j) & _FULL))
    return x


_FILLS = {"lip": (_NEVER, _NEVER, 0), "lis": (0, 0, 0), "ref": (_NEVER, 0, 0)}


def _planes_emulated(kind, fields, nb, P, items):
    """emit_planes_kernel in numpy: each word's lanes load their items
    (pair form: item 16 w + l / 2, the odd lane the sign cell; single form:
    32 w + l), padding past the fields, then each 32-pass window's masks
    are transposed and plane p of word w is lane p's value."""
    per_word = 32 if kind == "ref" else 16
    W = items // per_word
    n_real = fields[0].shape[0]
    w = np.arange(W)[:, None]
    lane = np.arange(32)[None, :]
    item = 32 * w + lane if kind == "ref" else 16 * w + (lane >> 1)
    odd = np.zeros_like(item, bool) if kind == "ref" else (lane & 1) == 1
    vals = []
    for k in range(3):
        f = fields[k] if k < len(fields) else None
        v = np.full(item.shape, _FILLS[kind][k], np.int64)
        if f is not None:
            ok = item < n_real
            v[ok] = np.asarray(f, np.int64)[item[ok]]
        vals.append(v)
    vw = np.zeros((P, W), np.int64)
    bw = np.zeros((P, W), np.int64)
    for base in range(0, P, 32):
        take = min(32, P - base)
        mv, mb = _cell_masks(kind, *vals, odd, nb, base)
        tv, tbits = _shfl_transpose(mv & _FULL), _shfl_transpose(mb & _FULL)
        vw[base:base + take] = tv[:, :take].T
        bw[base:base + take] = tbits[:, :take].T
    return vw, bw


def _as_u32(t):
    return t.numpy().astype(np.int64) & _FULL


@pytest.mark.parametrize("kind", ["lip", "lis", "ref"])
@pytest.mark.parametrize("P,nb", [(34, 31), (34, 0), (14, 14), (22, 9)])
def test_planes_emulation_matches_the_plain_masks_and_k10(kind, P, nb):
    rng = np.random.default_rng(P * 3 + nb + len(kind))
    n_real = 1000 if kind != "lis" else 700
    items = 1024 if kind != "lis" else 768
    if kind == "lis":
        fields = (rng.integers(-(1 << 31), 1 << 31, size=n_real, dtype=np.int64).astype(np.int32),)
    else:
        s = rng.integers(0, 36, size=n_real).astype(np.int32)
        s[rng.random(n_real) < 0.2] = _NEVER
        if kind == "lip":
            e = np.minimum(s, rng.integers(0, 36, size=n_real)).astype(np.int32)
            e[rng.random(n_real) < 0.1] = _NEVER
            fields = (s, e, (rng.random(n_real) < 0.5).astype(np.int32))
        else:
            m = rng.integers(0, 1 << 31, size=n_real, dtype=np.int64).astype(np.int32)
            fields = (s, m)
    nb_t = torch.tensor(nb, dtype=torch.int32)
    want_v, want_b = twp.emit_planes_ref(kind, [torch.from_numpy(f) for f in fields], nb_t, P, items)
    got_v, got_b = _planes_emulated(kind, fields, nb, P, items)
    np.testing.assert_array_equal(got_v, _as_u32(want_v))
    np.testing.assert_array_equal(got_b, _as_u32(want_b))


def test_planes_take_a_bool_sign_and_pad_the_full_width():
    """The full-width branch hands the chunk's own (s, e, bool signs) and
    (s, mags), n items, padded to the 256-cell multiple: equal to the int32
    signs padded by hand."""
    rng = np.random.default_rng(11)
    n = 300
    s = torch.from_numpy(rng.integers(0, 20, size=n).astype(np.int32))
    e = torch.minimum(s, torch.from_numpy(rng.integers(0, 20, size=n).astype(np.int32)))
    g = torch.from_numpy(rng.random(n) < 0.5)
    nb = torch.tensor(18, dtype=torch.int32)
    a = twp.emit_planes("lip", (s, e, g), nb, 18, 512)
    pad = lambda t, fill: torch.cat([t, torch.full((512 - n,), fill, dtype=torch.int32)])
    b = twp.emit_planes("lip", (pad(s, _NEVER), pad(e, _NEVER), pad(g.to(torch.int32), 0)), nb, 18, 512)
    assert a[0].shape == (18, 32) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# dispatch and the 512^3 walk
# ---------------------------------------------------------------------------
def test_cpu_tensors_never_load_the_emit_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)
    before = {k: kernels.launches[k] for k in ("emit_stage", "emit_planes")}
    mags, sgn = _chunk(16, (0.3, 1 << 12), 5)
    vt, nb, s, e, node_s = _schedule(16, mags)
    for wexp_cap in (0, 1024):
        twp.wave_emit_3d(torch.from_numpy(mags), torch.from_numpy(sgn), s, e, node_s, nb, vt, 16,
                         vt.nn, 1 << 20, 8 * 16**3, wexp_cap)
    assert {k: kernels.launches[k] for k in before} == before


def test_emit_kernels_raise_off_cpu_and_cuda():
    meta = torch.zeros(512, dtype=torch.int32, device="meta")
    nb = torch.zeros((), dtype=torch.int32, device="meta")
    for call in (lambda: twp.emit_planes("ref", (meta, meta), nb, 14, 512),
                 lambda: twp.emit_cube(meta, meta, meta, nb, 8, 64, True, meta, 16),
                 lambda: twp.emit_fields((meta,) * 4, meta, nb, 16)):
        with pytest.raises(ValueError, match="no .* kernel for tensors on meta"):
            call()
    cpu = torch.zeros(512, dtype=torch.int32)
    for call in (lambda: kernels.emit_planes("ref", (cpu, cpu), cpu[:1], 14, 512),
                 lambda: kernels.emit_cube(cpu, None, cpu, cpu[:1], 8, 64, cpu, 16),
                 lambda: kernels.emit_fields((cpu,) * 4, cpu, cpu[:1], 16)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="kind"):
        kernels.emit_planes("sig", (cpu,), cpu[:1], 14, 512)


def test_walk_layout_at_512_takes_two_path_words():
    """A 512^3 chunk's forest is deeper than base-9 paths of one word hold
    (depth_max > 6): the walk's keys take two path words, each key at most
    63 bits wide, at every tier's node cap."""
    dims = (512, 512, 512)
    vf = tsv.virtual_lis_index(dims, "cpu")
    assert vf.depth_max > 6
    for tier in tb.wave_tiers_for(512**3):
        lay = tsl.walk_layout(vf, tb._wave_caps(vf, dims, tier, 34)["node_cap"])
        assert lay.path_words == 2 and lay.pw0 == 30 and lay.ins_pw == 0
        assert max(lay.walk_bits + lay.ins_bits) <= 63
        assert lay.tcap.bit_length() + lay.pw0 <= lay.walk_bits[0]  # the unused entries' key
