"""The port's hybrid 3D decode (sperr_tpu_torch/ops/wave_unpack.py and the
hybrid split of TorchDecompressor3D) on the CPU, where K13 runs its plain
version.

The magnitudes the device half rebuilds from the host's control-only parse
must equal the C++ engine's full parse exactly, truncated streams included
(ROADMAP rule (a)); the plain version must equal sperr_tpu's
reconstruct_mags, overflow flag included; and the decoder must give the same
volume whichever route each chunk takes.  The inputs mirror
tests/test_wave_unpack.py, with p_cap 32 for 17 to 32 bitplanes, as the
production decoder picks it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import packemit as jpe
from sperr_tpu.ops import wave_unpack as jwu
from sperr_tpu.parallel import batched as jb
from sperr_tpu_torch.codec import outlier as outlier_mod
from sperr_tpu_torch.codec import speck_int_np as sp
from sperr_tpu_torch.ops import packemit as pe
from sperr_tpu_torch.ops import wave_unpack as wu
from sperr_tpu_torch.parallel import batched as tb
from sperr_tpu_torch.runtime.native import NativeEngine
from sperr_tpu_torch.stream import tools


def _np_pdep(x, m):
    out = 0
    k = 0
    for j in range(32):
        if (m >> j) & 1:
            out |= ((x >> k) & 1) << j
            k += 1
    return out


def _i32(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def test_pdep32_against_a_bit_loop_and_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 1024, dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 2**32, 1024, dtype=np.uint64).astype(np.uint32)
    m[:4] = [0, 0xFFFFFFFF, 1, 0x80000000]
    x[4:8] = [0xFFFFFFFF, 0, 0x80000000, 1]
    got = wu.pdep32(_i32(x), _i32(m)).numpy().view(np.uint32)
    want = np.asarray([_np_pdep(int(a), int(b)) for a, b in zip(x, m)], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jwu.pdep32(jnp.asarray(x), jnp.asarray(m))))
    # pdep inverts pext on the mask's population
    back = wu.pdep32(pe.pext32(_i32(x), _i32(m)), _i32(m)).numpy().view(np.uint32)
    np.testing.assert_array_equal(back, x & m)
    np.testing.assert_array_equal(
        np.asarray(jwu.pdep32(jpe.pext32(jnp.asarray(x), jnp.asarray(m)), jnp.asarray(m))), back
    )


_ENGINE = None


def _engine():
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = NativeEngine()
    return _ENGINE


def _case(dims, dens, seed, trunc=None, scale=5000):
    """A random chunk's SPECK stream (width 16, optionally truncated), its
    full parse and its control parse, as the decoder hands K13 one chunk:
    (args of reconstruct_mags_ref without the caps, p_cap, full-parse
    magnitudes, n)."""
    eng = _engine()
    rng = np.random.default_rng(seed)
    n = dims[0] * dims[1] * dims[2]
    mags = np.where(rng.random(n) < dens, rng.integers(0, scale, n), 0).astype(np.uint64)
    signs = rng.random(n) < 0.5
    body = eng.encode(3, mags, signs, dims, 16, 0)
    if trunc is not None:
        body = body[: max(9, int(len(body) * trunc))]
    m_ref, s_ref = eng.decode(3, body, dims, 16)
    spass, sg, roff, ravail, nbp, _ = eng.decode3d_control(body, dims, 16)
    np.testing.assert_array_equal(sg, s_ref.astype(bool))
    p_cap = 16 if nbp <= 16 else 32
    ro = np.zeros(32, np.int32)
    ra = np.zeros(32, np.int32)
    ro[:nbp] = roff.astype(np.int64)
    ra[:nbp] = ravail.astype(np.int64)
    words = np.frombuffer(bytes(body[9:]) + b"\0" * ((-len(body) + 9) % 4 + 8), dtype="<u4")
    args = (torch.from_numpy(spass), _i32(words), torch.from_numpy(ro), torch.from_numpy(ra), nbp)
    return args, p_cap, m_ref, n


def _all_slots(p_cap, n):
    # the reference test's cap: every (pass, word) slot, so nothing overflows
    return p_cap * ((-(-n // 128) * 128) // 32)


_FULL = [((32, 32, 32), 0.2, 5000), ((16, 16, 16), 0.9, 200000), ((31, 17, 9), 0.5, 60),
         ((64, 64, 64), 0.02, 5000)]
_CASES = ([("full", d, dens, 3, None, scale) for d, dens, scale in _FULL]
          + [("truncated", (32, 32, 32), 0.25, 9, t, 5000) for t in (0.85, 0.5, 0.2, 0.06)]
          + [("zero", (16, 16, 16), 0.0, 1, None, 5000)])


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[4]}")
def test_plain_reconstruct_equals_the_full_host_parse(case):
    _, dims, dens, seed, trunc, scale = case
    args, p_cap, m_ref, n = _case(dims, dens, seed, trunc, scale)
    got, overflow = wu.reconstruct_mags_ref(*args, p_cap, _all_slots(p_cap, n))
    assert not bool(overflow)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), m_ref)
    if args[4] == 0:
        assert not m_ref.any()


def test_batched_dispatch_on_the_cpu_runs_the_plain_version_per_chunk():
    cases = [_case((32, 32, 32), 0.25, 9, t) for t in (None, 0.5, 0.06)]
    B, n = len(cases), cases[0][3]
    W = max(c[0][1].shape[0] for c in cases)
    spass = torch.stack([c[0][0] for c in cases])
    words = torch.zeros((B, W), dtype=torch.int32)
    for b, c in enumerate(cases):
        words[b, : c[0][1].shape[0]] = c[0][1]
    ro = torch.stack([c[0][2] for c in cases])
    ra = torch.stack([c[0][3] for c in cases])
    nbps = torch.tensor([c[0][4] for c in cases], dtype=torch.int32)
    mags, ovf = wu.reconstruct_mags_batched(spass, words, ro, ra, nbps, 16, tb._evw_cap(n))
    assert mags.shape == (B, n) and ovf.tolist() == [False] * B
    for b, c in enumerate(cases):
        np.testing.assert_array_equal(mags[b].numpy().astype(np.uint64), c[2])
    # a cap of 10 active words: the chunks with more overflow
    acts = [_n_active(c[0][0].numpy(), c[0][3].numpy(), c[0][4]) for c in cases]
    ovf = wu.reconstruct_mags_batched(spass, words, ro, ra, nbps, 16, 10)[1]
    assert ovf.tolist() == [a > 10 for a in acts] and ovf.any()


@pytest.mark.parametrize("dims,dens,seed,trunc,evw_cap", [
    ((32, 32, 32), 0.2, 3, None, None),
    ((32, 32, 32), 0.25, 9, 0.5, None),
    ((32, 32, 32), 0.2, 3, None, 100),
])
def test_plain_reconstruct_equals_jax(dims, dens, seed, trunc, evw_cap):
    args, p_cap, m_ref, n = _case(dims, dens, seed, trunc)
    cap = evw_cap or _all_slots(p_cap, n)
    got, overflow = wu.reconstruct_mags_ref(*args, p_cap, cap)
    spass, words, ro, ra, nbp = args
    want, want_ovf = jwu.reconstruct_mags(
        jnp.asarray(spass.numpy()), jnp.asarray(words.numpy().view(np.uint32)),
        jnp.asarray(ro.numpy()), jnp.asarray(ra.numpy()), jnp.int32(nbp), p_cap, cap,
    )
    assert bool(overflow) == bool(want_ovf) == (evw_cap is not None)
    # magnitudes equal even where the cap cut the deposit short
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K13's launches (kernels/unpack.cu), emulated in numpy
# ---------------------------------------------------------------------------
_FULL32 = 0xFFFFFFFF
_AGG, _PREFIX = 1, 2


def _run_actors(starts, rng):
    """Run generator actors with their steps interleaved in a random order;
    actor i starts only after actor i - 1 has (the tiles' ticket)."""
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


def _warp_passes(t, w, agg, state, val, excl):
    """k13_count's warp w in tile t, which takes passes w, w + 8, w + 16 and
    w + 24 together: publish the tile's count of each (tile 0 its inclusive
    prefix), walk back 32 predecessors a step (lane l the l-th nearest; a
    word not yet published is waited for), each pass to its nearest
    inclusive prefix, and publish each pass's own."""
    ps = [w + 8 * i for i in range(4)]
    for p in ps:
        state[t, p], val[t, p] = (_PREFIX if t == 0 else _AGG), agg[t, p]
    if t == 0:
        excl[0, ps] = 0
        return
    yield
    e = {p: 0 for p in ps}
    done = {p: False for p in ps}
    j = t - 1
    while not all(done.values()):
        q = j - np.arange(32)
        for p in ps:
            if done[p]:
                continue
            while any(state[x, p] == 0 for x in q if x >= 0):
                yield
            st = np.array([state[x, p] if x >= 0 else _PREFIX for x in q])
            v = np.array([val[x, p] if x >= 0 else 0 for x in q])
            pm = st == _PREFIX
            first = int(np.argmax(pm)) if pm.any() else 32
            e[p] += int(v[:first + 1].sum())
            done[p] = bool(pm.any())
        j -= 32
        yield
    for p in ps:
        state[t, p], val[t, p], excl[t, p] = _PREFIX, e[p] + agg[t, p], e[p]


_COUNT_TILE = 32  # segments of a count tile (kCountTileSegs)


def _k13_count_emulated(spass, nb, rng):
    """k13_count on one chunk: each segment's histogram of s (s < 32; pairs
    of consecutive segments packed in the halves of one count), its
    exclusive prefix over the bins (#{s < p}), the tiles of 32 segments,
    the per-pass look-back with every warp's steps interleaved in a random
    order.  Returns rank0 (32, nseg) and mc (32,)."""
    n = spass.size
    nseg = -(-n // 1024)
    ntiles = -(-nseg // _COUNT_TILE)
    sp = np.full(ntiles * _COUNT_TILE * 1024, 255, np.int64)
    sp[:n] = spass
    seg = sp.reshape(ntiles * _COUNT_TILE // 2, 2, 1024)
    packed = np.stack([((seg[:, 0] == b).sum(axis=1) | ((seg[:, 1] == b).sum(axis=1) << 16))
                       for b in range(32)], axis=1)
    hist = np.stack([packed & 0xFFFF, packed >> 16], axis=1).reshape(ntiles * _COUNT_TILE, 32)
    c = (np.cumsum(hist, axis=1) - hist).reshape(ntiles, _COUNT_TILE, 32)
    agg = c.sum(axis=1)
    within = np.cumsum(c, axis=1) - c
    state = np.zeros((ntiles, 32), int)
    val, excl = np.zeros((ntiles, 32), np.int64), np.zeros((ntiles, 32), np.int64)
    _run_actors([lambda t=t, w=w: _warp_passes(t, w, agg, state, val, excl)
                 for t in range(ntiles) for w in range(8)], rng)
    assert (state == _PREFIX).all()
    rank0 = (excl[:, None, :] + within).reshape(ntiles * _COUNT_TILE, 32)[:nseg].T
    mc = np.where(np.arange(32) < min(nb, 32), excl[-1] + agg[-1], 0)
    return rank0, mc


def _ballot_counts(spass, nb):
    """The per-pass ballot counts of the design before (a ballot and a
    popcount for every pass past each word's smallest s): rank0 (32, nseg)
    for the passes below nb and the chunk totals mc."""
    n = spass.size
    nseg = -(-n // 1024)
    sp = np.full(nseg * 1024, 255, np.int64)
    sp[:n] = spass
    words = sp.reshape(nseg, 32, 32)
    smin = words.min(axis=2)
    cnt = np.zeros((32, nseg), np.int64)
    for p in range(min(nb, 32)):
        c = (words < p).sum(axis=2) * (p > smin)
        cnt[p] = c.sum(axis=1)
    return np.cumsum(cnt, axis=1) - cnt, cnt.sum(axis=1)


def _k13_mags_emulated(spass, words, roff, ravail, nb, rank0, mc, take):
    """k13_mags on one chunk, word by word in numpy: the chunk's scalars,
    lane p's aligned word (the two body words at ref_off[p] + rank, funnel
    shifted), each member lane's bit k of it by shuffle where rank + k <
    ref_avail[p], the active slots, and the closed form.  Returns (mags,
    overflow)."""
    n = spass.size
    nseg = rank0.shape[1]
    sp = np.full(nseg * 1024, 255, np.int64)
    sp[:n] = spass
    s = sp.reshape(nseg, 32, 32)
    W = words.size
    wd = words.astype(np.int64) & _FULL32
    nb = min(int(nb), 32)
    av = ravail.astype(np.int64)
    lanes = np.arange(32)
    full = (lanes < nb) & (av >= mc)
    lead = 32 if full.all() else int(np.argmin(full))
    pF, pstar = lead - 1, lead
    has_star = pstar < nb - 1
    T_star = 1 << min(max(nb - 1 - pstar, 0), 30) if has_star else 0
    star_on = has_star and int(av[pstar]) > 0
    F = min(pF, nb - 2)
    apw = np.zeros(s.shape, np.int64)
    pa = np.zeros(s.shape, bool)
    nact = 0
    for p in range(nb):
        member = s < p
        c = member.sum(axis=2)
        rank = rank0[p][:, None] + np.cumsum(c, axis=1) - c
        k = np.cumsum(member, axis=2) - member
        bi = int(roff[p]) + rank
        q, r = bi >> 5, bi & 31
        w0, w1 = wd[np.minimum(q, W - 1)], wd[np.minimum(q + 1, W - 1)]
        xw = np.where(r == 0, w0, ((w0 >> r) | (w1 << (32 - r))) & _FULL32)
        got = member & (rank[..., None] + k < av[p])
        apw |= np.where(got, ((xw[..., None] >> k) & 1) << p, 0)
        nact += int(((c > 0) & (rank < av[p])).sum())
        if p == pstar:
            pa = got
    sc = s
    sig = sc < nb
    sh = np.clip(nb - 1 - sc, 0, 30)
    Ts = np.int64(1) << sh
    init = (2 * Ts - (Ts >> 1) - 1) & _FULL32
    if nb >= 1:
        amask = (1 << (nb - 1)) - 1
        A = np.zeros_like(apw)
        x = apw & amask
        for i in range(32):
            A |= ((x >> i) & 1) << (31 - i)
        A >>= 32 - nb
    else:
        A = np.zeros_like(apw)
    last = (apw >> (nb - 1)) & 1 if nb >= 2 else np.zeros_like(apw)
    M = np.where(F >= sc + 1, (np.int64(1) << sh) - (1 << min(max(nb - 1 - F, 0), 30)), 0)
    M = M + np.where(star_on & pa, T_star, 0)
    d = (2 * A - M) & _FULL32
    d = np.where(d >= 1 << 31, d - (1 << 32), d) >> 1
    val = (init + d + last) & _FULL32
    val = np.where(val >= 1 << 31, val - (1 << 32), val)
    return np.where(sig, val, 0).reshape(-1)[:n], nact > take


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[4]}")
def test_k13_count_emulation_matches_the_ballot_counts(case):
    """The count launch's histogram counts and its per-pass look-back, the
    lanes' steps interleaved in a random order, give the first ranks and
    pass totals that the per-pass ballots of the design before gave."""
    _, dims, dens, seed, trunc, scale = case
    args, _, _, n = _case(dims, dens, seed, trunc, scale)
    spass, nbp = args[0].numpy(), int(args[4])
    want_r, want_mc = _ballot_counts(spass, nbp)
    for k in range(2):
        rank0, mc = _k13_count_emulated(spass, nbp, np.random.default_rng(seed * 10 + k))
        np.testing.assert_array_equal(rank0[:nbp], want_r[:nbp])
        np.testing.assert_array_equal(mc, want_mc)


@pytest.mark.parametrize("n,nb", [(2**22 + 77, 20), (1000, 7), (32769, 32)])
def test_k13_count_lookback_over_many_tiles(n, nb):
    """The count launch on a synthetic chunk of 129 tiles (five windows of
    32 predecessors), a chunk of one partial segment and one a pixel past a
    tile: the first ranks and totals equal the per-pass ballot counts."""
    rng = np.random.default_rng(n)
    spass = np.where(rng.random(n) < 0.4, rng.integers(0, 40, n), 255).astype(np.uint8)
    want_r, want_mc = _ballot_counts(spass, nb)
    rank0, mc = _k13_count_emulated(spass, nb, rng)
    np.testing.assert_array_equal(rank0[:nb], want_r[:nb])
    np.testing.assert_array_equal(mc, want_mc)


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[4]}")
def test_k13_mags_emulation_matches_the_plain_version(case):
    """Both launches emulated, the aligned words handed out by shuffle,
    against reconstruct_mags_batched_ref: every magnitude with all slots
    allowed, and the overflow flag (magnitudes unchanged) at a cap just
    below the chunk's active slots."""
    _, dims, dens, seed, trunc, scale = case
    args, p_cap, m_ref, n = _case(dims, dens, seed, trunc, scale)
    spass, words, ro, ra, nbp = (a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    rank0, mc = _k13_count_emulated(spass, int(nbp), np.random.default_rng(seed))
    acts = _n_active(spass, ra, int(nbp))
    for cap in (_all_slots(p_cap, n), max(acts - 1, 0)):
        take = min(cap, p_cap * (-(-n // 128) * 4))
        got, over = _k13_mags_emulated(spass, words, ro, ra, nbp, rank0, mc, take)
        want, want_over = wu.reconstruct_mags_batched_ref(
            args[0][None], args[1][None], args[2][None], args[3][None],
            torch.tensor([int(nbp)], dtype=torch.int32), p_cap, cap)
        assert over == bool(want_over[0]) == (cap < acts)
        np.testing.assert_array_equal(got, m_ref.astype(np.int64))
        if not over:
            np.testing.assert_array_equal(got, want[0].numpy())


def _vol32():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 32, dtype=np.float32)
    f = (np.sin(6 * t)[:, None, None] * np.cos(4 * t)[None, :, None]
         * np.sin(5 * t)[None, None, :]).astype(np.float32)
    return f + rng.normal(scale=0.002, size=(32, 32, 32)).astype(np.float32)


def _container(mode, q, vol=None):
    vol = _vol32() if vol is None else vol
    return tb.TorchCompressor3D((32, 32, 32), (16, 16, 16), device="cpu").compress(vol, mode, q)


def _decode(stream, hybrid, **kw):
    dec = tb.TorchDecompressor3D(device="cpu", hybrid=hybrid)
    out, dims = dec.decompress(stream, **kw)
    return dec, out


@pytest.mark.parametrize("mode,q,trunc", [("pwe", 1e-2, None), ("psnr", 60.0, None),
                                          ("rate", 1.0, None), ("pwe", 1e-3, 40)])
def test_hybrid_decoder_equals_the_full_parse(mode, q, trunc):
    s = _container(mode, q)
    if trunc is not None:
        s = tools.progressive_truncate(s, trunc)
    d0, o0 = _decode(s, False)
    d1, o1 = _decode(s, True)
    assert o0.dtype == o1.dtype == np.float32
    np.testing.assert_array_equal(o0, o1)
    assert d1.last_hybrid_chunks == 8 and d1.last_full_parse_chunks == {}
    assert d0.last_hybrid_chunks == 0 and d0.last_full_parse_chunks == {"hybrid off": 8}
    # spass and signs (1 byte each per voxel) against int16 magnitudes and signs
    assert d1.last_h2d_bytes < d0.last_h2d_bytes
    # the auto rule keeps the full parse on the CPU
    d2, o2 = _decode(s, None)
    assert d2.last_full_parse_chunks == {"hybrid off": 8}
    np.testing.assert_array_equal(o2, o0)


@pytest.mark.parametrize("jax_hybrid", [False, True])
def test_hybrid_decoder_against_jax(jax_hybrid):
    vol = _vol32()
    s = _container("pwe", 1e-2, vol)
    d1, ours = _decode(s, True)
    jd = jb.TpuDecompressor3D(hybrid=jax_hybrid)
    theirs, _ = jd.decompress(bytes(s))
    # the same routes: the active-word cap is the reference's
    assert d1.last_hybrid_chunks == 8 and jd.last_hybrid_chunks == (8 if jax_hybrid else 0)
    assert tb._evw_cap(16**3) == max(1 << 16, 16**3 // 64) and tb._evw_cap(256**3) == 256**3 // 64
    for out in (ours, theirs):
        assert float(np.abs(np.asarray(out, np.float64) - vol).max()) <= 1e-2
    # the magnitudes are exact on both sides; only the inverse transform's f32
    # rounding differs (XLA may contract multiply-adds, the port rounds each
    # operation): a few f32 ulps of max|vol| (ROADMAP rule (b))
    tol = 8 * np.finfo(np.float32).eps * float(np.abs(vol).max())
    assert float(np.abs(np.asarray(ours, np.float64) - np.asarray(theirs, np.float64)).max()) <= tol


def test_hybrid_decoder_other_outputs():
    s = _container("pwe", 1e-3)
    d0 = tb.TorchDecompressor3D(device="cpu", hybrid=False)
    d1 = tb.TorchDecompressor3D(device="cpu", hybrid=True)
    # to_host=False: chunk blocks stay tensors on the device
    b0, _ = d0.decompress(s, to_host=False)
    b1, _ = d1.decompress(s, to_host=False)
    assert set(b0) == set(b1) and len(b1) == 8 and d1.last_hybrid_chunks == 8
    for key in b0:
        assert torch.equal(b0[key], b1[key])
    # only=: a subset of the chunks
    b0, _ = d0.decompress(s, to_host=False, only=[1, 6])
    b1, _ = d1.decompress(s, to_host=False, only=[1, 6])
    assert set(b0) == set(b1) and len(b1) == 2 and d1.last_hybrid_chunks == 2
    for key in b0:
        assert torch.equal(b0[key], b1[key])
    # multi_res: the volume and every coarse level
    o0, _ = d0.decompress(s, multi_res=True)
    o1, _ = d1.decompress(s, multi_res=True)
    np.testing.assert_array_equal(o0, o1)
    assert len(d0.hierarchy) == len(d1.hierarchy) > 0
    for a, b in zip(d0.hierarchy, d1.hierarchy):
        np.testing.assert_array_equal(a, b)


def test_constant_and_empty_chunks_take_their_routes():
    vol = _vol32()
    vol[:16, :16, :16] = 0.5      # a constant chunk: no SPECK stream
    rng = np.random.default_rng(5)
    # a chunk whose coefficients all quantize to 0: num_bp 0, parsed in full
    vol[16:, 16:, 16:] = 0.25 + 1e-4 * rng.normal(size=(16, 16, 16)).astype(np.float32)
    s = _container("pwe", 1e-2, vol)
    d0, o0 = _decode(s, False)
    d1, o1 = _decode(s, True)
    np.testing.assert_array_equal(o0, o1)
    assert (o1[:16, :16, :16] == np.float32(0.5)).all()
    assert d1.last_hybrid_chunks == 6 and d1.last_full_parse_chunks == {"num_bp": 1}
    assert float(np.abs(np.asarray(o1, np.float64) - vol).max()) <= 1e-2


def test_a_stream_deeper_than_32_bitplanes_is_parsed_in_full():
    eng = _engine()
    dims = (16, 16, 16)
    rng = np.random.default_rng(6)
    mags = (rng.integers(0, 1 << 40, 4096, dtype=np.uint64) * (rng.random(4096) < 0.1)).astype(np.uint64)
    body = eng.encode(3, mags, rng.random(4096) < 0.5, dims, 64, 0)
    assert body[0] > 32
    chunk = tb._condi_header(False, 0.0, 0, 0.25, 1e-12) + body
    s = tools.generate_header(dims, dims, [len(chunk)], True) + chunk
    d0, o0 = _decode(s, False)
    d1, o1 = _decode(s, True)
    np.testing.assert_array_equal(o0, o1)
    assert d1.last_hybrid_chunks == 0 and d1.last_full_parse_chunks == {"num_bp": 1}


def _n_active(spass, ravail, nbp):
    """The active (pass, word) refinement slots of one chunk, counted in
    numpy: words with a member whose rank is below the pass's bits."""
    n = spass.size
    s = np.full(-(-n // 32) * 32, 255, np.int64)
    s[:n] = spass
    s = s.reshape(-1, 32)
    total = 0
    for p in range(nbp):
        c = (s < p).sum(axis=1)
        rank = np.cumsum(c) - c
        total += int(((c > 0) & (rank < int(ravail[p]))).sum())
    return total


def test_chunks_past_a_patched_cap_are_parsed_in_full(monkeypatch):
    s = _container("pwe", 1e-3)
    h = tools.parse_header(s)
    eng = _engine()
    acts = []
    for k in range(8):
        cs = s[h.chunk_offsets[2 * k] : h.chunk_offsets[2 * k] + h.chunk_offsets[2 * k + 1]]
        full_len = sp.speck_int_stream_full_len(cs[17:26])
        sbuf = cs[17 : 17 + min(full_len, len(cs) - 17)]
        spass, _, _, ravail, nbp, _ = eng.decode3d_control(
            sbuf, (16, 16, 16), sp.uint_width_for_num_bitplanes(sbuf[0]))
        acts.append(_n_active(spass, ravail, nbp))
    cap = sorted(acts)[3]
    over = sum(a > cap for a in acts)
    assert 0 < over < 8
    _, o0 = _decode(s, False)
    monkeypatch.setattr(tb, "_evw_cap", lambda n: cap)
    d1, o1 = _decode(s, True)
    np.testing.assert_array_equal(o0, o1)
    assert d1.last_hybrid_chunks == 8 - over
    assert d1.last_full_parse_chunks == {"evw_cap": over}


def _outlier_streams(ndim):
    rng = np.random.default_rng(8)
    if ndim == 3:
        vol = _vol32() + rng.normal(scale=0.003, size=(32, 32, 32)).astype(np.float32)
        return vol, [_container("pwe", 1e-3, vol)]
    fields = np.cumsum(rng.normal(size=(2, 48, 40)), axis=2).astype(np.float32)
    fields += rng.normal(scale=0.01, size=fields.shape).astype(np.float32)
    return fields, tb_2d().TorchCompressor2D((40, 48), device="cpu").compress_batch(fields, "pwe", 1e-2)


def tb_2d():
    from sperr_tpu_torch.parallel import batched2d

    return batched2d


@pytest.mark.parametrize("ndim", [3, 2])
def test_outlier_decode_through_the_engine_leaves_decodes_unchanged(ndim, monkeypatch):
    data, streams = _outlier_streams(ndim)

    def decode():
        if ndim == 3:
            return [_decode(streams[0], True)[1]]
        return tb_2d().TorchDecompressor2D((40, 48), device="cpu").decompress_batch(streams)

    seen = []
    orig = outlier_mod.decode_outliers

    def spy(stream, total_len, tol, engine=None):
        seen.append(engine)
        return orig(stream, total_len, tol, engine=engine)

    monkeypatch.setattr(outlier_mod, "decode_outliers", spy)
    ours = decode()
    assert seen and all(isinstance(e, NativeEngine) for e in seen)

    def python_coder(stream, total_len, tol, engine=None):
        return orig(stream, total_len, tol)

    monkeypatch.setattr(outlier_mod, "decode_outliers", python_coder)
    for a, b in zip(ours, decode()):
        np.testing.assert_array_equal(a, b)
    tol = 1e-3 if ndim == 3 else 1e-2
    for a, d in zip(ours, data if ndim == 2 else [data]):
        assert float(np.abs(np.asarray(a, np.float64).reshape(d.shape) - d).max()) <= tol


def test_dispatch_raises_off_cpu_and_cuda():
    z = torch.zeros((1, 64), dtype=torch.uint8, device="meta")
    w = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    r = torch.zeros((1, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no reconstruct_mags kernel for tensors on meta"):
        wu.reconstruct_mags_batched(z, w, r, r, torch.zeros(1, dtype=torch.int32, device="meta"), 16, 8)
