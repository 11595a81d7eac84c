"""The 3D emission's pixel stage (K9, sperr_tpu_torch/ops/wave_pack.py and
kernels/emit.cu) on the CPU.

``wave_emit_3d`` is held against sperr_tpu's on cases the other emission
tests leave out (an exposure that overflows, all-zero and one-pixel chunks,
N = 64 at P = 16 and P = 34), exactly.  The kernels cannot run here, so
their index arithmetic is emulated in numpy as the CUDA code does it and
held against the plain versions bit for bit: K9a's row counts, clamped
scan, ballot ranks and rank formula against the plain sort, and K9b's lane
mapping, register masks and shuffle transpose against the plain masks
through the plain K10.  The 512^3 walk's static layout (two path words) is
checked here too."""

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
# K9a: the kernels' index arithmetic, emulated
# ---------------------------------------------------------------------------
def _box_major(x, N):
    h = N // 2
    return x.reshape(h, 2, h, 2, h, 2).transpose(0, 2, 4, 1, 3, 5).reshape(-1)


def _pv_table(s, sgn, mags, N, pack_mag):
    pv = np.clip(s, 0, 127).astype(np.int64) | (sgn.astype(np.int64) << 7)
    if pack_mag:
        pv |= np.minimum(mags.astype(np.int64), (1 << 23) - 1) << 8
    return _box_major(pv.astype(np.int32), N)


def _exposed_emulated(pv, mags, s, nb, N, wexp_cap, pack_mag):
    """kernels/emit.cu's three launches in numpy: the rows kernel's flag
    words and counts (ballots), the scan's clamped row bases, and the place
    kernel's popcount ranks, rank formula and sentinel fill."""
    n = N**3
    Nh = N // 2
    NR = Nh * Nh
    fw = -(-Nh // 32)
    take_b = max(1, wexp_cap // 8)
    Lv = min(8 * take_b, wexp_cap)
    npad = -(-wexp_cap // 256) * 256
    boxes = pv.reshape(NR, Nh, 8)
    # rows: the flag from the s field's box minimum, or from s itself when
    # num_bp is outside [1, 127]
    if 1 <= nb <= 127:
        flag = (boxes & 127).min(axis=2) < nb
    else:
        sv = np.where(s < _NEVER, s, _NEVER)
        flag = _box_major(sv, N).reshape(NR, Nh, 8).min(axis=2) < nb
    words = np.zeros((NR, fw), np.uint64)
    for c in range(fw):
        for lane in range(32):
            b = 32 * c + lane
            if b < Nh:
                words[:, c] |= flag[:, b].astype(np.uint64) << np.uint64(lane)
    kraw = np.array([sum(bin(int(w)).count("1") for w in row) for row in words], np.int64)
    # scan: the clamped exclusive prefix, one more entry for the total
    incl = np.concatenate([[0], np.cumsum(kraw)])
    base = np.minimum(incl, take_b)
    carry = int(incl[-1])
    n_exp = 8 * carry
    # place
    out = {k: np.zeros(npad, np.int64) for k in ("s", "e", "g", "m")}
    exp_idx = np.zeros(Lv, np.int64)
    exp_ll = np.zeros(wexp_cap, np.int64)
    placed = np.zeros(npad, bool)
    for row in range(NR):
        b0, k = int(base[row]), int(base[row + 1] - base[row])
        if k == 0:
            continue
        zb, yb = divmod(row, Nh)
        B = int(base[zb * Nh])
        K = int(base[(zb + 1) * Nh]) - B
        R = b0 - B
        seen = 0
        for c in range(fw):
            if seen >= k:
                break
            m = int(words[row, c])
            for lane in range(32):
                j = seen + bin(m & ((1 << lane) - 1)).count("1")
                if not (m >> lane) & 1 or j >= k:
                    continue
                xb = 32 * c + lane
                v = boxes[row, xb].astype(np.int64)
                eb = int((v & 127).min())
                for slot in range(8):
                    dz, dy, dx = slot >> 2, (slot >> 1) & 1, slot & 1
                    rank = 8 * B + dz * 4 * K + 4 * R + dy * 2 * k + 2 * j + dx
                    if rank >= Lv:
                        continue
                    lin = ((2 * zb + dz) * N + 2 * yb + dy) * N + 2 * xb + dx
                    g = (v[slot] >> 7) & 1
                    mag = int(mags[lin]) if not pack_mag else int(v[slot] >> 8)
                    assert not placed[rank]
                    placed[rank] = True
                    out["s"][rank], out["e"][rank], out["g"][rank], out["m"][rank] = v[slot] & 127, eb, g, mag
                    exp_idx[rank] = lin
                    exp_ll[rank] = mag if g == 1 else -mag
            seen += bin(m).count("1")
    Rk = 8 * int(base[NR])
    lo = min(Rk, Lv)
    assert placed[:lo].all() and not placed[lo:].any()
    r = np.arange(lo, npad)
    z = r < n_exp
    for key in ("s", "e"):
        out[key][lo:] = np.where(z, 0, _NEVER)
    out["g"][lo:] = 0
    out["m"][lo:] = 0
    exp_ll[lo:] = 0
    exp_idx[Rk:Lv] = n
    return (exp_idx, exp_ll, n_exp, carry > take_b, out["s"], out["e"], out["g"], out["m"])


def _exposed_inputs(N, density, seed, nb=14):
    rng = np.random.default_rng(seed)
    n = N**3
    s = np.where(rng.random(n) < density, rng.integers(0, max(nb, 1), size=n), _NEVER).astype(np.int32)
    sgn = rng.random(n) < 0.5
    mags = rng.integers(0, 1 << 26, size=n).astype(np.int32)
    return s, sgn, mags


def _exposed_boxes(s, nb, N):
    return int(((_box_major(np.where(s < _NEVER, s, _NEVER), N).reshape(-1, 8).min(axis=1)) < nb).sum())


@pytest.mark.parametrize("N", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
@pytest.mark.parametrize("cut", ["one", "middle", "none"])
def test_exposed_emulation_matches_the_plain_sort(N, density, cut):
    s, sgn, mags = _exposed_inputs(N, density, N * 7 + int(density * 100))
    nb = 14
    nbox = _exposed_boxes(s, nb, N)
    n = N**3
    wexp_cap = {"one": 8, "middle": max(8, 8 * (nbox // 2) + 3), "none": n - 1}[cut]
    for pack_mag in (True, False):
        pv = _pv_table(s, sgn, mags, N, pack_mag)
        want = twp.emit_exposed_ref(torch.from_numpy(pv), torch.from_numpy(mags), torch.from_numpy(s),
                                    torch.tensor(nb, dtype=torch.int32), N, wexp_cap, pack_mag)
        got = _exposed_emulated(pv, mags, s, nb, N, wexp_cap, pack_mag)
        names = ("exp_idx", "exp_ll", "n_exp", "overflow", "s_p", "e_p", "g_i", "m_p")
        for name, a, b in zip(names, got, want):
            np.testing.assert_array_equal(np.asarray(a), b.numpy().astype(np.int64), name)
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
        want = twp.emit_exposed_ref(torch.from_numpy(pv), torch.from_numpy(mags), torch.from_numpy(s),
                                    torch.tensor(nb, dtype=torch.int32), N, wexp_cap, True)
        got = _exposed_emulated(pv, mags, s, nb, N, wexp_cap, True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b.numpy().astype(np.int64))


@pytest.mark.parametrize("wexp_cap", [1, 5, 7])
def test_exposed_caps_below_one_box(wexp_cap):
    """wexp_cap < 8 keeps one box (take_b = 1) and places only wexp_cap of
    its pixels; the rest of n_exp reads (0, 0, 0, 0)."""
    N = 8
    s, sgn, mags = _exposed_inputs(N, 0.3, wexp_cap)
    pv = _pv_table(s, sgn, mags, N, False)
    want = twp.emit_exposed_ref(torch.from_numpy(pv), torch.from_numpy(mags), torch.from_numpy(s),
                                torch.tensor(14, dtype=torch.int32), N, wexp_cap, False)
    got = _exposed_emulated(pv, mags, s, 14, N, wexp_cap, False)
    assert want[0].shape == (wexp_cap,) and want[1].shape == (wexp_cap,) and want[4].shape == (256,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy().astype(np.int64))


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
    return np.array([int(f"{int(v):032b}"[::-1], 2) for v in x.reshape(-1)], np.int64).reshape(x.shape)


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
    before = {k: kernels.launches[k] for k in ("emit_exposed", "emit_planes")}
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
                 lambda: twp.emit_exposed(meta, meta, meta, nb, 8, 64, True)):
        with pytest.raises(ValueError, match="no .* kernel for tensors on meta"):
            call()
    cpu = torch.zeros(512, dtype=torch.int32)
    for call in (lambda: kernels.emit_planes("ref", (cpu, cpu), cpu[:1], 14, 512),
                 lambda: kernels.emit_exposed(cpu, None, cpu, cpu[:1], 8, 64)):
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
