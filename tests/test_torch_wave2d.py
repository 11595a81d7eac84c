"""The port's 2D device entropy path (ops/speck.py's 2D schedule and event
helpers, ops/wave_pack.wave_emit_2d_pixels, ops/speck_lis2.py, and
TorchCompressor2D(entropy="wave")) against sperr_tpu on the same seeded
integer inputs, on the CPU with the kernels' plain versions: the schedule,
the I-set significance, the interval expansion and the event packing
exactly; the pixel emission and the quad/I-set walk byte for byte (the walk
also against the host's sorted emitter); the static caps, the fit test and
the stitch against their originals; containers equal to host entropy in
every mode, decoded by the port's and sperr_tpu's decoders."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.codec import speck_wave as jsw
from sperr_tpu.codec.speck_sorted import lis_segments_sorted_2d
from sperr_tpu.ops import speck_jax as sj
from sperr_tpu.ops import speck_lis2_jax as jsl2
from sperr_tpu.ops import wave_pack as jwp
from sperr_tpu.parallel import batched2d as jb2
from sperr_tpu_torch.codec.speck_flt import SpeckFloatCodec
from sperr_tpu_torch.ops import speck as tspk
from sperr_tpu_torch.ops import speck_lis2 as tsl2
from sperr_tpu_torch.ops import speck_virtual as tsv
from sperr_tpu_torch.ops import wave_pack as twp
from sperr_tpu_torch.parallel import batched2d as tb2

_NEVER = 0x7FFF
_SHAPES = [(32, 32), (64, 48), (33, 57), (128, 41)]  # (nx, ny)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The 2D programs are hundreds of small torch ops per field: with
    several pytest workers on one machine, each op's parallel region waits
    for threads that the other workers hold (60 s instead of 0.3 s for one
    container), so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mags(n, seed, density=0.4, hi=1 << 12):
    rng = np.random.default_rng(seed)
    mags = (rng.integers(0, hi, size=n) * (rng.random(n) < density)).astype(np.int64)
    return mags, rng.random(n) < 0.5


def _walk_case(nx, ny, case):
    """(mags, signs) of one walk case, as tests/test_speck_lis2_jax.py
    builds them."""
    n = nx * ny
    if case in ("seed 0", "seed 1"):
        return _mags(n, int(case[-1]))
    if case == "density 0.02":
        return _mags(n, 3, 0.02, 1 << 20)
    if case == "density 0.95":
        return _mags(n, 3, 0.95, 1 << 6)
    m2d = np.zeros((ny, nx), np.int64)
    if case == "cascade":  # energy only in the far corner: every I level cascades
        m2d[ny - 1, nx - 1] = 1000
        m2d[0, 0] = 3
        return m2d.reshape(-1), np.ones(n, bool)
    if case == "s0 only":
        m2d[0, 0] = 1
        return m2d.reshape(-1), np.zeros(n, bool)
    return np.full(n, 5, np.int64), np.zeros(n, bool)  # flat


_CASES = ["seed 0", "seed 1", "density 0.02", "density 0.95", "cascade", "s0 only", "flat"]


def _port_schedule(nx, ny, mags):
    mt = torch.from_numpy(mags.astype(np.int32))
    pm = tsv.msbp1_device(mt)
    nb = pm.max()
    s, e, nm = tspk.pixel_schedule(mt, tspk.tree_index((nx, ny), "cpu"), nb)
    return pm, nb, s, e, nm


@functools.lru_cache(maxsize=None)
def _jax_schedule(dims):
    ti = sj.tree_index(dims)
    return jax.jit(lambda m, nb: sj.pixel_schedule(m, ti, nb))


@pytest.mark.parametrize("nx,ny", _SHAPES)
def test_schedule_2d_equals_jax(nx, ny):
    mags, _ = _mags(nx * ny, nx + ny, 0.3)
    pm, nb, s, e, nm = _port_schedule(nx, ny, mags)
    want = _jax_schedule((nx, ny))(jnp.asarray(mags.astype(np.uint32)), jnp.asarray(nb.numpy()))
    for name, a, b in zip(("s", "e", "nm"), (s, e, nm), want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


@functools.lru_cache(maxsize=None)
def _jax_walk(dims, ev_cap, cap_total):
    li2 = jsl2.lis2_index(dims)  # device constants: built outside the trace
    return jax.jit(lambda ns, s, g, nb, iset: jsl2.lis2_segments_device(
        ns, s, g, nb, iset, li2, 34, li2.nn, ev_cap, cap_total))


def _walk_both(nx, ny, mags, signs, ev_cap=None):
    n = nx * ny
    tree = jsw.build_tree2((nx, ny))
    pm, nb, s, _, nm = _port_schedule(nx, ny, mags)
    node_s = torch.where(nm > 0, nb - nm, _NEVER).to(torch.int32)
    iset_s = tsl2.iset_significance_device(pm.reshape(ny, nx), tree, nb)
    ev_cap = 6 * n + 4096 if ev_cap is None else ev_cap
    cap_total = 2 * n + 64
    li = tsl2.lis2_index((nx, ny), "cpu")
    ours = tsl2.lis2_segments_device(node_s, s, torch.from_numpy(signs), nb, iset_s, li, 34, li.nn,
                                     ev_cap, cap_total)
    want = _jax_walk((nx, ny), ev_cap, cap_total)(
        jnp.asarray(node_s.numpy()), jnp.asarray(s.numpy()), jnp.asarray(signs),
        jnp.asarray(nb.numpy()), jnp.asarray(iset_s.numpy()))
    jax_iset = jsl2.iset_significance_device(jnp.asarray(pm.numpy().reshape(ny, nx)), tree,
                                             jnp.asarray(nb.numpy()))
    np.testing.assert_array_equal(iset_s.numpy(), np.asarray(jax_iset))
    return tree, int(nb), node_s.numpy(), s.numpy(), iset_s.numpy(), ours, want


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("nx,ny", _SHAPES)
def test_walk_equals_jax_and_the_host(nx, ny, case):
    mags, signs = _walk_case(nx, ny, case)
    tree, nb, node_s, s_lin, iset_s, ours, want = _walk_both(nx, ny, mags, signs)
    for name, a, b in zip(("buf", "counts", "total_bytes", "n_sig"), ours, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert int(ours[3]) < 2**31 - 1  # no cap overflowed
    host = lis_segments_sorted_2d(tree, node_s, s_lin, signs, nb, iset_s)
    buf, counts = ours[0].numpy(), ours[1].numpy()
    bc = (counts.astype(np.int64) + 7) // 8
    offs = np.cumsum(bc) - bc
    for p in range(nb):
        bits = np.unpackbits(buf[offs[p] : offs[p] + bc[p]], bitorder="little")[: counts[p]]
        np.testing.assert_array_equal(bits, host[p], f"pass {p}")
    assert counts[nb:].sum() == 0


def test_walk_event_overflow_equals_jax():
    """Past the event cap both raise n_sig past any node cap and keep the
    same (truncated) counts and bytes."""
    mags, signs = _walk_case(64, 48, "seed 0")
    *_, ours, want = _walk_both(64, 48, mags, signs, ev_cap=700)
    assert int(ours[3]) == 2**31 - 1
    for name, a, b in zip(("buf", "counts", "total_bytes", "n_sig"), ours, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_walk_index_tables_equal_jax():
    li, lj = tsl2.lis2_index((33, 57), "cpu"), jsl2.lis2_index((33, 57))
    assert tsl2.lis2_index((33, 57), "cpu") is li  # cached
    for name in ("nn", "n", "nrows", "max_ch", "depth_max", "nlev", "xf", "G"):
        assert getattr(li, name) == getattr(lj, name), name
    for name in ("parent", "level", "depth", "ch_start", "ch_count", "ctab", "is_group", "k_of",
                 "irank_of", "block_rank_of", "group_ids", "group_k", "gbit_rank", "gsel"):
        np.testing.assert_array_equal(getattr(li, name).numpy(), np.asarray(getattr(lj, name)), name)
    # a shallow tree keeps the first two path words, which carry every digit
    pw = np.asarray(lj.pw)
    np.testing.assert_array_equal(li.pw.numpy(), pw[:, : li.pw.shape[1]])
    assert not pw[:, li.pw.shape[1] :].any()


@functools.lru_cache(maxsize=None)
def _jax_fill(ev_cap, widths, nwords):
    return jax.jit(lambda ln, *w: sj._expand_fill(ln, list(w), ev_cap, widths=widths))


@pytest.mark.parametrize("widths,ev_frac", [((18,), 1.2), ((18,), 0.6), ((6, 31), 1.0), (None, 1.1),
                                            (None, 0.5)])
def test_expand_fill_equals_jax(widths, ev_frac):
    rng = np.random.default_rng(len(widths or ()) + int(10 * ev_frac))
    T = 3000
    ln = (rng.integers(0, 6, size=T) * (rng.random(T) < 0.7)).astype(np.int32)
    wd = widths or (18, 31)
    words = [rng.integers(0, 1 << w, size=T).astype(np.int32) for w in wd]
    ev_cap = max(8, int(ev_frac * ln.sum()))
    ours = tspk._expand_fill(torch.from_numpy(ln), [torch.from_numpy(w) for w in words], ev_cap, widths)
    want = _jax_fill(ev_cap, widths, len(words))(jnp.asarray(ln), *map(jnp.asarray, words))
    for a, b in zip(ours[0], want[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name, a, b in zip(("rel", "ev_ok", "ev_total"), ours[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


@functools.lru_cache(maxsize=None)
def _jax_events(P, cap_total, with_sec):
    if with_sec:
        return jax.jit(lambda k, sec, b: sj.events_to_segments(k, sec, b, P, cap_total))
    return jax.jit(lambda k, b: sj.events_to_segments(k, None, b, P, cap_total))


@pytest.mark.parametrize("branch,EV,P,cap_frac", [
    ("fused", 20000, 34, 1.0), ("fused", 20000, 34, 0.3),
    ("stable", 270000, 1024, 1.0),  # (2P + 2) and the index need 32 bits
    ("sec_key", 20000, 34, 1.0),
])
def test_events_to_segments_equals_jax(branch, EV, P, cap_frac):
    rng = np.random.default_rng(EV + P)
    p_key = rng.integers(0, P + 1, size=EV).astype(np.int32)  # P: invalid
    bits = rng.random(EV) < 0.5
    cap_total = max(16, int(cap_frac * (EV + 7 * P) // 8))
    args = [torch.from_numpy(p_key), None, torch.from_numpy(bits)]
    jargs = [jnp.asarray(p_key), jnp.asarray(bits)]
    if branch == "sec_key":
        sec = rng.integers(-1000, 1000, size=EV).astype(np.int32)  # ties keep input order
        args[1] = torch.from_numpy(sec)
        jargs.insert(1, jnp.asarray(sec))
    ours = tspk.events_to_segments(*args, P, cap_total)
    want = _jax_events(P, cap_total, branch == "sec_key")(*jargs)
    for name, a, b in zip(("buf", "counts", "total_bytes"), ours, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert ours[0].dtype == torch.uint8 and ours[0].shape == (cap_total,)


@functools.lru_cache(maxsize=None)
def _jax_pixels(P, evb, out, wexp):
    return jax.jit(lambda m, g, s, e, nb: jwp.wave_emit_2d_pixels(m, g, s, e, nb, P, evb, out, wexp))


@pytest.mark.parametrize("nx,ny", [(64, 48), (33, 57)])
@pytest.mark.parametrize("wexp", ["none", "below n", "overflow"])
def test_pixel_emission_equals_jax(nx, ny, wexp):
    n = nx * ny
    mags, signs = _mags(n, n, 0.3)
    pm, nb, s, e, _ = _port_schedule(nx, ny, mags)
    n_exp = int((e < nb).sum())
    wexp_cap = {"none": 0, "below n": min(n - 1, n_exp + 300), "overflow": n_exp // 2}[wexp]
    assert wexp_cap < n
    caps = tb2._wave_caps2(n, 34, 1, 4096)
    args = (caps["px_bp"], caps["px_evb"], caps["px_out"], wexp_cap)
    ours = twp.wave_emit_2d_pixels(torch.from_numpy(mags.astype(np.int32)), torch.from_numpy(signs),
                                   s, e, nb, *args)
    want = _jax_pixels(*args)(jnp.asarray(mags.astype(np.uint32)), jnp.asarray(signs),
                              jnp.asarray(s.numpy()), jnp.asarray(e.numpy()), jnp.asarray(nb.numpy()))
    for name, a, b in zip(("seg", "counts", "total_bytes", "overflow"), ours, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert bool(ours[3]) == (wexp == "overflow")


@functools.lru_cache(maxsize=None)
def _jax_caps(dims, ev_cap):
    """The caps sperr_tpu's _dense_encode2_wave hands the pixel emission and
    the walk at one event cap, read by tracing it (no compile, no run) with
    recording stand-ins."""
    jsl2.lis2_index(dims)
    sj.tree_index(dims)
    seen = {}

    def pixels(mags, signs, s, e, num_bp, px_bp, evb, out, wexp):
        seen.update(px_bp=px_bp, px_evb=evb, px_out=out, wexp_px=wexp)
        z = jnp.zeros((), jnp.int32)
        return jnp.zeros(out, jnp.uint8), jnp.zeros(2 * px_bp, jnp.int32), z, jnp.zeros((), bool)

    def walk(node_s, s, signs, num_bp, iset_s, li, P, node_cap, ev_cap, cap_total):
        seen.update(node_cap=node_cap, ev_cap=ev_cap, cap_total=cap_total)
        z = jnp.zeros((), jnp.int32)
        return jnp.zeros(cap_total, jnp.uint8), jnp.zeros(P, jnp.int32), z, z

    orig = jwp.wave_emit_2d_pixels, jsl2.lis2_segments_device
    jwp.wave_emit_2d_pixels, jsl2.lis2_segments_device = pixels, walk
    try:
        n = dims[0] * dims[1]
        fn = functools.partial(
            jb2._dense_encode2_wave.__wrapped__, mode="pwe", quality=1e-2, cap=n, out_cap=n,
            num_bp_cap=34, dims2=dims, residual="dual", node_cap=777, ev_cap=ev_cap, wave_cap=n,
        )
        jax.eval_shape(fn, jax.ShapeDtypeStruct((1, dims[1], dims[0]), jnp.float32))
    finally:
        jwp.wave_emit_2d_pixels, jsl2.lis2_segments_device = orig
    return seen


@pytest.mark.parametrize("dims", [(64, 48), (200, 120)])
def test_wave_caps_equal_jax(dims):
    n = dims[0] * dims[1]
    for t in jb2.TpuCompressor2D(dims).wave_event_tiers:
        ev_cap = max(4096, int(t * n))
        assert tb2._wave_caps2(n, 34, 777, ev_cap) == _jax_caps(dims, ev_cap)


def test_wave_fits_and_stitch_copies():
    t = jb2.TpuCompressor2D((64, 48), entropy="wave")
    p = tb2.TorchCompressor2D((64, 48), device="cpu", entropy="wave")
    n = 64 * 48
    for n_sig in (5, 2000):
        for over in (False, True):
            for num_bp in (0, 18, 19):
                for lis_total in (10, n + 1):
                    w = {"caps": (1000, 4096, n), "n_sig": [n_sig], "px_over": [over],
                         "num_bp": [num_bp], "lis_total": [lis_total]}
                    assert p._wave_fits(w, 0, n) == t._wave_fits(w, 0, n)
    # a field's fetched emission stitches to the same body in both
    f = np.random.default_rng(9).normal(size=(1, 48, 64)).astype(np.float32)
    front = tb2._dense_encode2(torch.from_numpy(f), "pwe", 1e-2, "dual")
    index = tb2._wave_index2((64, 48), "cpu")
    caps = tb2._wave_caps2(n, 34, index[1].nn, 3 * n)
    w = p._fetch_wave(tb2._wave_emit_field(front["mags"][0], front["signs"][0], index, caps, 34), caps, n)
    assert p._wave_fits(w, 0, n)
    for budget in (0, 3000):
        assert p._stitch_wave2(w, 0, budget) == t._stitch_wave2(w, 0, budget)


def _fields(nx, ny, seed=0):
    """Three smooth fields and a constant one."""
    rng = np.random.default_rng(seed)
    out = [np.cumsum(np.cumsum(rng.normal(size=(ny, nx)), axis=0), axis=1) * 0.01 for _ in range(3)]
    out.insert(2, np.full((ny, nx), 0.25))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("mode,quality,strict,header", [
    ("pwe", 1e-3, True, False), ("pwe", 1e-3, True, True), ("pwe", 1e-3, False, False),
    ("pwe", 1e-3, "f64", True), ("rate", 1.5, True, False), ("psnr", 70.0, True, True),
])
def test_wave_container_equals_host(mode, quality, strict, header):
    nx, ny = 64, 48
    f = _fields(nx, ny)
    kw = dict(device="cpu", pwe_strict=strict, with_header=header)
    host = tb2.TorchCompressor2D((nx, ny), **kw)
    wave = tb2.TorchCompressor2D((nx, ny), entropy="wave", **kw)
    want = host.compress_batch(f, mode, quality)
    assert wave.compress_batch(f, mode, quality) == want
    assert wave.last_uncertified_chunks == host.last_uncertified_chunks == 0
    assert wave.last_wave_tiers[2] is None  # the constant field
    # rate mode's magnitudes need more bitplanes than the pixel classes'
    # cap: those fields take the host engine
    assert wave.last_wave_chunks == (0 if mode == "rate" else 3)
    assert host.last_wave_chunks == 0
    assert 0 < wave.last_d2h_bytes < host.last_d2h_bytes


def test_noisy_fields_climb_the_ladder_or_fall_back():
    """A noisy field overflows the first tier and fits the next; with the
    ladder cut to its first tier it falls back to the host engine; both
    write the host's bytes."""
    f = np.random.default_rng(3).normal(size=(1, 64, 64)).astype(np.float32)
    want = tb2.TorchCompressor2D((64, 64), device="cpu").compress_batch(f, "pwe", 1e-2)
    wave = tb2.TorchCompressor2D((64, 64), device="cpu", entropy="wave")
    assert wave.compress_batch(f, "pwe", 1e-2) == want
    assert wave.last_wave_tiers == [1]
    wave.wave_event_tiers = (1.25,)
    assert wave.compress_batch(f, "pwe", 1e-2) == want
    assert wave.last_wave_tiers == [None] and wave.last_wave_chunks == 0


def test_sub_batches_sum_their_counts():
    f = _fields(32, 32, seed=4)
    wave = tb2.TorchCompressor2D((32, 32), device="cpu", entropy="wave")
    whole = wave.compress_batch(f, "pwe", 1e-3)
    d2h = wave.last_d2h_bytes
    wave.elem_budget = 2 * 32 * 32
    assert wave.compress_batch(f, "pwe", 1e-3) == whole
    assert wave.last_wave_tiers == [0, 0, None, 0] and wave.last_wave_chunks == 3
    assert wave.last_d2h_bytes == d2h


def test_wave_streams_decode_with_both_decoders_and_match_jax_counts():
    """On inputs whose means are exact in f32 (tests/test_torch_pipeline.py),
    sperr_tpu's wave compressor puts as many fields on the device as the
    port's; the port's wave streams decode within the bound under the
    port's decoder, sperr_tpu's TpuDecompressor2D and the host f64 codec."""
    nx, ny = 64, 48
    y, x = np.mgrid[0:ny, 0:nx]
    smooth = np.sin(x * 0.3) * np.cos(y * 0.2)
    rng = np.random.default_rng(4)
    f = np.stack([smooth + 2.0, 1.5 * smooth[::-1] - 1.0, smooth[:, ::-1]])
    f = (np.round((f + 0.05 * rng.normal(size=f.shape)) * 16) / 16).astype(np.float32)
    tol = 1e-2
    t = jb2.TpuCompressor2D((nx, ny), entropy="wave")
    t.compress_batch(f, "pwe", tol)
    p = tb2.TorchCompressor2D.from_jax(t, "cpu")
    assert (p.entropy, p.wave_event_tiers, p.num_bp_cap) == ("wave", t.wave_event_tiers, t.num_bp_cap)
    streams = p.compress_batch(f, "pwe", tol)
    assert p.last_wave_chunks == t.last_wave_chunks == 3
    ours = tb2.TorchDecompressor2D((nx, ny), device="cpu").decompress_batch(streams)
    theirs = jb2.TpuDecompressor2D((nx, ny)).decompress_batch(streams)
    for k in range(3):
        host, _ = SpeckFloatCodec(2, (nx, ny, 1)).decompress(bytes(streams[k]))
        for out in (ours[k], theirs[k], host):
            assert float(np.abs(np.asarray(out, np.float64).reshape(ny, nx) - f[k]).max()) <= tol
