"""The port's device entropy path for chunks that are not power-of-two cubes
(sperr_tpu_torch/ops/speck.py, speck_lis.py's table walk, wave_pack.py's
non-uniform branch) against sperr_tpu's on the same integer inputs, on the
CPU with the kernels' plain versions: the child-table and pyramid-form
schedules exactly, the table walk's payload words apart from ties among
padding rows, every WaveEmit field and the packed bytes, the stitched
bodies against the C++ host engine and sperr_tpu's stitch; and a container
with chunks of all three forms against host entropy, decoded by three
decoders."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import speck_jax as sj
from sperr_tpu.ops import speck_lis_jax as jsl
from sperr_tpu.ops import wave_pack as jwp
from sperr_tpu.parallel import batched as jb
from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor
from sperr_tpu.runtime.engine import default_engine
from sperr_tpu_torch.ops import speck as tspk
from sperr_tpu_torch.ops import speck_lis as tsl
from sperr_tpu_torch.ops import speck_virtual as tsv
from sperr_tpu_torch.ops import wave_pack as twp
from sperr_tpu_torch.parallel import batched as tb

_NEVER = 0x7FFF
_NOOP_ROW = 126  # payload of a child row of a padding parent: emits nothing

_TREE_DIMS = [(24, 24, 16), (32, 32, 16), (64, 64, 25)]
_PYRAMID_DIMS = [(23, 16, 16), (23, 15, 13), (20, 20, 20)]


def _mags(n, seed, density=0.3, hi=1 << 14):
    rng = np.random.default_rng(seed)
    mags = (rng.integers(0, hi, size=n) * (rng.random(n) < density)).astype(np.int32)
    return mags, rng.random(n) < 0.5


@functools.lru_cache(maxsize=None)
def _jax_schedule(dims, form):
    if form == "pyramid":
        idx = sj.pyramid_index(dims)
        return jax.jit(lambda m, nb: sj.pixel_schedule_pyramid(m, idx, nb))
    idx = sj.tree_index(dims)
    return jax.jit(lambda m, nb: sj.pixel_schedule(m, idx, nb))


def _port_schedule(dims, mags, form):
    mt = torch.from_numpy(mags)
    nb = tsv.msbp1_device(mt).max()
    if form == "pyramid":
        return (nb,) + tspk.pixel_schedule_pyramid(mt, tspk.pyramid_index(dims, "cpu"), nb)
    return (nb,) + tspk.pixel_schedule(mt, tspk.tree_index(dims, "cpu"), nb)


@pytest.mark.parametrize("dims,form", [(d, "tree") for d in _TREE_DIMS]
                         + [(d, "pyramid") for d in _PYRAMID_DIMS])
def test_schedule_equals_jax(dims, form):
    n = dims[0] * dims[1] * dims[2]
    mags, _ = _mags(n, sum(dims), density=0.2)
    nb, s, e, nm = _port_schedule(dims, mags, form)
    want = _jax_schedule(dims, form)(jnp.asarray(mags.astype(np.uint32)), jnp.asarray(nb.numpy()))
    for name, a, b in zip(("s", "e", "nm"), (s, e, nm), want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    if form == "pyramid":
        # the two forms of the port agree too
        for a, b in zip((s, e, nm), _port_schedule(dims, mags, "tree")[1:]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_index_forms_and_caches():
    """Each chunk shape takes the index sperr_tpu's wave program takes, and
    each index is made once per (dims, device)."""
    assert isinstance(tb._wave_index((16, 16, 16), "cpu")[1], tsv.VirtualLisIndex)
    for dims in _PYRAMID_DIMS:
        li, si = tb._wave_index(dims, "cpu")
        assert isinstance(si, tspk.PyramidIndex) and isinstance(li, tsl.LisIndex)
        sj.pyramid_index(dims)  # builds in the reference too
    for dims in _TREE_DIMS:
        li, si = tb._wave_index(dims, "cpu")
        assert isinstance(si, tspk.TreeIndex)
        with pytest.raises(ValueError):
            sj.pyramid_index(dims)
        assert tb._wave_index(dims, "cpu") == (li, si)
        lj = jsl.lis_index(dims)
        for name in ("nn", "n", "nrows", "max_ch", "depth_max", "nlev", "nroots", "shallow"):
            assert getattr(li, name) == getattr(lj, name), name
        for name in ("parent", "level", "depth", "ch_start", "ch_count", "ctab", "root_ids",
                     "root_levels", "O0", "off0"):
            np.testing.assert_array_equal(getattr(li, name).numpy(), np.asarray(getattr(lj, name)), name)
        np.testing.assert_array_equal(li.pw.numpy(), np.asarray(lj.pw)[:, : li.pw.shape[1]])


def _walk_inputs(dims, seed, density):
    n = dims[0] * dims[1] * dims[2]
    mags, sgn = _mags(n, seed, density)
    form = "pyramid" if dims in _PYRAMID_DIMS else "tree"
    nb, s, e, nm = _port_schedule(dims, mags, form)
    node_s = torch.where(nm > 0, nb - nm, _NEVER).to(torch.int32)
    return mags, sgn, nb, s, e, node_s


@functools.lru_cache(maxsize=None)
def _jax_walk(dims, node_cap):
    lj = jsl.lis_index(dims)
    return jax.jit(
        lambda ns, s, g, nb: jsl.lis_segments_device(
            ns, s, g, nb, lj, 34, node_cap, 0, 0, return_events="items"
        )
    )


def _walk_swaps(dims, node_cap, node_s, s, sgn, nb):
    """The table walk against sperr_tpu's: equal payload words and n_sig,
    apart from where XLA's unstable sorts place padding rows among the
    rows they tie with (a child row of the last node); returns the number
    of positions that differ."""
    li = tsl.lis_index(dims, "cpu")
    pt, nt = tsl.lis_segments_device(node_s, s, torch.from_numpy(sgn), nb, li, 34, node_cap,
                                     return_events="items")
    pj, nj = _jax_walk(dims, node_cap)(jnp.asarray(node_s.numpy()), jnp.asarray(s.numpy()),
                                       jnp.asarray(sgn), jnp.asarray(nb.numpy()))
    pt, pj = pt.numpy(), np.asarray(pj)
    assert pt.shape == pj.shape == (tsl.lis_item_count(li, node_cap),)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(pt[pt != _NOOP_ROW], pj[pj != _NOOP_ROW])
    return int((pt != pj).sum())


# (dims, seed, density, node cap as a fraction of the node count)
@pytest.mark.parametrize("dims,seed,density,frac", [
    ((24, 24, 16), 0, 0.3, 1.0), ((64, 64, 25), 1, 0.05, 1.0), ((23, 15, 13), 2, 0.5, 1.0),
    ((20, 20, 20), 3, 0.2, 0.25), ((32, 32, 16), 4, 0.02, 2.0),
])
def test_table_walk_equals_jax(dims, seed, density, frac):
    _, sgn, nb, s, _, node_s = _walk_inputs(dims, seed, density)
    nn = tsl.lis_index(dims, "cpu").nn
    node_cap = max(16, int(nn * frac))
    swaps = _walk_swaps(dims, node_cap, node_s, s, sgn, nb)
    assert swaps <= 2 * tsl.lis_index(dims, "cpu").max_ch


@functools.lru_cache(maxsize=None)
def _jax_event_walk(dims, node_cap, ev_cap, cap_total, form):
    lj = jsl.lis_index(dims)
    return jax.jit(
        lambda ns, s, g, nb: jsl.lis_segments_device(
            ns, s, g, nb, lj, 34, node_cap, ev_cap, cap_total, return_events=form
        )
    )


# the event tail after the table walk (child-table and pyramid-schedule
# chunks): events (True) and packed segments (False), array for array; an
# event cap of 64 overflows and forces n_sig to _BIG in both packages
@pytest.mark.parametrize("form", [True, False])
@pytest.mark.parametrize("dims,seed,density,ev_cap", [
    ((24, 24, 16), 5, 0.3, 1 << 16), ((23, 15, 13), 6, 0.1, 1 << 15), ((24, 24, 16), 7, 0.3, 64),
])
def test_table_walk_event_tail_equals_jax(form, dims, seed, density, ev_cap):
    _, sgn, nb, s, _, node_s = _walk_inputs(dims, seed, density)
    li = tsl.lis_index(dims, "cpu")
    cap_total = 1 << 14
    got = tsl.lis_segments_device(node_s, s, torch.from_numpy(sgn), nb, li, 34, li.nn, ev_cap,
                                  cap_total, return_events=form)
    want = _jax_event_walk(dims, li.nn, ev_cap, cap_total, form)(
        jnp.asarray(node_s.numpy()), jnp.asarray(s.numpy()), jnp.asarray(sgn), jnp.asarray(nb.numpy()))
    assert len(got) == len(want) == (3 if form else 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (int(want[-1]) == tsl._BIG) == (ev_cap == 64)


@functools.lru_cache(maxsize=None)
def _jax_emit(dims, P, node_cap, evb_cap, out_cap, wexp_cap):
    lj = jsl.lis_index(dims)
    return jax.jit(
        lambda m, g, s, e, ns, nb: jwp.wave_emit_3d(
            m, g, s, e, ns, nb, lj, P, node_cap, evb_cap, out_cap, wexp_cap
        )
    )


# (dims, P, wexp_cap, seed, density): the exposed-pixel compaction (K12) and
# the full-width branch, 16 and 34 bitplanes, a compaction that overflows
@pytest.mark.parametrize("dims,P,wexp_cap,seed,density", [
    ((24, 24, 16), 16, 8192, 0, 0.3), ((24, 24, 16), 34, 0, 1, 0.3),
    ((23, 15, 13), 34, 2048, 2, 0.1), ((64, 64, 25), 16, 0, 3, 0.05),
    ((20, 20, 20), 16, 512, 4, 0.4),
])
def test_wave_emit_table_equals_jax(dims, P, wexp_cap, seed, density):
    n = dims[0] * dims[1] * dims[2]
    mags, sgn, nb, s, e, node_s = _walk_inputs(dims, seed, density)
    li = tsl.lis_index(dims, "cpu")
    node_cap, evb_cap, out_cap = li.nn, 1 << 20, 8 * n
    ours = twp.wave_emit_3d(
        torch.from_numpy(mags), torch.from_numpy(sgn), s, e, node_s, nb, li, P, node_cap,
        evb_cap, out_cap, wexp_cap,
    )
    theirs = _jax_emit(dims, P, node_cap, evb_cap, out_cap, wexp_cap)(
        jnp.asarray(mags), jnp.asarray(sgn), jnp.asarray(s.numpy()), jnp.asarray(e.numpy()),
        jnp.asarray(node_s.numpy()), jnp.asarray(nb.numpy()),
    )
    for f in ("num_bp", "counts", "total_bytes", "n_sig", "overflow", "exp_idx", "exp_ll", "n_exp"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)), f)
    if wexp_cap:
        assert ours.exp_idx.shape == (wexp_cap,)
        assert bool(ours.overflow) == (int(ours.n_exp) > wexp_cap)
    swaps = _walk_swaps(dims, node_cap, node_s, s, sgn, nb)
    assert abs(int(ours.n_nz) - int(theirs.n_nz)) <= swaps
    if swaps == 0:
        assert int(ours.n_nz) == int(theirs.n_nz)
    tbytes = int(ours.total_bytes)
    if not bool(ours.overflow):
        np.testing.assert_array_equal(ours.seg.numpy()[:tbytes], np.asarray(theirs.seg)[:tbytes])


@pytest.mark.parametrize("budget_bits", [0, 3000])
@pytest.mark.parametrize("dims", [(24, 24, 16), (23, 15, 13)])
def test_stitched_table_body_equals_host_engine_and_jax(dims, budget_bits):
    """The stitched body of a table-form chunk (child-table and pyramid
    schedules) is the C++ host engine's stream and sperr_tpu's stitch of
    the same emission, byte for byte."""
    n = dims[0] * dims[1] * dims[2]
    mags, sgn = _mags(n, sum(dims) + budget_bits, 0.3, 1 << 11)
    li, si = tb._wave_index(dims, "cpu")
    caps = tb._wave_caps(li, dims, tb.DEFAULT_WAVE_TIERS[-1], 34)
    em, fits = tb._wave_emit_chunk(torch.from_numpy(mags), torch.from_numpy(sgn), li, caps, si)
    assert bool(fits)
    wave = {
        "num_bp": em.num_bp.numpy()[None], "counts": em.counts.numpy()[None],
        "seg": em.seg.numpy()[None], "bp_cap": caps["P"],
    }
    body = tb._stitch_wave(wave, 0, dims, budget_bits)
    assert bytes(body) == bytes(default_engine().encode(3, mags, sgn, dims, 16, budget_bits))
    assert bytes(body) == bytes(jb.TpuCompressor3D._stitch_wave(None, wave, 0, dims, budget_bits))


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    t = np.linspace(0, 1, max(shape), dtype=np.float32)
    f = (np.sin(7 * t[:nz])[:, None, None] * np.cos(5 * t[:ny])[None, :, None]
         * np.sin(6 * t[:nx])[None, None, :]).astype(np.float32)
    return f + rng.normal(scale=0.003, size=shape).astype(np.float32)


def test_container_with_every_chunk_form_equals_host_entropy():
    """A 28 x 16 x 40 volume in 16^3 chunks: a power-of-two cube (virtual
    forest), a dyadic 12 x 16 x 16 chunk (pyramid schedule) and two
    wavelet-packet chunks of depth 24 (child-table schedule), all on the
    device, byte for byte the host-entropy container; it decodes within the
    bound under the port's, sperr_tpu's and the host f64 decoders."""
    dims, chunk, tol = (28, 16, 40), (16, 16, 16), 1e-3
    vol = _field(dims[::-1], 8)
    forms = {c[1::2]: type(tb._wave_index(c[1::2], "cpu")[1]).__name__
             for c in tb.chunk_volume(dims, chunk)}
    assert forms == {(16, 16, 16): "VirtualLisIndex", (12, 16, 16): "PyramidIndex",
                     (16, 16, 24): "TreeIndex", (12, 16, 24): "TreeIndex"}
    host = tb.TorchCompressor3D(dims, chunk, device="cpu").compress(vol, "pwe", tol)
    wave = tb.TorchCompressor3D(dims, chunk, device="cpu", entropy="wave")
    stream = wave.compress(vol, "pwe", tol)
    assert stream == host
    assert wave.last_wave_chunks == 4 and None not in wave.last_wave_tiers
    v64 = vol.astype(np.float64)
    for out in (tb.TorchDecompressor3D(device="cpu").decompress(stream)[0],
                tb.TorchDecompressor3D(device="cpu", hybrid=True).decompress(stream)[0],
                jb.TpuDecompressor3D().decompress(bytes(stream))[0],
                Sperr3DDecompressor().decompress(bytes(stream))[0]):
        assert np.abs(np.asarray(out, np.float64).reshape(vol.shape) - v64).max() <= tol


@pytest.mark.parametrize("mode,q", [("psnr", 70.0), ("rate", 1.0)])
def test_table_chunks_in_the_other_modes(mode, q):
    dims, chunk = (24, 24, 12), (24, 24, 12)  # one wavelet-packet chunk
    assert isinstance(tb._wave_index(dims, "cpu")[1], tspk.TreeIndex)
    vol = _field(dims[::-1], 9)
    host = tb.TorchCompressor3D(dims, chunk, device="cpu").compress(vol, mode, q)
    wave = tb.TorchCompressor3D(dims, chunk, device="cpu", entropy="wave")
    assert wave.compress(vol, mode, q) == host
    assert wave.last_wave_chunks == 1
