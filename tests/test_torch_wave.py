"""The port's device entropy path (sperr_tpu_torch/ops/wave_pack.py and
TorchCompressor3D(entropy="wave")) on the CPU, with the kernels' plain
versions.

The emission is held against sperr_tpu's wave_emit_3d on the same integer
inputs (bit for bit, both branches); its stitched bodies against the C++
host engine; and the wave containers against the port's host-entropy
containers, byte for byte, in every mode and certification setting that
scans like the host path."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import speck_lis_jax as jsl
from sperr_tpu.ops import speck_virtual as jsv
from sperr_tpu.ops import wave_pack as jwp
from sperr_tpu.parallel import batched as jb
from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor
from sperr_tpu.runtime.engine import default_engine
from sperr_tpu_torch.ops import speck_lis as tsl
from sperr_tpu_torch.ops import speck_virtual as tsv
from sperr_tpu_torch.ops import wave_pack as twp
from sperr_tpu_torch.parallel import batched as tb

_NEVER = 0x7FFF
_NOOP_ROW = 126  # payload of a child row of a padding parent: emits nothing


def _mags(n, seed, density, hi):
    rng = np.random.default_rng(seed)
    mags = (rng.integers(0, hi, size=n) * (rng.random(n) < density)).astype(np.int32)
    return mags, rng.random(n) < 0.5


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


def _tie_swaps(N, node_s, s, sgn, nb):
    """Positions where sperr_tpu's walk order differs from the port's.  The
    only full-key ties of the walk are a child row of the last node against
    padding rows; XLA's unstable sort may place them either way, which moves
    no stream bit but may move a cell to another piece (n_nz)."""
    vt = tsv.virtual_lis_index((N, N, N), "cpu")
    pt = tsl.lis_segments_device(node_s, s, torch.from_numpy(sgn), nb, vt, 34, vt.nn,
                                 return_events="items")[0].numpy()
    pj = np.asarray(_jax_walk(N)(jnp.asarray(node_s.numpy()), jnp.asarray(s.numpy()),
                                 jnp.asarray(sgn), jnp.asarray(nb.numpy())))
    d = np.flatnonzero(pt != pj)
    keep = lambda p: p[p != _NOOP_ROW]
    np.testing.assert_array_equal(keep(pt), keep(pj))
    return d.size


# (N, P, wexp_cap): the exposure compaction with magnitudes packed in the
# box-major table (P <= 23) and in a second table (P = 34), and the
# full-width branch
@pytest.mark.parametrize(
    "N,P,wexp_cap,seed,density,hi",
    [(32, 16, 8192, 0, 0.3, 1 << 12), (32, 16, 8192, 1, 0.05, 1 << 15),
     (32, 14, 8192, 2, 0.4, 1 << 15), (32, 34, 16384, 3, 0.2, 1 << 20),
     (32, 16, 0, 4, 0.5, 1 << 10), (16, 34, 0, 5, 0.7, 1 << 25)],
)
def test_wave_emit_matches_jax(N, P, wexp_cap, seed, density, hi):
    n = N**3
    mags, sgn = _mags(n, seed, density, hi)
    vt, nb, s, e, node_s = _schedule(N, mags)
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
    swaps = _tie_swaps(N, node_s, s, sgn, nb)
    # each swapped pair moves one row's two cells: at most one piece each
    assert abs(int(ours.n_nz) - int(theirs.n_nz)) <= swaps
    if swaps == 0:
        assert int(ours.n_nz) == int(theirs.n_nz)
    tbytes = int(ours.total_bytes)
    if not bool(ours.overflow):
        np.testing.assert_array_equal(ours.seg.numpy()[:tbytes], np.asarray(theirs.seg)[:tbytes])


@pytest.mark.parametrize("budget_bits", [0, 5000])
@pytest.mark.parametrize("seed,density", [(7, 0.3), (8, 0.02)])
def test_stitched_body_equals_host_engine(seed, density, budget_bits):
    N = 16
    n = N**3
    mags, sgn = _mags(n, seed, density, 1 << 11)
    vt = tsv.virtual_lis_index((N, N, N), "cpu")
    caps = tb._wave_caps(vt, (N, N, N), tb.DEFAULT_WAVE_TIERS[-1], 34)
    em, fits = tb._wave_emit_chunk(torch.from_numpy(mags), torch.from_numpy(sgn), vt, caps)
    assert bool(fits)
    wave = {
        "num_bp": em.num_bp.numpy()[None], "counts": em.counts.numpy()[None],
        "seg": em.seg.numpy()[None], "bp_cap": caps["P"],
    }
    body = tb._stitch_wave(wave, 0, (N, N, N), budget_bits)
    want = default_engine().encode(3, mags, sgn, (N, N, N), 16, budget_bits)
    assert bytes(body) == bytes(want)
    assert bytes(body) == bytes(jb.TpuCompressor3D._stitch_wave(None, wave, 0, (N, N, N), budget_bits))


def _vol(shape=(32, 32, 32), seed=0):
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    t = np.linspace(0, 1, max(shape), dtype=np.float32)
    f = (
        np.sin(6 * t[:nz])[:, None, None]
        * np.cos(4 * t[:ny])[None, :, None]
        * np.sin(5 * t[:nx])[None, None, :]
    ).astype(np.float32)
    return f + rng.normal(scale=0.002, size=shape).astype(np.float32)


def _pair(dims, chunk, vol, mode, q, **kw):
    host = tb.TorchCompressor3D(dims, chunk, device="cpu", **kw)
    wave = tb.TorchCompressor3D(dims, chunk, device="cpu", entropy="wave", **kw)
    return host.compress(vol, mode, q), wave.compress(vol, mode, q), wave


@pytest.mark.parametrize(
    "mode,q,strict",
    [("pwe", 1e-2, True), ("pwe", 1e-3, "f64"), ("pwe", 1e-2, False), ("psnr", 60.0, True),
     ("rate", 1.0, True), ("rate", 0.3, True)],
)
def test_wave_container_equals_host_container(mode, q, strict):
    vol = _vol()
    s_host, s_wave, wave = _pair((32, 32, 32), (16, 16, 16), vol, mode, q, pwe_strict=strict)
    assert s_wave == s_host
    assert wave.last_wave_chunks == 8
    assert wave.last_wave_tiers == [0] * 8 or mode == "rate"


@pytest.mark.parametrize("q", [1e-2, 1e-4])
def test_wave_device_margin_meets_the_bound_under_both_decoders(q):
    """pwe_strict="device": the wave path scans on the device at
    max(tol - eta, 0) (the host path certifies on the host), so the two
    containers may differ; the wave stream meets the bound under the host
    f64 decoder and the port's decoder."""
    vol = _vol(seed=3)
    comp = tb.TorchCompressor3D((32, 32, 32), (16, 16, 16), device="cpu", entropy="wave",
                                pwe_strict="device")
    stream = comp.compress(vol, "pwe", q)
    assert comp.last_wave_chunks == 8
    host, _ = Sperr3DDecompressor().decompress(bytes(stream))
    ours, _ = tb.TorchDecompressor3D(device="cpu").decompress(stream)
    v64 = vol.astype(np.float64)
    assert np.abs(np.asarray(host).reshape(vol.shape) - v64).max() <= q
    assert np.abs(ours.astype(np.float64) - v64).max() <= q + 4 * np.finfo(np.float32).eps


def test_retry_ladder_with_a_tiny_first_tier():
    rng = np.random.default_rng(7)
    vol = rng.normal(size=(32, 32, 32)).astype(np.float32)
    host = tb.TorchCompressor3D((32, 32, 32), (32, 32, 32), device="cpu").compress(vol, "pwe", 1e-2)
    wave = tb.TorchCompressor3D((32, 32, 32), (32, 32, 32), device="cpu", entropy="wave")
    wave.wave_tiers = ((0.01, 0.01, 0.01, 8, 0.01),) + tb.DEFAULT_WAVE_TIERS
    assert wave.compress(vol, "pwe", 1e-2) == host
    assert wave.last_wave_chunks == 1 and wave.last_wave_tiers[0] > 0
    out, _ = jb.TpuDecompressor3D().decompress(bytes(host))
    assert np.abs(out.reshape(vol.shape).astype(np.float64) - vol).max() <= 1e-2


def test_noisy_chunk_retries_then_falls_back():
    rng = np.random.default_rng(9)
    vol = rng.normal(size=(16, 16, 16)).astype(np.float32)
    # 21 bitplanes: past the first tier's 16, within the second's 34
    s_host, s_wave, wave = _pair((16, 16, 16), (16, 16, 16), vol, "pwe", 1e-6)
    assert s_wave == s_host
    assert wave.last_wave_tiers == [1]
    # a ladder whose only tier cannot hold the chunk: host entropy, same bytes
    only = tb.TorchCompressor3D((16, 16, 16), (16, 16, 16), device="cpu", entropy="wave")
    only.wave_tiers = ((0.01, 0.01, 0.01, 8, 0.01),)
    assert only.compress(vol, "pwe", 1e-6) == s_host
    assert only.last_wave_chunks == 0 and only.last_wave_tiers == [None]


def test_constant_chunk_and_non_cube_chunks_take_host_entropy():
    """A constant chunk takes host entropy; chunks that are not power-of-two
    cubes now take the table-form device path (tests/test_torch_wave_table.py),
    with the same bytes."""
    vol = np.zeros((16, 16, 16), dtype=np.float32)
    vol[:8] = 2.5  # one constant chunk, one not
    vol[8:] = _vol((8, 16, 16))
    s_host, s_wave, wave = _pair((16, 16, 16), (16, 16, 8), vol, "pwe", 1e-3)
    assert s_wave == s_host and wave.last_wave_chunks == 1
    assert wave.last_wave_tiers[0] is None and wave.last_wave_tiers[1] is not None
    vol = _vol()
    s_host, s_wave, wave = _pair((16, 16, 32), (16, 16, 16), vol[:, :16, :16].copy(), "pwe", 1e-2)
    assert s_wave == s_host and wave.last_wave_chunks == 2
    # (23, 31, 29) in 16^3 chunks: no chunk is a power-of-two cube, and all
    # four are encoded on the device
    odd = vol[:29, :31, :23].copy()
    s_host, s_wave, wave = _pair((23, 31, 29), (16, 16, 16), odd, "pwe", 1e-2)
    assert s_wave == s_host
    assert wave.last_wave_chunks == 4 and None not in wave.last_wave_tiers


def test_wave_stream_decodes_with_the_jax_decoder_and_the_port():
    vol = _vol()
    tol = 1e-2
    comp = tb.TorchCompressor3D((32, 32, 32), (16, 16, 16), device="cpu", entropy="wave")
    stream = comp.compress(vol, "pwe", tol)
    for out in (jb.TpuDecompressor3D().decompress(bytes(stream))[0],
                tb.TorchDecompressor3D(device="cpu").decompress(stream)[0]):
        assert np.abs(np.asarray(out, np.float64).reshape(vol.shape) - vol).max() <= tol


def test_sub_batched_wave_groups_identical_streams():
    vol = _vol((64, 16, 16))
    one = tb.TorchCompressor3D((16, 16, 64), (16, 16, 16), device="cpu", entropy="wave")
    s_one = one.compress(vol, "pwe", 1e-3)
    sub = tb.TorchCompressor3D((16, 16, 64), (16, 16, 16), device="cpu", entropy="wave")
    sub.wave_elem_budget = 16 * 16 * 16  # one chunk per group
    assert sub.compress(vol, "pwe", 1e-3) == s_one
    assert sub.last_wave_chunks == one.last_wave_chunks == 4
    assert 0 < one.last_d2h_bytes < 16**3 * 4 * 4 * 10


def test_wave_front_outlier_compaction_matches_the_dense_scan():
    """The wave front's compacted outliers (K12) are the dense scan's, and
    the margin scan flags margin_bad and thresholds as sperr_tpu's wave
    front does."""
    vol = _vol(seed=5)[None]
    x = torch.from_numpy(vol)
    for resid in ("dual", "f32"):
        dense = tb._dense_encode(x, "pwe", 1e-3, resid)
        wave = tb._dense_encode_rows(x, "pwe", 1e-3, resid, tb.cdf97.dwt3d, tb.cdf97.idwt3d_,
                                     out_cap=4096)
        idx = np.flatnonzero(dense["outlier_mask"][0].numpy())
        assert 0 < idx.size <= 4096
        assert int(wave["n_out"][0]) == idx.size
        np.testing.assert_array_equal(wave["out_idx"][0, : idx.size].numpy(), idx)
        assert (wave["out_idx"][0, idx.size :].numpy() == vol.size).all()
        np.testing.assert_array_equal(wave["out_vals"][0, : idx.size].numpy(), dense["diff"][0, idx].numpy())
    margin = tb._dense_encode_rows(x, "pwe", 1e-3, "margin", tb.cdf97.dwt3d, tb.cdf97.idwt3d_,
                                   out_cap=64)
    f32 = tb._dense_encode_rows(x, "pwe", 1e-3, "f32", tb.cdf97.dwt3d, tb.cdf97.idwt3d_,
                                out_cap=64)
    assert not bool(margin["margin_bad"][0])
    # past the cap: the true count and the first out_cap indices
    assert int(margin["n_out"][0]) > 64
    assert (margin["out_idx"][0].numpy() < vol.size).all()
    assert (np.diff(margin["out_idx"][0].numpy()) > 0).all()
    assert int(margin["n_out"][0]) >= int(f32["n_out"][0])  # threshold tol - eta < tol
    tiny = tb._dense_encode_rows(x, "pwe", 1e-9, "margin", tb.cdf97.dwt3d, tb.cdf97.idwt3d_,
                                 out_cap=64)
    assert bool(tiny["margin_bad"][0])


def test_from_jax_takes_the_dense_wave_configuration():
    t = jb.TpuCompressor3D((32, 32, 32), (16, 16, 16), entropy="wave", transfer="dense",
                           pwe_strict="f64")
    t.wave_tiers = ((0.5, 0.5, 0.5, 12, 0.5),)
    t.num_bp_cap = 30
    t.wave_elem_budget = 4096
    p = tb.TorchCompressor3D.from_jax(t, "cpu")
    assert (p.entropy, p.wave_tiers, p.num_bp_cap, p.wave_elem_budget, p.pwe_strict) == (
        "wave", t.wave_tiers, 30, 4096, "f64",
    )
    assert p.transfer == "dense"
    # sperr_tpu's default transfer, the sparse one, is ported too
    p = tb.TorchCompressor3D.from_jax(jb.TpuCompressor3D((32, 32, 32), (16, 16, 16), entropy="wave"), "cpu")
    assert (p.entropy, p.transfer) == ("wave", "sparse")
