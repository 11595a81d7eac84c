"""The port's batched 2D codec (sperr_tpu_torch/parallel/batched2d.py) and the
multi-resolution decodes against sperr_tpu's host-entropy 2D path and its
decoders, on the CPU with the kernels' plain versions.

Float stages agree with sperr_tpu within f32 roundoff, not bit for bit (XLA
may contract multiply-adds; the port rounds each operation), so quantized
values may differ at rounding ties and stream-level checks compare decodes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.codec.speck_flt import SpeckFloatCodec
from sperr_tpu.parallel import batched as jb
from sperr_tpu.parallel import batched2d as jb2
from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor
from sperr_tpu.stream import tools
from sperr_tpu_torch.stream import tools as ttools
from sperr_tpu.utils.dims import coarsened_resolutions, coarsened_resolutions_chunked
from sperr_tpu_torch.parallel import batched as tb
from sperr_tpu_torch.parallel import batched2d as tb2

NX, NY = 96, 64


def _field(nx, ny, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:ny, 0:nx]
    f = np.sin(x * 0.11) * np.cos(y * 0.07)
    return (f + 0.02 * rng.normal(size=f.shape)).astype(np.float32)


def _err(out, f):
    return float(np.abs(np.asarray(out, np.float64).reshape(f.shape) - f).max())


def _host_decode(stream, nx, ny):
    out, _ = SpeckFloatCodec(2, (nx, ny, 1)).decompress(bytes(stream))
    return out.reshape(ny, nx)


def _psnr(orig, rec):
    mse = np.mean((np.asarray(rec, np.float64).reshape(orig.shape) - orig) ** 2)
    rng = float(orig.max() - orig.min())
    return 10 * np.log10(rng * rng / mse)


@pytest.mark.parametrize(
    "mode,quality,resid",
    [("pwe", 1e-3, "dual"), ("pwe", 1e-3, "none"), ("pwe", 1e-3, "f32"),
     ("psnr", 60.0, "f32"), ("rate", 2.0, "f32")],
)
def test_dense_encode2_matches_jax(mode, quality, resid):
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:NY, 0:NX]
    smooth = np.sin(x * 0.3) * np.cos(y * 0.2)
    # on a 1/16 grid with |x| < 4 every partial sum of a field is exact in
    # f32, so both means are exact whatever order a reduction takes
    batch = np.stack([smooth + 2.0, 1.5 * smooth[::-1] - 1.0, smooth[:, ::-1]])
    batch = batch + 0.05 * rng.normal(size=batch.shape)
    batch = (np.round(batch * 16) / 16).astype(np.float32)
    n = NX * NY
    ours = tb2._dense_encode2(torch.from_numpy(batch), mode, quality, resid)
    ref = jb2._dense_encode2(jnp.asarray(batch), mode, quality, n, n, resid)
    ours = {k: v.numpy() for k, v in ours.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_allclose(ours["mean"], ref["mean"], rtol=1e-6)
    np.testing.assert_allclose(ours["q"], ref["q"], rtol=1e-6)
    np.testing.assert_array_equal(ours["is_const"], ref["is_const"])
    np.testing.assert_array_equal(ours["v0"], ref["v0"])
    ll = np.where(ours["signs"], 1, -1) * ours["mags"].astype(np.int64)
    ll_ref = np.zeros((3, n), dtype=np.int64)
    for b in range(3):
        m = int(ref["nnz"][b])
        ll_ref[b, ref["idx"][b, :m]] = ref["vals"][b, :m]
    np.testing.assert_array_equal(ref["nnz"], (ll_ref != 0).sum(axis=1))
    # ulp-level differences in the coefficients flip values that sit near a
    # rounding tie (2 of these 18432 at tol 1e-3); rate mode's 2^20 steps of
    # max|c| flip a few percent
    assert np.mean(ll == ll_ref) >= (0.97 if mode == "rate" else 0.9998)
    assert np.abs(ll - ll_ref).max() <= 1
    assert np.abs(ours["maxmag"].astype(np.int64) - ref["maxmag"]).max() <= 1
    if resid == "dual":
        np.testing.assert_allclose(ours["eta_sim"], ref["eta_sim"], rtol=1e-6)
        np.testing.assert_allclose(ours["kappa"], ref["kappa"], rtol=1e-6)
    if mode == "pwe" and resid != "none":
        # the outlier sets agree up to points near the threshold or near a
        # flipped coefficient (3 of 208 on this input)
        for b in range(3):
            mine = set(np.flatnonzero(ours["outlier_mask"][b]))
            theirs = set(ref["out_idx"][b, : int(ref["n_out"][b])])
            assert len(mine & theirs) >= 0.95 * len(mine | theirs)
    else:
        assert "outlier_mask" not in ours


@pytest.mark.parametrize("nx,ny", [(96, 64), (64, 48)])
def test_pwe_streams_decode_within_bound_under_three_decoders(nx, ny):
    fields = np.stack([_field(nx, ny, seed=s) for s in range(3)])
    comp = tb2.TorchCompressor2D((nx, ny), device="cpu")
    streams = comp.compress_batch(fields, "pwe", 1e-3)
    assert comp.last_uncertified_chunks == 0
    ours = tb2.TorchDecompressor2D((nx, ny), device="cpu").decompress_batch(streams)
    theirs = jb2.TpuDecompressor2D((nx, ny)).decompress_batch(streams)
    for k, f in enumerate(fields):
        assert ours[k].dtype == np.float32 and ours[k].shape == (ny, nx)
        assert _err(ours[k], f) <= 1e-3
        assert _err(theirs[k], f) <= 1e-3
        assert _err(_host_decode(streams[k], nx, ny), f) <= 1e-3


def test_batch_streams_equal_single_streams_and_sub_batches():
    fields = np.stack([_field(64, 48, seed=i) for i in range(5)])
    comp = tb2.TorchCompressor2D((64, 48), device="cpu")
    streams = comp.compress_batch(fields, "pwe", 1e-3)
    for i in range(5):
        assert streams[i] == comp.compress(fields[i], "pwe", 1e-3)
    comp.elem_budget = 2 * 64 * 48  # sub-batches of two fields
    assert comp.compress_batch(fields, "pwe", 1e-3) == streams
    assert comp.last_uncertified_chunks == 0


def test_port_decodes_jax_streams():
    f = _field(NX, NY, seed=8)
    s = jb2.TpuCompressor2D((NX, NY)).compress(f, "pwe", 1e-3)
    out = tb2.TorchDecompressor2D((NX, NY), device="cpu").decompress(s)
    assert _err(out, f) <= 1e-3


def test_with_header_round_trip():
    nx, ny = 48, 32
    f = _field(nx, ny, seed=11)
    comp = tb2.TorchCompressor2D((nx, ny), device="cpu", with_header=True)
    s = comp.compress(f, "pwe", 1e-3)
    (hx, hy), is_float = tools.parse_2d_header(s)
    assert (hx, hy) == (nx, ny) and is_float
    dec = tb2.TorchDecompressor2D((nx, ny), device="cpu")
    assert _err(dec.decompress(s, with_header=True), f) <= 1e-3
    assert _err(jb2.TpuDecompressor2D((nx, ny)).decompress(s, with_header=True), f) <= 1e-3
    # the port raises its own copy's StreamError
    with pytest.raises(ttools.StreamError, match="header dims"):
        tb2.TorchDecompressor2D((ny, nx), device="cpu").decompress(s, with_header=True)


def test_constant_field_is_a_conditioner_stream():
    f = np.full((32, 32), 4.25, dtype=np.float32)
    s = tb2.TorchCompressor2D((32, 32), device="cpu").compress(f, "pwe", 1e-3)
    assert len(s) == 17
    out = tb2.TorchDecompressor2D((32, 32), device="cpu").decompress(s)
    np.testing.assert_array_equal(out, f)
    s_h = tb2.TorchCompressor2D((32, 32), device="cpu", with_header=True).compress(f, "psnr", 80.0)
    assert len(s_h) == 10 + 17


@pytest.mark.parametrize("mode,quality", [("psnr", 70.0), ("rate", 2.0)])
def test_psnr_and_rate_decodes_agree_with_f64_decoder(mode, quality):
    f = _field(NX, NY, seed=5)
    s = tb2.TorchCompressor2D((NX, NY), device="cpu").compress(f, mode, quality)
    ours = tb2.TorchDecompressor2D((NX, NY), device="cpu").decompress(s)
    host = _host_decode(s, NX, NY)
    vrange = float(f.max() - f.min())
    assert np.abs(ours - host).max() <= 1e-4 * vrange
    s_jax = jb2.TpuCompressor2D((NX, NY)).compress(f, mode, quality)
    theirs = jb2.TpuDecompressor2D((NX, NY)).decompress(s_jax)
    assert abs(_psnr(f, ours) - _psnr(f, theirs)) <= 0.1
    if mode == "rate":
        assert len(s) == len(s_jax) == 17 + 9 + int(quality * NX * NY) // 8
    else:
        assert _psnr(f, host) >= quality - 0.5


@pytest.mark.parametrize("pwe_strict", [False, "f64"])
def test_pwe_other_certification_modes(pwe_strict):
    f = _field(NX, NY, seed=6)
    s = tb2.TorchCompressor2D((NX, NY), device="cpu", pwe_strict=pwe_strict).compress(f, "pwe", 1e-3)
    ours = tb2.TorchDecompressor2D((NX, NY), device="cpu").decompress(s)
    # the f32 scan at tol bounds the error up to f32 roundoff of the data
    slack = 4 * np.finfo(np.float32).eps * np.abs(f).max()
    assert _err(_host_decode(s, NX, NY), f) <= 1e-3 + (slack if pwe_strict is False else 0)
    assert _err(ours, f) <= 1e-3 + slack


@pytest.mark.parametrize("nx,ny", [(64, 64), (96, 64)])
def test_multi_res_hierarchy_matches_jax(nx, ny):
    fields = np.stack([_field(nx, ny, seed=13), np.full((ny, nx), -1.5, np.float32)])
    streams = tb2.TorchCompressor2D((nx, ny), device="cpu").compress_batch(fields, "psnr", 75.0)
    dec = tb2.TorchDecompressor2D((nx, ny), device="cpu")
    ours = dec.decompress_batch(streams, multi_res=True)
    jdec = jb2.TpuDecompressor2D((nx, ny))
    theirs = jdec.decompress_batch(streams, multi_res=True)
    res = coarsened_resolutions((nx, ny, 1))
    vrange = float(fields[0].max() - fields[0].min())
    for k in range(2):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-4 * vrange)
        assert len(dec.hierarchy[k]) == len(jdec.hierarchy[k]) == len(res) > 0
        for a, b, r in zip(dec.hierarchy[k], jdec.hierarchy[k], res):
            assert a.shape == b.shape == (r[1], r[0])
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * vrange)
    np.testing.assert_array_equal(dec.hierarchy[1][0], np.full((res[0][1], res[0][0]), -1.5))
    # the full-resolution output is the plain decode's
    plain = dec.decompress_batch(streams)
    np.testing.assert_array_equal(ours[0], plain[0])
    assert dec.hierarchy == [[], []]


def _vol3(seed=21):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:64, 0:32, 0:32]
    f = np.sin(x * 0.2) * np.cos(y * 0.15) * np.sin(z * 0.1 + 1.0)
    f = f + 0.02 * rng.normal(size=f.shape)
    f[32:] = 0.75  # the second 32^3 chunk is constant
    return f.astype(np.float32)


def test_3d_multi_res_decode_matches_jax():
    vol = _vol3()
    dims, chunk = (32, 32, 64), (32, 32, 32)
    stream = tb.TorchCompressor3D(dims, chunk, device="cpu").compress(vol, "psnr", 80.0)
    assert tools.parse_header(stream).chunk_offsets[3] == 17
    dec = tb.TorchDecompressor3D(device="cpu")
    out, d = dec.decompress(stream, multi_res=True)
    jdec = jb.TpuDecompressor3D()
    theirs, _ = jdec.decompress(stream, multi_res=True)
    host = Sperr3DDecompressor()
    host.decompress(bytes(stream), multi_res=True)
    vrange = float(vol.max() - vol.min())
    assert d == dims
    np.testing.assert_allclose(out, theirs, rtol=0, atol=1e-4 * vrange)
    res = coarsened_resolutions_chunked(dims, chunk)
    assert len(dec.hierarchy) == len(jdec.hierarchy) == len(host.hierarchy) == len(res) > 0
    for a, b, c, r in zip(dec.hierarchy, jdec.hierarchy, host.hierarchy, res):
        assert a.shape == b.shape == c.shape == (r[2], r[1], r[0])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * vrange)
        # the constant chunk fills the upper half of every level (the host
        # decoder leaves a constant chunk's coarse blocks unwritten)
        half = a.shape[0] // 2
        np.testing.assert_array_equal(a[half:], 0.75)
        np.testing.assert_allclose(a[:half], c[:half], rtol=0, atol=1e-4 * vrange)
    plain, _ = dec.decompress(stream)
    np.testing.assert_array_equal(out, plain)


def test_3d_multi_res_refuses_device_blocks_and_only():
    stream = tb.TorchCompressor3D((32, 32, 32), (32, 32, 32), device="cpu").compress(
        _vol3()[:32], "pwe", 1e-3
    )
    dec = tb.TorchDecompressor3D(device="cpu")
    with pytest.raises(ValueError, match="to_host"):
        dec.decompress(stream, to_host=False, multi_res=True)
    with pytest.raises(ValueError, match="only"):
        dec.decompress(stream, multi_res=True, only=[0])


def test_unported_options_raise():
    with pytest.raises(ValueError, match="entropy"):
        tb2.TorchCompressor2D((NX, NY), device="cpu", entropy="events")
    with pytest.raises(ValueError, match="pwe_strict"):
        tb2.TorchCompressor2D((NX, NY), device="cpu", pwe_strict="device")
    with pytest.raises(ValueError, match="mode"):
        tb2.TorchCompressor2D((NX, NY), device="cpu").compress(_field(NX, NY), "lossless", 1.0)


def test_from_jax_copies_settings():
    t = jb2.TpuCompressor2D((NX, NY), pwe_strict="f64", with_header=True, num_threads=3)
    t.elem_budget = 12345
    p = tb2.TorchCompressor2D.from_jax(t, "cpu")
    assert (p.dims, p.pwe_strict, p.with_header, p.num_threads, p.elem_budget) == (
        (NX, NY), "f64", True, 3, 12345,
    )
    assert p.device == torch.device("cpu")
    f = _field(NX, NY, seed=2)
    assert _err(tb2.TorchDecompressor2D((NX, NY), device="cpu").decompress(
        p.compress(f, "pwe", 1e-3), with_header=True), f) <= 1e-3
