"""The port's dense 3D codec path (sperr_tpu_torch/parallel/batched.py) against
sperr_tpu's dense-transfer path, on the CPU with the kernels' plain versions.

Float stages agree with sperr_tpu within f32 roundoff, not bit for bit (XLA
may contract multiply-adds; the port rounds each operation), so quantized
values may differ at rounding ties and stream-level checks compare decodes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.parallel import batched as jb
from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor
from sperr_tpu.stream import tools
from sperr_tpu_torch.parallel import batched as tb

DIMS, CHUNK = (32, 32, 64), (32, 32, 32)


def _vol(nx, ny, nz, seed=21):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    f = np.sin(x * 0.2) * np.cos(y * 0.15) * np.sin(z * 0.1 + 1.0)
    return (f + 0.02 * rng.normal(size=f.shape)).astype(np.float32)


def _jax_comp(**kw):
    return jb.TpuCompressor3D(DIMS, CHUNK, entropy="host", transfer="dense", **kw)


def _port_comp(**kw):
    return tb.TorchCompressor3D.from_jax(_jax_comp(**kw), "cpu")


def _err(out, vol):
    return float(np.abs(np.asarray(out, np.float64).reshape(vol.shape) - vol).max())


def _psnr(orig, rec):
    mse = np.mean((np.asarray(rec, np.float64).reshape(orig.shape) - orig) ** 2)
    rng = float(orig.max() - orig.min())
    return 10 * np.log10(rng * rng / mse)


@pytest.mark.parametrize(
    "mode,quality,resid",
    [("pwe", 1e-3, "dual"), ("pwe", 1e-3, "margin"), ("pwe", 1e-3, "none"),
     ("psnr", 60.0, "f32"), ("rate", 2.0, "f32")],
)
def test_dense_encode_matches_jax(mode, quality, resid):
    rng = np.random.default_rng(4)
    z, y, x = np.mgrid[0:32, 0:32, 0:32]
    smooth = np.sin(x * 0.3) * np.cos(y * 0.2 + z * 0.1)
    # on a 1/16 grid with |x| < 4 every partial sum of a chunk is exact in
    # f32, so both means are exact whatever order a reduction takes: the
    # comparison sees the transform and the quantizer, not XLA's summation
    # (its fused f32 mean is ~5e-6 off the exact one on smooth data)
    batch = np.stack([smooth + 2.0, 1.5 * smooth[::-1] - 1.0])
    batch = batch + 0.05 * rng.normal(size=(2, 32, 32, 32))
    batch = (np.round(batch * 16) / 16).astype(np.float32)
    ours = tb._dense_encode(torch.from_numpy(batch), mode, quality, resid)
    ref = jb._dense_encode(jnp.asarray(batch), mode, quality, resid, seq=True)
    ours = {k: v.numpy() for k, v in ours.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert set(ours) == set(ref)
    np.testing.assert_allclose(ours["mean"], ref["mean"], rtol=1e-6)
    np.testing.assert_allclose(ours["q"], ref["q"], rtol=1e-6)
    np.testing.assert_array_equal(ours["is_const"], ref["is_const"])
    ll = np.where(ours["signs"], 1, -1) * ours["mags"].astype(np.int64)
    ll_ref = np.where(ref["signs"], 1, -1) * ref["mags"].astype(np.int64)
    # ulp-level differences in the coefficients (XLA contracts into FMAs)
    # flip values that sit near a rounding tie.  Rate mode quantizes to 2^20
    # steps of max|c|, where one f32 ulp of a large coefficient is 1/8 of a
    # step, so there a few percent flip (1.3% measured on this input)
    assert np.mean(ll == ll_ref) >= (0.97 if mode == "rate" else 0.9999)
    assert np.abs(ll - ll_ref).max() <= 1
    assert np.abs(ours["maxmag"].astype(np.int64) - ref["maxmag"]).max() <= 1
    if resid == "dual":
        np.testing.assert_allclose(ours["eta_sim"], ref["eta_sim"], rtol=1e-6)
        np.testing.assert_allclose(ours["kappa"], ref["kappa"], rtol=1e-6)


def test_pwe_streams_decode_within_bound_under_three_decoders():
    vol = _vol(*DIMS)
    comp = _port_comp()
    stream = comp.compress(vol, "pwe", 1e-3)
    assert comp.last_uncertified_chunks == 0 and comp.last_uncertified_ids == []
    host, dims = Sperr3DDecompressor().decompress(bytes(stream))
    ours, dims2 = tb.TorchDecompressor3D(device="cpu").decompress(stream)
    theirs, dims3 = jb.TpuDecompressor3D().decompress(stream)
    assert dims == dims2 == dims3 == DIMS
    assert ours.dtype == np.float32
    for out in (host, ours, theirs):
        assert _err(out, vol) <= 1e-3


@pytest.mark.parametrize("pwe_strict", [False, "f64", "device"])
def test_pwe_other_certification_modes(pwe_strict):
    vol = _vol(*DIMS)
    stream = _port_comp(pwe_strict=pwe_strict).compress(vol, "pwe", 1e-3)
    host, _ = Sperr3DDecompressor().decompress(bytes(stream))
    ours, _ = tb.TorchDecompressor3D(device="cpu").decompress(stream)
    # the f32 scan at tol bounds the error up to f32 roundoff of the data
    slack = 4 * np.finfo(np.float32).eps * np.abs(vol).max() if pwe_strict is False else 0
    assert _err(host, vol) <= 1e-3 + slack
    assert _err(ours, vol) <= 1e-3 + 4 * np.finfo(np.float32).eps * np.abs(vol).max()


def test_port_decodes_jax_dense_stream():
    vol = _vol(*DIMS)
    stream = _jax_comp().compress(vol, "pwe", 1e-3)
    ours, _ = tb.TorchDecompressor3D(device="cpu").decompress(stream)
    assert _err(ours, vol) <= 1e-3


def test_psnr_mode_matches_jax_path():
    vol = _vol(*DIMS)
    s_ours = _port_comp().compress(vol, "psnr", 60.0)
    s_jax = _jax_comp().compress(vol, "psnr", 60.0)
    ours, _ = tb.TorchDecompressor3D(device="cpu").decompress(s_ours)
    theirs, _ = jb.TpuDecompressor3D().decompress(s_jax)
    assert abs(_psnr(vol, ours) - _psnr(vol, theirs)) <= 0.1


def test_rate_mode_matches_jax_path():
    vol = _vol(*DIMS)
    s_ours = _port_comp().compress(vol, "rate", 2.0)
    s_jax = _jax_comp().compress(vol, "rate", 2.0)
    assert len(s_ours) == len(s_jax)
    # every chunk holds the conditioner (17 B), the SPECK header (9 B) and
    # exactly the budgeted body
    h = tools.parse_header(s_ours)
    n = CHUNK[0] * CHUNK[1] * CHUNK[2]
    assert list(h.chunk_offsets[1::2]) == [17 + 9 + 2 * n // 8] * 2
    ours, _ = tb.TorchDecompressor3D(device="cpu").decompress(s_ours)
    theirs, _ = jb.TpuDecompressor3D().decompress(s_jax)
    assert abs(_psnr(vol, ours) - _psnr(vol, theirs)) <= 0.1


def test_constant_chunk_is_a_conditioner_stream():
    vol = np.full((32, 32, 32), 2.5, dtype=np.float32)
    stream = tb.TorchCompressor3D((32, 32, 32), (32, 32, 32), device="cpu").compress(
        vol, "psnr", 80.0
    )
    out, _ = tb.TorchDecompressor3D(device="cpu").decompress(stream)
    np.testing.assert_array_equal(out, vol)
    assert tools.parse_header(stream).chunk_offsets[1] == 17


def test_sub_batched_groups_identical_streams():
    vol = _vol(16, 16, 64)
    dims, cd = (16, 16, 64), (16, 16, 16)
    one = tb.TorchCompressor3D(dims, cd, device="cpu")
    s_one = one.compress(vol, "pwe", 1e-3)
    sub = tb.TorchCompressor3D(dims, cd, device="cpu")
    sub.dense_elem_budget = 16 * 16 * 16  # one chunk per sub-batch
    assert sub.compress(vol, "pwe", 1e-3) == s_one
    out, _ = tb.TorchDecompressor3D(device="cpu").decompress(s_one)
    assert _err(out, vol) <= 1e-3


def test_device_resident_decode_and_only():
    vol = _vol(*DIMS)
    stream = _port_comp().compress(vol, "pwe", 1e-3)
    dec = tb.TorchDecompressor3D(device="cpu")
    full, _ = dec.decompress(stream)
    blocks, dims = dec.decompress(stream, to_host=False)
    assert dims == DIMS and len(blocks) == 2
    for (z0, y0, x0, lz, ly, lx), t in blocks.items():
        assert isinstance(t, torch.Tensor) and t.device == torch.device("cpu")
        assert tuple(t.shape) == (lz, ly, lx)
        np.testing.assert_array_equal(
            t.numpy(), full[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]
        )
    only, _ = dec.decompress(stream, to_host=False, only=[1])
    assert list(only) == [(32, 0, 0, 32, 32, 32)]
    np.testing.assert_array_equal(only[(32, 0, 0, 32, 32, 32)].numpy(), full[32:])


def test_unported_options_raise():
    """Unknown options raise; both transfers of either entropy are ported,
    and only a device dtype other than f32 is not."""
    with pytest.raises(ValueError, match="entropy"):
        tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", entropy="events")
    with pytest.raises(ValueError, match="transfer"):
        tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", transfer="packed")
    assert tb.TorchCompressor3D(DIMS, CHUNK, device="cpu").transfer == "sparse"
    # sperr_tpu's default configuration (sparse transfer) and both wave ones
    for kw in ({}, {"entropy": "wave"}, {"entropy": "wave", "transfer": "dense"}):
        t = jb.TpuCompressor3D(DIMS, CHUNK, **kw)
        t.sparse_cap_frac = 0.25
        p = tb.TorchCompressor3D.from_jax(t, "cpu")
        assert (p.entropy, p.transfer, p.sparse_cap_frac) == (t.entropy, t.transfer, 0.25)
    with pytest.raises(NotImplementedError, match="dtype"):
        tb.TorchCompressor3D.from_jax(jb.TpuCompressor3D(DIMS, CHUNK, dtype=np.float64), "cpu")


def test_from_jax_copies_settings():
    t = _jax_comp(pwe_strict="f64", num_threads=3)
    t.dense_elem_budget = 12345
    p = tb.TorchCompressor3D.from_jax(t, "cpu")
    assert (p.vol_dims, p.chunk_dims, p.pwe_strict, p.num_threads, p.dense_elem_budget) == (
        t.vol_dims, t.chunk_dims, "f64", 3, 12345,
    )
    assert p.device == torch.device("cpu")
