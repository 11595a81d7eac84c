"""The port's sparse transfer (``TorchCompressor3D(transfer="sparse")``, the
default) against its own dense transfer and sperr_tpu's sparse transfer, on
the CPU with the kernels' plain versions.

The sparse program's integer outputs equal the port's dense front compacted
in numpy bit for bit (rule (a)); against sperr_tpu's ``_dense_encode_sparse``
they agree wherever the two fronts quantize alike (rule (b): XLA may contract
multiply-adds, so a value near a rounding tie can flip).  The sparse
containers equal the dense ones byte for byte in every mode, tier and
entropy route, except under ``pwe_strict="device"``, where the transfers
certify differently; there they equal sperr_tpu's sparse containers on a
smooth input whose quantized values both fronts agree on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.parallel import batched as jb
from sperr_tpu_torch.parallel import batched as tb
from sperr_tpu_torch.parallel.chunked3d import Sperr3DDecompressor

DIMS, CHUNK = (64, 64, 32), (32, 32, 32)
_EPS32 = np.finfo(np.float32).eps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops per chunk: with several pytest workers on one
    machine, torch's thread pools wait on each other, so one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(dims, seed, noise, grid):
    """A smooth (nz, ny, nx) field plus Gaussian noise, on a 1/grid lattice:
    with |x| <= 1.1 every partial sum of a chunk of up to 2^15 values is
    exact in f32, so both packages' means are exact whatever order their
    reductions take (XLA's fused f32 mean is ~5e-6 off the exact one)."""
    nx, ny, nz = dims
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    f = np.sin(x * 0.2) * np.cos(y * 0.15) * np.sin(z * 0.1 + 1.0)
    f = f + noise * rng.normal(size=f.shape)
    return (np.round(f * grid) / grid).astype(np.float32)


def _smooth(dims=DIMS, seed=4):
    """Smooth data at PWE 1e-2: few nonzeros, a few outliers per chunk."""
    return _field(dims, seed, 0.001, 256)


def _noisy(dims=DIMS, seed=21):
    """Noisy data at PWE 1e-3: most coefficients nonzero, over a thousand
    outliers per 32^3 chunk (past the wave program's outlier cap)."""
    return _field(dims, seed, 0.02, 64)


def _chunks(vol, shape):
    lz, ly, lx = shape
    return np.ascontiguousarray(np.stack([vol[:lz, :ly, :lx], vol[-lz:, -ly:, -lx:]]))


def _ll(mags, signs):
    return np.where(signs, 1, -1) * mags.astype(np.int64)


_FRONTS = [("pwe", 1e-2, "dual"), ("pwe", 1e-2, "margin"), ("pwe", 1e-2, "none"),
           ("pwe", 1e-2, "f32"), ("psnr", 60.0, "f32"), ("rate", 2.0, "f32")]


@pytest.mark.parametrize("shape", [(32, 32, 32), (32, 48, 40)])
@pytest.mark.parametrize("mode,quality,resid", _FRONTS)
def test_sparse_program_equals_the_dense_front_compacted(shape, mode, quality, resid):
    x = torch.from_numpy(_chunks(_field((48, 48, 40), 3, 0.003, 256), shape))
    n = int(np.prod(shape))
    cap, out_cap = n // 2, max(256, n // 64)
    sp = {k: v.numpy() for k, v in tb._dense_encode_sparse(x, mode, quality, cap, out_cap, resid).items()}
    small = {k: v.numpy() for k, v in tb._dense_encode_sparse(x, mode, quality, 1024, 256, resid).items()}
    dense = {k: v.numpy() for k, v in tb._dense_encode(x, mode, quality, resid).items()}
    for key in ("is_const", "v0", "mean", "q", "maxmag"):
        np.testing.assert_array_equal(sp[key], dense[key], key)
    np.testing.assert_array_equal(sp["absmax"], np.abs(x.numpy().reshape(2, n)).max(axis=1))
    for b in range(2):
        ll = _ll(dense["mags"][b], dense["signs"][b])
        nz = np.flatnonzero(ll)
        # rate mode's 2^20 steps leave most values nonzero, past cap
        assert sp["nnz"][b] == small["nnz"][b] == nz.size > 1024
        k = min(nz.size, cap)
        np.testing.assert_array_equal(sp["idx"][b, :k], nz[:k])
        np.testing.assert_array_equal(sp["idx"][b, k:], n)
        np.testing.assert_array_equal(sp["vals"][b, :k], ll[nz[:k]])
        np.testing.assert_array_equal(sp["vals"][b, k:], 0)
        # past the cap: the true count and the first cap indices
        np.testing.assert_array_equal(small["idx"][b], nz[:1024])
        np.testing.assert_array_equal(small["vals"][b], ll[nz[:1024]])
        if mode != "pwe" or resid == "none":
            assert "n_out" not in sp
            continue
        pos = np.flatnonzero(dense["outlier_mask"][b])
        m = int(sp["n_out"][b])
        assert 0 < m <= out_cap
        oi, ov = sp["out_idx"][b, :m], sp["out_vals"][b, :m]
        np.testing.assert_array_equal(sp["out_idx"][b, m:], n)
        if resid == "margin":
            # the dense front scans at tol, the sparse program at tol - eta
            assert not sp["margin_bad"][b]
            assert np.isin(pos, oi).all() and (np.diff(oi) > 0).all()
        else:
            np.testing.assert_array_equal(oi, pos)
        np.testing.assert_array_equal(ov, dense["diff"][b][oi])
        np.testing.assert_array_equal(sp["out_vals"][b, m:], 0)
    if resid == "dual":
        for key in ("eta_sim", "kappa"):
            np.testing.assert_array_equal(sp[key], dense[key], key)


@pytest.mark.parametrize("mode,quality,resid", [f for f in _FRONTS if f[2] != "f32" or f[0] != "pwe"])
def test_sparse_program_matches_jax(mode, quality, resid):
    x = _chunks(_smooth((40, 48, 48)), (32, 32, 32))
    n = 32**3
    cap, out_cap = n // 2, n // 64
    ours = {k: v.numpy() for k, v in
            tb._dense_encode_sparse(torch.from_numpy(x), mode, quality, cap, out_cap, resid).items()}
    ref = {k: np.asarray(v) for k, v in
           jb._dense_encode_sparse(jnp.asarray(x), mode, quality, cap, out_cap, resid, seq=True).items()}
    assert set(ours) == set(ref)
    np.testing.assert_allclose(ours["mean"], ref["mean"], rtol=1e-6)
    np.testing.assert_allclose(ours["q"], ref["q"], rtol=1e-6)
    np.testing.assert_array_equal(ours["absmax"], ref["absmax"])
    np.testing.assert_array_equal(ours["is_const"], ref["is_const"])
    same_rows = 0
    for b in range(2):
        ll, ll_ref = (np.zeros(n, np.int64) for _ in range(2))
        ll[ours["idx"][b, : ours["nnz"][b]]] = ours["vals"][b, : ours["nnz"][b]]
        ll_ref[ref["idx"][b, : ref["nnz"][b]]] = ref["vals"][b, : ref["nnz"][b]]
        # ulp-level differences in the coefficients flip values that sit
        # near a rounding tie; rate mode quantizes to 2^20 steps of max|c|
        assert np.mean(ll == ll_ref) >= (0.97 if mode == "rate" else 0.9999)
        assert np.abs(ll - ll_ref).max() <= 1
        if np.array_equal(ll, ll_ref):
            same_rows += 1
            for key in ("idx", "vals", "nnz", "maxmag"):
                np.testing.assert_array_equal(ours[key][b], ref[key][b], key)
    if mode == "pwe":
        assert same_rows == 2  # this smooth input quantizes alike in both
        if resid != "none":
            assert np.abs(ours["n_out"].astype(np.int64) - ref["n_out"]).max() <= 1
    if resid == "dual":
        np.testing.assert_allclose(ours["eta_sim"], ref["eta_sim"], rtol=1e-6)


def _decodes_within(stream, vol, tol):
    host, _ = Sperr3DDecompressor().decompress(bytes(stream))
    ours, _ = tb.TorchDecompressor3D(device="cpu").decompress(stream)
    v64 = vol.astype(np.float64)
    assert np.abs(np.asarray(host).reshape(vol.shape) - v64).max() <= tol
    assert np.abs(ours.astype(np.float64) - v64).max() <= tol + 4 * _EPS32 * np.abs(vol).max()


_CONTAINERS = [("pwe", 1e-3, s) for s in (True, False, "f64", "device")] + [
    ("psnr", 60.0, True), ("rate", 2.0, True)]


@pytest.mark.parametrize("entropy", ["host", "wave"])
@pytest.mark.parametrize("mode,quality,strict", _CONTAINERS)
def test_sparse_container(entropy, mode, quality, strict):
    """From ``from_jax`` of sperr_tpu's default compressor (the sparse
    transfer): the container decodes within the bound under the port's
    decoder and the host f64 decoder, and equals the port's dense-transfer
    container; under ``pwe_strict="device"`` it equals sperr_tpu's sparse
    container on smooth data."""
    device = strict == "device"
    vol, quality = (_smooth(), 1e-2) if device else (_noisy(), quality)
    jax_comp = jb.TpuCompressor3D(DIMS, CHUNK, entropy=entropy, pwe_strict=strict)
    sparse = tb.TorchCompressor3D.from_jax(jax_comp, "cpu")
    assert (sparse.transfer, sparse.sparse_cap_frac) == ("sparse", 0.5)
    s = sparse.compress(vol, mode, quality)
    if mode == "pwe":
        assert sparse.last_uncertified_chunks == 0
        _decodes_within(s, vol, quality)
    else:
        host, _ = Sperr3DDecompressor().decompress(bytes(s))
        ours, _ = tb.TorchDecompressor3D(device="cpu").decompress(s)
        assert np.abs(ours - np.asarray(host).reshape(vol.shape)).max() <= 1e-4 * np.ptp(vol)
    if device:
        assert s == jax_comp.compress(vol, mode, quality)
    else:
        dense = tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", entropy=entropy, pwe_strict=strict,
                                     transfer="dense")
        assert s == dense.compress(vol, mode, quality)
    if entropy == "wave":
        assert sparse.last_wave_chunks == 4


@pytest.mark.parametrize("entropy", ["host", "wave"])
def test_dense_rerun_past_the_caps_leaves_the_container_unchanged(entropy):
    """A tiny ``sparse_cap_frac`` puts every chunk past ``cap``; the noisy
    data's outliers are past ``out_cap`` (n / 64) and past the wave
    program's outlier cap.  Each chunk re-runs through the dense front."""
    vol = _noisy()
    dense = tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", entropy=entropy, transfer="dense")
    want = dense.compress(vol, "pwe", 1e-3)
    sparse = tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", entropy=entropy)
    sparse.sparse_cap_frac = 1e-6
    assert sparse.compress(vol, "pwe", 1e-3) == want
    sp = tb._dense_encode_sparse(torch.from_numpy(_chunks(vol, (32, 32, 32))), "pwe", 1e-3, 1024, 512,
                                 "dual")
    assert (sp["nnz"] > 1024).all() and (sp["n_out"] > 512).all()


@pytest.mark.parametrize("tiers", ["view", "no view"])
def test_wave_views_leave_the_container_unchanged(tiers):
    """The wave route's view of a chunk's values: the exposure compaction of
    a tier that has one (``wexp_frac`` < 1), or the nonzeros compacted from
    the front (a tier with ``wexp_frac`` 1.0); outliers past the wave
    program's cap (n / 1024) but within n / 64 come from the front at the
    wider cap.  The container is the dense transfer's."""
    dims = (64, 64, 32)
    # off the lattice (only the port is compared): 1527 outliers at tol 1e-2
    nx, ny, nz = dims
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    vol = np.sin(x * 0.2) * np.cos(y * 0.15) * np.sin(z * 0.1 + 1.0)
    vol = (vol + 0.0038 * np.random.default_rng(8).normal(size=vol.shape)).astype(np.float32)
    tol = 1e-2
    dense = tb.TorchCompressor3D(dims, dims, device="cpu", entropy="wave", transfer="dense")
    want = dense.compress(vol, "pwe", tol)
    sparse = tb.TorchCompressor3D(dims, dims, device="cpu", entropy="wave")
    sparse.wave_tiers = ((0.5, 0.5, 0.5, 16, 0.75),) if tiers == "view" else ((1.0, 1.0, 1.0, 34, 1.0),)
    assert sparse.compress(vol, "pwe", tol) == want
    assert sparse.last_wave_tiers == [0]
    n = dims[0] * dims[1] * dims[2]
    sp = tb._dense_encode_sparse(torch.from_numpy(vol[None]), "pwe", tol, n // 2, n // 64, "dual")
    assert max(1024, n // 1024) < int(sp["n_out"][0]) <= n // 64
    assert sparse.last_d2h_bytes < dense.last_d2h_bytes


@pytest.mark.parametrize("entropy", ["host", "wave"])
@pytest.mark.parametrize("chunk", [CHUNK, (8, 8, 8)])
def test_sparse_transfer_copies_fewer_bytes_on_smooth_data(entropy, chunk):
    """Smooth data: fewer bytes than the dense transfer, the same container;
    8^3 chunks hold fewer values (512) than the caps' floors (1024, 256)."""
    dims = DIMS if chunk == CHUNK else (16, 16, 16)
    vol = np.ascontiguousarray(_smooth()[: dims[2], : dims[1], : dims[0]])
    comps = {t: tb.TorchCompressor3D(dims, chunk, device="cpu", entropy=entropy, transfer=t)
             for t in ("sparse", "dense")}
    streams = {t: c.compress(vol, "pwe", 1e-2) for t, c in comps.items()}
    assert streams["sparse"] == streams["dense"]
    if chunk == CHUNK:
        assert 0 < comps["sparse"].last_d2h_bytes < comps["dense"].last_d2h_bytes


@pytest.mark.parametrize("entropy", ["host", "wave"])
def test_margin_bad_chunks_are_rescanned_on_the_host(entropy):
    """pwe_strict="device" on data whose scale f32 cannot certify at tol
    (eta > tol/4 in every chunk): the host scans every residual, so the
    sparse container is the dense transfer's, and the host route's device
    outliers (nearly every voxel past max(tol - eta, 0)) are not read: no
    chunk re-runs through the dense front."""
    nx, ny, nz = DIMS
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    vol = (1000 * np.sin(x * 0.2) * np.cos(y * 0.15) * np.sin(z * 0.1 + 1.0)).astype(np.float32)
    tol = 0.05
    sp = tb._dense_encode_sparse(torch.from_numpy(_chunks(vol, (32, 32, 32))), "pwe", tol, 16384, 512,
                                 "margin")
    assert sp["margin_bad"].all() and (sp["n_out"] > 512).all() and (sp["nnz"] <= 16384).all()
    dense = tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", entropy=entropy, transfer="dense",
                                 pwe_strict="device")
    sparse = tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", entropy=entropy, pwe_strict="device")
    s = sparse.compress(vol, "pwe", tol)
    assert s == dense.compress(vol, "pwe", tol)
    _decodes_within(s, vol, tol)
    n_total = vol.size
    assert sparse.last_d2h_bytes < (4 * n_total if entropy == "host" else dense.last_d2h_bytes)
