"""The port's 2D sparse transfer (``TorchCompressor2D(transfer="sparse")``,
the default) against its own dense transfer and sperr_tpu's 2D compressor,
which always compacts, on the CPU with the kernels' plain versions.

The sparse program's outputs equal the port's dense front compacted in
numpy bit for bit (rule (a)); against sperr_tpu's ``_dense_encode2`` they
agree wherever the two fronts quantize alike (rule (b): XLA may contract
multiply-adds, so a value near a rounding tie can flip).  The sparse streams
equal the dense ones byte for byte on both entropy routes, and a part with a
field past a cap is refused wherever sperr_tpu refuses it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.codec.speck_flt import SpeckFloatCodec
from sperr_tpu.parallel import batched2d as jb2
from sperr_tpu_torch.parallel import batched2d as tb2

SHAPES = [(64, 48), (96, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops per field: with several pytest workers on one
    machine, torch's thread pools wait on each other, so one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(nx, ny, seed, noise, grid):
    """A smooth (ny, nx) field plus Gaussian noise, on a 1/grid lattice: with
    |x| <= 1.1 every partial sum of a field of up to 2^13 values is exact in
    f32, so both packages' means are exact whatever order their reductions
    take."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:ny, 0:nx]
    f = np.sin(x * 0.2 + seed) * np.cos(y * 0.15) + noise * rng.normal(size=(ny, nx))
    return (np.round(f * grid) / grid).astype(np.float32)


def _smooth(nx, ny):
    """Three smooth fields: at PWE 1e-2 about a sixth of the pixels are
    nonzero, with a few outliers."""
    return np.stack([_field(nx, ny, s, 0.001, 256) for s in range(3)])


def _mixed(nx, ny):
    """A smooth field, a noisy one and a constant one."""
    return np.stack([_field(nx, ny, 0, 0.001, 256), _field(nx, ny, 1, 0.02, 64),
                     np.full((ny, nx), 0.75, np.float32)])


def _ll(mags, signs):
    return np.where(signs, 1, -1) * mags.astype(np.int64)


def _scatter(idx, vals, count, n):
    ll = np.zeros(n, np.int64)
    ll[idx[:count]] = vals[:count]
    return ll


_FRONTS = [("pwe", 1e-2, "dual"), ("pwe", 1e-2, "f32"), ("pwe", 1e-2, "none"),
           ("psnr", 60.0, "f32"), ("rate", 2.0, "f32")]


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("mode,quality,resid", _FRONTS)
def test_sparse_program_equals_the_dense_front_compacted(nx, ny, mode, quality, resid):
    x = torch.from_numpy(_mixed(nx, ny))
    n = nx * ny
    sp = {k: v.numpy() for k, v in tb2._dense_encode2_sparse(x, mode, quality, n, n, resid).items()}
    # the reference's caps at a small sparse_cap_frac: the first 1024
    # nonzeros and 256 outliers, with the true counts
    small = {k: v.numpy() for k, v in tb2._dense_encode2_sparse(x, mode, quality, 1024, 256, resid).items()}
    dense = {k: v.numpy() for k, v in tb2._dense_encode2(x, mode, quality, resid).items()}
    want = {"is_const", "v0", "mean", "q", "maxmag", "idx", "vals", "nnz"}
    if mode == "pwe" and resid != "none":
        want |= {"n_out", "out_idx", "out_vals"}
    if resid == "dual":
        want |= {"eta_sim", "kappa"}
    assert set(sp) == want
    for key in want & {"is_const", "v0", "mean", "q", "maxmag", "eta_sim", "kappa"}:
        np.testing.assert_array_equal(sp[key], dense[key], key)
    np.testing.assert_array_equal(sp["is_const"], [False, False, True])
    # the constant field's values are never read (in PSNR and rate modes its
    # zero range gives q = 0, and the front's magnitudes saturate): no
    # nonzeros, as in sperr_tpu
    np.testing.assert_array_equal(sp["idx"][2], n)
    np.testing.assert_array_equal(sp["vals"][2], 0)
    assert sp["nnz"][2] == 0
    for b in range(2):
        ll = _ll(dense["mags"][b], dense["signs"][b])
        nz = np.flatnonzero(ll)
        assert sp["nnz"][b] == small["nnz"][b] == nz.size
        np.testing.assert_array_equal(sp["idx"][b, : nz.size], nz)
        np.testing.assert_array_equal(sp["idx"][b, nz.size :], n)
        np.testing.assert_array_equal(sp["vals"][b, : nz.size], ll[nz])
        np.testing.assert_array_equal(sp["vals"][b, nz.size :], 0)
        k = min(nz.size, 1024)
        np.testing.assert_array_equal(small["idx"][b, :k], nz[:k])
        np.testing.assert_array_equal(small["vals"][b, :k], ll[nz[:k]])
        if "n_out" not in want:
            continue
        pos = np.flatnonzero(dense["outlier_mask"][b])
        m = int(sp["n_out"][b])
        assert m == pos.size == small["n_out"][b]
        np.testing.assert_array_equal(sp["out_idx"][b, :m], pos)
        np.testing.assert_array_equal(sp["out_idx"][b, m:], n)
        np.testing.assert_array_equal(sp["out_vals"][b, :m], dense["diff"][b][pos])
        np.testing.assert_array_equal(sp["out_vals"][b, m:], 0)
        k = min(m, 256)
        np.testing.assert_array_equal(small["out_idx"][b, :k], pos[:k])
    assert small["nnz"][1] > 1024  # the noisy field passes the small cap


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("mode,quality,resid", _FRONTS)
def test_sparse_program_matches_jax(nx, ny, mode, quality, resid):
    x = _smooth(nx, ny)
    n = nx * ny
    ours = {k: v.numpy() for k, v in
            tb2._dense_encode2_sparse(torch.from_numpy(x), mode, quality, n, n, resid).items()}
    ref = {k: np.asarray(v) for k, v in jb2._dense_encode2(jnp.asarray(x), mode, quality, n, n, resid).items()}
    assert set(ours) == set(ref)
    np.testing.assert_allclose(ours["mean"], ref["mean"], rtol=1e-6)
    np.testing.assert_allclose(ours["q"], ref["q"], rtol=1e-6)
    np.testing.assert_array_equal(ours["is_const"], ref["is_const"])
    same_rows = 0
    for b in range(3):
        ll = _scatter(ours["idx"][b], ours["vals"][b], ours["nnz"][b], n)
        ll_ref = _scatter(ref["idx"][b], ref["vals"][b], ref["nnz"][b], n)
        # ulp-level differences in the coefficients flip values that sit
        # near a rounding tie; rate mode quantizes to 2^20 steps of max|c|
        assert np.mean(ll == ll_ref) >= (0.97 if mode == "rate" else 0.9999)
        assert np.abs(ll - ll_ref).max() <= 1
        if np.array_equal(ll, ll_ref):
            same_rows += 1
            keys = ("idx", "vals", "nnz", "maxmag") + (("n_out", "out_idx") if "n_out" in ref else ())
            for key in keys:
                np.testing.assert_array_equal(ours[key][b], ref[key][b], key)
    if mode != "rate":
        assert same_rows == 3  # this smooth input quantizes alike in both
    if resid == "dual":
        np.testing.assert_allclose(ours["eta_sim"], ref["eta_sim"], rtol=1e-6)


def _decodes_within(streams, fields, tol, header=False):
    b, ny, nx = fields.shape
    ours = tb2.TorchDecompressor2D((nx, ny), device="cpu").decompress_batch(streams, with_header=header)
    theirs = jb2.TpuDecompressor2D((nx, ny)).decompress_batch(streams, with_header=header)
    for k, f in enumerate(fields):
        host, _ = SpeckFloatCodec(2, (nx, ny, 1)).decompress(bytes(streams[k])[10 if header else 0 :])
        for out in (ours[k], theirs[k], host):
            assert np.abs(np.asarray(out, np.float64).reshape(f.shape) - f).max() <= tol


# (mode, quality, pwe_strict, with_header); rate mode's magnitudes need more
# than the 18 bitplanes of the wave route's pixel classes: the host engine
_STREAMS = [("pwe", 1e-2, True, False), ("pwe", 1e-2, True, True), ("pwe", 1e-2, False, False),
            ("pwe", 1e-2, "f64", False), ("psnr", 60.0, True, False), ("rate", 2.0, True, False)]


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("entropy", ["host", "wave"])
@pytest.mark.parametrize("mode,quality,strict,header", _STREAMS)
def test_sparse_streams_equal_dense_streams(nx, ny, entropy, mode, quality, strict, header):
    fields = _mixed(nx, ny)
    comps = {t: tb2.TorchCompressor2D((nx, ny), device="cpu", entropy=entropy, pwe_strict=strict,
                                      with_header=header, transfer=t) for t in ("sparse", "dense")}
    assert tb2.TorchCompressor2D((nx, ny), device="cpu").transfer == "sparse"
    streams = {t: c.compress_batch(fields, mode, quality) for t, c in comps.items()}
    assert streams["sparse"] == streams["dense"]
    sp = comps["sparse"]
    assert sp.last_uncertified_chunks == comps["dense"].last_uncertified_chunks == 0
    assert sp.last_wave_tiers == comps["dense"].last_wave_tiers
    if entropy == "wave":
        # the constant field and, in rate mode, every field take the host engine
        assert sp.last_wave_tiers[2] is None
        assert sp.last_wave_chunks == (0 if mode == "rate" else 2)
    if mode == "pwe":
        _decodes_within(streams["sparse"], fields, quality, header)


@pytest.mark.parametrize("entropy", ["host", "wave"])
def test_split_over_devices_gives_the_one_device_streams(entropy):
    fields = np.concatenate([_mixed(96, 64), _smooth(96, 64)])
    one = tb2.TorchCompressor2D((96, 64), device="cpu", entropy=entropy)
    two = tb2.TorchCompressor2D((96, 64), devices=["cpu", "cpu"], entropy=entropy)
    dense = tb2.TorchCompressor2D((96, 64), device="cpu", entropy=entropy, transfer="dense")
    want = dense.compress_batch(fields, "pwe", 1e-2)
    assert one.compress_batch(fields, "pwe", 1e-2) == want
    assert two.compress_batch(fields, "pwe", 1e-2) == want
    assert two.last_wave_tiers == one.last_wave_tiers
    # each part trims to its own largest counts, at most the whole batch's
    assert 0 < two.last_d2h_bytes <= one.last_d2h_bytes


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("entropy", ["host", "wave"])
def test_sparse_transfer_copies_fewer_bytes_on_smooth_fields(nx, ny, entropy):
    fields = _smooth(nx, ny)
    comps = {t: tb2.TorchCompressor2D((nx, ny), device="cpu", entropy=entropy, transfer=t)
             for t in ("sparse", "dense")}
    streams = {t: c.compress_batch(fields, "pwe", 1e-2) for t, c in comps.items()}
    assert streams["sparse"] == streams["dense"]
    assert 0 < comps["sparse"].last_d2h_bytes < comps["dense"].last_d2h_bytes


def _smooth_and_constant(nx, ny):
    return np.stack([_smooth(nx, ny)[0], np.full((ny, nx), -2.5, np.float32)])


# (fields, sparse_cap_frac, mode, quality, whether sperr_tpu raises): at PWE
# 1e-3 the noisy field has ~5,960 nonzeros of 6,144 and the smooth ones
# ~4,290, past a cap of 1,024 (sparse_cap_frac 0.1) or 3,072 (0.5); at 1e-2
# the smooth fields have ~700 nonzeros and a few outliers (out_cap 384); a
# constant field has none, whatever its q
_CAPS = [(_mixed, 0.1, "pwe", 1e-3, True), (_mixed, 0.5, "pwe", 1e-3, True),
         (_smooth, 0.1, "pwe", 1e-3, True), (_smooth, 0.1, "pwe", 1e-2, False),
         (_mixed, 1.0, "pwe", 1e-3, False), (_smooth_and_constant, 0.1, "psnr", 40.0, False),
         (_smooth_and_constant, 0.1, "rate", 0.5, True)]


@pytest.mark.parametrize("fields,frac,mode,quality,raises", _CAPS)
def test_past_a_cap_raises_where_jax_raises(fields, frac, mode, quality, raises):
    fields = fields(96, 64)
    ref = jb2.TpuCompressor2D((96, 64))
    ref.sparse_cap_frac = frac
    try:
        want = ref.compress_batch(fields, mode, quality)
    except ValueError:
        want = None
    assert (want is None) == raises
    dense = tb2.TorchCompressor2D((96, 64), device="cpu", transfer="dense").compress_batch(fields, mode, quality)
    for entropy in ("host", "wave"):
        comp = tb2.TorchCompressor2D((96, 64), device="cpu", entropy=entropy)
        comp.sparse_cap_frac = frac
        if raises:
            with pytest.raises(ValueError, match="2D compaction capacity exceeded"):
                comp.compress_batch(fields, mode, quality)
        else:
            assert comp.compress_batch(fields, mode, quality) == dense
        # the dense transfer has no caps
        comp.transfer = "dense"
        assert comp.compress_batch(fields, mode, quality) == dense


def test_from_jax_takes_the_sparse_transfer_and_maps_device_strictness():
    fields = _mixed(96, 64)
    t = jb2.TpuCompressor2D((96, 64), pwe_strict="device")
    t.sparse_cap_frac = 0.9
    p = tb2.TorchCompressor2D.from_jax(t, "cpu")
    assert (p.transfer, p.sparse_cap_frac, p.pwe_strict) == ("sparse", 0.9, True)
    s = p.compress_batch(fields, "pwe", 1e-2)
    assert s == tb2.TorchCompressor2D((96, 64), device="cpu", pwe_strict=True).compress_batch(fields, "pwe", 1e-2)
    assert p.last_uncertified_chunks == 0
    _decodes_within(s, fields, 1e-2)
    with pytest.raises(ValueError, match="transfer"):
        tb2.TorchCompressor2D((96, 64), device="cpu", transfer="packed")
