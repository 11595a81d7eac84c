"""The port's copies of sperr_tpu's host layers give their originals' bytes
and arrays on seeded inputs.

sperr_tpu_torch keeps its own copies of the framework-neutral layers it needs
(the C++ SPECK engine, the container format, the outlier coder, the stream
stitcher, the exact f64 decoders and the small helpers under them), so that
it imports nothing of sperr_tpu.  Each copy is held against its original
here."""

from dataclasses import asdict

import numpy as np
import pytest

from sperr_tpu import errors as j_errors
from sperr_tpu.codec import outlier as j_outlier
from sperr_tpu.codec import speck_flt as j_flt
from sperr_tpu.codec import speck_int_np as j_sp
from sperr_tpu.codec import speck_sorted as j_sorted
from sperr_tpu.codec import speck_wave as j_wave
from sperr_tpu.ops import cdf97_np as j_cdf
from sperr_tpu.ops import condition as j_cond
from sperr_tpu.ops import pyramid as j_pyr
from sperr_tpu.ops import quantize as j_qz
from sperr_tpu.parallel import chunked3d as j_chunked
from sperr_tpu.runtime import native as j_native
from sperr_tpu.runtime.engine import NumpyEngine as JNumpyEngine
from sperr_tpu.stream import tools as j_tools
from sperr_tpu.utils import dims as j_dims
from sperr_tpu.utils import packing as j_packing
from sperr_tpu.utils import testdata as j_testdata
from sperr_tpu_torch import errors as t_errors
from sperr_tpu_torch.codec import outlier as t_outlier
from sperr_tpu_torch.codec import speck_flt as t_flt
from sperr_tpu_torch.codec import speck_int_np as t_sp
from sperr_tpu_torch.codec import speck_sorted as t_sorted
from sperr_tpu_torch.codec import speck_wave as t_wave
from sperr_tpu_torch.ops import cdf97_np as t_cdf
from sperr_tpu_torch.ops import condition as t_cond
from sperr_tpu_torch.ops import pyramid as t_pyr
from sperr_tpu_torch.ops import quantize_np as t_qz
from sperr_tpu_torch.parallel import chunked3d as t_chunked
from sperr_tpu_torch.runtime import native as t_native
from sperr_tpu_torch.runtime.engine import NumpyEngine as TNumpyEngine
from sperr_tpu_torch.stream import tools as t_tools
from sperr_tpu_torch.utils import dims as t_dims
from sperr_tpu_torch.utils import packing as t_packing
from sperr_tpu_torch.utils import testdata as t_testdata


def _coeffs(seed, n, width, density=0.3):
    rng = np.random.default_rng(seed)
    hi = min((1 << width) - 1, 1 << 20)
    mags = (rng.integers(0, hi, size=n) * (rng.random(n) < density)).astype(np.uint64)
    mags[rng.integers(0, n)] = hi  # the top bitplane is used
    return mags, rng.random(n) < 0.5


# (ndim, dims (nx, ny, nz), uint width, budget in bits)
_ENGINE_CASES = [
    (3, (16, 12, 10), 16, 0),
    (3, (32, 32, 32), 8, 0),
    (3, (20, 24, 18), 32, 6000),
    (2, (64, 48, 1), 16, 0),
    (2, (33, 17, 1), 8, 2000),
    (1, (1000, 1, 1), 8, 0),
]


@pytest.mark.parametrize("case", range(len(_ENGINE_CASES)))
def test_native_engine_copy(case):
    ndim, dims, width, budget = _ENGINE_CASES[case]
    n = dims[0] * dims[1] * dims[2]
    mags, signs = _coeffs(case, n, width)
    j, t = j_native.NativeEngine(), t_native.NativeEngine()
    s_j = j.encode(ndim, mags, signs, dims, width, budget)
    s_t = t.encode(ndim, mags, signs, dims, width, budget)
    assert s_t == s_j and len(s_t) > 9
    for a, b in zip(t.decode(ndim, s_t, dims, width), j.decode(ndim, s_j, dims, width)):
        np.testing.assert_array_equal(a, b)
    if ndim == 3:
        for a, b in zip(t.decode3d_control(s_t, dims, width), j.decode3d_control(s_j, dims, width)):
            np.testing.assert_array_equal(a, b)
    # and both equal the NumPy reference engines
    assert TNumpyEngine().encode(ndim, mags, signs, dims, width, budget) == s_j


@pytest.mark.parametrize("seed", [0, 1])
def test_native_chunk_codec_copy(seed):
    data = t_testdata.smooth_field_3d(16, seed=seed).astype(np.float64)
    j, t = j_native.NativeChunkCodec(), t_native.NativeChunkCodec()
    s_j = j.compress(data, 3, (16, 16, 16), "pwe", 1e-3)
    assert t.compress(data, 3, (16, 16, 16), "pwe", 1e-3) == s_j
    np.testing.assert_array_equal(t.decompress(s_j, 3, (16, 16, 16)), j.decompress(s_j, 3, (16, 16, 16)))


def _segments(seed, num_bp):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 2, size=int(rng.integers(0, 300))).astype(np.uint8) for _ in range(num_bp)]
            for _ in range(3)]


@pytest.mark.parametrize("budget", [0, 333, 5000])
def test_stitch_3d_copy(budget):
    num_bp = 9
    lip, lis, ref = _segments(budget, num_bp)
    want = j_wave.stitch_3d(None, None, None, (8, 8, 8), num_bp, lip, ref, budget, lis_segments=lis)
    assert t_wave.stitch_3d(num_bp, lip, lis, ref, budget) == want
    assert t_wave._pack_stream(np.empty(0, np.uint8), 0, 0) == j_wave._pack_stream(np.empty(0, np.uint8), 0, 0)


def _same_arrays(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, name)
        else:
            assert x == y, name


# a wavelet-packet chunk, a dyadic one and a power-of-two cube
@pytest.mark.parametrize("dims", [(24, 20, 12), (23, 15, 13), (16, 16, 16)])
def test_partition_tree_and_sorted_keys_copy(dims):
    assert t_wave._NEVER == j_wave._NEVER
    t_tree, j_tree = t_wave.build_tree(dims), j_wave.build_tree(dims)
    assert t_wave.build_tree(dims) is t_tree  # cached
    _same_arrays(t_tree, j_tree, j_wave.Tree.__slots__)
    _same_arrays(t_sorted.sorted_tree(t_tree), j_sorted.sorted_tree(j_tree), j_sorted.SortedTree.__slots__)
    assert t_wave._initial_sets(*dims) == j_wave._initial_sets(*dims)


# 2D (nx, ny): square, odd and wide fields, and one too small for a transform
@pytest.mark.parametrize("dims", [(32, 32), (33, 57), (128, 41), (7, 5)])
def test_quad_tree_and_sorted_keys_copy(dims):
    t_tree, j_tree = t_wave.build_tree2(dims), j_wave.build_tree2(dims)
    assert t_wave.build_tree2(dims) is t_tree  # cached
    _same_arrays(t_tree, j_tree, j_wave.Tree2.__slots__)
    _same_arrays(t_sorted.sorted_tree(t_tree), j_sorted.sorted_tree(j_tree), j_sorted.SortedTree.__slots__)
    for s in ((0, 0, 7, 5), (3, 2, 1, 4), (5, 9, 2, 1)):
        assert t_wave._quad_children(s) == j_wave._quad_children(s)
    nx, ny = dims
    pmsb = np.random.default_rng(nx * ny).integers(0, 20, size=(ny, nx)).astype(np.int16)
    pmsb[: ny // 2, : nx // 2] = 0
    np.testing.assert_array_equal(t_wave._iset_maxes(t_tree, pmsb), j_wave._iset_maxes(j_tree, pmsb))


@pytest.mark.parametrize("dims,budget", [((33, 57), 0), ((64, 48), 0), ((64, 48), 2500), ((7, 5), 0)])
def test_stitch_2d_and_sorted_walk_copy(dims, budget):
    """The host walk (every segment computed from the schedule), the sorted
    2D LIS walk, the LIP helper, and the pure concatenation of supplied
    segments, against the originals."""
    nx, ny = dims
    n = nx * ny
    mags, signs = _coeffs(n + budget, n, 12)
    tree = j_wave.build_tree2(dims)
    pmsb = j_wave.msbp1(mags)
    num_bp = int(pmsb.max())
    node_max = j_wave.compute_node_max(tree, pmsb)
    want = j_wave.stitch_2d(pmsb, signs, node_max, dims, num_bp, None, None, budget, mags=mags)
    assert t_wave.stitch_2d(pmsb, signs, node_max, dims, num_bp, None, None, budget, mags=mags) == want
    node_s = np.where(node_max > 0, num_bp - node_max, j_wave._NEVER).astype(np.int32)
    s_lin = np.where(pmsb > 0, num_bp - pmsb, j_wave._NEVER).astype(np.int32)
    iset_max = j_wave._iset_maxes(tree, pmsb.reshape(ny, nx))
    iset_s = np.where(iset_max > 0, num_bp - iset_max, j_wave._NEVER).astype(np.int32)
    lis_j = j_sorted.lis_segments_sorted_2d(tree, node_s, s_lin, signs, num_bp, iset_s)
    lis_t = t_sorted.lis_segments_sorted_2d(t_wave.build_tree2(dims), node_s, s_lin, signs, num_bp, iset_s)
    assert len(lis_t) == len(lis_j) == num_bp
    for a, b in zip(lis_t, lis_j):
        np.testing.assert_array_equal(a, b)
    cand = np.flatnonzero(s_lin < j_wave._NEVER)
    for p in range(num_bp):
        np.testing.assert_array_equal(
            t_wave._lip_segment(s_lin[cand] - 1, s_lin[cand], signs[cand], p),
            j_wave._lip_segment(s_lin[cand] - 1, s_lin[cand], signs[cand], p),
        )
    lip, lis, ref = _segments(budget + 1, num_bp)
    assert t_wave.stitch_2d(None, None, None, dims, num_bp, lip, ref, budget, lis_segments=lis) == \
        j_wave.stitch_2d(None, None, None, dims, num_bp, lip, ref, budget, lis_segments=lis)


@pytest.mark.parametrize("dims", [(23, 15, 13), (20, 20, 20), (12, 16, 16)])
def test_pyramid_tables_copy(dims):
    tp, jp = t_pyr.Pyramid(dims), j_pyr.Pyramid(dims)
    for axis in ("ax", "ay", "az"):
        _same_arrays(getattr(tp, axis), getattr(jp, axis), j_pyr.AxisTables.__slots__)
    assert tp.levels == jp.levels
    t_perm = t_pyr._build_tree_perm(tp, t_wave.build_tree(dims))
    j_perm = j_pyr._build_tree_perm(jp, j_wave.build_tree(dims))
    assert sorted(t_perm) == sorted(j_perm)
    for d in j_perm:
        for a, b in zip(t_perm[d], j_perm[d]):
            np.testing.assert_array_equal(a, b)
    pmsb = np.random.default_rng(sum(dims)).integers(0, 20, size=dims[0] * dims[1] * dims[2]).astype(np.int16)
    np.testing.assert_array_equal(t_pyr.exposure_pyramid(tp, pmsb, 20), j_pyr.exposure_pyramid(jp, pmsb, 20))
    with pytest.raises(ValueError, match="dyadic"):
        t_pyr._build_tree_perm(t_pyr.Pyramid((24, 20, 12)), t_wave.build_tree((24, 20, 12)))


@pytest.mark.parametrize("vol,chunk", [((64, 48, 40), (32, 32, 32)), ((20, 20, 20), (20, 20, 20)),
                                       ((100, 30, 7), (64, 16, 7))])
def test_container_header_copy(vol, chunk):
    nch = len(j_dims.chunk_volume(vol, chunk))
    lens = [int(v) for v in np.random.default_rng(nch).integers(30, 5000, size=nch)]
    for is_float in (False, True):
        h = t_tools.generate_header(vol, chunk, lens, is_float)
        assert h == j_tools.generate_header(vol, chunk, lens, is_float)
        stream = h + bytes(sum(lens))
        assert asdict(t_tools.parse_header(stream)) == asdict(j_tools.parse_header(stream))
    assert t_tools.generate_2d_header(vol[:2], True) == j_tools.generate_2d_header(vol[:2], True)
    with pytest.raises(t_tools.StreamError):
        t_tools.parse_header(b"\x05" + bytes(40))


@pytest.mark.parametrize("seed,tol", [(0, 1e-2), (1, 1e-3), (2, 0.5)])
def test_outlier_coder_copy(seed, tol):
    rng = np.random.default_rng(seed)
    n = 5000
    pos = np.sort(rng.choice(n, size=200, replace=False))
    errs = rng.normal(scale=4 * tol, size=200)
    s_j = j_outlier.encode_outliers(pos, errs, n, tol)
    assert t_outlier.encode_outliers(pos, errs, n, tol) == s_j
    assert t_outlier.encode_outliers(pos, errs, n, tol, engine=t_native.NativeEngine()) == s_j
    for a, b in zip(t_outlier.decode_outliers(s_j, n, tol), j_outlier.decode_outliers(s_j, n, tol)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ndim,dims,mode,quality", [
    (3, (16, 16, 16), "pwe", 1e-3),
    (3, (20, 16, 12), "psnr", 70.0),
    (3, (16, 16, 16), "rate", 2.0),
    (2, (48, 40, 1), "pwe", 1e-3),
    (2, (48, 40, 1), "psnr", 60.0),
])
def test_speck_float_codec_copy(ndim, dims, mode, quality):
    rng = np.random.default_rng(7)
    shape = dims[::-1] if ndim == 3 else dims[1::-1]
    data = np.cumsum(rng.normal(size=shape), axis=-1).astype(np.float64).ravel()
    s_j = j_flt.SpeckFloatCodec(ndim, dims).compress(data, mode, quality)
    codec = t_flt.SpeckFloatCodec(ndim, dims)
    assert codec.compress(data, mode, quality) == s_j
    for multi_res in (False, True):
        a, ha = codec.decompress(s_j, multi_res=multi_res)
        b, hb = j_flt.SpeckFloatCodec(ndim, dims).decompress(s_j, multi_res=multi_res)
        np.testing.assert_array_equal(a, b)
        assert len(ha) == len(hb)
        for x, y in zip(ha, hb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("multi_res", [False, True])
def test_sperr3d_decompressor_copy(multi_res):
    vol = j_testdata.smooth_field_3d(32, seed=3)
    stream = j_chunked.Sperr3DCompressor((32, 32, 32), (16, 16, 16)).compress(vol, "pwe", 1e-3)
    a, da = t_chunked.Sperr3DDecompressor().decompress(stream, multi_res=multi_res)
    j = j_chunked.Sperr3DDecompressor()
    b, db = j.decompress(stream, multi_res=multi_res)
    assert da == db
    np.testing.assert_array_equal(a, b)
    t = t_chunked.Sperr3DDecompressor()
    t.decompress(stream, multi_res=multi_res)
    assert len(t.hierarchy) == len(j.hierarchy)
    for x, y in zip(t.hierarchy, j.hierarchy):
        np.testing.assert_array_equal(x, y)


def _small_cases():
    rng = np.random.default_rng(11)
    x3 = rng.normal(size=(12, 10, 14))
    x1 = rng.normal(size=4096 * 3 + 5)
    v = rng.normal(size=3000) + 2.0
    return {
        "dims": lambda m: [m.num_of_xforms(n) for n in (1, 8, 9, 100, 5000)]
        + [m.calc_approx_detail_len(37, lev) for lev in range(4)]
        + [m.can_use_dyadic(d) for d in ((64, 64, 64), (64, 64, 8), (32, 32, 1))]
        + [m.chunk_volume((100, 30, 7), (64, 16, 7))]
        + [m.coarsened_resolutions((64, 32, 16)), m.coarsened_resolutions_chunked((64, 64, 64), (32, 32, 32))],
        "packing": lambda m: [m.pack_8_booleans([1, 0, 0, 1, 1, 0, 1, 0]), m.unpack_8_booleans(0x93)]
        + [m.pack_booleans(np.arange(40) % 3 == 0).tolist()],
        "condition": lambda m: [m.condition(v)[0], m.condition(v)[1].tolist(), m.calc_mean(v),
                                m.condition(np.full(64, 2.5))[0], m.retrieve_q(m.save_q(m.condition(v)[0], 0.25))],
        "cdf97_np": lambda m: [m.dwt3d(x3).tolist(), m.idwt3d(x3).tolist(), m.dwt2d(x3[0]).tolist(),
                               m.dwt1d(x1[:1000]).tolist()],
        "quantize_np": lambda m: [m.estimate_q("psnr", 60.0, 8.0, x1), m.midtread_quantize(x1, 0.01)[0].tolist(),
                                  m.strided_sum(x1, 4096)],
        "testdata": lambda m: [m.smooth_field_3d(12, seed=5).tolist(), m.ball_field_2d(16).tolist(),
                               m.ball_field_3d(10).tolist()],
        "speck_int_np": lambda m: [m.uint_width_for_num_bitplanes(b) for b in (1, 8, 9, 17, 33, 64)]
        + [m.speck_int_stream_full_len(bytes([5]) + (77).to_bytes(8, "little"))],
    }


_PAIRS = {
    "dims": (t_dims, j_dims), "packing": (t_packing, j_packing), "condition": (t_cond, j_cond),
    "cdf97_np": (t_cdf, j_cdf), "quantize_np": (t_qz, j_qz), "testdata": (t_testdata, j_testdata),
    "speck_int_np": (t_sp, j_sp),
}


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_small_host_module_copy(name):
    fn = _small_cases()[name]
    t_mod, j_mod = _PAIRS[name]
    assert fn(t_mod) == fn(j_mod)


def test_first_chunk_failure_copy():
    errs = [None, (5, ValueError("b")), (2, KeyError("a"))]
    with pytest.raises(t_errors.ChunkError) as ti:
        t_errors.first_chunk_failure(errs)
    with pytest.raises(j_errors.ChunkError) as ji:
        j_errors.first_chunk_failure(errs)
    assert ti.value.chunk_index == ji.value.chunk_index == 2
    assert str(ti.value) == str(ji.value)
    t_errors.first_chunk_failure([None, None])


def test_numpy_engine_copy_matches_original():
    mags, signs = _coeffs(4, 12 * 10 * 8, 16)
    dims = (12, 10, 8)
    s = JNumpyEngine().encode(3, mags, signs, dims, 16, 0)
    assert TNumpyEngine().encode(3, mags, signs, dims, 16, 0) == s
    for a, b in zip(TNumpyEngine().decode(3, s, dims, 16), JNumpyEngine().decode(3, s, dims, 16)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The flat API, the tools' shared helpers, the numpy stats and host_scaling
# ---------------------------------------------------------------------------
def _capi_pair():
    from sperr_tpu import capi as j_capi
    from sperr_tpu_torch import capi as t_capi

    return t_capi, j_capi


@pytest.mark.parametrize("mode,quality", [(1, 2.0), (2, 70.0), (3, 1e-2)])
def test_capi_2d_copy(mode, quality):
    t_capi, j_capi = _capi_pair()
    nx, ny = 40, 28
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:ny, 0:nx]
    data = (np.sin(x * 0.2) * np.cos(y * 0.13) + 0.03 * rng.normal(size=(ny, nx))).astype(np.float32)
    for header in (False, True):
        s = t_capi.comp_2d(data.ravel(), nx, ny, mode, quality, out_inc_header=header)
        assert s == j_capi.comp_2d(data.ravel(), nx, ny, mode, quality, out_inc_header=header)
    assert t_capi.parse_header(s) == j_capi.parse_header(s) == (nx, ny, 1, True)
    for as_float in (False, True):
        a = t_capi.decomp_2d(s[10:], nx, ny, output_float=as_float)
        b = j_capi.decomp_2d(s[10:], nx, ny, output_float=as_float)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,quality", [(1, 2.0), (2, 60.0), (3, 1e-2)])
def test_capi_3d_copy(mode, quality):
    t_capi, j_capi = _capi_pair()
    nx, ny, nz = 30, 20, 24
    rng = np.random.default_rng(5)
    vol = np.sin(np.arange(nx * ny * nz) * 0.01) + 0.1 * rng.normal(size=nx * ny * nz)
    s = t_capi.comp_3d(vol, nx, ny, nz, 16, 16, 16, mode=mode, quality=quality)
    assert s == j_capi.comp_3d(vol, nx, ny, nz, 16, 16, 16, mode=mode, quality=quality)
    assert t_capi.parse_header(s) == j_capi.parse_header(s) == (nx, ny, nz, False)
    assert t_capi.trunc_3d(s, 40) == j_capi.trunc_3d(s, 40)
    for as_float in (False, True):
        (a, da), (b, db) = t_capi.decomp_3d(s, output_float=as_float), j_capi.decomp_3d(s, output_float=as_float)
        assert da == db and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,quality", [("pwe", 1e-3), ("psnr", 60.0), ("rate", 1.5),
                                          ("directq", 5e-3)])
@pytest.mark.parametrize("precision", [64, 32])
def test_sperr3d_compressor_copy(mode, quality, precision):
    vol = j_testdata.smooth_field_3d(32, seed=3)
    args = ((32, 32, 24), (16, 16, 16))
    data = vol[:24]
    s = t_chunked.Sperr3DCompressor(*args, precision=precision).compress(data, mode, quality)
    assert s == j_chunked.Sperr3DCompressor(*args, precision=precision).compress(data, mode, quality)
    a, da = t_chunked.Sperr3DDecompressor(precision=precision).decompress(s)
    b, db = j_chunked.Sperr3DDecompressor(precision=precision).decompress(s)
    assert da == db and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_cli_common_copy(tmp_path, capsys):
    from sperr_tpu.cli import common as j_common
    from sperr_tpu_torch.cli import common as t_common

    rng = np.random.default_rng(6)
    a = rng.normal(size=500).astype(np.float32)
    b = a + rng.normal(scale=1e-3, size=500).astype(np.float32)
    for mod, name in ((t_common, "t"), (j_common, "j")):
        mod.write_array(str(tmp_path / f"{name}.f64"), a.reshape(20, 25), np.float64)
    assert (tmp_path / "t.f64").read_bytes() == (tmp_path / "j.f64").read_bytes()
    for ftype in (32, 64):
        a.astype(np.float32 if ftype == 32 else np.float64).tofile(tmp_path / "x")
        x, y = t_common.read_floats(str(tmp_path / "x"), ftype), j_common.read_floats(str(tmp_path / "x"), ftype)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for pair in ((a, b), (a, a)):
        assert t_common.calc_stats(*pair) == j_common.calc_stats(*pair)
    printed = []
    for mod in (t_common, j_common):
        mod.print_stats(a, b, 321)
        printed.append(capsys.readouterr().out)
        with pytest.raises(SystemExit):
            mod.die("no input")
        printed.append(capsys.readouterr().err)
    assert printed[:2] == printed[2:] and "PSNR" in printed[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_stats_copy(seed):
    from sperr_tpu.utils import stats as j_stats
    from sperr_tpu_torch.utils import stats as t_stats

    rng = np.random.default_rng(seed)
    a = rng.normal(size=3000)
    b = a + rng.normal(scale=1e-3, size=3000)
    for pair in ((a, b), (a, a), (a.astype(np.float32), b.astype(np.float32))):
        assert t_stats.calc_stats(*pair) == j_stats.calc_stats(*pair)
        assert t_stats.accuracy_gain(*pair, 777) == j_stats.accuracy_gain(*pair, 777)
    assert t_stats.calc_mean_var(a) == j_stats.calc_mean_var(a)


def test_host_scaling_copy():
    from sperr_tpu.runtime import host_scaling as j_hs
    from sperr_tpu_torch.runtime import host_scaling as t_hs

    a = t_hs.parse_scaling_evidence(n=16, chunks=2)
    b = j_hs.parse_scaling_evidence(n=16, chunks=2)
    assert set(a) == set(b)
    for k in ("n", "chunks", "host_cores", "extrapolation"):
        assert a[k] == b[k]
    assert len(a["per_chunk_parse_ms"]) == 2 and a["serial_sum_s"] > 0
    assert a["gil_released"] in (True, False)
