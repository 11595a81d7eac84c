"""sperr_tpu_torch stays free of jax and of sperr_tpu, and has no silent fallbacks.

The machine with the GPU has no jax, and the port owns copies of the host
layers it needs, so no file of the port and no line of chip_smoke.py imports
jax or sperr_tpu, at any depth (an AST scan), and the port encodes and
decodes with both packages blocked.  The host helpers it copies out of
sperr_tpu.parallel.batched (which imports jax) must equal their originals,
and so must the wave path's static caps.  A missing GPU, a missing nvcc or a
C++ engine that cannot be built raises instead of quietly running something
slower."""

import ast
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sperr_tpu.parallel import batched as jb
from sperr_tpu_torch import kernels
from sperr_tpu_torch.parallel import batched as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(os.path.join(ROOT, "sperr_tpu_torch"))
    for f in fs
    if f.endswith(".py")
) + ["chip_smoke.py", "compare_parent.py"]
_BANNED = ("sperr_tpu", "jax", "jaxlib")


def _imported_names(path):
    """Every module name a file imports: import statements at any depth and
    importlib.import_module / __import__ calls with a constant name."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.args[0].value


@pytest.mark.parametrize("path", _PORT_FILES)
def test_no_file_of_the_port_imports_sperr_tpu_or_jax(path):
    names = list(_imported_names(path))
    bad = [n for n in names if n.split(".")[0] in _BANNED]
    assert not bad, f"{path} imports {bad}"


def test_the_scan_sees_the_whole_port():
    assert len(_PORT_FILES) >= 30
    for f in ("sperr_tpu_torch/parallel/batched.py", "sperr_tpu_torch/runtime/native/__init__.py",
              "sperr_tpu_torch/codec/speck_wave.py", "sperr_tpu_torch/parallel/chunked3d.py",
              "sperr_tpu_torch/ops/speck_lis2.py", "sperr_tpu_torch/codec/speck_sorted.py",
              "sperr_tpu_torch/cli/sperr3d.py", "sperr_tpu_torch/capi.py",
              "sperr_tpu_torch/runtime/device_bench.py", "sperr_tpu_torch/utils/stats.py",
              "sperr_tpu_torch/parallel/distributed.py", "sperr_tpu_torch/parallel/transport.py"):
        assert f in _PORT_FILES
    # the scan finds imports inside functions too
    assert "sperr_tpu_torch.utils.dims" in set(_imported_names("chip_smoke.py"))


_BLOCKED_RUN = """
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("sperr_tpu", "jax", "jaxlib"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
from sperr_tpu_torch.parallel.batched import TorchCompressor3D, TorchDecompressor3D
from sperr_tpu_torch.parallel.batched2d import TorchCompressor2D, TorchDecompressor2D
from sperr_tpu_torch.parallel.chunked3d import Sperr3DDecompressor
from sperr_tpu_torch.utils.testdata import smooth_field_3d

tol = 1e-2
vol = smooth_field_3d(64, seed=5)
streams = []
for entropy in ("host", "wave"):
    comp = TorchCompressor3D((64, 64, 64), (32, 32, 32), device="cpu", entropy=entropy)
    s = comp.compress(vol, "pwe", tol)
    out, dims = TorchDecompressor3D(device="cpu").decompress(s)
    host, _ = Sperr3DDecompressor().decompress(s)
    assert dims == (64, 64, 64)
    assert float(np.abs(out.astype(np.float64) - vol).max()) <= tol
    assert float(np.abs(host.reshape(vol.shape) - vol).max()) <= tol
    streams.append(s)
assert streams[0] == streams[1], "wave and host containers differ"
assert comp.last_wave_chunks == 8, comp.last_wave_tiers
rng = np.random.default_rng(1)
fields = np.cumsum(np.cumsum(rng.normal(size=(2, 64, 64)), axis=1), axis=2).astype(np.float32)
s2 = TorchCompressor2D((64, 64), device="cpu").compress_batch(fields, "pwe", tol)
w2 = TorchCompressor2D((64, 64), device="cpu", entropy="wave")
assert w2.compress_batch(fields, "pwe", tol) == s2, "2D wave and host streams differ"
assert w2.last_wave_chunks == 2, w2.last_wave_tiers
outs = TorchDecompressor2D((64, 64), device="cpu").decompress_batch(s2)
for f, o in zip(fields, outs):
    assert float(np.abs(o.astype(np.float64) - f).max()) <= tol
import os, tempfile
from sperr_tpu_torch.cli import sperr3d
with tempfile.TemporaryDirectory() as tmp:
    inp, bs = os.path.join(tmp, "in.f32"), os.path.join(tmp, "v.sperr")
    vol.tofile(inp)
    assert sperr3d.run(["-c", inp, "--exec", "cpu", "--dims", "64", "64", "64", "--chunks", "32",
                        "32", "32", "--pwe", str(tol), "--bitstream", bs]) == 0
    with open(bs, "rb") as f:
        assert f.read() == streams[0], "the tool's container differs from TorchCompressor3D's"
from sperr_tpu_torch.parallel import distributed as td
from sperr_tpu_torch.parallel.transport import LocalTransport

def loader(c):
    return vol[c[4] : c[4] + c[5], c[2] : c[2] + c[3], c[0] : c[0] + c[1]]

factory = td.device_compressor_factory((32, 32, 32), devices=["cpu", "cpu"], entropy="wave")
s = td.compress_distributed(loader, (64, 64, 64), (32, 32, 32), "pwe", tol, compressor_factory=factory,
                            transport=LocalTransport())
assert s == streams[0], "the distributed container over two devices differs"
out, _ = td.decompress_distributed(s, decompressor_factory=lambda: TorchDecompressor3D(devices=["cpu"] * 2))
assert np.array_equal(out, TorchDecompressor3D(device="cpu").decompress(s)[0])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("sperr_tpu", "jax", "jaxlib"))
assert not bad, bad
print("ok", len(streams[0]), sum(len(s) for s in s2))
"""


def test_the_port_runs_with_sperr_tpu_and_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=900,
    )
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stdout + proc.stderr


def _unbuildable_engine(monkeypatch, tmp_path):
    from sperr_tpu_torch.runtime import engine, native

    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(engine, "_default", None)
    return engine


def test_default_engine_raises_when_the_library_cannot_be_built(monkeypatch, tmp_path):
    engine = _unbuildable_engine(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="failed to build"):
        engine.default_engine()
    assert engine._default is None
    with pytest.raises(RuntimeError, match="failed to build"):
        tb.TorchDecompressor3D(device="cpu")
    from sperr_tpu_torch.parallel.chunked3d import Sperr3DDecompressor

    with pytest.raises(RuntimeError, match="failed to build"):
        Sperr3DDecompressor()


def test_residual_scan_raises_when_the_library_cannot_be_built(monkeypatch, tmp_path):
    _unbuildable_engine(monkeypatch, tmp_path)
    ll, orig = _ll_and_orig(0, (16, 12, 10))
    with pytest.raises(RuntimeError, match="failed to build"):
        tb._residual_outliers(ll, (16, 12, 10), 0.003, 0.5, orig, 0.02)


def test_no_module_of_the_port_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sperr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sperr_tpu_torch.__path__, 'sperr_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 11 and 'sperr_tpu_torch.parallel.batched2d' in names, names\n"
        "for m in ('packemit', 'speck_virtual', 'speck_lis', 'speck_lis2', 'wave_pack', 'wave_unpack'):\n"
        "    assert 'sperr_tpu_torch.ops.' + m in names, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sperr_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _ll_and_orig(seed, dims3):
    lx, ly, lz = dims3
    rng = np.random.default_rng(seed)
    n = lx * ly * lz
    ll = rng.integers(-50, 51, size=n) * (rng.random(n) < 0.2)
    orig = rng.normal(scale=0.1, size=n) + 0.5
    return ll.astype(np.int64), orig


@pytest.mark.parametrize("seed", [0, 1])
def test_residual_outliers_copy(seed):
    dims3 = (16, 12, 10)
    ll, orig = _ll_and_orig(seed, dims3)
    a = tb._residual_outliers(ll, dims3, 0.003, 0.5, orig, 0.02)
    b = jb._residual_outliers(ll, dims3, 0.003, 0.5, orig, 0.02)
    assert a[0].size > 0
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_sim_outlier_corr_copy():
    rng = np.random.default_rng(2)
    for e in np.concatenate([rng.normal(scale=0.01, size=200), [0.0, 0.005, -0.005, 0.0149]]):
        for tol in (1e-3, 1e-2):
            assert tb._sim_outlier_corr(e, tol, tol * 1.0000001) == jb._sim_outlier_corr(
                e, tol, tol * 1.0000001
            )


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_certify_dual_copy(seed):
    rng = np.random.default_rng(seed)
    tol, eta = 1e-2, 1e-5
    pos = np.sort(rng.choice(5000, size=300, replace=False))
    errs64 = rng.normal(scale=0.012, size=300)
    keep32 = rng.random(300) < 0.9
    pos32 = pos[keep32]
    errs32 = errs64[keep32] + rng.normal(scale=2e-5, size=pos32.size)
    # points that only one scan saw
    pos64 = np.concatenate([pos, [6000]])
    errs64 = np.concatenate([errs64, [0.02]])
    pos32 = np.concatenate([pos32, [7000]])
    errs32 = np.concatenate([errs32, [0.0125]])
    a = tb._certify_dual(pos64, errs64, pos32, errs32, tol, eta, 1.5 * tol)
    b = jb._certify_dual(pos64, errs64, pos32, errs32, tol, eta, 1.5 * tol)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_width_for_copy():
    for m in (0, 1, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x100000000):
        assert tb._width_for(m) == jb._width_for(m)


def test_condi_header_copy():
    args = [(True, 2.5, 32768, 0.0, 0.0), (False, 0.0, 0, 0.125, 0.0015),
            (False, 0.0, 0, -3.25e-7, 1.5e-9)]
    for a in args:
        assert tb._condi_header(*a) == jb._condi_header(*a)


def test_wave_tier_tables_copy():
    assert tb._WAVE_NEVER == jb._WAVE_NEVER
    assert tb.DEFAULT_WAVE_TIERS == jb.DEFAULT_WAVE_TIERS
    assert tb.DEFAULT_WAVE_TIERS_BIG == jb.DEFAULT_WAVE_TIERS_BIG
    for n in (1, 4096, (1 << 21) - 1, 1 << 21, 1 << 24):
        assert tb.wave_tiers_for(n) == jb.wave_tiers_for(n)


def test_wave_fits_copy():
    t = jb.TpuCompressor3D((16, 16, 16), (16, 16, 16), entropy="wave")
    p = tb.TorchCompressor3D((16, 16, 16), (16, 16, 16), device="cpu", entropy="wave")
    for fits in (False, True):
        for num_bp in (0, 20, 34, 35):
            wave = {"fits": np.array([fits]), "num_bp": np.array([num_bp])}
            assert p._wave_fits(wave, 0) == t._wave_fits(wave, 0)


@functools.lru_cache(maxsize=None)
def _jax_wave_caps(dims3, tier):
    """The caps sperr_tpu's _dense_encode_wave hands wave_emit_3d, read by
    tracing it (no compile, no run) with a recording stand-in."""
    import jax
    import jax.numpy as jnp
    from sperr_tpu.ops import speck_virtual as jsv
    from sperr_tpu.ops import wave_pack as jwp

    # the index caches device constants: build it outside the trace, as
    # TpuCompressor3D does, or its cache would keep the trace's tracers
    jsv.virtual_lis_index(dims3)
    seen = []

    def record(mags, signs, s, e, node_s, num_bp, li, P, node_cap, evb_cap, out_cap_bytes, wexp_cap=0):
        seen.append(dict(P=P, node_cap=node_cap, evb_cap=evb_cap, out_cap_bytes=out_cap_bytes,
                         wexp_cap=wexp_cap))
        z = jnp.zeros((), jnp.int32)
        return jwp.WaveEmit(num_bp, jnp.zeros(out_cap_bytes, jnp.uint8), jnp.zeros(3 * P, jnp.int32),
                            z, z, jnp.zeros((), bool), z, jnp.zeros(0, jnp.int32),
                            jnp.zeros(0, jnp.int32), z)

    orig = jwp.wave_emit_3d
    jwp.wave_emit_3d = record
    try:
        fn = functools.partial(
            jb._dense_encode_wave.__wrapped__, mode="pwe", quality=1e-2, out_cap=16384,
            num_bp_cap=34, dims3=dims3, residual="dual", node_frac=tier[0], evb_frac=tier[1],
            out_frac=tier[2], bp_cap=tier[3], wexp_frac=tier[4], sparse_view=False, seq=True,
        )
        jax.eval_shape(fn, jax.ShapeDtypeStruct((1,) + tuple(dims3[::-1]), jnp.float32))
    finally:
        jwp.wave_emit_3d = orig
    (caps,) = seen
    return caps


# node_cap, T (walk items), words per emission array, evb_cap, out_cap_bytes
# of each default tier at 256^3
_CAPS_256 = (
    (119837, 1917428, 2778832, 43419, 463140),
    (599185, 7190220, 18537376, 579293, 4634348),
    (1198370, 11983700, 37149568, 847288, 67108864),
    (2396740, 21570660, 46736512, 5842064, 134217728),
    (2396740, 21570660, 99315088, 8388608, 134217728),
)


@pytest.mark.parametrize("t", range(len(jb.DEFAULT_WAVE_TIERS_BIG)))
def test_wave_caps_equal_jax_at_256(t):
    from sperr_tpu_torch.ops import speck_virtual as tsv

    dims3 = (256, 256, 256)
    tier = jb.DEFAULT_WAVE_TIERS_BIG[t]
    caps = tb._wave_caps(tsv.virtual_lis_index(dims3, "cpu"), dims3, tier, 34)
    want = _jax_wave_caps(dims3, tier)
    assert {k: caps[k] for k in want} == want
    assert (caps["node_cap"], caps["T"], caps["cells"] // 32, caps["evb_cap"],
            caps["out_cap_bytes"]) == _CAPS_256[t]


@pytest.mark.parametrize("dims3,t", [((16, 16, 16), 0), ((16, 16, 16), 1), ((32, 32, 32), 0)])
def test_wave_caps_equal_jax_small(dims3, t):
    from sperr_tpu_torch.ops import speck_virtual as tsv

    tier = jb.wave_tiers_for(dims3[0] ** 3)[t]
    caps = tb._wave_caps(tsv.virtual_lis_index(dims3, "cpu"), dims3, tier, 34)
    want = _jax_wave_caps(dims3, tier)
    assert {k: caps[k] for k in want} == want


def test_cuda_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.TorchCompressor3D((32, 32, 32), (32, 32, 32), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.TorchDecompressor3D(device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.TorchDecompressor3D(device="meta")


def test_hybrid_decode_on_cuda_raises_without_a_gpu(monkeypatch):
    """hybrid=True names the card's K13: without a GPU it raises instead of
    decoding on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for hybrid in (True, None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.TorchDecompressor3D(device="cuda", hybrid=hybrid)
    assert tb.TorchDecompressor3D(device="cpu", hybrid=True)._hybrid_enabled()
    assert not tb.TorchDecompressor3D(device="cpu")._hybrid_enabled()


def test_forced_hybrid_needs_the_control_parse(monkeypatch):
    from sperr_tpu_torch.runtime.engine import NumpyEngine

    dec = tb.TorchDecompressor3D(device="cpu", hybrid=True)
    dec.engine = NumpyEngine()
    with pytest.raises(ValueError, match="decode3d_control"):
        dec._hybrid_enabled()


def test_device_is_required(monkeypatch):
    """The entry points run on the card unless the caller names the CPU:
    without a GPU, a constructor called without ``device`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.TorchCompressor3D((32, 32, 32), (32, 32, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.TorchDecompressor3D()


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(str(tmp_path / "build"))
    assert not (tmp_path / "build").exists()


def test_kernel_wrappers_refuse_cpu_tensors():
    from sperr_tpu_torch.ops import speck as tspk

    c = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.quantize(c, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.psnr_q(c, torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.cdf97_lift(torch.zeros((1, 4, 4, 4)), -1, (4, 4, 4), False, np.ones(6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.dwt2d_full(torch.zeros((2, 16, 16)), np.ones(6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.idwt2d_full(torch.zeros((2, 16, 16)), np.ones(6), 1, 0)
    w = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.transpose_bits32(w, torch.zeros((32, 2), dtype=torch.int32), 0, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.transpose_bits32_pair(w, w, torch.zeros((14, 4), dtype=torch.int32), 0, 14)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.masked_pack([(w.reshape(8, 8), w.reshape(8, 8))], 8, 1024)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.masked_pack(
            [(w.reshape(8, 8), w.reshape(8, 8)), (w.reshape(4, 16), w.reshape(4, 16))], 8, 1024, 4,
        )
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.compact_flags_rows(torch.zeros((1, 64), dtype=torch.bool), 8)
    r = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.reconstruct_mags(torch.zeros((1, 64), dtype=torch.uint8), w.reshape(1, 64), r, r,
                                 torch.zeros(1, dtype=torch.int32), 16, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.radix_sort(w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.walk_vtab(w, w.bool(), None, w, w, 4, 72)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.anchor_ranks(w, w, w, np.zeros(0, np.int32), 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.node_passes(w, w[:1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sched_table(w, w, w[:2], w, tspk.tree_index((8, 8), "cpu").plan, (8, 8),
                            regions=[(0, 0), (4, 4)])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.table_anchors(kernels.TableArgs(), "cpu", w, np.zeros(0, np.int32), 0)
    assert set(kernels.launches) == {
        "quantize", "psnr_q", "cdf97_lift", "dwt2d_full", "idwt2d_full", "transpose_bits32",
        "masked_pack", "compact_flags_rows", "reconstruct_mags", "sched_boxmax", "sched_virtual",
        "sched_table", "sched_pyramid", "walk_vtab", "anchor_ranks", "walk_rows", "radix_sort",
        "emit_stage", "table_anchors", "table_walk", "node_passes",
    }
    assert not any(kernels.launches.values())


def test_bit_kernels_raise_off_cpu_and_cuda():
    from sperr_tpu_torch.ops import packemit as pe

    w = torch.zeros(64, dtype=torch.int32, device="meta")
    for call in (
        lambda: pe.transpose_bits32(w),
        lambda: pe.transpose_bits32_pair(w, w),
        lambda: pe.compact_flags_rows(torch.zeros((1, 64), dtype=torch.bool, device="meta"), 8),
        lambda: pe.masked_pack([(w.reshape(8, 8), w.reshape(8, 8))], 8, 1024),
    ):
        with pytest.raises(ValueError, match="no .* kernel for tensors on meta"):
            call()


@pytest.mark.parametrize("fn", ["dwt2d", "idwt2d", "dwt2d_", "idwt2d_"])
def test_2d_transforms_raise_off_cpu_and_cuda(fn):
    from sperr_tpu_torch.ops import cdf97

    x = torch.zeros((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no 2D transform kernel"):
        getattr(cdf97, fn)(x)


def test_2d_codec_requires_a_device(monkeypatch):
    from sperr_tpu_torch.parallel import batched2d as tb2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb2.TorchCompressor2D((32, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb2.TorchDecompressor2D((32, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        tb2.TorchDecompressor2D((32, 32), device="meta")
