"""sperr_tpu_torch stays free of jax and has no silent fallbacks.

The machine with the GPU has no jax, so the port must not import it, even
indirectly; the host helpers it copies out of sperr_tpu.parallel.batched
(which imports jax) must equal their originals; and a missing GPU or a
missing nvcc raises instead of quietly running the plain versions."""

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


def test_no_module_of_the_port_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sperr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sperr_tpu_torch.__path__, 'sperr_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 7 and 'sperr_tpu_torch.parallel.batched2d' in names, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
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


def test_cuda_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.TorchCompressor3D((32, 32, 32), (32, 32, 32), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.TorchDecompressor3D(device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.TorchDecompressor3D(device="meta")


def test_device_is_required():
    with pytest.raises(TypeError):
        tb.TorchCompressor3D((32, 32, 32), (32, 32, 32))
    with pytest.raises(TypeError):
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
    c = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.quantize(c, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.cdf97_lift(torch.zeros((1, 4, 4, 4)), -1, (4, 4, 4), False, np.ones(6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.dwt2d_full(torch.zeros((2, 16, 16)), np.ones(6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.idwt2d_full(torch.zeros((2, 16, 16)), np.ones(6), 1, 0)
    assert kernels.launches == {"quantize": 0, "cdf97_lift": 0, "dwt2d_full": 0, "idwt2d_full": 0}


@pytest.mark.parametrize("fn", ["dwt2d", "idwt2d", "dwt2d_", "idwt2d_"])
def test_2d_transforms_raise_off_cpu_and_cuda(fn):
    from sperr_tpu_torch.ops import cdf97

    x = torch.zeros((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no 2D transform kernel"):
        getattr(cdf97, fn)(x)


def test_2d_codec_requires_a_device():
    from sperr_tpu_torch.parallel import batched2d as tb2

    with pytest.raises(TypeError):
        tb2.TorchCompressor2D((32, 32))
    with pytest.raises(TypeError):
        tb2.TorchDecompressor2D((32, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        tb2.TorchDecompressor2D((32, 32), device="meta")
