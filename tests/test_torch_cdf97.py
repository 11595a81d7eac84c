"""The port's CDF 9/7 transform (sperr_tpu_torch/ops/cdf97.py) against
sperr_tpu's f32 engine (cdf97_jax) and its exact f64 engine (cdf97_np).

On the CPU every level runs the plain lifting version; the CUDA kernel is held
against the same plain version on the card by chip_smoke.py.  Tolerance:
2e-5 * max|x|, f32 roundoff over a few levels of lifting (the JAX engine may
contract multiply-adds into FMAs; the port rounds each operation)."""

import numpy as np
import pytest
import torch

from sperr_tpu.ops import cdf97_jax as cj
from sperr_tpu.ops import cdf97_np as cn
from sperr_tpu.utils.dims import can_use_dyadic
from sperr_tpu_torch.ops import cdf97 as ct

# tensor shapes (..., nz, ny, nx): dims (nx, ny, nz) = (256,)*3 and
# (33, 27, 19) are dyadic, (32, 32, 12) is a wavelet packet
SHAPES_3D = [(256, 256, 256), (19, 27, 33), (12, 32, 32), (2, 32, 32, 32)]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tol(x):
    return 2e-5 * float(np.abs(x).max())


def _np_batched(fn, x):
    x64 = x.astype(np.float64)
    if x.ndim == 3:
        return fn(x64)
    return np.stack([fn(v) for v in x64])


def test_shapes_cover_both_branches():
    dyadic = [can_use_dyadic((s[-1], s[-2], s[-3])) is not None for s in SHAPES_3D]
    assert dyadic == [True, True, False, True]


@pytest.mark.parametrize("shape", SHAPES_3D)
def test_dwt3d_matches_jax_and_numpy(shape):
    x = _rand(shape, seed=sum(shape))
    ours = ct.dwt3d(torch.from_numpy(x)).numpy()
    tol = _tol(x)
    np.testing.assert_allclose(ours, np.asarray(cj.dwt3d(x)), rtol=0, atol=tol)
    np.testing.assert_allclose(ours, _np_batched(cn.dwt3d, x), rtol=0, atol=tol)

    back = ct.idwt3d(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(back, np.asarray(cj.idwt3d(ours)), rtol=0, atol=tol)
    np.testing.assert_allclose(back, _np_batched(cn.idwt3d, ours), rtol=0, atol=tol)
    np.testing.assert_allclose(back, x, rtol=0, atol=tol)


def test_transforms_leave_input_alone():
    x = _rand((12, 32, 32), seed=1)
    t = torch.from_numpy(x.copy())
    ct.dwt3d(t)
    ct.idwt3d(t)
    np.testing.assert_array_equal(t.numpy(), x)


def test_ref_drivers_equal_dispatching_drivers_on_cpu():
    x = torch.from_numpy(_rand((2, 19, 27, 33), seed=2))
    torch.testing.assert_close(ct.dwt3d_ref(x), ct.dwt3d(x), rtol=0, atol=0)
    torch.testing.assert_close(ct.idwt3d_ref(x), ct.idwt3d(x), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 48, 80), (1, 127, 127), (27, 19)])
def test_dwt2d_matches_jax_and_numpy(shape):
    x = _rand(shape, seed=shape[-1])
    ours = ct.dwt2d(torch.from_numpy(x)).numpy()
    tol = _tol(x)
    np.testing.assert_allclose(ours, np.asarray(cj.dwt2d(x)), rtol=0, atol=tol)
    ref = np.stack([cn.dwt2d(p) for p in x.reshape((-1,) + shape[-2:]).astype(np.float64)])
    np.testing.assert_allclose(ours, ref.reshape(shape), rtol=0, atol=tol)
    back = ct.idwt2d(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(back, np.asarray(cj.idwt2d(ours)), rtol=0, atol=tol)
    np.testing.assert_allclose(back, x, rtol=0, atol=tol)


@pytest.mark.parametrize("n", [9, 10, 64, 255, 1000])
def test_dwt1d_matches_jax_and_numpy(n):
    x = _rand((3, n), seed=n)
    ours = ct.dwt1d(torch.from_numpy(x)).numpy()
    tol = _tol(x)
    np.testing.assert_allclose(ours, np.asarray(cj.dwt1d(x)), rtol=0, atol=tol)
    ref = np.stack([cn.dwt1d(r) for r in x.astype(np.float64)])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)
    back = ct.idwt1d(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(back, np.asarray(cj.idwt1d(ours)), rtol=0, atol=tol)
    np.testing.assert_allclose(back, x, rtol=0, atol=tol)


def test_lift_constants_are_jax_f32_rounding():
    expect = [np.float32(v) for v in (cn.ALPHA, cn.BETA, cn.GAMMA, cn.DELTA, cn.EPSILON, cn.INV_EPSILON)]
    assert ct.LIFT_CONSTS.dtype == np.float32
    np.testing.assert_array_equal(ct.LIFT_CONSTS, expect)
