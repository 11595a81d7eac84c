"""The port's 2D CDF 9/7 transforms and multi-resolution inverses
(sperr_tpu_torch/ops/cdf97.py) against sperr_tpu's whole-plane Pallas kernels
K2/K3 (run in interpret mode, as tests/test_pallas_kernels.py runs them) and
its f32 engine cdf97_jax.

On the CPU the transforms run the plain version level by level; the CUDA
kernels K2/K3 are held against the same plain version, bit for bit, on the
card by chip_smoke.py.  Tolerance: 2e-5 * max|x|, f32 roundoff over a few
levels of lifting (XLA may contract multiply-adds into FMAs; the port rounds
each operation)."""

import numpy as np
import pytest
import torch

from sperr_tpu.ops import cdf97_jax as cj
from sperr_tpu.ops import pallas_kernels as pk
from sperr_tpu.utils.dims import coarsened_resolutions, num_of_xforms
from sperr_tpu_torch.ops import cdf97 as ct

SHAPES_2D = [(3, 64, 64), (2, 48, 80), (1, 127, 127), (2, 19, 27)]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tol(x):
    return 2e-5 * float(np.abs(x).max())


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_ref_matches_pallas_kernels(shape):
    x = _rand(shape, seed=shape[1])
    ours = ct.dwt2d_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(pk.dwt2d_pallas(x, interpret=True)),
                               rtol=0, atol=_tol(x))
    back = ct.idwt2d_ref(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(back, np.asarray(pk.idwt2d_pallas(ours, interpret=True)),
                               rtol=0, atol=_tol(x))
    np.testing.assert_allclose(back, x, rtol=0, atol=_tol(x))


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_ref_matches_cdf97_jax(shape):
    x = _rand(shape, seed=shape[2])
    ours = ct.dwt2d_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(cj.dwt2d(x)), rtol=0, atol=_tol(x))
    back = ct.idwt2d_ref(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(back, np.asarray(cj.idwt2d(ours)), rtol=0, atol=_tol(x))


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_dispatching_transforms_equal_ref_on_cpu(shape):
    x = torch.from_numpy(_rand(shape, seed=7))
    fwd = ct.dwt2d(x)
    torch.testing.assert_close(fwd, ct.dwt2d_ref(x), rtol=0, atol=0)
    torch.testing.assert_close(ct.idwt2d(fwd), ct.idwt2d_ref(fwd), rtol=0, atol=0)
    # in place on a contiguous tensor, and through the lifting dispatcher
    y = x.clone()
    assert ct.dwt2d_(y) is y
    torch.testing.assert_close(y, fwd, rtol=0, atol=0)
    torch.testing.assert_close(ct.dwt2d_ref(x, lift=ct.lift_axis), fwd, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 48, 80), (1, 127, 127)])
def test_level_by_level_inverse_composes_to_the_full_inverse(shape):
    x = torch.from_numpy(_rand(shape, seed=11))
    coeffs = ct.dwt2d(x)
    levels = num_of_xforms(min(shape[-2:]))
    y = coeffs.clone()
    for lev in range(levels, 0, -1):
        ct.idwt2d_(y, lev, lev - 1)
    torch.testing.assert_close(y, ct.idwt2d(coeffs), rtol=0, atol=0)
    # and any split into a coarse and a fine part
    z = coeffs.clone()
    ct.idwt2d_(z, levels, 2)
    ct.idwt2d_(z, 2, 0)
    torch.testing.assert_close(z, y, rtol=0, atol=0)


def test_fewer_levels_and_small_planes():
    x = _rand((2, 40, 56), seed=5)
    ours = ct.dwt2d(torch.from_numpy(x), levels=2).numpy()
    np.testing.assert_allclose(ours, np.asarray(cj.dwt2d(x, levels=2)), rtol=0, atol=_tol(x))
    # planes too small for one level pass through unchanged
    s = torch.from_numpy(_rand((3, 8, 30), seed=6))
    torch.testing.assert_close(ct.dwt2d(s), s, rtol=0, atol=0)
    torch.testing.assert_close(ct.idwt2d(s), s, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 48, 80), (1, 127, 127), (19, 27)])
def test_idwt2d_multi_res_matches_jax(shape):
    x = _rand(shape, seed=shape[-1])
    full, hier = ct.idwt2d_multi_res(torch.from_numpy(x))
    full_j, hier_j = cj.idwt2d_multi_res(x)
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), rtol=0, atol=_tol(x))
    torch.testing.assert_close(full, ct.idwt2d(torch.from_numpy(x)), rtol=0, atol=0)
    res = coarsened_resolutions((shape[-1], shape[-2], 1))
    assert len(hier) == len(hier_j) == len(res) > 0
    for h, hj, r in zip(hier, hier_j, res):
        assert tuple(h.shape) == tuple(hj.shape) == shape[:-2] + (r[1], r[0])
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=_tol(x))


@pytest.mark.parametrize("shape", [(32, 32, 32), (2, 19, 27, 33)])
def test_idwt3d_multi_res_matches_jax(shape):
    x = _rand(shape, seed=sum(shape))
    full, hier = ct.idwt3d_multi_res(torch.from_numpy(x))
    full_j, hier_j = cj.idwt3d_multi_res(x)
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), rtol=0, atol=_tol(x))
    torch.testing.assert_close(full, ct.idwt3d(torch.from_numpy(x)), rtol=0, atol=0)
    res = coarsened_resolutions((shape[-1], shape[-2], shape[-3]))
    assert len(hier) == len(hier_j) == len(res) > 0
    for h, hj, r in zip(hier, hier_j, res):
        assert tuple(h.shape) == tuple(hj.shape) == shape[:-3] + (r[2], r[1], r[0])
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=_tol(x))


def test_idwt3d_multi_res_non_dyadic_has_empty_hierarchy():
    x = _rand((12, 32, 32), seed=3)  # dims (32, 32, 12): a wavelet packet
    full, hier = ct.idwt3d_multi_res(torch.from_numpy(x))
    full_j, hier_j = cj.idwt3d_multi_res(x)
    assert hier == () and len(hier_j) == 0
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), rtol=0, atol=_tol(x))
