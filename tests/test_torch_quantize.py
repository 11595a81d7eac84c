"""The port's quantizer (sperr_tpu_torch/ops/quantize.py) against sperr_tpu's.

On the CPU the port runs the plain version of kernel K1; the CUDA kernel is
held against the same plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import pallas_kernels as pk
from sperr_tpu.ops import quantize_jax as qzj
from sperr_tpu_torch.ops import quantize as qz


def _coeffs_with_ties(seed):
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(scale=100.0, size=(4, 4096)).astype(np.float32)
    q = (np.abs(rng.normal(scale=0.5, size=4)) + 0.01).astype(np.float32)
    # row 3 at q = 0.5: c = k + 0.25 lands on 2k + 0.5 exactly, a rounding
    # tie; half to even sends it to 2k.  Zeros and -0.0 have a positive sign.
    k = rng.integers(-500, 500, size=4096).astype(np.float32)
    coeffs[3] = k + np.float32(0.25)
    coeffs[3, :4] = [0.0, -0.0, -0.25, 0.25]
    q[3] = 0.5
    return coeffs, q


@pytest.mark.parametrize("seed", [5, 11])
def test_plain_k1_equals_jax_and_pallas(seed):
    coeffs, q = _coeffs_with_ties(seed)
    ours = qz.midtread_quantize_batched_best(torch.from_numpy(coeffs), torch.from_numpy(q))
    ref = qzj.midtread_quantize_batched(jnp.asarray(coeffs), jnp.asarray(q))
    pal = pk.quantize_pallas(jnp.asarray(coeffs), jnp.asarray(q), interpret=True)
    for a, b, c in zip(ours, ref, pal):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    mags, signs, _ = ours
    # the ties went to even, and zero coefficients are positive
    ll = np.where(signs[3].numpy(), 1, -1) * mags[3].numpy()
    k = (coeffs[3, 4:] - np.float32(0.25)).astype(np.int64)
    np.testing.assert_array_equal(ll[4:], 2 * k)
    # 0.0, -0.0, -0.25 and 0.25 quantize to +-0.0, all with a positive sign
    assert signs[3, :4].all() and not mags[3, :4].any()


@pytest.mark.parametrize("mag_dtype", [np.int16, np.int32])
def test_inv_quantize_equals_jax(mag_dtype):
    rng = np.random.default_rng(3)
    mags = rng.integers(0, 30000, size=(3, 1000)).astype(mag_dtype)
    signs = rng.random((3, 1000)) < 0.5
    q = (rng.random(3) + 0.1).astype(np.float32)
    ours = qz.midtread_inv_quantize_batched(
        torch.from_numpy(mags), torch.from_numpy(signs), torch.from_numpy(q)
    )
    ref = qzj.midtread_inv_quantize_batched(
        jnp.asarray(mags), jnp.asarray(signs), jnp.asarray(q)
    )
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("psnr", [40.0, 80.0])
def test_estimate_q_psnr_matches_jax(psnr):
    rng = np.random.default_rng(int(psnr))
    coeffs = rng.normal(scale=3.0, size=(3, 8192)).astype(np.float32)
    data_range = (np.abs(rng.normal(size=3)) * 10 + 1).astype(np.float32)
    ours = qz.estimate_q_psnr_batched(
        torch.from_numpy(coeffs), torch.from_numpy(data_range), psnr
    )
    ref = qzj.estimate_q_psnr_batched(jnp.asarray(coeffs), jnp.asarray(data_range), psnr)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


def test_rate_constant_matches_jax():
    assert qz.RATE_MAX_MAG_DEVICE == qzj.RATE_MAX_MAG_DEVICE
