"""Midtread quantization and PSNR-mode q estimation, batched over chunks.

PyTorch port of sperr_tpu/ops/quantize_jax.py.  Arithmetic is f32.  On a
CUDA tensor the fused quantizer runs the hand-written kernel K1
(kernels/quantize.cu); on a CPU tensor it runs the plain version
``quantize_ref``, which the kernel equals bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import kernels

# Quantized magnitudes must stay exactly representable in f32, so the
# rate-mode q targets 2^20-1 instead of the host engine's 2^32-1.
RATE_MAX_MAG_DEVICE = float(2**20 - 1)


def quantize_ref(coeffs: torch.Tensor, inv_q: torch.Tensor):
    """Plain K1: coeffs (B, n), inv_q (B,) -> (mags i32, signs bool, maxmag i32).

    ``torch.round`` rounds half to even, as ``rintf`` does; the product with
    the reciprocal (not a division) is what the reference quantizes."""
    ll = torch.round(coeffs * inv_q[:, None])
    signs = ll >= 0
    mags = torch.abs(ll).to(torch.int32)
    return mags, signs, torch.amax(mags, dim=1)


def _reciprocal(q: torch.Tensor) -> torch.Tensor:
    # IEEE f32 division, computed once per chunk before the quantizer
    return torch.ones_like(q) / q


def midtread_quantize_batched(coeffs: torch.Tensor, q: torch.Tensor):
    """coeffs (B, n), q (B,) -> (magnitudes i32, signs bool, max magnitude i32)."""
    return quantize_ref(coeffs, _reciprocal(q))


def midtread_quantize_batched_best(coeffs: torch.Tensor, q: torch.Tensor):
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if coeffs.is_cuda:
        return kernels.quantize(coeffs, _reciprocal(q))
    if coeffs.device.type != "cpu":
        raise ValueError(f"no quantizer for tensors on {coeffs.device}")
    return midtread_quantize_batched(coeffs, q)


def midtread_inv_quantize_batched(
    mags: torch.Tensor, signs: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """(B, n) magnitudes (i16 or i32) and signs, q (B,) -> f32 coefficients."""
    one = torch.ones((), dtype=q.dtype, device=q.device)
    sgn = torch.where(signs, one, -one)
    return (q[:, None] * mags.to(q.dtype)) * sgn


def estimate_q_psnr_batched(
    coeffs: torch.Tensor, data_range: torch.Tensor, psnr_target: float
) -> torch.Tensor:
    """Per-chunk q for a PSNR target; coeffs (B, n) f32, data_range (B,).

    Shrinks q by 2^(-1/4) until each chunk's MSE meets the target
    (SPECK_FLT.cpp:268-279), all chunks iterated together."""
    f32 = np.float32
    t_mse = (data_range * data_range) * float(f32(10.0 ** (-psnr_target / 10.0)))
    q = 2.0 * torch.sqrt(t_mse * 3.0)
    shrink = float(f32(1.0 / (2.0**0.25)))

    def mse(q):
        r = torch.round(coeffs * _reciprocal(q)[:, None])
        d = coeffs - q[:, None] * r
        return torch.mean(d * d, dim=1)

    while True:
        over = mse(q) > t_mse
        if not bool(over.any()):
            return q
        q = torch.where(over, q * shrink, q)
