"""Midtread quantization and PSNR-mode q estimation, batched over chunks.

PyTorch port of sperr_tpu/ops/quantize_jax.py.  Arithmetic is f32 (the
PSNR search's MSE is an f64 mean of exact f32 squares).  On a CUDA tensor
the fused quantizer and the PSNR search run the hand-written kernels K1
and K16 (kernels/quantize.cu); on a CPU tensor their plain versions
``quantize_ref`` and ``psnr_q_ref``, which the kernels equal bit for bit.
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


def psnr_start(data_range: torch.Tensor, psnr_target: float):
    """(t_mse, q0) of the PSNR search for each chunk's data range, as the
    reference rounds them in f32: t_mse = range^2 10^(-psnr/10), the
    search's first q0 = 2 sqrt(3 t_mse)."""
    t_mse = (data_range * data_range) * float(np.float32(10.0 ** (-psnr_target / 10.0)))
    return t_mse, 2.0 * torch.sqrt(t_mse * 3.0)


def psnr_q_ref(coeffs: torch.Tensor, q0: torch.Tensor, t_mse: torch.Tensor) -> torch.Tensor:
    """Plain K16: shrink each row's q from q0 by 2^(-1/4) in f32 until its
    MSE, the f64 mean of the exact squares of the f32 residuals
    c - q rint(c / q), is not above t_mse (SPECK_FLT.cpp:268-279; all rows
    iterated together).  A row whose q no longer shrinks raises ValueError
    (f32 cannot reach its target); the loop would not end."""
    n = coeffs.shape[1]
    target = t_mse.double()
    q = q0
    while True:
        r = torch.round(coeffs * _reciprocal(q)[:, None])
        d = coeffs - q[:, None] * r
        over = d.double().square().sum(dim=1) / n > target
        if not bool(over.any()):
            return q
        nxt = torch.where(over, q * kernels.PSNR_SHRINK, q)
        stuck = torch.nonzero(over & (nxt == q))
        if stuck.numel():
            row = int(stuck[0, 0])
            raise ValueError(kernels.psnr_unreachable(row, float(t_mse[row]), float(q[row])))
        q = nxt


def estimate_q_psnr_batched(
    coeffs: torch.Tensor, data_range: torch.Tensor, psnr_target: float
) -> torch.Tensor:
    """Per-chunk q for a PSNR target; coeffs (B, n) f32, data_range (B,).
    K16 (``kernels.psnr_q``: a round of candidates in a lean launch and a
    full one queued behind it, one host wait) on a CUDA tensor, the plain
    version on a CPU tensor; the same q."""
    t_mse, q0 = psnr_start(data_range, psnr_target)
    if coeffs.is_cuda:
        return kernels.psnr_q(coeffs, q0, t_mse)
    if coeffs.device.type != "cpu":
        raise ValueError(f"no PSNR search for tensors on {coeffs.device}")
    return psnr_q_ref(coeffs, q0, t_mse)
