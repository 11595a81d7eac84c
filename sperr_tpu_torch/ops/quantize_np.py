"""Midtread quantization and quality-target -> q estimation (host engine).

Semantics mirror SPECK_FLT.cpp:237-399 so that streams are interchangeable:
  * quantize:     ll = rint(v * (1/q))  (round-half-even), sign + magnitude
  * inv-quantize: v = (q * magnitude) * sign
  * PSNR mode:    q = 2*sqrt(3*t_mse) shrunk by 2^0.25 until the estimated
                  midtread MSE (computed with fma(-q, rint(v/q), v)) meets it
  * PWE mode:     q = 1.5 * tol
  * Rate mode:    q = max|coeff| / (2^32-1), or / 0x1.fffffffffffffp52

The port's copy of sperr_tpu/ops/quantize.py; only its imports differ.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

UINT32_MAX = 4294967295.0
DBL_BIG_ODD = float.fromhex("0x1.fffffffffffffp52")  # 9007199254740991.0


def _two_prod(a: np.ndarray, b) -> Tuple[np.ndarray, np.ndarray]:
    """Dekker/Veltkamp exact product: a*b == hi + lo exactly."""
    hi = a * b
    splitter = 134217729.0  # 2^27 + 1
    a1 = a * splitter
    ah = a1 - (a1 - a)
    al = a - ah
    b1 = b * splitter
    bh = b1 - (b1 - b)
    bl = b - bh
    lo = ((ah * bh - hi) + ah * bl + al * bh) + al * bl
    return hi, lo


def fma_np(a: np.ndarray, b, c: np.ndarray) -> np.ndarray:
    """Vectorized fused multiply-add, correctly rounded like C's fma().

    Computes a*b + c with a single rounding via Dekker two-product +
    two-sum.  Needed because the reference's MSE probe uses std::fma
    (SPECK_FLT.cpp:250) and the PSNR-mode q search is sensitive to it.
    """
    hi, lo = _two_prod(np.asarray(a, dtype=np.float64), b)
    s = hi + c
    bb = s - hi
    err = (hi - (s - bb)) + (c - bb)
    return s + (err + lo)


def _sequential_sum(x: np.ndarray) -> float:
    """Strict left-to-right sum of a 1D array (cumsum is sequential)."""
    if x.size == 0:
        return 0.0
    return float(np.cumsum(x)[-1])


def strided_sum(x: np.ndarray, stride: int) -> float:
    """Reference-style strided accumulation: per-stride left-to-right sums
    (strict order), then a left-to-right sum of the stride sums plus the
    remainder sum appended last."""
    n = x.size
    num = n // stride
    sums = np.empty(num + 1, dtype=np.float64)
    if num:
        body = x[: num * stride].reshape(num, stride)
        sums[:num] = np.cumsum(body, axis=1)[:, -1]
    sums[num] = _sequential_sum(x[num * stride :])
    return _sequential_sum(sums)


def estimate_mse_midtread(vals: np.ndarray, q: float) -> float:
    """Estimated MSE of midtread quantization at step q (SPECK_FLT.cpp:237)."""
    rcp = 1.0 / q
    diff = fma_np(-q, np.rint(vals * rcp), vals)
    return strided_sum(diff * diff, 4096) / float(vals.size)


def estimate_q(
    mode: str, quality: float, param: float, vals: np.ndarray | None, high_prec: bool = False
) -> float:
    """Pick the quantization step for a quality target (SPECK_FLT.cpp:268)."""
    if mode == "psnr":
        t_mse = (param * param) * (10.0 ** (-quality / 10.0))
        q = 2.0 * np.sqrt(t_mse * 3.0)
        q = float(q)
        shrink = float(np.exp2(0.25))
        while estimate_mse_midtread(vals, q) > t_mse:
            q /= shrink
        return q
    if mode == "pwe":
        return quality * 1.5
    if mode == "rate":
        return param / (DBL_BIG_ODD if high_prec else UINT32_MAX)
    if mode == "directq":  # experimental: q given verbatim (SPECK_FLT.cpp:302-305)
        return quality
    raise ValueError(f"unknown mode {mode!r}")


def midtread_quantize(vals: np.ndarray, q: float) -> Tuple[np.ndarray, np.ndarray, int]:
    """Quantize doubles -> (magnitudes u64 w/ width wraparound later, signs, width).

    Returns magnitudes as int64 `rint` results (absolute values), the sign
    array (True == non-negative), and the chosen uint width in bits.
    """
    # Width selection uses rint(|maxd| / q) — a division, unlike the
    # per-element multiply by 1/q (SPECK_FLT.cpp:321-337).
    maxd = vals[np.argmax(np.abs(vals))]
    maxll = int(np.rint(np.abs(maxd) / q))
    if maxll <= 0xFF:
        width = 8
    elif maxll <= 0xFFFF:
        width = 16
    elif maxll <= 0xFFFFFFFF:
        width = 32
    else:
        width = 64

    inv = 1.0 / q
    ll = np.rint(vals * inv)
    signs = ll >= 0.0
    mags = np.abs(ll)
    # int64 conversion mirrors llrint; values beyond the chosen width wrap
    # when narrowed by the caller, same as the reference's implicit casts.
    mags_int = mags.astype(np.int64).astype(np.uint64)
    return mags_int, signs, width


def midtread_inv_quantize(mags: np.ndarray, signs: np.ndarray, q: float) -> np.ndarray:
    """Inverse: v = (q * magnitude) * (+-1)  (SPECK_FLT.cpp:373-399)."""
    sgn = np.where(signs, 1.0, -1.0)
    return (q * mags.astype(np.float64)) * sgn
