"""CDF 9/7 biorthogonal wavelet transform — exact host (NumPy f64) engine.

Lifting implementation with symmetric boundary handling equivalent to the
reference (CDF97.cpp:598-666).  Each lifting step is elementwise-parallel, so
the whole transform is expressed as batched vector ops along the last axis;
results are bit-identical to the reference compiled with -ffp-contract=off.

The JAX/TPU engine (cdf97_jax.py) reuses the same step structure.

The port's copy of sperr_tpu/ops/cdf97_np.py; only its imports differ.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..utils.dims import calc_approx_detail_len, can_use_dyadic, num_of_xforms

# Lifting constants derived from the Cohen et al. filter bank exactly as the
# reference does (CDF97.h:135-147); all arithmetic below is double precision.
_H = (0.602949018236, 0.266864118443, -0.078223266529, -0.016864118443, 0.026748757411)
_R0 = _H[0] - 2.0 * _H[4] * _H[1] / _H[3]
_R1 = _H[2] - _H[4] - _H[4] * _H[1] / _H[3]
_S0 = _H[1] - _H[3] - _H[3] * _R0 / _R1
_T0 = _H[0] - 2.0 * (_H[2] - _H[4])
ALPHA = _H[4] / _H[3]
BETA = _H[3] / _R1
GAMMA = _R1 / _S0
DELTA = _S0 / _T0
EPSILON = math.sqrt(2.0) * _T0
INV_EPSILON = 1.0 / EPSILON


def _even_neighbor_idx(even_len: int, odd_len: int) -> np.ndarray:
    """Index of even[i+1] for each odd i, clamped to the last even sample."""
    idx = np.arange(1, odd_len + 1)
    idx[-1] = min(idx[-1], even_len - 1)
    if odd_len >= 1:
        idx[odd_len - 1] = even_len - 1 if even_len == odd_len else odd_len
    return idx


def _odd_pair_idx(even_len: int, odd_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right) odd indices feeding each even sample's update."""
    i = np.arange(even_len)
    left = np.maximum(i - 1, 0)  # even[0] mirrors odd[0]
    right = np.minimum(i, odd_len - 1)  # even[last] mirrors when len is odd
    return left, right


def analysis_1d(x: np.ndarray) -> np.ndarray:
    """One level of forward lifting on deinterleaved [even | odd] data.

    Operates along the LAST axis; x may be batched arbitrarily in front.
    """
    n = x.shape[-1]
    el = n - n // 2
    ol = n // 2
    even = x[..., :el].copy()
    odd = x[..., el:].copy()

    nb = _even_neighbor_idx(el, ol)
    lft, rgt = _odd_pair_idx(el, ol)

    odd += ALPHA * (even[..., :ol] + even[..., nb])
    even += BETA * (odd[..., lft] + odd[..., rgt])
    odd += GAMMA * (even[..., :ol] + even[..., nb])
    even = EPSILON * (even + DELTA * (odd[..., lft] + odd[..., rgt]))
    odd *= -INV_EPSILON

    return np.concatenate([even, odd], axis=-1)


def synthesis_1d(x: np.ndarray) -> np.ndarray:
    """One level of inverse lifting on [approx | detail] data (last axis)."""
    n = x.shape[-1]
    el = n - n // 2
    ol = n // 2
    even = x[..., :el].copy()
    odd = x[..., el:].copy()

    nb = _even_neighbor_idx(el, ol)
    lft, rgt = _odd_pair_idx(el, ol)

    odd *= -EPSILON
    even = even * INV_EPSILON - DELTA * (odd[..., lft] + odd[..., rgt])
    odd -= GAMMA * (even[..., :ol] + even[..., nb])
    even -= BETA * (odd[..., lft] + odd[..., rgt])
    odd -= ALPHA * (even[..., :ol] + even[..., nb])

    return np.concatenate([even, odd], axis=-1)


def gather(x: np.ndarray) -> np.ndarray:
    """Deinterleave evens/odds of the last axis to front/back."""
    return np.concatenate([x[..., 0::2], x[..., 1::2]], axis=-1)


def scatter(x: np.ndarray) -> np.ndarray:
    """Interleave [approx | detail] back to even/odd positions."""
    n = x.shape[-1]
    el = n - n // 2
    out = np.empty_like(x)
    out[..., 0::2] = x[..., :el]
    out[..., 1::2] = x[..., el:]
    return out


def dwt_axis(x: np.ndarray, length: int) -> np.ndarray:
    """One forward level over x[..., :length]; returns a full copy of x."""
    out = np.array(x, copy=True)
    seg = out[..., :length]
    out[..., :length] = analysis_1d(gather(seg))
    return out


def idwt_axis(x: np.ndarray, length: int) -> np.ndarray:
    out = np.array(x, copy=True)
    seg = out[..., :length]
    out[..., :length] = scatter(synthesis_1d(seg))
    return out


# ---------------------------------------------------------------------------
# Multi-level loops.  Data layout: C-order array shaped (nz, ny, nx); the
# reference's x dimension is the fastest-varying, matching our last axis.
# ---------------------------------------------------------------------------
def dwt1d(x: np.ndarray, num_levels: int | None = None) -> np.ndarray:
    n = x.shape[-1]
    levels = num_of_xforms(n) if num_levels is None else num_levels
    out = np.array(x, copy=True)
    length = n
    for _ in range(levels):
        out = dwt_axis(out, length)
        length -= length // 2
    return out


def idwt1d(x: np.ndarray, num_levels: int | None = None) -> np.ndarray:
    n = x.shape[-1]
    levels = num_of_xforms(n) if num_levels is None else num_levels
    out = np.array(x, copy=True)
    for lev in range(levels, 0, -1):
        length, _ = calc_approx_detail_len(n, lev - 1)
        out = idwt_axis(out, length)
    return out


def _dwt2d_level(x: np.ndarray, lx: int, ly: int) -> np.ndarray:
    """One 2D level on the top-left (ly, lx) corner; x shaped (..., ny, nx)."""
    out = np.array(x, copy=True)
    # Rows (X) first, then columns (Y) — reference order (CDF97.cpp:345-364).
    sub = out[..., :ly, :lx]
    sub = dwt_axis(sub, lx)
    sub = np.swapaxes(dwt_axis(np.swapaxes(sub, -1, -2), ly), -1, -2)
    out[..., :ly, :lx] = sub
    return out


def _idwt2d_level(x: np.ndarray, lx: int, ly: int) -> np.ndarray:
    out = np.array(x, copy=True)
    sub = out[..., :ly, :lx]
    # Columns (Y) first, then rows (X) — reference order (CDF97.cpp:366-385).
    sub = np.swapaxes(idwt_axis(np.swapaxes(sub, -1, -2), ly), -1, -2)
    sub = idwt_axis(sub, lx)
    out[..., :ly, :lx] = sub
    return out


def dwt2d(x: np.ndarray, num_levels: int | None = None) -> np.ndarray:
    ny, nx = x.shape[-2], x.shape[-1]
    levels = num_of_xforms(min(nx, ny)) if num_levels is None else num_levels
    out = np.array(x, copy=True)
    for lev in range(levels):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        out = _dwt2d_level(out, lx, ly)
    return out


def idwt2d(x: np.ndarray, num_levels: int | None = None) -> np.ndarray:
    ny, nx = x.shape[-2], x.shape[-1]
    levels = num_of_xforms(min(nx, ny)) if num_levels is None else num_levels
    out = np.array(x, copy=True)
    for lev in range(levels, 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev - 1)
        ly, _ = calc_approx_detail_len(ny, lev - 1)
        out = _idwt2d_level(out, lx, ly)
    return out


def idwt2d_multi_res(x: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Inverse 2D transform capturing each intermediate (coarse) resolution."""
    ny, nx = x.shape[-2], x.shape[-1]
    levels = num_of_xforms(min(nx, ny))
    out = np.array(x, copy=True)
    hierarchy: List[np.ndarray] = []
    for lev in range(levels, 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        hierarchy.append(out[..., :ly, :lx].copy())
        lxd, _ = calc_approx_detail_len(nx, lev - 1)
        lyd, _ = calc_approx_detail_len(ny, lev - 1)
        out = _idwt2d_level(out, lxd, lyd)
    return out, hierarchy


def _dwt3d_level(x: np.ndarray, lx: int, ly: int, lz: int) -> np.ndarray:
    """One 3D level: XY planes first, then Z columns (CDF97.cpp:387-429)."""
    out = np.array(x, copy=True)
    sub = out[:lz, :ly, :lx]
    sub = dwt_axis(sub, lx)
    sub = np.swapaxes(dwt_axis(np.swapaxes(sub, -1, -2), ly), -1, -2)
    sub = np.swapaxes(dwt_axis(np.swapaxes(sub, 0, 2), lz), 0, 2)
    out[:lz, :ly, :lx] = sub
    return out


def _idwt3d_level(x: np.ndarray, lx: int, ly: int, lz: int) -> np.ndarray:
    """One inverse 3D level: Z columns first, then XY planes."""
    out = np.array(x, copy=True)
    sub = out[:lz, :ly, :lx]
    sub = np.swapaxes(idwt_axis(np.swapaxes(sub, 0, 2), lz), 0, 2)
    sub = np.swapaxes(idwt_axis(np.swapaxes(sub, -1, -2), ly), -1, -2)
    sub = idwt_axis(sub, lx)
    out[:lz, :ly, :lx] = sub
    return out


def dwt3d(x: np.ndarray) -> np.ndarray:
    """Full 3D forward transform; x shaped (nz, ny, nx)."""
    nz, ny, nx = x.shape
    dims = (nx, ny, nz)
    dyadic = can_use_dyadic(dims)
    out = np.array(x, copy=True)
    if dyadic is not None:
        for lev in range(dyadic):
            lx, _ = calc_approx_detail_len(nx, lev)
            ly, _ = calc_approx_detail_len(ny, lev)
            lz, _ = calc_approx_detail_len(nz, lev)
            out = _dwt3d_level(out, lx, ly, lz)
    else:
        # Wavelet packet: full 1D transform along Z, then full 2D per slice.
        zlev = num_of_xforms(nz)
        out = np.swapaxes(dwt1d(np.swapaxes(out, 0, 2), zlev), 0, 2)
        xylev = num_of_xforms(min(nx, ny))
        out = dwt2d(out, xylev)
    return out


def idwt3d(x: np.ndarray) -> np.ndarray:
    nz, ny, nx = x.shape
    dims = (nx, ny, nz)
    dyadic = can_use_dyadic(dims)
    out = np.array(x, copy=True)
    if dyadic is not None:
        for lev in range(dyadic, 0, -1):
            lx, _ = calc_approx_detail_len(nx, lev - 1)
            ly, _ = calc_approx_detail_len(ny, lev - 1)
            lz, _ = calc_approx_detail_len(nz, lev - 1)
            out = _idwt3d_level(out, lx, ly, lz)
    else:
        xylev = num_of_xforms(min(nx, ny))
        out = idwt2d(out, xylev)
        zlev = num_of_xforms(nz)
        out = np.swapaxes(idwt1d(np.swapaxes(out, 0, 2), zlev), 0, 2)
    return out


def idwt3d_multi_res(x: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Inverse 3D dyadic transform capturing each coarse resolution.

    Falls back to plain wavelet-packet inversion (empty hierarchy) when the
    dims do not admit dyadic decomposition, mirroring CDF97.cpp:150-168.
    """
    nz, ny, nx = x.shape
    dims = (nx, ny, nz)
    dyadic = can_use_dyadic(dims)
    if dyadic is None:
        return idwt3d(x), []
    out = np.array(x, copy=True)
    hierarchy: List[np.ndarray] = []
    for lev in range(dyadic, 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        lz, _ = calc_approx_detail_len(nz, lev)
        hierarchy.append(out[:lz, :ly, :lx].copy())
        lxd, _ = calc_approx_detail_len(nx, lev - 1)
        lyd, _ = calc_approx_detail_len(ny, lev - 1)
        lzd, _ = calc_approx_detail_len(nz, lev - 1)
        out = _idwt3d_level(out, lxd, lyd, lzd)
    return out, hierarchy
