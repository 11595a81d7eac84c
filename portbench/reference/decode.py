"""The plain reference decoder of SPERR streams: container, conditioner
header, SPECK integers, inverse quantization, inverse CDF 9/7 and outlier
corrections, in plain PyTorch (and numpy for the headers).

It follows the stream format of NCAR/SPERR (SPERR3D_OMP_C.cpp for the
container, SPECK_FLT.cpp for a chunk, CDF97.cpp for the transform,
Outlier_Coder.cpp for the corrections).  The SPECK integers come from the
frozen C++ decoder beside this file (``native.py``); everything after them
is written out here, one array operation per lifting step, so that in
float64 every value equals the exact host decoder's bit for bit (each
product and sum rounds on its own, as the reference built with
-ffp-contract=off does).  ``dtype`` runs the same steps in a lower
precision: that is the control of the read cell.

Imports neither jax, nor sperr_tpu, nor anything of sperr_tpu_torch.
"""

from __future__ import annotations

import math
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch

from . import native

CONDI_BYTES = 17
SPECK_HEADER_BYTES = 9
MAX_XFORM_LEVELS = 6
MIN_LEN_ONE_LEVEL = 9

# Lifting constants from the Cohen et al. filter bank (CDF97.h:135-147).
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


class StreamError(ValueError):
    """A stream the reference cannot read."""


# --------------------------------------------------------------------------
# sizes (sperr_helper.cpp:36-68, 542-592)
# --------------------------------------------------------------------------
def num_of_xforms(length: int) -> int:
    num = 0
    while length >= MIN_LEN_ONE_LEVEL:
        num += 1
        length -= length // 2
    return min(num, MAX_XFORM_LEVELS)


def approx_len(orig_len: int, lev: int) -> int:
    low = orig_len
    for _ in range(lev):
        low -= low // 2
    return low


def dyadic_levels(dims) -> int | None:
    """3D dyadic level count of (nx, ny, nz), or None for a wavelet packet."""
    if dims[2] < 2 or dims[1] < 2:
        return None
    xy = num_of_xforms(min(dims[0], dims[1]))
    z = num_of_xforms(dims[2])
    if xy == z or (xy >= 5 and z >= 5):
        return min(xy, z)
    return None


def chunk_volume(vol_dims, chunk_dims) -> List[Tuple[int, int, int, int, int, int]]:
    """(x0, lx, y0, ly, z0, lz) of each chunk, x fastest; a remainder longer
    than half a chunk is a chunk of its own, a shorter one joins the last."""
    tics = []
    for i in range(3):
        segs = vol_dims[i] // chunk_dims[i]
        if vol_dims[i] % chunk_dims[i] > chunk_dims[i] // 2:
            segs += 1
        segs = max(segs, 1)
        tics.append([k * chunk_dims[i] for k in range(segs)] + [vol_dims[i]])
    out = []
    for z in range(len(tics[2]) - 1):
        for y in range(len(tics[1]) - 1):
            for x in range(len(tics[0]) - 1):
                out.append((tics[0][x], tics[0][x + 1] - tics[0][x], tics[1][y],
                            tics[1][y + 1] - tics[1][y], tics[2][z], tics[2][z + 1] - tics[2][z]))
    return out


def parse_container(stream: bytes):
    """A 3D container -> (vol_dims, chunk specs, [(offset, length)] per chunk)."""
    if len(stream) < 18:
        raise StreamError(f"container of {len(stream)} bytes")
    flags = stream[1]
    if not flags & 0x40:
        raise StreamError("not a 3D container")
    multi = bool(flags & 0x10)
    vol = struct.unpack_from("<III", stream, 2)
    pos = 14
    if multi:
        cdims = struct.unpack_from("<HHH", stream, pos)
        pos += 6
    else:
        cdims = vol
    chunks = chunk_volume(vol, cdims)
    if len(stream) < pos + 4 * len(chunks):
        raise StreamError("container shorter than its header")
    lens = struct.unpack_from(f"<{len(chunks)}I", stream, pos)
    off = pos + 4 * len(chunks)
    spans = []
    for ln in lens:
        spans.append((off, ln))
        off += ln
    if off != len(stream):
        raise StreamError(f"container holds {len(stream)} bytes, its header {off}")
    return tuple(vol), chunks, spans


# --------------------------------------------------------------------------
# inverse CDF 9/7 (CDF97.cpp:598-666), along the last axis
# --------------------------------------------------------------------------
def _synthesis(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    el, ol = n - n // 2, n // 2
    dev = x.device
    nb = torch.clamp(torch.arange(1, ol + 1, device=dev), max=el - 1)
    i = torch.arange(el, device=dev)
    lft = torch.clamp(i - 1, min=0)
    rgt = torch.clamp(i, max=ol - 1)
    even = x[..., :el]
    odd = x[..., el:] * -EPSILON
    even = even * INV_EPSILON - DELTA * (odd.index_select(-1, lft) + odd.index_select(-1, rgt))
    odd = odd - GAMMA * (even[..., :ol] + even.index_select(-1, nb))
    even = even - BETA * (odd.index_select(-1, lft) + odd.index_select(-1, rgt))
    odd = odd - ALPHA * (even[..., :ol] + even.index_select(-1, nb))
    out = torch.empty_like(x)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _inverse_axis(x: torch.Tensor, axis: int, length: int) -> torch.Tensor:
    """One inverse level over the first ``length`` samples along ``axis``."""
    y = x.movedim(axis, -1).contiguous()
    y[..., :length] = _synthesis(y[..., :length])
    return y.movedim(-1, axis).contiguous()


def _idwt2d(x: torch.Tensor, levels: int) -> torch.Tensor:
    """x (..., ny, nx): columns then rows each level (CDF97.cpp:366-385)."""
    ny, nx = x.shape[-2], x.shape[-1]
    for lev in range(levels, 0, -1):
        lx, ly = approx_len(nx, lev - 1), approx_len(ny, lev - 1)
        sub = x[..., :ly, :lx]
        sub = _inverse_axis(sub, -2, ly)
        sub = _inverse_axis(sub, -1, lx)
        x[..., :ly, :lx] = sub
    return x


def idwt(coeffs: torch.Tensor) -> torch.Tensor:
    """The inverse transform of a chunk: (ny, nx) or (nz, ny, nx)."""
    x = coeffs.clone()
    if x.dim() == 2:
        return _idwt2d(x, num_of_xforms(min(x.shape)))
    nz, ny, nx = x.shape
    dyadic = dyadic_levels((nx, ny, nz))
    if dyadic is None:
        # wavelet packet: the 2D levels of every slice, then z
        x = _idwt2d(x, num_of_xforms(min(nx, ny)))
        for lev in range(num_of_xforms(nz), 0, -1):
            x = _inverse_axis(x, 0, approx_len(nz, lev - 1))
        return x
    for lev in range(dyadic, 0, -1):
        lx, ly, lz = (approx_len(d, lev - 1) for d in (nx, ny, nz))
        sub = x[:lz, :ly, :lx]
        sub = _inverse_axis(sub, 0, lz)
        sub = _inverse_axis(sub, 1, ly)
        sub = _inverse_axis(sub, 2, lx)
        x[:lz, :ly, :lx] = sub
    return x


# --------------------------------------------------------------------------
# one chunk's stream (SPECK_FLT.cpp:528-606)
# --------------------------------------------------------------------------
def _speck_len(stream: bytes, pos: int) -> int:
    (bits,) = struct.unpack_from("<Q", stream, pos + 1)
    return SPECK_HEADER_BYTES + (bits + 7) // 8


def decode_outliers(stream: bytes, n: int, tol: float):
    """(positions, corrections): magnitudes 1 -> 1.1 tol, m -> (m - 0.25) tol
    (Outlier_Coder.cpp)."""
    mags, signs = native.decode(1, stream, (n, 1, 1), native.width_for(stream[0]))
    pos = np.flatnonzero(mags)
    m = mags[pos].astype(np.float64)
    vals = np.where(mags[pos] == 1, 1.1, m - 0.25)
    return pos, vals * (tol * np.where(signs[pos], 1.0, -1.0))


def decode_chunk(stream: bytes, dims, device, dtype=torch.float64) -> torch.Tensor:
    """One chunk's SPERR stream of dims (nx, ny, nz) (nz = 1: a 2D field)
    -> its values on ``device``, shaped (nz, ny, nx) or (ny, nx), in
    ``dtype`` (the header's mean and the outliers' corrections added in it)."""
    nx, ny, nz = (int(d) for d in dims)
    n = nx * ny * nz
    shape = (ny, nx) if nz == 1 else (nz, ny, nx)
    if len(stream) < CONDI_BYTES:
        raise StreamError(f"chunk stream of {len(stream)} bytes")
    flags = stream[0]
    if flags & 0x01:  # constant chunk: count u64, value f64
        count, value = struct.unpack_from("<Qd", stream, 1)
        if count != n:
            raise StreamError(f"constant chunk of {count} values, {n} expected")
        return torch.full(shape, value, dtype=dtype, device=device)
    mean, q = struct.unpack_from("<dd", stream, 1)
    if not (q > 0.0 and math.isfinite(q)):
        raise StreamError(f"quantization step {q}")
    pos = CONDI_BYTES
    if len(stream) < pos + SPECK_HEADER_BYTES:
        raise StreamError("no SPECK header")
    slen = min(_speck_len(stream, pos), len(stream) - pos)
    speck = stream[pos: pos + slen]
    pos += slen
    mags, signs = native.decode(2 if nz == 1 else 3, speck, (nx, ny, nz), native.width_for(speck[0]))
    m = torch.from_numpy(mags.view(np.int64)).to(device)
    s = torch.from_numpy(signs).to(device)
    coeffs = (q * m.to(torch.float64)) * torch.where(s, 1.0, -1.0).to(torch.float64)
    vals = idwt(coeffs.to(dtype).reshape(shape)).reshape(-1)
    rest = len(stream) - pos
    if rest:
        if rest < SPECK_HEADER_BYTES or _speck_len(stream, pos) != rest:
            raise StreamError(f"{rest} bytes after the SPECK stream are not an outlier stream")
        opos, corr = decode_outliers(stream[pos:], n, q / 1.5)
        p = torch.from_numpy(opos).to(device)
        vals[p] = vals[p] + torch.from_numpy(corr).to(device=device, dtype=dtype)
    return (vals + mean).reshape(shape)


def decode_container(stream: bytes, device, dtype=torch.float64, threads: int = 8) -> torch.Tensor:
    """A 3D container -> its volume (nz, ny, nx) on ``device`` in ``dtype``,
    the chunks decoded on ``threads`` host threads."""
    vol, chunks, spans = parse_container(stream)
    out = torch.empty((vol[2], vol[1], vol[0]), dtype=dtype, device=device)

    def one(k):
        x0, lx, y0, ly, z0, lz = chunks[k]
        off, ln = spans[k]
        out[z0:z0 + lz, y0:y0 + ly, x0:x0 + lx] = decode_chunk(stream[off:off + ln], (lx, ly, lz), device, dtype)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one, range(len(chunks))))
    return out


def decode_fields(streams, dims, device, dtype=torch.float64, threads: int = 8) -> torch.Tensor:
    """B streams of 2D fields of dims (nx, ny) -> (B, ny, nx) on ``device``."""
    nx, ny = dims
    out = torch.empty((len(streams), ny, nx), dtype=dtype, device=device)

    def one(k):
        out[k] = decode_chunk(bytes(streams[k]), (nx, ny, 1), device, dtype)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one, range(len(streams))))
    return out
