"""Flat one-call API mirroring the reference C API (SPERR_C_API.h).

Functions accept/return numpy arrays and bytes; modes are 1=Rate (bpp),
2=PSNR, 3=PWE, like the reference.  The 2D compressor can optionally
prepend the 10-byte header; 3D streams always carry the container header.
The port's copy of sperr_tpu/capi.py, on the port's exact host engine.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .codec.speck_flt import SpeckFloatCodec
from .parallel.chunked3d import Sperr3DCompressor, Sperr3DDecompressor
from .stream import tools

_MODES = {1: "rate", 2: "psnr", 3: "pwe"}


def comp_2d(
    src: np.ndarray,
    dimx: int,
    dimy: int,
    mode: int,
    quality: float,
    out_inc_header: bool = False,
) -> bytes:
    """Compress a 2D slice; src flat or (dimy, dimx), f32 or f64."""
    arr = np.asarray(src)
    is_float = arr.dtype == np.float32
    codec = SpeckFloatCodec(2, (dimx, dimy, 1))
    stream = codec.compress(arr.reshape(-1).astype(np.float64), _MODES[mode], quality)
    if out_inc_header:
        return tools.generate_2d_header((dimx, dimy), is_float) + stream
    return stream


def decomp_2d(
    src: bytes, dimx: int, dimy: int, output_float: bool = False
) -> np.ndarray:
    """Decompress a headerless 2D stream to a flat array."""
    codec = SpeckFloatCodec(2, (dimx, dimy, 1))
    out, _ = codec.decompress(bytes(src))
    return out.astype(np.float32) if output_float else out


def parse_header(src: bytes) -> Tuple[int, int, int, bool]:
    """Returns (dimx, dimy, dimz, is_float) for a 2D-with-header/3D stream."""
    from .utils.packing import unpack_8_booleans

    b8 = unpack_8_booleans(src[1])
    if b8[1]:  # 3D
        h = tools.parse_header(bytes(src))
        return (*h.vol_dims, h.is_float)
    (nx, ny), is_float = tools.parse_2d_header(bytes(src))
    return (nx, ny, 1, is_float)


def comp_3d(
    src: np.ndarray,
    dimx: int,
    dimy: int,
    dimz: int,
    chunk_x: int = 256,
    chunk_y: int = 256,
    chunk_z: int = 256,
    mode: int = 3,
    quality: float = 1e-2,
    nthreads: int = 0,
) -> bytes:
    arr = np.asarray(src).reshape(dimz, dimy, dimx)
    comp = Sperr3DCompressor(
        (dimx, dimy, dimz), (chunk_x, chunk_y, chunk_z), num_threads=nthreads
    )
    return comp.compress(arr, _MODES[mode], quality)


def decomp_3d(
    src: bytes, output_float: bool = False, nthreads: int = 0
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    dec = Sperr3DDecompressor(num_threads=nthreads)
    out, dims = dec.decompress(bytes(src))
    out = out.reshape(-1)
    return (out.astype(np.float32) if output_float else out), dims


def trunc_3d(src: bytes, pct: int) -> bytes:
    return tools.progressive_truncate(bytes(src), pct)
