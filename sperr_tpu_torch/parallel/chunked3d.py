"""Chunk-parallel exact 3D compressor and decompressor (SPERR3D_OMP_* parity):
the host engine behind the tools' ``--exec host`` and the flat API, and the
yardstick that the port's device decoder is held against.

The container is header || chunk_0 || chunk_1 || ... (the reference stream
layout).  A thread pool runs over the chunks; the native C++ codec releases
the GIL, so chunks scale across host cores, as the reference's OpenMP loop
does.  The compressor gathers each chunk inside the C++ codec; a
full-resolution decode scatters each chunk into the volume inside the C++
codec; a multi-resolution decode runs each chunk through
``SpeckFloatCodec`` to fill the coarser levels as well.

The port's copy of sperr_tpu/parallel/chunked3d.py, reduced to the native
codec: the ``engine``, ``use_native`` and ``out`` options are not copied,
and the C++ codec is built at construction and raises if it cannot be.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ..codec.speck_flt import SpeckFloatCodec
from ..errors import first_chunk_failure
from ..runtime.native import NativeChunkCodec
from ..stream import tools
from ..utils.dims import chunk_volume, coarsened_resolutions, coarsened_resolutions_chunked


def _scatter_chunk(vol: np.ndarray, small: np.ndarray, c) -> None:
    x0, lx, y0, ly, z0, lz = c
    vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx] = small.reshape(lz, ly, lx)


class Sperr3DCompressor:
    """Multi-chunk 3D compressor (reference: SPERR3D_OMP_C).  ``precision``
    64 writes the reference's bytes; 32 is the C++ codec's fast mode."""

    def __init__(
        self,
        vol_dims: Tuple[int, int, int],
        chunk_dims: Tuple[int, int, int] = (256, 256, 256),
        num_threads: int = 0,
        precision: int = 64,
    ):
        self.vol_dims = tuple(int(d) for d in vol_dims)
        self.chunk_dims = tuple(
            min(max(1, int(chunk_dims[i])), self.vol_dims[i]) for i in range(3)
        )
        self.num_threads = num_threads if num_threads > 0 else (os.cpu_count() or 1)
        self.native = NativeChunkCodec(precision=precision)

    def compress(self, vol: np.ndarray, mode: str, quality: float) -> bytes:
        """vol: array of shape (nz, ny, nx) or flat (x fastest); any float dtype."""
        nx, ny, nz = self.vol_dims
        is_float = np.asarray(vol).dtype == np.float32
        vol3 = np.asarray(vol).reshape(nz, ny, nx)
        chunks = chunk_volume(self.vol_dims, self.chunk_dims)

        # strided native gather: the chunk block never exists as a
        # Python-side copy
        if vol3.dtype not in (np.float32, np.float64):
            vol3c = np.ascontiguousarray(vol3, dtype=np.float64)
        else:
            vol3c = np.ascontiguousarray(vol3)  # dtype-preserving

        def run_i(i):
            try:
                return self.native.compress_strided(vol3c, chunks[i], mode, quality)
            except Exception as e:  # noqa: BLE001 - reduced below
                return (i, e)

        if len(chunks) == 1:
            results = [run_i(0)]
        else:
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                results = list(pool.map(run_i, range(len(chunks))))
        first_chunk_failure(r for r in results if isinstance(r, tuple))
        streams = results

        header = tools.generate_header(
            self.vol_dims, self.chunk_dims, [len(s) for s in streams], is_float
        )
        return header + b"".join(streams)


class Sperr3DDecompressor:
    """Multi-chunk 3D decompressor (reference: SPERR3D_OMP_D).  ``precision``
    64 decodes in f64; 32 is the C++ codec's fast mode (f32 output)."""

    def __init__(self, num_threads: int = 0, precision: int = 64):
        self.num_threads = num_threads if num_threads > 0 else (os.cpu_count() or 1)
        self.precision = precision
        self.native = NativeChunkCodec(precision=precision)
        self.header: Optional[tools.Sperr3DHeader] = None
        self.hierarchy: List[np.ndarray] = []

    def decompress(
        self, stream: bytes, multi_res: bool = False
    ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
        """Returns (volume shaped (nz, ny, nx), f64 or at precision 32 f32,
        vol_dims (nx, ny, nz)); with ``multi_res`` also fills
        ``self.hierarchy`` (f64), coarsest first."""
        h = tools.parse_header(stream)
        self.header = h
        nx, ny, nz = h.vol_dims
        chunks = chunk_volume(h.vol_dims, h.chunk_dims)
        out_dtype = np.float64 if self.precision == 64 else np.float32
        vol = np.empty((nz, ny, nx), dtype=out_dtype)

        vol_res = coarsened_resolutions_chunked(h.vol_dims, h.chunk_dims)
        chunk_res = coarsened_resolutions(h.chunk_dims)
        hierarchy: List[np.ndarray] = []
        hier_chunks = []
        if multi_res:
            for res in vol_res:
                hierarchy.append(np.empty((res[2], res[1], res[0]), dtype=np.float64))
            hier_chunks = [
                chunk_volume(vol_res[i], chunk_res[i]) for i in range(len(vol_res))
            ]

        def run(i):
            c = chunks[i]
            off, ln = h.chunk_offsets[i * 2], h.chunk_offsets[i * 2 + 1]
            if not multi_res:
                # strided native scatter: writes land in `vol` directly
                self.native.decompress_strided(stream[off : off + ln], vol, c)
                return
            codec = SpeckFloatCodec(3, (c[1], c[3], c[5]))
            vals, hier = codec.decompress(stream[off : off + ln], multi_res=True)
            _scatter_chunk(vol, vals, c)
            for lev in range(len(hier)):
                _scatter_chunk(hierarchy[lev], hier[lev], hier_chunks[lev][i])

        def run_i(i):
            try:
                run(i)
            except Exception as e:  # noqa: BLE001 - reduced below
                return (i, e)

        if len(chunks) == 1:
            errs = [run_i(0)]
        else:
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                errs = list(pool.map(run_i, range(len(chunks))))
        first_chunk_failure(errs)

        self.hierarchy = hierarchy
        return vol, h.vol_dims
