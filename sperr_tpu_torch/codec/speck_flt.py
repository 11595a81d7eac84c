"""Per-chunk float codec: the full SPERR pipeline for 1D/2D/3D arrays.

Pipeline (SPECK_FLT.cpp:401-606):
  compress:   condition -> DWT -> estimate q -> midtread quantize ->
              [PWE: inverse-reconstruct, collect outliers] -> SPECK encode
  decompress: SPECK decode -> inv-quantize -> IDWT -> [outliers] -> inv-condition

Stream: condi(17B) | SPECK_INT | [outlier SPECK_INT]

The wavelet + quantization stages run on a pluggable dense engine (exact
NumPy host engine by default; the JAX/TPU engine lives in ops/cdf97_jax.py
and is used by the batched chunk pipeline in parallel/).  The SPECK entropy
stage runs on the host (NumPy reference engine or native C++ engine).

The port's copy of sperr_tpu/codec/speck_flt.py; only its imports differ.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..ops import cdf97_np as cdf
from ..ops import condition as cond
from ..ops import quantize_np as qz
from ..utils.dims import coarsened_resolutions
from . import outlier as outlier_mod
from . import speck_int_np as sp

# "directq" mirrors the reference's EXPERIMENTING CompMode::DirectQ
# (sperr_helper.h:48-50): the quantization step is given verbatim, no
# outlier coding, no budget.
_MODES = ("psnr", "pwe", "rate", "directq")


def _get_speck_engine(engine):
    if engine is not None:
        return engine
    from ..runtime.engine import default_engine

    return default_engine()


class SpeckFloatCodec:
    """One-chunk codec. `ndim` in {1, 2, 3}; dims given as (nx, ny, nz)."""

    def __init__(self, ndim: int, dims: Tuple[int, int, int], engine=None):
        assert ndim in (1, 2, 3)
        self.ndim = ndim
        self.dims = tuple(int(d) for d in dims)
        self.engine = _get_speck_engine(engine)

    # ------------------------------------------------------------------
    def _shape(self) -> Tuple[int, ...]:
        nx, ny, nz = self.dims
        return {1: (nx,), 2: (ny, nx), 3: (nz, ny, nx)}[self.ndim]

    def _dwt(self, arr: np.ndarray) -> np.ndarray:
        a = arr.reshape(self._shape())
        return {1: cdf.dwt1d, 2: cdf.dwt2d, 3: cdf.dwt3d}[self.ndim](a).reshape(-1)

    def _idwt(self, arr: np.ndarray) -> np.ndarray:
        a = arr.reshape(self._shape())
        return {1: cdf.idwt1d, 2: cdf.idwt2d, 3: cdf.idwt3d}[self.ndim](a).reshape(-1)

    def _idwt_multi_res(self, arr: np.ndarray):
        a = arr.reshape(self._shape())
        if self.ndim == 2:
            out, hier = cdf.idwt2d_multi_res(a)
        elif self.ndim == 3:
            out, hier = cdf.idwt3d_multi_res(a)
        else:
            out, hier = cdf.idwt1d(a), []
        return out.reshape(-1), [h.reshape(-1) for h in hier]

    # ------------------------------------------------------------------
    def compress(self, data: np.ndarray, mode: str, quality: float) -> bytes:
        """Compress a flat float64 array (x fastest) to a SPERR chunk stream."""
        assert mode in _MODES
        total = int(np.prod(self.dims))
        vals = np.ascontiguousarray(data, dtype=np.float64).reshape(-1)
        assert vals.size == total

        condi, conditioned = cond.condition(vals)
        if conditioned is None:  # constant field: 17-byte stream, done.
            return condi

        # PWE mode diffs against the *conditioned* data (SPECK_FLT.cpp:422-424).
        vals_orig = conditioned.copy() if mode == "pwe" else None
        param = 0.0
        if mode == "psnr":
            param = float(conditioned.max()) - float(conditioned.min())

        coeffs = self._dwt(conditioned)
        if mode == "rate":
            param = float(np.abs(coeffs[np.argmax(np.abs(coeffs))]))

        budget_bits = 0
        if mode == "rate":
            budget_bits = int(quality * float(total))

        for high_prec in (False, True):
            q = qz.estimate_q(mode, quality, param, coeffs, high_prec)
            assert q > 0.0
            condi_q = cond.save_q(condi, q)

            mags, signs, width = qz.midtread_quantize(coeffs, q)

            outlier_stream = b""
            if mode == "pwe":
                # Reconstruct (inv-quantize + IDWT) and collect outliers whose
                # pointwise error still exceeds the tolerance.
                rec_coeffs = qz.midtread_inv_quantize(
                    _narrow(mags, width).astype(np.uint64), signs, q
                )
                rec = self._idwt(rec_coeffs)
                diff = vals_orig - rec
                out_pos = np.flatnonzero(np.abs(diff) > quality)
                if out_pos.size:
                    outlier_stream = outlier_mod.encode_outliers(
                        out_pos, diff[out_pos], total, quality, engine=None
                    )

            speck_stream = self.engine.encode(
                self.ndim, _narrow(mags, width), signs, self.dims, width, budget_bits
            )

            if mode != "rate":
                return condi_q + speck_stream + outlier_stream
            # Rate mode: if under budget at low precision, redo with high.
            actual_bits = len(speck_stream) * 8
            if high_prec or actual_bits >= budget_bits:
                return condi_q + speck_stream + outlier_stream
        raise AssertionError("unreachable")

    # ------------------------------------------------------------------
    def decompress(
        self, stream: bytes, multi_res: bool = False
    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Returns (flat float64 data, hierarchy of coarse reconstructions)."""
        total = int(np.prod(self.dims))
        condi = stream[: cond.CONDI_HEADER_SIZE]
        if cond.is_constant(condi[0]):
            return cond.inverse_condition(None, condi), []

        q = cond.retrieve_q(condi)
        if not (q > 0.0 and np.isfinite(q)):
            from ..stream.tools import StreamError

            raise StreamError(f"invalid conditioner q={q}")
        pos = cond.CONDI_HEADER_SIZE
        num_bp = sp.speck_int_get_num_bitplanes(stream[pos : pos + 1])
        width = sp.uint_width_for_num_bitplanes(num_bp)
        full_len = sp.speck_int_stream_full_len(stream[pos : pos + sp.HEADER_SIZE])
        speck_len = min(full_len, len(stream) - pos)
        speck_stream = stream[pos : pos + speck_len]
        pos += speck_len

        outlier_stream = b""
        if pos < len(stream):
            rem = len(stream) - pos
            if rem >= sp.HEADER_SIZE:
                o_len = sp.speck_int_stream_full_len(stream[pos : pos + sp.HEADER_SIZE])
                if rem == o_len:
                    outlier_stream = stream[pos : pos + o_len]

        mags, signs = self.engine.decode(self.ndim, speck_stream, self.dims, width)
        coeffs = qz.midtread_inv_quantize(mags, signs, q)

        hierarchy: List[np.ndarray] = []
        if multi_res:
            vals, hierarchy = self._idwt_multi_res(coeffs)
        else:
            vals = self._idwt(coeffs)

        if outlier_stream:
            tol = q / 1.5  # decode-side tolerance (SPECK_FLT.cpp:578)
            opos, ocorr = outlier_mod.decode_outliers(outlier_stream, total, tol)
            vals[opos] += ocorr

        vals = cond.inverse_condition(vals, condi)
        if multi_res and hierarchy:
            dims3 = self.dims if self.ndim == 3 else (self.dims[0], self.dims[1], 1)
            res = coarsened_resolutions(dims3)
            assert len(res) == len(hierarchy)
            hierarchy = [cond.inverse_condition(h, condi) for h in hierarchy]
        return vals, hierarchy


def _narrow(mags: np.ndarray, width: int) -> np.ndarray:
    return mags.astype({8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[width])
