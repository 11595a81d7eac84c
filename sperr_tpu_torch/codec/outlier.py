"""Outlier corrector for PWE mode (Outlier_Coder.cpp semantics).

Outliers (pos, err) are quantized by the tolerance into a sparse integer
array over the full domain and entropy-coded with the 1D SPECK coder.
Decode reconstructs with the bias corrections 1 -> 1.1*tol and
n -> (n - 0.25)*tol.

The port's copy of sperr_tpu/codec/outlier.py; only its imports differ.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import speck_int_np as sp


def encode_outliers(
    positions: np.ndarray, errors: np.ndarray, total_len: int, tol: float,
    engine=None,
) -> bytes:
    """Encode outliers; `engine` optionally supplies a fast 1D SPECK encoder."""
    assert positions.size > 0
    inv = 1.0 / tol
    ll = np.rint(errors * inv)
    # Width selection uses the raw (unscaled) max |error| — normative quirk
    # of the reference (Outlier_Coder.cpp:82-100).
    maxint = int(np.rint(np.max(np.abs(errors))))
    if maxint <= 0xFF:
        width = 8
    elif maxint <= 0xFFFF:
        width = 16
    elif maxint <= 0xFFFFFFFF:
        width = 32
    else:
        width = 64

    mags = np.zeros(total_len, dtype=np.uint64)
    signs = np.ones(total_len, dtype=bool)
    mags[positions] = np.abs(ll).astype(np.int64).astype(np.uint64)
    signs[positions] = ll >= 0.0

    if engine is not None:
        return engine.encode_1d(mags, signs, total_len, width)
    enc = sp.SpeckInt1D(width)
    enc.set_dims((total_len, 1, 1))
    enc.use_coeffs(mags, signs)
    enc.encode()
    return enc.encoded_bitstream()


def decode_outliers(
    stream: bytes, total_len: int, tol: float, engine=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode to (positions, float corrections)."""
    width = sp.uint_width_for_num_bitplanes(sp.speck_int_get_num_bitplanes(stream))
    if engine is not None:
        mags, signs = engine.decode_1d(stream, total_len, width)
    else:
        dec = sp.SpeckInt1D(width)
        dec.set_dims((total_len, 1, 1))
        dec.use_bitstream(stream)
        dec.decode()
        mags, signs = dec.coeff, dec.signs

    pos = np.flatnonzero(mags)
    vals = mags[pos].astype(np.float64)
    vals = np.where(mags[pos] == 1, 1.1, vals - 0.25)
    sgn = np.where(signs[pos], 1.0, -1.0)
    return pos, vals * (tol * sgn)
