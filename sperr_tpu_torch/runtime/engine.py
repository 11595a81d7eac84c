"""SPECK entropy-stage execution engines (the port's copy of
sperr_tpu/runtime/engine.py).

The dense stages (wavelets, quantization) run on the torch device; the
bit-serial SPECK entropy stage runs on the host.  Two interchangeable engines
produce byte-identical streams:

  * NumpyEngine  — pure NumPy/Python reference engine (ground truth, slow)
  * NativeEngine — C++ engine (runtime/native), multithreaded across chunks

`default_engine()` is the native engine.  It raises when the C++ library
cannot be built or loaded: a broken build must not turn into a run that is
many times slower.  The NumPy engine runs only where a caller names it.
The original's wavefront engine (codec/speck_wave.py) and its
``set_default_engine`` switch are not copied.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..codec import speck_int_np as sp


class NumpyEngine:
    name = "numpy"

    def encode(self, ndim, mags, signs, dims, width, budget_bits) -> bytes:
        enc = sp.make_encoder(ndim, width)
        enc.set_dims(dims)
        enc.set_budget(budget_bits)
        enc.use_coeffs(mags, signs)
        enc.encode()
        return enc.encoded_bitstream()

    def decode(self, ndim, stream, dims, width) -> Tuple[np.ndarray, np.ndarray]:
        dec = sp.make_decoder(ndim, width)
        dec.set_dims(dims)
        dec.use_bitstream(stream)
        dec.decode()
        return dec.coeff, dec.signs

    def encode_1d(self, mags, signs, total_len, width) -> bytes:
        return self.encode(1, mags, signs, (total_len, 1, 1), width, 0)

    def decode_1d(self, stream, total_len, width):
        return self.decode(1, stream, (total_len, 1, 1), width)


_default: Optional[object] = None


def default_engine():
    """The C++ engine, built and loaded at first use; raises if it cannot be."""
    global _default
    if _default is None:
        from .native import NativeEngine

        _default = NativeEngine()
    return _default
