"""Conditioner: constant-field detection + mean subtraction (host engine).

Header layout (17 bytes, Conditioner.cpp):
  byte 0: flags from pack_8_booleans([subtract_mean, 0..0, constant])
          -> subtract_mean lands in bit 7, constant in bit 0
  normal field:   mean f64 at offset 1, quant step q f64 at offset 9
  constant field: nval u64 at offset 1, value f64 at offset 9

The port's copy of sperr_tpu/ops/condition.py; only its imports differ.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from ..utils.packing import pack_8_booleans, unpack_8_booleans
from .quantize_np import _sequential_sum

CONDI_HEADER_SIZE = 17
_DEFAULT_NUM_STRIDES = 2048


def _adjust_strides(length: int) -> int:
    """Pick a stride count dividing `length` (Conditioner.cpp:137-163)."""
    num = _DEFAULT_NUM_STRIDES
    if length % num == 0:
        return num
    for cand in range(num, 32769):
        if length % cand == 0:
            return cand
    for cand in range(num, 0, -1):
        if length % cand == 0:
            return cand
    return 1


def calc_mean(buf: np.ndarray) -> float:
    """Strided mean identical to the reference's accumulation order."""
    n = buf.size
    num_strides = _adjust_strides(n)
    stride = n // num_strides
    per = np.cumsum(buf.reshape(num_strides, stride), axis=1)[:, -1] / float(stride)
    return _sequential_sum(per) / float(num_strides)


def condition(buf: np.ndarray) -> Tuple[bytes, Optional[np.ndarray]]:
    """Returns (17-byte header, conditioned data or None for constant field)."""
    v0 = buf.flat[0]
    if bool((buf == v0).all()):
        flags = pack_8_booleans([True, 0, 0, 0, 0, 0, 0, True])
        header = struct.pack("<BQd", flags, buf.size, float(v0))
        return header, None
    mean = calc_mean(buf)
    flags = pack_8_booleans([True, 0, 0, 0, 0, 0, 0, False])
    header = struct.pack("<Bd", flags, mean) + b"\x00" * 8
    return header, buf - mean


def is_constant(flag_byte: int) -> bool:
    return unpack_8_booleans(flag_byte)[7]


def save_q(header: bytes, q: float) -> bytes:
    return header[:9] + struct.pack("<d", q)


def retrieve_q(header: bytes) -> float:
    return struct.unpack_from("<d", header, 9)[0]


def inverse_condition(buf: Optional[np.ndarray], header: bytes) -> np.ndarray:
    flags = unpack_8_booleans(header[0])
    if flags[7]:  # constant field
        nval, val = struct.unpack_from("<Qd", header, 1)
        return np.full(nval, val, dtype=np.float64)
    (mean,) = struct.unpack_from("<d", header, 1)
    return buf + mean
