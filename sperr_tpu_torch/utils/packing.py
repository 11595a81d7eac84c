"""Boolean <-> byte packing with the reference's bit convention.

The reference packs bool[i] into bit (7-i) of each byte via the
0x8040201008040201 multiply trick (sperr_helper.cpp:150-287).  We express the
same mapping with numpy's big-endian packbits.

The port's copy of sperr_tpu/utils/packing.py; only its imports differ.
"""

from __future__ import annotations

import numpy as np


def pack_8_booleans(b8) -> int:
    """Pack 8 booleans into one byte; b8[0] lands in the MSB (bit 7)."""
    assert len(b8) == 8
    out = 0
    for i, b in enumerate(b8):
        out |= int(bool(b)) << (7 - i)
    return out


def unpack_8_booleans(byte: int):
    """Inverse of pack_8_booleans."""
    return [bool((byte >> (7 - i)) & 1) for i in range(8)]


def pack_booleans(src: np.ndarray) -> np.ndarray:
    """Pack a bool array (length divisible by 8) into bytes, MSB-first."""
    src = np.asarray(src, dtype=np.uint8)
    assert src.size % 8 == 0
    return np.packbits(src, bitorder="big")


def unpack_booleans(src: np.ndarray, num_bits: int | None = None) -> np.ndarray:
    """Unpack bytes into a bool array, MSB-first."""
    bits = np.unpackbits(np.asarray(src, dtype=np.uint8), bitorder="big")
    if num_bits is not None:
        bits = bits[:num_bits]
    return bits.astype(bool)
