"""Bit-level I/O with the SPERR stream convention (LSB-first).

The reference Bitstream (Bitstream.cpp) buffers bits LSB-first inside 64-bit
little-endian words, which is byte-for-byte identical to an LSB-first bit
order over the byte stream.  numpy's packbits/unpackbits with
bitorder="little" reproduce it exactly.

The port's copy of sperr_tpu/codec/bitio.py; only its imports differ.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Append-only bit buffer; bit i of the stream = bit (i%8) of byte (i//8)."""

    __slots__ = ("_bits",)

    def __init__(self):
        self._bits: list[int] = []

    def wbit(self, bit) -> None:
        self._bits.append(1 if bit else 0)

    def wbits(self, bits) -> None:
        """Append many bits; accepts any iterable / bool ndarray."""
        if isinstance(bits, np.ndarray):
            self._bits.extend(bits.astype(np.uint8).tolist())
        else:
            self._bits.extend(1 if b else 0 for b in bits)

    def wtell(self) -> int:
        return len(self._bits)

    def pack(self, num_bits: int | None = None) -> bytes:
        """Pack the first `num_bits` bits (default: all) into bytes."""
        n = len(self._bits) if num_bits is None else min(num_bits, len(self._bits))
        if n == 0:
            return b""
        arr = np.array(self._bits[:n], dtype=np.uint8)
        return np.packbits(arr, bitorder="little").tobytes()


class BitReader:
    """Sequential bit reader over a byte buffer, LSB-first, with zero padding.

    `total_bits` mirrors the reference's progressive-decode semantics
    (SPECK_INT.cpp:80-108): when fewer bits are available than the stream
    header advertises, reads beyond the available region return 0.
    """

    __slots__ = ("_bits", "pos")

    def __init__(self, data: bytes | np.ndarray, avail_bits: int, total_bits: int):
        raw = np.frombuffer(bytes(data), dtype=np.uint8)
        bits = np.unpackbits(raw, bitorder="little")
        # Allocate the full advertised length plus slack; extra stays zero.
        buf = np.zeros(total_bits + 256, dtype=np.uint8)
        n = min(avail_bits, bits.size)
        buf[:n] = bits[:n]
        self._bits = buf
        self.pos = 0

    def rbit(self) -> int:
        b = self._bits[self.pos]
        self.pos += 1
        return int(b)

    def rbits(self, n: int) -> np.ndarray:
        out = self._bits[self.pos : self.pos + n]
        self.pos += n
        return out

    def rtell(self) -> int:
        return self.pos
