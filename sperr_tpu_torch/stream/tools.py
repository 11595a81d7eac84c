"""SPERR3D container header + progressive access tools.

Container layout (SPERR3D_OMP_C.cpp:163-234):
  version u8 | flags u8 (pack8: [portion, is3D, isFloat, multichunk, 0..]) |
  vol dims 3 x u32 | [chunk dims 3 x u16 if multichunk] | chunk lens u32 x n |
  chunk streams...
Header magic sizes: 20 (multi-chunk) / 14 (single chunk), + 4*num_chunks.

The port's copy of sperr_tpu/stream/tools.py; only its imports differ.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

from .. import SPERR_VERSION_MAJOR
from ..utils.dims import chunk_volume
from ..utils.packing import pack_8_booleans, unpack_8_booleans

HEADER_MAGIC_NCHUNKS = 20
HEADER_MAGIC_1CHUNK = 14
PROGRESSIVE_MIN_CHUNK_BYTES = 64


@dataclass
class Sperr3DHeader:
    major_version: int = 0
    is_portion: bool = False
    is_3d: bool = False
    is_float: bool = False
    multi_chunk: bool = False
    vol_dims: Tuple[int, int, int] = (0, 0, 0)
    chunk_dims: Tuple[int, int, int] = (0, 0, 0)
    header_len: int = 0
    stream_len: int = 0
    chunk_offsets: List[int] = field(default_factory=list)  # [off, len, off, len...]


def generate_header(
    vol_dims: Tuple[int, int, int],
    chunk_dims: Tuple[int, int, int],
    stream_lens: List[int],
    is_float: bool,
) -> bytes:
    chunks = chunk_volume(vol_dims, chunk_dims)
    num_chunks = len(chunks)
    assert num_chunks == len(stream_lens)
    multi = num_chunks > 1

    out = bytearray()
    out.append(SPERR_VERSION_MAJOR)
    out.append(
        pack_8_booleans([False, True, is_float, multi, False, False, False, False])
    )
    out += struct.pack("<III", *vol_dims)
    if multi:
        out += struct.pack("<HHH", *chunk_dims)
    for ln in stream_lens:
        assert ln <= 0xFFFFFFFF
        out += struct.pack("<I", ln)
    expect = (HEADER_MAGIC_NCHUNKS if multi else HEADER_MAGIC_1CHUNK) + 4 * num_chunks
    assert len(out) == expect
    return bytes(out)


class StreamError(ValueError):
    """Raised for malformed or unsupported SPERR container streams."""


def parse_header(stream: bytes) -> Sperr3DHeader:
    from .. import SPERR_VERSION_MAJOR

    if len(stream) < HEADER_MAGIC_1CHUNK + 4:
        raise StreamError(f"stream too short for a container header: {len(stream)}B")
    h = Sperr3DHeader()
    h.major_version = stream[0]
    if h.major_version != SPERR_VERSION_MAJOR:
        raise StreamError(
            f"unsupported stream version {h.major_version} "
            f"(expected {SPERR_VERSION_MAJOR})"
        )
    b8 = unpack_8_booleans(stream[1])
    h.is_portion, h.is_3d, h.is_float, h.multi_chunk = b8[0], b8[1], b8[2], b8[3]
    if not h.is_3d:
        raise StreamError("not a 3D container stream (2D streams carry a 10-byte header)")
    pos = 2
    vx, vy, vz = struct.unpack_from("<III", stream, pos)
    pos += 12
    if vx == 0 or vy == 0 or vz == 0:
        raise StreamError(f"invalid volume dims in header: {(vx, vy, vz)}")
    h.vol_dims = (vx, vy, vz)
    if h.multi_chunk:
        cx, cy, cz = struct.unpack_from("<HHH", stream, pos)
        pos += 6
        h.chunk_dims = (cx, cy, cz)
    else:
        h.chunk_dims = h.vol_dims

    chunks = chunk_volume(h.vol_dims, h.chunk_dims)
    num_chunks = len(chunks)
    h.header_len = (
        HEADER_MAGIC_NCHUNKS if h.multi_chunk else HEADER_MAGIC_1CHUNK
    ) + 4 * num_chunks
    if len(stream) < h.header_len:
        raise StreamError(
            f"stream shorter than its header: {len(stream)} < {h.header_len}"
        )
    lens = struct.unpack_from(f"<{num_chunks}I", stream, pos)
    h.stream_len = h.header_len + sum(lens)
    offsets: List[int] = []
    off = h.header_len
    for ln in lens:
        offsets += [off, ln]
        off += ln
    h.chunk_offsets = offsets
    return h


def _progressive_header(stream: bytes, pct: int) -> Tuple[bytes, List[int]]:
    """New (portion-flagged) header + [off, len] pairs to extract."""
    h = parse_header(stream)
    if pct == 0 or pct >= 100:
        return bytes(stream[: h.header_len]), list(h.chunk_offsets)

    offsets = list(h.chunk_offsets)
    nchunks = len(offsets) // 2
    for i in range(nchunks):
        orig = offsets[i * 2 + 1]
        if orig > PROGRESSIVE_MIN_CHUNK_BYTES:
            req = int(pct / 100.0 * orig)
            offsets[i * 2 + 1] = max(PROGRESSIVE_MIN_CHUNK_BYTES, req)

    new_header = bytearray(stream[: h.header_len])
    new_header[0] = SPERR_VERSION_MAJOR
    b8 = unpack_8_booleans(new_header[1])
    b8[0] = True  # mark as a portion
    new_header[1] = pack_8_booleans(b8)
    pos = h.header_len - 4 * nchunks
    for i in range(nchunks):
        struct.pack_into("<I", new_header, pos, offsets[i * 2 + 1])
        pos += 4
    return bytes(new_header), offsets


def progressive_truncate(stream: bytes, pct: int) -> bytes:
    """Truncate an in-memory container stream to ~pct% of each chunk."""
    header_new, sections = _progressive_header(stream, pct)
    out = bytearray(header_new)
    for i in range(len(sections) // 2):
        off, ln = sections[i * 2], sections[i * 2 + 1]
        assert off + ln <= len(stream)
        out += stream[off : off + ln]
    return bytes(out)


def progressive_read(filename: str, pct: int) -> bytes:
    """Read only the needed portions of a container file from disk."""
    with open(filename, "rb") as f:
        magic = f.read(HEADER_MAGIC_NCHUNKS)
        hlen = get_header_len(magic)
        f.seek(0)
        header = f.read(hlen)
        header_new, sections = _progressive_header(header, pct)
        out = bytearray(header_new)
        for i in range(len(sections) // 2):
            off, ln = sections[i * 2], sections[i * 2 + 1]
            f.seek(off)
            chunk = f.read(ln)
            assert len(chunk) == ln
            out += chunk
    return bytes(out)


def get_header_len(magic20: bytes) -> int:
    b8 = unpack_8_booleans(magic20[1])
    multi = b8[3]
    vx, vy, vz = struct.unpack_from("<III", magic20, 2)
    if multi:
        cx, cy, cz = struct.unpack_from("<HHH", magic20, 14)
        cdim = (cx, cy, cz)
    else:
        cdim = (vx, vy, vz)
    num_chunks = len(chunk_volume((vx, vy, vz), cdim))
    return (HEADER_MAGIC_NCHUNKS if multi else HEADER_MAGIC_1CHUNK) + 4 * num_chunks


# ---------------------------------------------------------------------------
# 2D file header (10 bytes) used by the sperr2d CLI and the C API.
# ---------------------------------------------------------------------------
def generate_2d_header(dims: Tuple[int, int], is_float: bool) -> bytes:
    out = bytearray()
    out.append(SPERR_VERSION_MAJOR)
    out.append(
        pack_8_booleans([False, False, is_float, False, False, False, False, False])
    )
    out += struct.pack("<II", dims[0], dims[1])
    return bytes(out)


def parse_2d_header(stream: bytes) -> Tuple[Tuple[int, int], bool]:
    b8 = unpack_8_booleans(stream[1])
    assert not b8[1], "stream is 3D, not 2D"
    nx, ny = struct.unpack_from("<II", stream, 2)
    return (nx, ny), b8[2]
