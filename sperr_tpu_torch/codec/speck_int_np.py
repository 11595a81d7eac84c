"""Bit-exact SPECK integer bitplane coders (1D / 2D / 3D), host engine.

This is the *reference engine* of the framework: a from-scratch NumPy
implementation of SPECK set-partitioning whose emitted bit sequence is
byte-identical to NCAR/SPERR streams (see NCAR/SPERR src/SPECK_INT.cpp,
SPECK{1,2,3}D_INT*.cpp for the normative behavior).  It favors clarity and
vectorizes the regular passes (LIP walk, refinement); the recursive sorting
pass stays in Python.  The production path uses the native C++ engine in
sperr_tpu/runtime/native (same streams, much faster); this module is the
ground truth that engine is validated against.

Stream layout (bitstream_definition.txt):
  header: num_bitplanes (u8) | num_useful_bits (u64 LE)
  body:   packed bits, LSB-first
Significance invariants:
  * threshold ladder: largest power of two <= max coefficient
  * a set is significant iff any element >= threshold (== msb test)
  * "last sibling needs no bit" when no earlier sibling was significant
  * decoder reconstruction: new point -> 2T - T//2 - 1, refinement +-T//2

The port's copy of sperr_tpu/codec/speck_int_np.py; only its imports differ.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..utils.dims import (
    calc_approx_detail_len,
    can_use_dyadic,
    num_of_partitions,
    num_of_xforms,
)
from .bitio import BitReader, BitWriter

HEADER_SIZE = 9
_UINT_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}


def speck_int_get_num_bitplanes(stream: bytes) -> int:
    return stream[0]


def speck_int_stream_full_len(stream: bytes) -> int:
    """Total byte length (header included) a complete stream would have."""
    (num_bits,) = struct.unpack_from("<Q", stream, 1)
    return HEADER_SIZE + (num_bits + 7) // 8


def uint_width_for_num_bitplanes(num_bitplanes: int) -> int:
    if num_bitplanes <= 8:
        return 8
    if num_bitplanes <= 16:
        return 16
    if num_bitplanes <= 32:
        return 32
    return 64


class _SpeckIntBase:
    """State and passes shared by the 1D/2D/3D coders."""

    def __init__(self, uint_width: int):
        assert uint_width in (8, 16, 32, 64)
        self.uint_width = uint_width
        self.dims: Tuple[int, int, int] = (0, 0, 0)
        self.budget: Optional[int] = None  # in bits, already rounded up to x8
        self.coeff: Optional[np.ndarray] = None  # uint64 working copy
        self.signs: Optional[np.ndarray] = None  # bool, True == non-negative
        self.num_bitplanes = 0
        self.total_bits = 0
        self.avail_bits = 0
        self.threshold = 0  # python int
        self.lip_mask: Optional[np.ndarray] = None
        self.lsp_mask: Optional[np.ndarray] = None
        self.lsp_new: List[int] = []
        self.bw: Optional[BitWriter] = None
        self.br: Optional[BitReader] = None
        self.encoding = False

    # ---- configuration --------------------------------------------------
    def set_dims(self, dims: Tuple[int, int, int]) -> None:
        self.dims = tuple(dims)

    def set_budget(self, bits: int) -> None:
        if bits == 0:
            self.budget = None
        else:
            self.budget = bits + (-bits) % 8

    def use_coeffs(self, coeffs: np.ndarray, signs: np.ndarray) -> None:
        # Apply the declared integer width (wraparound), then widen to u64.
        narrowed = np.asarray(coeffs).astype(_UINT_DTYPES[self.uint_width])
        self.coeff = narrowed.astype(np.uint64)
        self.signs = np.asarray(signs).astype(bool).copy()

    # ---- bitstream ------------------------------------------------------
    def use_bitstream(self, stream: bytes) -> None:
        assert len(stream) >= HEADER_SIZE
        self.num_bitplanes = stream[0]
        (self.total_bits,) = struct.unpack_from("<Q", stream, 1)
        avail = (len(stream) - HEADER_SIZE) * 8
        self.avail_bits = min(avail, self.total_bits)
        self.br = BitReader(stream[HEADER_SIZE:], self.avail_bits, self.total_bits)

    def encoded_bitstream_len(self) -> int:
        bits = self.total_bits
        if self.budget is not None:
            bits = min(self.budget, bits)
        return HEADER_SIZE + (bits + 7) // 8

    def encoded_bitstream(self) -> bytes:
        bits = self.total_bits
        if self.budget is not None:
            bits = min(self.budget, bits)
        header = struct.pack("<BQ", self.num_bitplanes, self.total_bits)
        return header + self.bw.pack(bits)

    # ---- subclass hooks ---------------------------------------------------
    def _initialize_lists(self) -> None:
        raise NotImplementedError

    def _sorting_pass(self) -> None:
        raise NotImplementedError

    def _clean_lis(self) -> None:
        raise NotImplementedError

    def _refinement_extra(self) -> None:
        """3D/2D encoders subtract the threshold from newly-found points here."""
        if self.encoding and self.lsp_new:
            idx = np.array(self.lsp_new, dtype=np.int64)
            self.coeff[idx] -= np.uint64(self.threshold)

    # ---- top-level actions ----------------------------------------------
    def encode(self) -> None:
        self.encoding = True
        self._initialize_lists()
        n = int(np.prod(self.dims))
        assert self.coeff is not None and self.coeff.size == n
        self.lsp_mask = np.zeros(n, dtype=bool)
        self.lsp_new = []
        self.lip_mask = np.zeros(n, dtype=bool)
        self.bw = BitWriter()
        self.total_bits = 0

        max_coeff = int(self.coeff.max()) if n else 0
        if max_coeff == 0:
            self.num_bitplanes = 0
            return

        self.num_bitplanes = 1
        self.threshold = 1
        while max_coeff - self.threshold >= self.threshold:
            self.threshold *= 2
            self.num_bitplanes += 1

        budget = self.budget if self.budget is not None else float("inf")
        for _ in range(self.num_bitplanes):
            self._sorting_pass()
            if self.bw.wtell() >= budget:
                break
            self._refinement_pass_encode()
            if self.bw.wtell() >= budget:
                break
            self.threshold //= 2
            self._clean_lis()

        self.total_bits = self.bw.wtell()

    def decode(self) -> None:
        self.encoding = False
        self._initialize_lists()
        n = int(np.prod(self.dims))
        self.coeff = np.zeros(n, dtype=np.uint64)
        self.signs = np.ones(n, dtype=bool)
        self.lsp_mask = np.zeros(n, dtype=bool)
        self.lsp_new = []
        self.lip_mask = np.zeros(n, dtype=bool)

        if self.num_bitplanes == 0:
            assert self.total_bits == 0
            return

        self.threshold = 1 << (self.num_bitplanes - 1)
        for _ in range(self.num_bitplanes):
            self._sorting_pass()
            if self.br.rtell() >= self.avail_bits:
                break
            if not self._refinement_pass_decode():
                break
            if self.br.rtell() >= self.avail_bits:
                break
            self.threshold //= 2
            self._clean_lis()

        # Initialize points found by a final sorting pass that was cut short.
        if self.lsp_new:
            t = self.threshold
            init_val = t + t - t // 2 - 1
            idx = np.array(self.lsp_new, dtype=np.int64)
            self.coeff[idx] = np.uint64(init_val)
            self.lsp_new = []

    # ---- refinement passes ------------------------------------------------
    def _refinement_pass_encode(self) -> None:
        idx = np.flatnonzero(self.lsp_mask)
        if idx.size:
            t = np.uint64(self.threshold)
            o1 = self.coeff[idx] >= t
            self.coeff[idx] -= np.where(o1, t, np.uint64(0))
            self.bw.wbits(o1)
        self._refinement_extra()
        if self.lsp_new:
            self.lsp_mask[np.array(self.lsp_new, dtype=np.int64)] = True
            self.lsp_new = []

    def _refinement_pass_decode(self) -> bool:
        """Returns False when the available bits were exhausted mid-pass."""
        idx = np.flatnonzero(self.lsp_mask)
        exhausted = False
        if idx.size:
            remaining = self.avail_bits - self.br.rtell()
            k = min(idx.size, remaining)
            bits = self.br.rbits(k).astype(bool)
            sel = idx[:k]
            t = self.threshold
            if t >= 2:
                half = np.uint64(t // 2)
                self.coeff[sel] = np.where(
                    bits, self.coeff[sel] + half, self.coeff[sel] - half
                )
            else:
                self.coeff[sel] += bits.astype(np.uint64)
            exhausted = k < idx.size or self.br.rtell() == self.avail_bits

        t = self.threshold
        init_val = np.uint64(t + t - t // 2 - 1)
        if self.lsp_new:
            new_idx = np.array(self.lsp_new, dtype=np.int64)
            self.coeff[new_idx] = init_val
            self.lsp_mask[new_idx] = True
            self.lsp_new = []
        return not exhausted

    # ---- shared pixel handling -------------------------------------------
    def _emit_pixel_sig(self, idx: int, is_sig: bool, output: bool) -> bool:
        """Encoder-side: emit significance/sign for a LIP pixel. Returns sig."""
        if output:
            self.bw.wbit(is_sig)
        if is_sig:
            self.bw.wbit(bool(self.signs[idx]))
            self.lsp_new.append(idx)
            self.lip_mask[idx] = False
        return is_sig

    def _read_pixel_sig(self, idx: int, read: bool) -> bool:
        is_sig = bool(self.br.rbit()) if read else True
        if is_sig:
            self.signs[idx] = bool(self.br.rbit())
            self.lsp_new.append(idx)
            self.lip_mask[idx] = False
        return is_sig


# ---------------------------------------------------------------------------
# 3D coder: octree partitioning over (x fastest, then y, then z) layout.
# ---------------------------------------------------------------------------
class SpeckInt3D(_SpeckIntBase):
    def __init__(self, uint_width: int):
        super().__init__(uint_width)
        self.lis: List[List[list]] = []  # sets: [sx, sy, sz, lx, ly, lz]

    # view of coeff as (z, y, x)
    def _vol(self) -> np.ndarray:
        nx, ny, nz = self.dims
        return self.coeff.reshape(nz, ny, nx)

    def _initialize_lists(self) -> None:
        nx, ny, nz = self.dims
        num_levels = (
            num_of_partitions(nx) + num_of_partitions(ny) + num_of_partitions(nz) + 1
        )
        self.lis = [[] for _ in range(num_levels)]

        big = [0, 0, 0, nx, ny, nz]
        curr_lev = 0
        dyadic = can_use_dyadic(self.dims)
        if dyadic is not None:
            for _ in range(dyadic):
                subsets, next_lev = _partition_xyz(big, curr_lev)
                big = subsets[0]
                for s in subsets[1:]:
                    self.lis[next_lev].append(s)
                curr_lev = next_lev
        else:
            xforms_xy = num_of_xforms(min(nx, ny))
            xforms_z = num_of_xforms(nz)
            xf = 0
            while xf < xforms_xy and xf < xforms_z:
                subsets, next_lev = _partition_xyz(big, curr_lev)
                big = subsets[0]
                for s in subsets[1:]:
                    self.lis[next_lev].append(s)
                curr_lev = next_lev
                xf += 1
            while xf < xforms_xy:
                subsets, next_lev = _partition_xy(big, curr_lev)
                big = subsets[0]
                for s in subsets[1:]:
                    self.lis[next_lev].append(s)
                curr_lev = next_lev
                xf += 1
            while xf < xforms_z:
                subsets, next_lev = _partition_z(big, curr_lev)
                big = subsets[0]
                self.lis[next_lev].append(subsets[1])
                curr_lev = next_lev
                xf += 1

        self.lis[curr_lev].insert(0, big)

    def _clean_lis(self) -> None:
        for lev in range(len(self.lis)):
            self.lis[lev] = [s for s in self.lis[lev] if s[3] != 0]

    def _set_is_sig(self, s: list) -> bool:
        sx, sy, sz, lx, ly, lz = s
        v = self._vol()[sz : sz + lz, sy : sy + ly, sx : sx + lx]
        return bool((v >= np.uint64(self.threshold)).any())

    def _sorting_pass(self) -> None:
        for idx in np.flatnonzero(self.lip_mask):
            self._process_p(int(idx), _Counter(), True)
        for lev in range(len(self.lis) - 1, -1, -1):
            lst = self.lis[lev]
            i = 0
            while i < len(lst):
                self._process_s(lev, i, _Counter(), True)
                i += 1

    def _process_p(self, idx: int, counter, decide: bool) -> None:
        if self.encoding:
            is_sig = bool(self.coeff[idx] >= np.uint64(self.threshold)) if decide else True
            sig = self._emit_pixel_sig(idx, is_sig, decide)
        else:
            sig = self._read_pixel_sig(idx, decide)
        if sig:
            counter.n += 1

    def _process_s(self, lev: int, i: int, counter, decide: bool) -> None:
        s = self.lis[lev][i]
        if self.encoding:
            is_sig = self._set_is_sig(s) if decide else True
            if decide:
                self.bw.wbit(is_sig)
        else:
            is_sig = bool(self.br.rbit()) if decide else True
        if is_sig:
            counter.n += 1
            self._code_s(lev, i)
            s[3] = 0  # mark empty

    def _code_s(self, lev: int, i: int) -> None:
        s = list(self.lis[lev][i])
        sx, sy, sz, lx, ly, lz = s
        nx, ny, _ = self.dims

        if lx == 2 and ly == 2 and lz == 2:
            # 2x2x2 tail: eight pixels in x-fastest order; last one's bit is
            # skipped when it alone must be significant.
            counter = _Counter()
            base = sz * nx * ny + sy * nx + sx
            offsets = [
                0, 1, nx, nx + 1,
                nx * ny, nx * ny + 1, nx * ny + nx, nx * ny + nx + 1,
            ]
            for k, off in enumerate(offsets):
                idx = base + off
                need = True if k < 7 else (counter.n != 0)
                self.lip_mask[idx] = True
                self._process_p(idx, counter, need)
            return

        subsets, next_lev = _partition_xyz(s, lev)
        nonempty = [t for t in subsets if t[3] * t[4] * t[5] != 0]
        counter = _Counter()
        for k, t in enumerate(nonempty):
            need = counter.n != 0 or k + 1 != len(nonempty)
            if t[3] * t[4] * t[5] == 1:
                idx = t[2] * nx * ny + t[1] * nx + t[0]
                self.lip_mask[idx] = True
                self._process_p(idx, counter, need)
            else:
                self.lis[next_lev].append(t)
                self._process_s(next_lev, len(self.lis[next_lev]) - 1, counter, need)


class _Counter:
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def __ne__(self, other):  # allows `counter != 0` style checks
        return self.n != other

    def __eq__(self, other):
        return self.n == other


def _split2(length: int) -> Tuple[int, int]:
    return length - length // 2, length // 2


def _partition_xyz(s: list, lev: int):
    sx, sy, sz, lx, ly, lz = s
    ax, dx = _split2(lx)
    ay, dy = _split2(ly)
    az, dz = _split2(lz)
    lev += (dx != 0) + (dy != 0) + (dz != 0)
    subs = [
        [sx, sy, sz, ax, ay, az],
        [sx + ax, sy, sz, dx, ay, az],
        [sx, sy + ay, sz, ax, dy, az],
        [sx + ax, sy + ay, sz, dx, dy, az],
        [sx, sy, sz + az, ax, ay, dz],
        [sx + ax, sy, sz + az, dx, ay, dz],
        [sx, sy + ay, sz + az, ax, dy, dz],
        [sx + ax, sy + ay, sz + az, dx, dy, dz],
    ]
    return subs, lev


def _partition_xy(s: list, lev: int):
    sx, sy, sz, lx, ly, lz = s
    ax, dx = _split2(lx)
    ay, dy = _split2(ly)
    lev += (dx != 0) + (dy != 0)
    subs = [
        [sx, sy, sz, ax, ay, lz],
        [sx + ax, sy, sz, dx, ay, lz],
        [sx, sy + ay, sz, ax, dy, lz],
        [sx + ax, sy + ay, sz, dx, dy, lz],
    ]
    return subs, lev


def _partition_z(s: list, lev: int):
    sx, sy, sz, lx, ly, lz = s
    az, dz = _split2(lz)
    if dz != 0:
        lev += 1
    subs = [
        [sx, sy, sz, lx, ly, az],
        [sx, sy, sz + az, lx, ly, dz],
    ]
    return subs, lev


# ---------------------------------------------------------------------------
# 2D coder: QccPack-style S sets plus the type-I "everything else" set.
# ---------------------------------------------------------------------------
class SpeckInt2D(_SpeckIntBase):
    def __init__(self, uint_width: int):
        super().__init__(uint_width)
        self.lis: List[List[list]] = []  # sets: [sx, sy, lx, ly]
        self.iset = [0, 0, 0, 0, 0]  # sx, sy, lx, ly, part_level

    def _plane(self) -> np.ndarray:
        nx, ny, _ = self.dims
        return self.coeff.reshape(ny, nx)

    def _initialize_lists(self) -> None:
        nx, ny, _ = self.dims
        num_levels = num_of_partitions(max(nx, ny)) + 1
        self.lis = [[] for _ in range(num_levels)]
        xforms = num_of_xforms(min(nx, ny))
        ax, _ = calc_approx_detail_len(nx, xforms)
        ay, _ = calc_approx_detail_len(ny, xforms)
        self.lis[xforms].append([0, 0, ax, ay])
        self.iset = [ax, ay, nx, ny, xforms]

    def _clean_lis(self) -> None:
        for lev in range(len(self.lis)):
            self.lis[lev] = [s for s in self.lis[lev] if s[2] != 0]

    def _set_is_sig(self, s: list) -> bool:
        sx, sy, lx, ly = s
        v = self._plane()[sy : sy + ly, sx : sx + lx]
        return bool((v >= np.uint64(self.threshold)).any())

    def _iset_is_sig(self) -> bool:
        nx, ny, _ = self.dims
        sx, sy = self.iset[0], self.iset[1]
        p = self._plane()
        t = np.uint64(self.threshold)
        if (p[sy:, :] >= t).any():
            return True
        return bool((p[:sy, sx:] >= t).any())

    def _sorting_pass(self) -> None:
        for idx in np.flatnonzero(self.lip_mask):
            self._process_p(int(idx), _Counter(), True)
        for lev in range(len(self.lis) - 1, -1, -1):
            lst = self.lis[lev]
            i = 0
            while i < len(lst):
                self._process_s(lev, i, _Counter(), True)
                i += 1
        self._process_i(True)

    def _process_p(self, idx: int, counter, decide: bool) -> None:
        if self.encoding:
            is_sig = bool(self.coeff[idx] >= np.uint64(self.threshold)) if decide else True
            sig = self._emit_pixel_sig(idx, is_sig, decide)
        else:
            sig = self._read_pixel_sig(idx, decide)
        if sig:
            counter.n += 1

    def _process_s(self, lev: int, i: int, counter, decide: bool) -> None:
        s = self.lis[lev][i]
        if self.encoding:
            is_sig = self._set_is_sig(s) if decide else True
            if decide:
                self.bw.wbit(is_sig)
        else:
            is_sig = bool(self.br.rbit()) if decide else True
        if is_sig:
            counter.n += 1
            self._code_s(lev, i)
            s[2] = 0

    def _process_i(self, decide: bool) -> None:
        if self.iset[4] <= 0:
            return
        if self.encoding:
            is_sig = self._iset_is_sig() if decide else True
            if decide:
                self.bw.wbit(is_sig)
        else:
            is_sig = bool(self.br.rbit()) if decide else True
        if is_sig:
            self._code_i()

    def _code_s(self, lev: int, i: int) -> None:
        sx, sy, lx, ly = self.lis[lev][i]
        nx = self.dims[0]
        ax, dx = _split2(lx)
        ay, dy = _split2(ly)
        # QccPack subset order: BR, BL, TR, TL (SPECK2D_INT.cpp:109-148).
        subs = [
            [sx + ax, sy + ay, dx, dy],
            [sx, sy + ay, ax, dy],
            [sx + ax, sy, dx, ay],
            [sx, sy, ax, ay],
        ]
        nonempty = [t for t in subs if t[2] * t[3] != 0]
        counter = _Counter()
        next_lev = lev + 1
        for k, t in enumerate(nonempty):
            need = counter.n != 0 or k + 1 != len(nonempty)
            if t[2] * t[3] == 1:
                idx = t[1] * nx + t[0]
                self.lip_mask[idx] = True
                self._process_p(idx, counter, need)
            else:
                self.lis[next_lev].append(t)
                self._process_s(next_lev, len(self.lis[next_lev]) - 1, counter, need)

    def _code_i(self) -> None:
        nx, ny, _ = self.dims
        part_lev = self.iset[4]
        ax, dx = calc_approx_detail_len(nx, part_lev)
        ay, dy = calc_approx_detail_len(ny, part_lev)
        # Subset order from m_partition_I: BR, TR, BL (SPECK2D_INT.cpp:151-185).
        subs = [
            [ax, ay, dx, dy],
            [ax, 0, dx, ay],
            [0, ay, ax, dy],
        ]
        self.iset[0] += dx
        self.iset[1] += dy
        self.iset[4] -= 1
        counter = _Counter()
        for t in subs:
            if t[2] * t[3] != 0:
                self.lis[part_lev].append(t)
                self._process_s(part_lev, len(self.lis[part_lev]) - 1, counter, True)
        self._process_i(counter.n != 0)


# ---------------------------------------------------------------------------
# 1D coder: binary partitioning with position-based significance inference.
# ---------------------------------------------------------------------------
_SIG, _INSIG, _DUNNO = 1, 0, 2


class SpeckInt1D(_SpeckIntBase):
    def __init__(self, uint_width: int):
        super().__init__(uint_width)
        self.lis: List[List[list]] = []  # sets: [start, length]

    def _initialize_lists(self) -> None:
        n = self.dims[0]
        # +1 slack level: zero-length sets produced by partitioning length-1
        # sets land one level deeper; an empty extra list emits nothing.
        # +2 slack: a length-1 set splits into [pixel, empty] one level deeper
        # than the partition count suggests (n == 1 needs 3 levels).
        num_levels = num_of_partitions(n) + 3
        self.lis = [[] for _ in range(num_levels)]
        subs, lev = _partition_1d([0, n], 0)
        self.lis[lev].append(subs[0])
        self.lis[lev].append(subs[1])

    def _clean_lis(self) -> None:
        for lev in range(len(self.lis)):
            self.lis[lev] = [s for s in self.lis[lev] if s[1] != 0]

    def _find_first_sig(self, s: list) -> Optional[int]:
        start, length = s
        seg = self.coeff[start : start + length] >= np.uint64(self.threshold)
        hits = np.flatnonzero(seg)
        return int(hits[0]) if hits.size else None

    def _sorting_pass(self) -> None:
        for idx in np.flatnonzero(self.lip_mask):
            self._process_p(int(idx), _DUNNO, _Counter(), True)
        for lev in range(len(self.lis) - 1, -1, -1):
            lst = self.lis[lev]
            i = 0
            while i < len(lst):
                self._process_s(lev, i, _DUNNO, _Counter(), True)
                i += 1

    def _process_p(self, idx: int, sig: int, counter, output: bool) -> None:
        if self.encoding:
            if sig == _DUNNO:
                is_sig = bool(self.coeff[idx] >= np.uint64(self.threshold))
            else:
                is_sig = sig == _SIG
            if output:
                self.bw.wbit(is_sig)
            if is_sig:
                counter.n += 1
                self.bw.wbit(bool(self.signs[idx]))
                self.coeff[idx] -= np.uint64(self.threshold)
                self.lsp_new.append(idx)
                self.lip_mask[idx] = False
        else:
            is_sig = bool(self.br.rbit()) if output else True
            if is_sig:
                counter.n += 1
                self.signs[idx] = bool(self.br.rbit())
                self.lsp_new.append(idx)
                self.lip_mask[idx] = False

    def _refinement_extra(self) -> None:
        # 1D encoder subtracts the threshold inline in _process_p.
        pass

    def _process_s(self, lev: int, i: int, sig: int, counter, output: bool) -> None:
        s = self.lis[lev][i]
        subset_sigs = [_DUNNO, _DUNNO]
        if self.encoding:
            if sig == _DUNNO:
                pos = self._find_first_sig(s)
                sig = _SIG if pos is not None else _INSIG
                if pos is not None:
                    if pos < s[1] - s[1] // 2:
                        subset_sigs = [_SIG, _DUNNO]
                    else:
                        subset_sigs = [_INSIG, _SIG]
            if output:
                self.bw.wbit(sig == _SIG)
            if sig == _SIG:
                counter.n += 1
                self._code_s(lev, i, subset_sigs)
                s[1] = 0
        else:
            is_sig = bool(self.br.rbit()) if output else True
            if is_sig:
                counter.n += 1
                self._code_s(lev, i, subset_sigs)
                s[1] = 0

    def _code_s(self, lev: int, i: int, subset_sigs: list) -> None:
        subs, next_lev = _partition_1d(self.lis[lev][i], lev)
        counter = _Counter()
        output = True

        s0 = subs[0]
        if s0[1] == 1:
            self.lip_mask[s0[0]] = True
            self._process_p(s0[0], subset_sigs[0], counter, output)
        else:
            self.lis[next_lev].append(s0)
            self._process_s(next_lev, len(self.lis[next_lev]) - 1, subset_sigs[0], counter, output)

        if counter.n == 0:
            output = False
            subset_sigs[1] = _SIG
        s1 = subs[1]
        if s1[1] == 1:
            self.lip_mask[s1[0]] = True
            self._process_p(s1[0], subset_sigs[1], counter, output)
        else:
            self.lis[next_lev].append(s1)
            self._process_s(next_lev, len(self.lis[next_lev]) - 1, subset_sigs[1], counter, output)


def _partition_1d(s: list, lev: int):
    start, length = s
    a, d = _split2(length)
    return [[start, a], [start + a, d]], lev + 1


# ---------------------------------------------------------------------------
# Convenience constructors
# ---------------------------------------------------------------------------
def make_encoder(ndim: int, uint_width: int) -> _SpeckIntBase:
    return {1: SpeckInt1D, 2: SpeckInt2D, 3: SpeckInt3D}[ndim](uint_width)


def make_decoder(ndim: int, uint_width: int) -> _SpeckIntBase:
    return {1: SpeckInt1D, 2: SpeckInt2D, 3: SpeckInt3D}[ndim](uint_width)
