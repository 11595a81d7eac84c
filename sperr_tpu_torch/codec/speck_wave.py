"""Stream assembly of the wavefront SPECK coder (the port's copy of what
``stitch_3d`` in sperr_tpu/codec/speck_wave.py reaches when the device
supplies every segment).

Every bit the serial coder emits falls in one of three per-pass segments, in
this order (SPECK_INT.cpp:146-158):

    [LIP walk] [LIS set walk (with embedded newly-exposed pixel bits)]
    [refinement pass]

The device computes all three for every pass (ops/wave_pack.py); the host
concatenates them pass by pass and writes the 9-byte SPECK header.  The
original's host-side schedule, partition tree and set walk, which fill in
segments that are not supplied, are not copied: here all three are
required.
"""

from __future__ import annotations

from typing import List

import numpy as np


def stitch_3d(num_bp: int, lip_segments, lis_segments, ref_segments, budget_bits: int = 0) -> bytes:
    """Assemble the final stream from the per-pass 0/1 segments computed on
    a device: a pure per-pass concatenation, no tree data needed.  The
    original's ``pmsb``, ``signs``, ``node_max``, ``dims``, ``mags`` and
    ``s_lin`` arguments, which only its host walk reads, are not copied."""
    budget = (budget_bits + 7) // 8 * 8 if budget_bits else None

    segments: List[np.ndarray] = []
    total = 0
    stop = False

    for p in range(num_bp):
        lip_bits = lip_segments[p]
        lis_bits = lis_segments[p]

        segments.append(lip_bits)
        segments.append(lis_bits)
        total += lip_bits.size + lis_bits.size
        if budget is not None and total >= budget:
            stop = True
        if not stop:
            rbits = ref_segments[p]
            segments.append(rbits)
            total += rbits.size
            if budget is not None and total >= budget:
                stop = True
        if stop:
            break

    allbits = np.concatenate(segments) if segments else np.empty(0, np.uint8)
    return _pack_stream(allbits, total, num_bp, budget)


def _pack_stream(
    bits: np.ndarray, total_bits: int, num_bp: int, budget=None
) -> bytes:
    """9-byte header {num_bitplanes u8, total_bits u64} + packed bits
    (bitstream_definition.txt:1-3); budget truncates packed bytes only."""
    emit = total_bits if budget is None else min(total_bits, budget)
    packed = np.packbits(bits[:emit], bitorder="little").tobytes()
    header = bytes([num_bp]) + int(total_bits).to_bytes(8, "little")
    return header + packed
