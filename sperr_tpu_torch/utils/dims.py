"""Dimension / transform-level arithmetic shared by every layer of the codec.

These are pure host-side functions: they compute *static* quantities (transform
levels, subband lengths, chunk decompositions) that parameterize the TPU
kernels and the entropy coder.  Semantics mirror the reference implementation
(see NCAR/SPERR src/sperr_helper.cpp:36-146,542-592) so that bitstreams
stay interchangeable.

The port's copy of sperr_tpu/utils/dims.py; only its imports differ.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

# Maximum number of wavelet transform levels, and the minimum signal length
# that admits one level of transform (reference: sperr_helper.cpp:36-49).
MAX_XFORM_LEVELS = 6
MIN_LEN_ONE_LEVEL = 9


def num_of_xforms(length: int) -> int:
    """How many wavelet transform levels a signal of `length` undergoes."""
    assert length > 0
    num = 0
    while length >= MIN_LEN_ONE_LEVEL:
        num += 1
        length -= length // 2
    return min(num, MAX_XFORM_LEVELS)


def num_of_partitions(length: int) -> int:
    """How many binary partitions a length admits (len 0/1 -> 0, 2 -> 1, ...)."""
    num = 0
    while length > 1:
        num += 1
        length -= length // 2
    return num


def calc_approx_detail_len(orig_len: int, lev: int) -> Tuple[int, int]:
    """(approx, detail) lengths after `lev` levels; odd lengths favor approx."""
    low = orig_len
    high = 0
    for _ in range(lev):
        high = low // 2
        low -= high
    return low, high


def can_use_dyadic(dims: Tuple[int, int, int]) -> Optional[int]:
    """Return dyadic 3D decomposition level count, or None for wavelet-packet.

    Reference: sperr_helper.cpp:51-68.  1D/2D dims always return None.
    """
    if dims[2] < 2 or dims[1] < 2:
        return None
    xy = num_of_xforms(min(dims[0], dims[1]))
    z = num_of_xforms(dims[2])
    if xy == z or (xy >= 5 and z >= 5):
        return min(xy, z)
    return None


def coarsened_resolutions(full_dims: Tuple[int, int, int]) -> List[Tuple[int, int, int]]:
    """All coarse resolutions available for multi-resolution decoding."""
    res: List[Tuple[int, int, int]] = []
    if full_dims[2] > 1:  # 3D
        dyadic = can_use_dyadic(full_dims)
        if dyadic is not None:
            for lev in range(dyadic, 0, -1):
                x, _ = calc_approx_detail_len(full_dims[0], lev)
                y, _ = calc_approx_detail_len(full_dims[1], lev)
                z, _ = calc_approx_detail_len(full_dims[2], lev)
                res.append((x, y, z))
    else:  # 2D
        xy = num_of_xforms(min(full_dims[0], full_dims[1]))
        for lev in range(xy, 0, -1):
            x, _ = calc_approx_detail_len(full_dims[0], lev)
            y, _ = calc_approx_detail_len(full_dims[1], lev)
            res.append((x, y, 1))
    return res


def coarsened_resolutions_chunked(
    vdim: Tuple[int, int, int], cdim: Tuple[int, int, int]
) -> List[Tuple[int, int, int]]:
    """Coarse resolutions of a chunked volume (empty unless evenly divisible)."""
    if any(vdim[i] % cdim[i] != 0 for i in range(3)):
        return []
    nx, ny, nz = (vdim[i] // cdim[i] for i in range(3))
    return [(x * nx, y * ny, z * nz) for (x, y, z) in coarsened_resolutions(cdim)]


def chunk_volume(
    vol_dim: Tuple[int, int, int], chunk_dim: Tuple[int, int, int]
) -> List[Tuple[int, int, int, int, int, int]]:
    """Decompose a volume into chunks: (x0, lenx, y0, leny, z0, lenz) tuples.

    A trailing remainder longer than half a chunk becomes its own segment;
    otherwise it merges into the previous one (reference: sperr_helper.cpp:542).
    Chunk order is x-fastest, then y, then z.
    """
    n_segs = [0, 0, 0]
    for i in range(3):
        n_segs[i] = vol_dim[i] // chunk_dim[i]
        if (vol_dim[i] % chunk_dim[i]) > (chunk_dim[i] // 2):
            n_segs[i] += 1
        if n_segs[i] == 0:
            n_segs[i] = 1

    tics = []
    for i in range(3):
        t = [k * chunk_dim[i] for k in range(n_segs[i])] + [vol_dim[i]]
        tics.append(t)

    chunks = []
    for z in range(n_segs[2]):
        for y in range(n_segs[1]):
            for x in range(n_segs[0]):
                chunks.append(
                    (
                        tics[0][x],
                        tics[0][x + 1] - tics[0][x],
                        tics[1][y],
                        tics[1][y + 1] - tics[1][y],
                        tics[2][z],
                        tics[2][z + 1] - tics[2][z],
                    )
                )
    return chunks
