"""The partition tree and stream assembly of the wavefront SPECK coder (the
port's copy of the parts of sperr_tpu/codec/speck_wave.py that the device
encoder needs: the static partition tree ``build_tree`` with its helpers,
and ``stitch_3d`` in the form it takes when the device supplies every
segment).

Every bit the serial coder emits falls in one of three per-pass segments, in
this order (SPECK_INT.cpp:146-158):

    [LIP walk] [LIS set walk (with embedded newly-exposed pixel bits)]
    [refinement pass]

The device computes all three for every pass (ops/wave_pack.py); the host
concatenates them pass by pass and writes the 9-byte SPECK header.  The
partition tree (morton layout, child tables) is a static function of the
dims, built once with a vectorized BFS and cached; it reproduces the
reference's dyadic / wavelet-packet initialization (SPECK3D_INT.cpp:22-97)
and x-fastest octant order (:214-326), and the device indices of chunks that
are not power-of-two cubes are made from it (ops/speck.py, ops/speck_lis.py).
The original's host-side schedule and set walk, which fill in segments that
are not supplied, are not copied: here all three are required.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils.dims import can_use_dyadic, num_of_partitions, num_of_xforms

_NEVER = 0x7FFF  # "pass" value larger than any real pass (num_bp <= 64)


# ---------------------------------------------------------------------------
# Static partition tree
# ---------------------------------------------------------------------------
class Tree:
    """Static 3D SPECK partition forest for one `dims` (cached).

    Nodes are sets with >= 2 elements, plus the initial root sets (which may
    be single pixels for degenerate dims).  Every pixel appears exactly once
    as a singleton child in the child table.
    """

    __slots__ = (
        "dims", "n", "nlevels",
        # node arrays
        "node_level", "node_parent", "node_ch_start", "node_ch_count",
        "node_depth_ranges",
        # child table: parent-major, partition order
        "ch_is_pixel", "ch_ref",
        # pixel slots
        "px_linear", "px_parent",
        # roots, in the morton-assignment order (finest list first)
        "root_ids", "root_levels", "big_level", "big_pos",
    )


def _initial_sets(nx: int, ny: int, nz: int):
    """Replicates the reference's list initialization exactly
    (SPECK3D_INT.cpp:22-97): returns (sets, big, big_level) where `sets` is a
    list of (sx,sy,sz,lx,ly,lz,level) in push order and `big` is prepended to
    its level's list."""

    def split2(l):
        return l - l // 2, l // 2

    def part_xyz(s, lev):
        sx, sy, sz, lx, ly, lz = s
        ax, dx = split2(lx)
        ay, dy = split2(ly)
        az, dz = split2(lz)
        nl = lev + (dx != 0) + (dy != 0) + (dz != 0)
        x0, x1, y0, y1, z0, z1 = sx, sx + ax, sy, sy + ay, sz, sz + az
        subs = [
            (x0, y0, z0, ax, ay, az), (x1, y0, z0, dx, ay, az),
            (x0, y1, z0, ax, dy, az), (x1, y1, z0, dx, dy, az),
            (x0, y0, z1, ax, ay, dz), (x1, y0, z1, dx, ay, dz),
            (x0, y1, z1, ax, dy, dz), (x1, y1, z1, dx, dy, dz),
        ]
        return subs, nl

    pushed: List[Tuple] = []  # (set6, level) in push order
    big = (0, 0, 0, nx, ny, nz)
    cur = 0
    dy_lev = can_use_dyadic((nx, ny, nz))
    if dy_lev is not None:
        for _ in range(dy_lev):
            subs, nl = part_xyz(big, cur)
            big = subs[0]
            for k in range(1, 8):
                pushed.append((subs[k], nl))
            cur = nl
    else:
        xf_xy = num_of_xforms(min(nx, ny))
        xf_z = num_of_xforms(nz)
        xf = 0
        while xf < xf_xy and xf < xf_z:
            subs, nl = part_xyz(big, cur)
            big = subs[0]
            for k in range(1, 8):
                pushed.append((subs[k], nl))
            cur = nl
            xf += 1
        while xf < xf_xy:  # split X and Y only
            sx, sy, sz, lx, ly, lz = big
            ax, dx = split2(lx)
            ay, dy = split2(ly)
            nl = cur + (dx != 0) + (dy != 0)
            pushed.append(((sx + ax, sy, sz, dx, ay, lz), nl))
            pushed.append(((sx, sy + ay, sz, ax, dy, lz), nl))
            pushed.append(((sx + ax, sy + ay, sz, dx, dy, lz), nl))
            big = (sx, sy, sz, ax, ay, lz)
            cur = nl
            xf += 1
        while xf < xf_z:  # split Z only
            sx, sy, sz, lx, ly, lz = big
            az, dz = split2(lz)
            nl = cur + (dz != 0)
            pushed.append(((sx, sy, sz + az, lx, ly, dz), nl))
            big = (sx, sy, sz, lx, ly, az)
            cur = nl
            xf += 1
    return pushed, big, cur


def _children_of(sx, sy, sz, lx, ly, lz, morton, level):
    """Vectorized octant partition of a batch of nodes (x-fastest order).
    Returns per-child field arrays of shape [K, 8] plus nelem and level."""
    K = sx.size
    ax, dx = lx - lx // 2, lx // 2
    ay, dy = ly - ly // 2, ly // 2
    az, dz = lz - lz // 2, lz // 2

    def oct8(lo, hi_start, hi, axis):
        out = np.empty((K, 8), dtype=np.int32)
        if axis == 0:  # x fastest: pattern lo hi lo hi ...
            out[:, 0::2] = lo[:, None]
            out[:, 1::2] = hi[:, None]
        elif axis == 1:  # y: lo lo hi hi lo lo hi hi
            out[:, [0, 1, 4, 5]] = lo[:, None]
            out[:, [2, 3, 6, 7]] = hi[:, None]
        else:  # z: first 4 lo, last 4 hi
            out[:, :4] = lo[:, None]
            out[:, 4:] = hi[:, None]
        return out

    csx = oct8(sx, None, (sx + ax), 0)
    clx = oct8(ax, None, dx, 0)
    csy = oct8(sy, None, (sy + ay), 1)
    cly = oct8(ay, None, dy, 1)
    csz = oct8(sz, None, (sz + az), 2)
    clz = oct8(az, None, dz, 2)
    ne = (clx * cly).astype(np.int64) * clz
    clev = (level + (dx != 0) + (dy != 0) + (dz != 0)).astype(level.dtype)
    # morton: parent morton + exclusive prefix of child sizes (x-fastest)
    cm = morton[:, None] + np.cumsum(ne, axis=1) - ne
    return csx, csy, csz, clx, cly, clz, ne, cm, clev


_TREES: Dict[Tuple[int, int, int], Tree] = {}


def build_tree(dims: Tuple[int, int, int]) -> Tree:
    key = tuple(int(d) for d in dims)
    t = _TREES.get(key)
    if t is not None:
        return t
    nx, ny, nz = key
    n = nx * ny * nz

    pushed, big, big_level = _initial_sets(nx, ny, nz)
    nlevels = num_of_partitions(nx) + num_of_partitions(ny) + num_of_partitions(nz) + 1

    # Order the roots exactly as morton offsets are assigned in the encoder:
    # levels finest-first, pushed order within a level, `big` first in its own.
    per_level: List[List[Tuple]] = [[] for _ in range(nlevels)]
    for s, lev in pushed:
        per_level[lev].append(s)
    per_level[big_level].insert(0, big)
    roots: List[Tuple] = []
    root_levels: List[int] = []
    for lev in range(nlevels - 1, -1, -1):
        for s in per_level[lev]:
            roots.append(s)
            root_levels.append(lev)

    R = len(roots)
    ra = np.array(roots, dtype=np.int64).reshape(R, 6)
    rlev = np.array(root_levels, dtype=np.int16)
    rne = ra[:, 3] * ra[:, 4] * ra[:, 5]
    rmorton = np.cumsum(rne) - rne

    # BFS over depths; nodes appended in (depth, parent-order) order.
    node_level = [rlev]
    node_parent = [np.full(R, -1, dtype=np.int64)]
    depth_ranges: List[Tuple[int, int]] = [(0, R)]
    ch_is_pixel: List[np.ndarray] = []
    ch_ref: List[np.ndarray] = []
    ch_counts: List[np.ndarray] = []  # per node, in node order
    px_linear: List[np.ndarray] = []
    px_parent: List[np.ndarray] = []

    f_sx, f_sy, f_sz = ra[:, 0], ra[:, 1], ra[:, 2]
    f_lx, f_ly, f_lz = ra[:, 3], ra[:, 4], ra[:, 5]
    f_m, f_lev = rmorton, rlev
    f_ids = np.arange(R, dtype=np.int64)
    n_nodes = R
    n_px = 0

    f_sx = f_sx.astype(np.int32)
    f_sy = f_sy.astype(np.int32)
    f_sz = f_sz.astype(np.int32)
    f_lx = f_lx.astype(np.int32)
    f_ly = f_ly.astype(np.int32)
    f_lz = f_lz.astype(np.int32)
    while f_ids.size:
        K = f_ids.size
        # (a 1-elem root partitions into itself in slot 0; generic code works)
        csx, csy, csz, clx, cly, clz, ne, cm, clev = _children_of(
            f_sx, f_sy, f_sz, f_lx, f_ly, f_lz, f_m, f_lev
        )
        flat_ne = ne.ravel()
        fv = np.flatnonzero(flat_ne > 0)  # valid children, parent-major order
        ne_v = flat_ne[fv]
        px_mask = ne_v == 1
        rows_ref = np.empty(fv.size, dtype=np.int64)

        # pixel slots
        fpx = fv[px_mask]
        lin = (
            csz.ravel().take(fpx).astype(np.int64) * (nx * ny)
            + csy.ravel().take(fpx).astype(np.int64) * nx
            + csx.ravel().take(fpx)
        )
        pxpar = f_ids[fpx >> 3]
        npx_new = fpx.size
        rows_ref[px_mask] = n_px + np.arange(npx_new)
        px_linear.append(lin)
        px_parent.append(pxpar)
        n_px += npx_new

        # new nodes
        fnd = fv[~px_mask]
        nnd_new = fnd.size
        rows_ref[~px_mask] = n_nodes + np.arange(nnd_new)
        ch_is_pixel.append(px_mask)
        ch_ref.append(rows_ref)
        ch_counts.append((ne > 0).sum(axis=1))

        nf_sx, nf_sy, nf_sz = (
            csx.ravel().take(fnd), csy.ravel().take(fnd), csz.ravel().take(fnd),
        )
        nf_lx, nf_ly, nf_lz = (
            clx.ravel().take(fnd), cly.ravel().take(fnd), clz.ravel().take(fnd),
        )
        nf_m = cm.ravel().take(fnd)
        nf_lev = clev[fnd >> 3]
        nf_par = f_ids[fnd >> 3]

        node_level.append(nf_lev.astype(np.int16))
        node_parent.append(nf_par)
        depth_ranges.append((n_nodes, n_nodes + nnd_new))
        n_nodes += nnd_new

        f_sx, f_sy, f_sz, f_lx, f_ly, f_lz = nf_sx, nf_sy, nf_sz, nf_lx, nf_ly, nf_lz
        f_m, f_lev = nf_m, nf_lev
        f_ids = np.arange(n_nodes - nnd_new, n_nodes, dtype=np.int64)

    t = Tree()
    t.dims = key
    t.n = n
    t.nlevels = nlevels
    t.node_level = np.concatenate(node_level).astype(np.int16)
    t.node_parent = np.concatenate(node_parent)
    counts = np.concatenate(ch_counts)
    t.node_ch_count = counts
    t.node_ch_start = np.cumsum(counts) - counts
    t.node_depth_ranges = [r for r in depth_ranges if r[1] > r[0]]
    t.ch_is_pixel = np.concatenate(ch_is_pixel)
    t.ch_ref = np.concatenate(ch_ref)
    t.px_linear = np.concatenate(px_linear) if px_linear else np.empty(0, np.int64)
    t.px_parent = np.concatenate(px_parent) if px_parent else np.empty(0, np.int64)
    t.root_ids = np.arange(R, dtype=np.int64)
    t.root_levels = rlev
    t.big_level = big_level
    t.big_pos = 0
    _TREES[key] = t
    return t


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
