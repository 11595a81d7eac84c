"""The partition trees and stream assembly of the wavefront SPECK coder (the
port's copy of the parts of sperr_tpu/codec/speck_wave.py that the device
encoders need: the static 3D partition tree ``build_tree`` with its
helpers, ``stitch_3d`` in the form it takes when the device supplies every
segment; and the 2D quad/I-set tree ``build_tree2``, ``_iset_maxes`` and
``stitch_2d`` with the LIP helper it calls).

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
The original's 3D host-side schedule and set walk, which fill in segments
that are not supplied, are not copied: there all three are required.  The
2D stitch is copied whole: with all three segment families supplied (the
device path, ops/speck_lis2.py) it is pure concatenation, and it runs the
sorted host walk (codec/speck_sorted.py) for the ones that are not.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils.dims import calc_approx_detail_len, can_use_dyadic, num_of_partitions, num_of_xforms

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


def _lip_segment(ce, cs, csign, p: int) -> np.ndarray:
    """Vectorized LIP-walk bits for pass p from the (e, s, sign) cohort:
    one decision per member, the sign interleaved after each 1."""
    memb = (ce < p) & (cs >= p)
    mi = np.flatnonzero(memb)
    dec = cs[mi] == p
    pair = np.empty((mi.size, 2), dtype=np.uint8)
    pair[:, 0] = dec
    pair[:, 1] = csign[mi]
    keep = np.empty((mi.size, 2), dtype=bool)
    keep[:, 0] = True
    keep[:, 1] = dec
    return pair.ravel()[keep.ravel()]


# ===========================================================================
# 2D variant: quad partitions + the type-I "everything else" set
# (reference SPECK2D_INT.cpp:11-218).  Same decomposition as 3D — pixel bits
# (LIP + refinement) are vectorized from (e, s, sign); only the quad/I-set
# walk is control flow.  Per-pass segments: LIP ‖ LIS ‖ I-expansion ‖ refine.
# ===========================================================================
class Tree2:
    __slots__ = (
        "dims", "n", "nlevels", "xf",
        "node_level", "node_ch_start", "node_ch_count", "node_depth_ranges",
        "ch_is_pixel", "ch_ref", "px_linear", "px_parent",
        "root_id", "iset_groups",  # iset_groups[k] = list of node ids (k=xf..1)
        "iset_regions",  # [k] = (ax, ay) corner excluded from I at level k
    )


def _quad_children(s):
    """QccPack order: BR, BL, TR, TL (SPECK2D_INT.cpp:60-97)."""
    sx, sy, lx, ly = s
    ax, dx = lx - lx // 2, lx // 2
    ay, dy = ly - ly // 2, ly // 2
    return [
        (sx + ax, sy + ay, dx, dy),
        (sx, sy + ay, ax, dy),
        (sx + ax, sy, dx, ay),
        (sx, sy, ax, ay),
    ]


_TREES2: Dict[Tuple[int, int], "Tree2"] = {}


def build_tree2(dims: Tuple[int, int]) -> "Tree2":
    key = (int(dims[0]), int(dims[1]))
    t = _TREES2.get(key)
    if t is not None:
        return t
    nx, ny = key
    n = nx * ny
    xf = num_of_xforms(min(nx, ny))

    a_xf, _ = calc_approx_detail_len(nx, xf)
    b_xf, _ = calc_approx_detail_len(ny, xf)

    # roots: S0, then I-children groups for k = xf .. 1 (push order BR,TR,BL)
    roots = [((0, 0, a_xf, b_xf), xf)]
    iset_groups: List[List[int]] = [[] for _ in range(xf + 1)]
    iset_regions: List[Tuple[int, int]] = [(0, 0)] * (xf + 1)
    rid = 1
    for k in range(xf, 0, -1):
        ax, dx = calc_approx_detail_len(nx, k)
        ay, dy = calc_approx_detail_len(ny, k)
        iset_regions[k] = (ax, ay)
        for s in ((ax, ay, dx, dy), (ax, 0, dx, ay), (0, ay, ax, dy)):
            if s[2] * s[3] != 0:
                roots.append((s, k))
                iset_groups[k].append(rid)
                rid += 1

    R = len(roots)
    node_level = [np.array([lev for _, lev in roots], dtype=np.int16)]
    depth_ranges: List[Tuple[int, int]] = [(0, R)]
    ch_is_pixel: List[np.ndarray] = []
    ch_ref: List[np.ndarray] = []
    ch_counts: List[np.ndarray] = []
    px_linear: List[np.ndarray] = []
    px_parent: List[np.ndarray] = []

    f = np.array([s for s, _ in roots], dtype=np.int64).reshape(R, 4)
    f_lev = node_level[0].astype(np.int64)
    f_ids = np.arange(R, dtype=np.int64)
    n_nodes, n_px = R, 0

    while f_ids.size:
        K = f_ids.size
        sx, sy, lx, ly = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
        ax, dx = lx - lx // 2, lx // 2
        ay, dy = ly - ly // 2, ly // 2
        csx = np.stack([sx + ax, sx, sx + ax, sx], axis=1)
        csy = np.stack([sy + ay, sy + ay, sy, sy], axis=1)
        clx = np.stack([dx, ax, dx, ax], axis=1)
        cly = np.stack([dy, dy, ay, ay], axis=1)
        ne = clx * cly
        valid = ne > 0
        flat_valid = valid.ravel()
        is_px = (ne == 1).ravel()[flat_valid]
        rows_ref = np.empty(int(flat_valid.sum()), dtype=np.int64)

        lin = (csy * nx + csx).ravel()[flat_valid][is_px]
        pxpar = np.repeat(f_ids, 4).ravel()[flat_valid][is_px]
        rows_ref[is_px] = n_px + np.arange(lin.size)
        px_linear.append(lin)
        px_parent.append(pxpar)
        n_px += lin.size

        nd_mask = ~is_px
        nnd = int(nd_mask.sum())
        rows_ref[nd_mask] = n_nodes + np.arange(nnd)
        ch_is_pixel.append(is_px)
        ch_ref.append(rows_ref)
        ch_counts.append(valid.sum(axis=1))

        sel = (ne > 1).ravel()
        nf = np.stack(
            [csx.ravel()[sel], csy.ravel()[sel], clx.ravel()[sel], cly.ravel()[sel]],
            axis=1,
        )
        nf_lev = (np.repeat(f_lev, 4).ravel()[sel] + 1).astype(np.int64)
        node_level.append(nf_lev.astype(np.int16))
        depth_ranges.append((n_nodes, n_nodes + nnd))
        n_nodes += nnd
        f, f_lev = nf, nf_lev
        f_ids = np.arange(n_nodes - nnd, n_nodes, dtype=np.int64)

    t = Tree2()
    t.dims = key
    t.n = n
    t.xf = xf
    t.nlevels = num_of_partitions(max(nx, ny)) + 1
    t.node_level = np.concatenate(node_level).astype(np.int16)
    counts = np.concatenate(ch_counts)
    t.node_ch_count = counts
    t.node_ch_start = np.cumsum(counts) - counts
    t.node_depth_ranges = [r for r in depth_ranges if r[1] > r[0]]
    t.ch_is_pixel = np.concatenate(ch_is_pixel)
    t.ch_ref = np.concatenate(ch_ref)
    t.px_linear = np.concatenate(px_linear) if px_linear else np.empty(0, np.int64)
    t.px_parent = np.concatenate(px_parent) if px_parent else np.empty(0, np.int64)
    t.root_id = 0
    t.iset_groups = iset_groups
    t.iset_regions = iset_regions
    _TREES2[key] = t
    return t


def _iset_maxes(tree: Tree2, pmsb2d: np.ndarray) -> np.ndarray:
    """max msb+1 over the I region at each level k (1..xf); index 0 unused."""
    nx, ny = tree.dims
    out = np.zeros(tree.xf + 1, dtype=np.int16)
    for k in range(1, tree.xf + 1):
        ax, ay = tree.iset_regions[k]
        m = 0
        if ay < ny:
            m = int(pmsb2d[ay:, :].max()) if pmsb2d[ay:, :].size else 0
        if ax < nx and ay > 0:
            m2 = int(pmsb2d[:ay, ax:].max()) if pmsb2d[:ay, ax:].size else 0
            m = max(m, m2)
        out[k] = m
    return out


def stitch_2d(
    pmsb: np.ndarray,
    signs: np.ndarray,
    node_max: np.ndarray,
    dims: Tuple[int, int],
    num_bp: int,
    lip_segments,
    ref_segments,
    budget_bits: int = 0,
    mags: np.ndarray = None,
    s_lin: np.ndarray = None,
    iset_max: np.ndarray = None,
    lis_segments=None,
) -> bytes:
    """2D analog of stitch_3d: assemble the stream from pixel schedules
    (device-supplied segments optional) plus the quad/I-set walk.  When
    all three segment families are supplied (the full device-entropy
    path, ops/speck_lis2_jax.py), this is pure concatenation."""
    nx, ny = dims
    n = nx * ny
    tree = build_tree2((nx, ny))
    budget = (budget_bits + 7) // 8 * 8 if budget_bits else None

    if lis_segments is None or lip_segments is None:
        node_s = np.where(node_max > 0, num_bp - node_max, _NEVER).astype(
            np.int32
        )
    if s_lin is None and pmsb is not None:
        s_lin = np.where(pmsb > 0, num_bp - pmsb, _NEVER).astype(np.int32)
    if lip_segments is None:
        e_lin = np.full(n, _NEVER, dtype=np.int32)
        e_lin[tree.px_linear] = node_s[tree.px_parent]
        cand = np.flatnonzero((e_lin < num_bp) & (s_lin > e_lin))
        ce, cs = e_lin[cand], s_lin[cand]
        csign = signs[cand]
    if ref_segments is None:
        rnz = np.flatnonzero(s_lin < _NEVER)
        rs = s_lin[rnz]
        rmag = mags[rnz].astype(np.uint64)

    if lis_segments is not None:
        lis_all = lis_segments
    else:
        if iset_max is None:
            iset_max = _iset_maxes(tree, pmsb.reshape(ny, nx))
        iset_s = np.where(
            iset_max > 0, num_bp - iset_max, _NEVER
        ).astype(np.int32)
        # LIS bits: the set walk (quad partitions + I-set) as a
        # lexicographic sort (codec/speck_sorted.py) — no recursion in the
        # 2D encoder either.
        from .speck_sorted import lis_segments_sorted_2d

        lis_all = lis_segments_sorted_2d(
            tree, node_s, s_lin, signs, num_bp, iset_s
        )

    segments: List[np.ndarray] = []
    total = 0
    stop = False
    for p in range(num_bp):
        if lip_segments is not None:
            lip_bits = lip_segments[p]
        else:
            lip_bits = _lip_segment(ce, cs, csign, p)
        lis_bits = lis_all[p]

        segments.append(lip_bits)
        segments.append(lis_bits)
        total += lip_bits.size + lis_bits.size
        if budget is not None and total >= budget:
            stop = True
        if not stop:
            if ref_segments is not None:
                rbits = ref_segments[p]
            else:
                rm = rs < p
                rbits = (
                    (rmag[rm] >> np.uint64(num_bp - 1 - p)) & np.uint64(1)
                ).astype(np.uint8)
            segments.append(rbits)
            total += rbits.size
            if budget is not None and total >= budget:
                stop = True
        if stop:
            break

    allbits = np.concatenate(segments) if segments else np.empty(0, np.uint8)
    return _pack_stream(allbits, total, num_bp, budget)
