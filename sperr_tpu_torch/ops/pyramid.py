"""Pyramid-form SPECK partition maxima (the port's copy of
sperr_tpu/ops/pyramid.py, NumPy only).

The partition tree's boxes at depth d are the outer products of per-axis
binary interval trees (ceil half first, reference SPECK3D_INT.cpp:214-326).
Embedding the per-pixel msb values into a power-of-two cube via static
per-axis slot tables makes every level of set maxima a regular 2x2x2
max-pool instead of a ragged segment reduction over the child table.

Also derives the per-pixel exposure pass e (the pass at which the pixel's
parent set partitions) from the pyramid: a pixel becomes a singleton child
at the depth where all three of its axis intervals reach length 1; its
parent box lives one depth above.

The static tables (``AxisTables``, ``Pyramid`` and the node permutation
``_build_tree_perm``) feed the device schedule ``pixel_schedule_pyramid``
(ops/speck.py); the NumPy reductions here are its host reference.  Node
maxima are returned in the partition tree's BFS order via a static
permutation, so the set walk is unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..codec.speck_wave import Tree, _NEVER, build_tree


class AxisTables:
    """Static per-axis interval-tree tables for one length n."""

    __slots__ = ("n", "depth", "slot", "inv", "d_single")

    def __init__(self, n: int):
        self.n = n
        # depth at which every interval has length <= 1
        d = 0
        ln = n
        while ln > 1:
            ln = ln - ln // 2  # ceil half shrinks slowest
            d += 1
        self.depth = d
        size = 1 << d
        slot = np.zeros(n, dtype=np.int64)  # pixel -> deepest slot
        d_single = np.zeros(n, dtype=np.int16)  # depth where interval len==1
        # walk the interval tree iteratively per pixel (vectorized by level)
        start = np.zeros(n, dtype=np.int64)
        length = np.full(n, n, dtype=np.int64)
        x = np.arange(n, dtype=np.int64)
        for lev in range(d):
            a = length - length // 2  # ceil half
            right = (x - start) >= a
            slot = slot * 2 + right
            start = np.where(right, start + a, start)
            length = np.where(right, length - a, a)
            d_single[(length == 1) & (d_single == 0)] = lev + 1
        self.slot = slot
        self.d_single = d_single
        inv = np.full(size, -1, dtype=np.int64)  # slot -> pixel (or -1)
        inv[slot] = x
        self.inv = inv


class Pyramid:
    """Per-depth box maxima + per-pixel exposure, pyramid formulation."""

    __slots__ = ("dims", "ax", "ay", "az", "levels", "tree_perm")

    def __init__(self, dims: Tuple[int, int, int]):
        nx, ny, nz = (int(d) for d in dims)
        self.dims = (nx, ny, nz)
        self.ax = AxisTables(nx)
        self.ay = AxisTables(ny)
        self.az = AxisTables(nz)
        self.levels = max(self.ax.depth, self.ay.depth, self.az.depth)
        self.tree_perm = None  # built lazily against the partition tree


def _axis_slots(t: AxisTables, depth: int, levels: int) -> np.ndarray:
    """Slot index of each pixel at `depth` (slots halve above the deepest)."""
    d = min(depth, t.depth)
    return t.slot >> (t.depth - d)


def box_max_levels(pyr: Pyramid, pmsb: np.ndarray) -> List[np.ndarray]:
    """Box maxima per depth, deepest (pixels) to depth 0 (whole volume).

    Returns a list L where L[d] has shape (2^min(d,dz), 2^min(d,dy),
    2^min(d,dx)) and L[d][k, j, i] = max msb+1 over the box."""
    nx, ny, nz = pyr.dims
    # embed pixels into the power-of-two cube (regular per-axis gathers)
    deep = np.zeros(
        (1 << pyr.az.depth, 1 << pyr.ay.depth, 1 << pyr.ax.depth),
        dtype=pmsb.dtype,
    )
    vol = pmsb.reshape(nz, ny, nx)
    zi, yi, xi = pyr.az.slot, pyr.ay.slot, pyr.ax.slot
    deep[np.ix_(zi, yi, xi)] = vol
    out = [None] * (pyr.levels + 1)
    out[pyr.levels] = deep
    cur = deep
    for d in range(pyr.levels - 1, -1, -1):
        z2 = 2 if d < pyr.az.depth else 1
        y2 = 2 if d < pyr.ay.depth else 1
        x2 = 2 if d < pyr.ax.depth else 1
        sz, sy, sx = cur.shape
        cur = cur.reshape(sz // z2, z2, sy // y2, y2, sx // x2, x2).max(
            axis=(1, 3, 5)
        )
        out[d] = cur
    return out


def node_max_pyramid(pyr: Pyramid, pmsb: np.ndarray, tree: Tree) -> np.ndarray:
    """Per-node maxima in the partition tree's BFS order, computed from the
    pyramid via a static (cached) permutation."""
    levels = box_max_levels(pyr, pmsb)
    if pyr.tree_perm is None:
        pyr.tree_perm = _build_tree_perm(pyr, tree)
    out = np.zeros(tree.node_ch_start.size, dtype=np.int16)
    for d, (ids, boxes) in pyr.tree_perm.items():
        out[ids] = levels[d].reshape(-1)[boxes]
    return out


def _build_tree_perm(pyr: Pyramid, tree: Tree) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Map tree node ids -> (depth, flat box index).  Static per dims.

    Tree depth ranges are BFS-ordered; within a depth, a node's box is
    identified by the axis-slot of its start coordinates at that depth."""
    # reconstruct per-node (pyramid depth, start, size) by replaying the
    # BFS structure; dyadic dims only (every split is a full octant split,
    # so all tree boxes are uniform-depth pyramid boxes)
    nx, ny, nz = pyr.dims
    from ..codec.speck_wave import _initial_sets
    from ..utils.dims import can_use_dyadic

    dy_lev = can_use_dyadic((nx, ny, nz))
    if dy_lev is None:
        raise ValueError("pyramid node maxima require dyadic dims")
    nn = tree.node_ch_start.size
    starts = np.zeros((nn, 3), dtype=np.int64)

    pushed, big, big_level = _initial_sets(nx, ny, nz)
    # chain step i pushes 7 octant children at pyramid depth i+1
    depth_by_box = {tuple(s): (j // 7) + 1 for j, (s, _) in enumerate(pushed)}
    depth_by_box[tuple(big)] = max(dy_lev, 1) if dy_lev else 0
    per_level: List[List[Tuple]] = [[] for _ in range(tree.nlevels)]
    for s, lev in pushed:
        per_level[lev].append(s)
    per_level[big_level].insert(0, big)
    roots = []
    for lev in range(tree.nlevels - 1, -1, -1):
        roots.extend(per_level[lev])
    for rid, s in enumerate(roots):
        starts[rid] = (s[0], s[1], s[2])
    sizes = np.zeros((nn, 3), dtype=np.int64)
    for rid, s in enumerate(roots):
        sizes[rid] = (s[3], s[4], s[5])
    depth_of = np.zeros(nn, dtype=np.int16)
    for rid, s in enumerate(roots):
        depth_of[rid] = depth_by_box[tuple(s)]
    for lo, hi in tree.node_depth_ranges:
        for nid in range(lo, hi):
            s0 = tree.node_ch_start[nid]
            cnt = tree.node_ch_count[nid]
            sx, sy, sz = starts[nid]
            lx, ly, lz = sizes[nid]
            ax, dx = lx - lx // 2, lx // 2
            ay, dy = ly - ly // 2, ly // 2
            az, dz = lz - lz // 2, lz // 2
            octs = [
                (sx, sy, sz, ax, ay, az), (sx + ax, sy, sz, dx, ay, az),
                (sx, sy + ay, sz, ax, dy, az), (sx + ax, sy + ay, sz, dx, dy, az),
                (sx, sy, sz + az, ax, ay, dz), (sx + ax, sy, sz + az, dx, ay, dz),
                (sx, sy + ay, sz + az, ax, dy, dz), (sx + ax, sy + ay, sz + az, dx, dy, dz),
            ]
            octs = [o for o in octs if o[3] * o[4] * o[5] > 0]
            ci = 0
            for k in range(cnt):
                if not tree.ch_is_pixel[s0 + k]:
                    r = int(tree.ch_ref[s0 + k])
                    # find the matching non-pixel oct in order
                    while octs[ci][3] * octs[ci][4] * octs[ci][5] == 1:
                        ci += 1
                    o = octs[ci]
                    ci += 1
                    starts[r] = o[:3]
                    sizes[r] = o[3:]
                    depth_of[r] = depth_of[nid] + 1
                else:
                    # pixels also consume an oct slot in order
                    while octs[ci][3] * octs[ci][4] * octs[ci][5] != 1:
                        ci += 1
                    ci += 1
    # node's box at its depth: slot of its start coordinate per axis
    perm: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for d in range(int(depth_of.max()) + 1):
        ids = np.flatnonzero(depth_of == d)
        if ids.size == 0:
            continue
        dz = min(d, pyr.az.depth)
        dy = min(d, pyr.ay.depth)
        dx = min(d, pyr.ax.depth)
        zi = pyr.az.slot[starts[ids, 2]] >> (pyr.az.depth - dz)
        yi = pyr.ay.slot[starts[ids, 1]] >> (pyr.ay.depth - dy)
        xi = pyr.ax.slot[starts[ids, 0]] >> (pyr.ax.depth - dx)
        flat = (zi << (dy + dx)) | (yi << dx) | xi
        perm[d] = (ids, flat)
    return perm


def exposure_pyramid(pyr: Pyramid, pmsb: np.ndarray, num_bp: int) -> np.ndarray:
    """Per-pixel exposure pass e from the pyramid (the pass at which the
    pixel's parent box becomes significant), linear order."""
    levels = box_max_levels(pyr, pmsb)
    nx, ny, nz = pyr.dims
    # parent depth of each pixel = max over axes of the depth where its
    # interval reaches length 1, minus 1 (its parent box is one level up)
    dx = pyr.ax.d_single.astype(np.int16)
    dy = pyr.ay.d_single.astype(np.int16)
    dz = pyr.az.d_single.astype(np.int16)
    pd = np.maximum.outer(np.maximum.outer(dz, dy), dx)  # (nz, ny, nx)
    e = np.full((nz, ny, nx), _NEVER, dtype=np.int32)
    for d in range(int(pd.max()) + 1):
        mask = pd == d
        if not mask.any():
            continue
        pdep = max(d - 1, 0)
        ddz = min(pdep, pyr.az.depth)
        ddy = min(pdep, pyr.ay.depth)
        ddx = min(pdep, pyr.ax.depth)
        zi = _axis_slots(pyr.az, pdep, pyr.levels)
        yi = _axis_slots(pyr.ay, pdep, pyr.levels)
        xi = _axis_slots(pyr.ax, pdep, pyr.levels)
        bm = levels[pdep][np.ix_(zi, yi, xi)]  # parent-box max per pixel
        ev = np.where(bm > 0, num_bp - bm.astype(np.int32), _NEVER)
        e[mask] = ev[mask]
    return e.reshape(-1)


__all__ = ["Pyramid", "AxisTables", "box_max_levels", "node_max_pyramid",
           "exposure_pyramid"]
