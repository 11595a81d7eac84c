"""Device SPECK schedule for 3D chunks that are not power-of-two cubes and
for 2D fields (K15, K14), and the event form of the emission (K14).

PyTorch port of the table, pyramid and event parts of
sperr_tpu/ops/speck_jax.py: ``TreeIndex`` / ``tree_index``, ``node_max``
and ``pixel_schedule`` (the child-table form, any 3D dims and 2D dims
through the quad/I-set tree), ``PyramidIndex`` / ``pyramid_index`` and
``pixel_schedule_pyramid`` (the max-pool form, dyadic dims), and the event
helpers of the walks' event tail (ops/speck_lis._event_tail), ``_expand_fill``
and ``events_to_segments``.  The schedules give, as
``speck_virtual.pixel_schedule_virtual`` does for power-of-two cubes:

  * s  = the pass at which each pixel becomes significant (NEVER for zero);
  * e  = the pass at which each pixel's parent set partitions, exposing it
         into the LIP;
  * nm = the maximum msb+1 of every node of the partition tree, in its BFS
         order (the set-significance oracle of the walk, ops/speck_lis.py).

The indices are static per dims: their host tables come from the partition
tree (codec/speck_wave.py) and, for the pyramid form, ops/pyramid.py; their
device tensors are made once per (dims, device) and cached.  Integer results
equal the JAX package's bit for bit.  ``schedule_table`` and
``schedule_pyramid`` (num_bp with the schedule; for the table form pm where
asked and, on a 2D field, the I-set passes of
speck_lis2.iset_significance_device where asked) run the hand kernels of
kernels/schedule.cu (``sched_table``, ``sched_pyramid``) on a CUDA tensor
and their plain versions (``pixel_schedule_ref`` with
speck_lis2.iset_significance_ref, ``pixel_schedule_pyramid_ref``) on a CPU
tensor; ``pixel_schedule`` and ``pixel_schedule_pyramid``, which take a
given num_bp, are those plain versions and take CPU tensors only.  The rest
of the module runs as torch ops on the tensors' device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import kernels
from ..codec.speck_wave import build_tree, build_tree2
from . import pyramid as pm
from .packemit import _dispatch, _words32
from .speck_virtual import msbp1_device

_NEVER = 0x7FFF
_I32 = torch.int32


def _long(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64), device=device)


def _int(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def _pixel_parent(tree) -> np.ndarray:
    """Parent node of every pixel in linear order: the pixel slots are a
    permutation of the pixels (each appears once as a singleton child), so
    the schedule's e is one gather instead of a scatter."""
    par = np.full(tree.n, -1, dtype=np.int64)
    par[tree.px_linear] = tree.px_parent
    if tree.px_linear.size != tree.n or (par < 0).any():
        raise ValueError(f"the pixel slots of {tree.dims} are not a permutation of the pixels")
    return par


SCHED_SMEM = 48 * 1024  # shared bytes a block of sched_table may stage (no opt-in needed)
SCHED_ROWS = 4096  # child rows a run of cut nodes, a block of sched_table's subtree launch, takes at most
SCHED_CUT_ROWS = 12288  # child rows of one cut node's subtree at most, by default (the leaves' unstaged)
SCHED_TOP_ROWS = 512  # child rows above the top cut, which one block reduces, by default
SCHED_MIN_ROWS = 1024  # child rows a block is filled to, where the launch has enough of them
SCHED_BLOCKS = 1056  # blocks a launch aims at: 8 of 256 threads on each of the H100's 132 SMs
SCHED_LEAF32 = 1 << 28  # boxes that start below this pixel fit the int32 leaf table (else int64)


def _groups(rows: np.ndarray, target: int) -> np.ndarray:
    """Runs of consecutive cut nodes, each of at most ``target`` rows (or
    one node): the index of each run's first node, then len(rows)."""
    starts, acc = [0], 0
    for i, r in enumerate(rows.tolist()):
        if acc and acc + r > target:
            starts.append(i)
            acc = 0
        acc += r
    return np.asarray(starts + [rows.size], dtype=np.int64)


def subtree_plan(tree, cuts=None):
    """The child-table schedule's static plan for ``tree`` (a partition tree
    of codec/speck_wave.py): (cuts, depth_lo, nroots, smem, sub, links,
    leaf), as kernels.SubtreePlan holds them, ``sub`` numpy (2, nsub, nblk
    + 1) int32 arrays, ``links`` an int32 array or None and ``leaf`` the
    deepest depth's boxes (int32, or int64 where a box starts at or past
    pixel SCHED_LEAF32; raises ValueError where one is not a box of at most
    2 x 2 x 2 pixels).

    The kernel's premise, checked here: the depths tile the node ids in
    order, and the node children, row by row, are the nodes past the roots
    in id order.  So each depth is ordered by parent, and the descendants
    of a run of consecutive nodes at any deeper depth are one id range and
    their child rows one row range.  A block takes a run of the first cut's
    nodes, down to the leaves; a group (with two cuts) a run of the second
    cut's nodes, down to the first cut: ``sub[v][0, j]`` holds each block's
    or group's first descendant id at depth cuts[v] + j (its end the next
    one's first), ``sub[v][1, j]`` their first child row.  Runs are cut
    greedily to at most max(SCHED_MIN_ROWS, the cut's rows / SCHED_BLOCKS)
    rows, at most SCHED_ROWS (or one node).  ``links``: each block's first
    and last group (the groups whose first-cut descendants it holds; a
    group without any, the block where they would start), then each
    group's blocks.  A block stages its rows (2 bytes each) and each node's
    first row (2 bytes) but the leaves', and every node's maximum (1 byte),
    in shared memory, and so do a group and the depths above the top cut,
    which the last block reduces; ``smem`` is the most of them.

    ``cuts`` (deepest first): the shallowest depth whose nodes' subtrees
    hold at most SCHED_CUT_ROWS rows each, and, where more than
    SCHED_TOP_ROWS rows lie above it, the deepest depth with at most that
    many above (the deepest whose groups fit); or the given ones.  Raises
    ValueError where the premise fails or a block would not fit
    SCHED_SMEM."""
    ranges = list(tree.node_depth_ranges)
    nn = int(tree.node_ch_start.size)
    D = len(ranges)
    counts = np.asarray(tree.node_ch_count, dtype=np.int64)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    if [lo for lo, _ in ranges] != [0] + [hi for _, hi in ranges[:-1]] or ranges[-1][1] != nn:
        raise ValueError(f"the depth ranges of {tree.dims} do not tile the nodes in order")
    if D > kernels.SCHED_MAX_DEPTH or counts.max() > kernels.SCHED_MAX_CHILDREN:
        raise ValueError(f"{D} depths and up to {counts.max()} child rows a node in the tree of {tree.dims}; the "
                         f"schedule takes {kernels.SCHED_MAX_DEPTH} and {kernels.SCHED_MAX_CHILDREN}")
    nroots = int(ranges[0][1])
    is_node = ~np.asarray(tree.ch_is_pixel, dtype=bool)
    if not np.array_equal(np.asarray(tree.ch_ref)[is_node], np.arange(nroots, nn)):
        raise ValueError(f"a depth of {tree.dims} is not ordered by parent: the node children, row by row, "
                         "are not the nodes past the roots in id order")
    # first child id of each node (nn + 1 entries): the roots plus the node rows before its rows
    first = nroots + np.concatenate([[0], np.cumsum(is_node)])[bounds]
    depth_lo = [lo for lo, _ in ranges] + [nn]
    for d in range(D):
        if first[depth_lo[d]] != depth_lo[min(d + 1, D)] or first[depth_lo[d + 1]] != depth_lo[min(d + 2, D)]:
            raise ValueError(f"depth {d} of {tree.dims} has node children outside depth {d + 1}")

    # the deepest depth's nodes: boxes of at most 2 x 2 x 2 pixels, each its first pixel << 3 | sides - 1
    nx, ny = int(tree.dims[0]), int(tree.dims[1])
    lo = depth_lo[D - 1]
    rows = np.arange(bounds[lo], bounds[nn])
    if not np.asarray(tree.ch_is_pixel)[rows].all():
        raise ValueError(f"the deepest depth of {tree.dims} has node children")
    px = np.asarray(tree.px_linear)[np.asarray(tree.ch_ref)[rows]].astype(np.int64)
    starts = bounds[lo:nn] - bounds[lo]
    corner = np.minimum.reduceat(px, starts)
    sides, box = [], corner << 3
    for k, coord in enumerate((px % nx, px // nx % ny, px // (nx * ny))):
        side = np.maximum.reduceat(coord, starts) - np.minimum.reduceat(coord, starts) + 1
        if (side > 2).any():
            raise ValueError(f"a node of the deepest depth of {tree.dims} is wider than 2 pixels")
        sides.append(side)
        box |= (side - 1) << k
    if (sides[0] * sides[1] * sides[2] != counts[lo:nn]).any():
        raise ValueError(f"the deepest depth of {tree.dims} is not a set of boxes")
    leaf = box.astype(np.int32 if int(corner.max(initial=0)) < SCHED_LEAF32 else np.int64)

    def subtrees(c, stop):
        """Each depth-c node's descendants at depths c .. stop: their first
        ids and first rows (2, stop - c + 1, nodes + 1); the last depth's
        rows are not the subtrees'."""
        tn = [np.arange(depth_lo[c], depth_lo[c + 1] + 1, dtype=np.int64)]
        for _ in range(c + 1, stop + 1):
            tn.append(first[tn[-1]])
        tn = np.stack(tn)
        return np.stack([tn, bounds[tn]])

    def plan_at(cuts):
        """The plan at the given cuts; ValueError where it does not fit."""

        def need(nodes, rows):
            return 2 * rows + 2 * (nodes + 1) + nodes

        if not 1 <= len(cuts) <= 2 or not 0 <= cuts[-1] or cuts[0] >= D or list(cuts) != sorted(set(cuts))[::-1]:
            raise ValueError(f"one or two cut depths, deepest first, within 0 .. {D - 1}; got {cuts}")
        subs, nbytes, firsts = [], [], []
        for v, c in enumerate(cuts):
            stop = cuts[v - 1] if v else D
            per = subtrees(c, min(stop, D - 1))
            node_rows = np.diff(per[1, : stop - c], axis=1).sum(axis=0)
            target = min(SCHED_ROWS, max(SCHED_MIN_ROWS, -(-int(node_rows.sum()) // SCHED_BLOCKS)))
            cols = _groups(node_rows, target)
            sub = per[:, : stop - c][:, :, cols]
            firsts.append(per[0, -1, cols])  # each run's first descendant at the depth below it
            nodes, rows = np.diff(sub[0], axis=1).sum(axis=0), np.diff(sub[1], axis=1).sum(axis=0)
            staged_nodes, staged_rows = nodes, rows
            if v == 0:  # the leaves' rows and row starts are not staged
                staged_nodes, staged_rows = nodes - np.diff(sub[0, -1]), rows - np.diff(sub[1, -1])
            nbytes.append(int((2 * staged_rows + 2 * (staged_nodes + 1) + nodes).max()))
            subs.append(sub.astype(np.int32))
        top = cuts[-1]
        nbytes.append(need(depth_lo[top], int(bounds[depth_lo[top]])) if top else 0)
        links = None
        if len(cuts) == 2:
            # the blocks' first nodes, and the groups' first descendants at the first cut
            starts, gfirst = subs[0][0, 0, :-1].astype(np.int64), firsts[1]
            nblk, ngrp = starts.size, gfirst.size - 1
            glo, ghi = np.full(nblk, ngrp, np.int64), np.full(nblk, -1, np.int64)
            for g in range(ngrp):
                lo, hi = int(gfirst[g]), int(gfirst[g + 1])
                b0 = min(int(np.searchsorted(starts, lo, "right")) - 1, nblk - 1)
                b1 = int(np.searchsorted(starts, hi - 1, "right")) - 1 if hi > lo else b0
                glo[b0:b1 + 1] = np.minimum(glo[b0:b1 + 1], g)
                ghi[b0:b1 + 1] = np.maximum(ghi[b0:b1 + 1], g)
            if (ghi < glo).any() or (ghi - glo + 1).max() > kernels.SCHED_MAX_GROUPS:
                raise ValueError(f"the cuts {cuts} of {tree.dims} leave a block reaching no group or more than "
                                 f"{kernels.SCHED_MAX_GROUPS}")
            per_group = np.zeros(ngrp, np.int64)
            for b in range(nblk):
                per_group[glo[b]:ghi[b] + 1] += 1
            links = np.concatenate([glo, ghi, per_group]).astype(np.int32)
        smem = max(nbytes)
        big_rows = max(int(np.diff(sb[1], axis=1).sum(axis=0).max()) for sb in subs)
        big_nodes = max(int(np.diff(sb[0], axis=1).sum(axis=0).max()) for sb in subs)
        if (smem > SCHED_SMEM or max(big_rows, int(bounds[depth_lo[top]])) >= 1 << 16
                or max(big_nodes, depth_lo[top]) + kernels.SCHED_NODE_MARK >= 1 << 16):
            raise ValueError(f"the cuts {cuts} of {tree.dims} need {smem} bytes of shared memory in a block; at "
                             f"most {SCHED_SMEM}")
        return cuts, tuple(int(v) for v in depth_lo), nroots, -(-smem // 16) * 16, tuple(subs), links, leaf

    if cuts is None:
        # the deepest cut whose subtrees fit a block; a second, shallower one where the depths above
        # hold too many rows for the last block, the deepest such that reaches few enough groups
        c2 = next(c for c in range(D) if np.diff(subtrees(c, D - 1)[1], axis=1).sum(axis=0).max() <= SCHED_CUT_ROWS)
        tries = [(c2,)] if bounds[depth_lo[c2]] <= SCHED_TOP_ROWS else \
            [(c2, c) for c in range(c2 - 1, -1, -1) if bounds[depth_lo[c]] <= SCHED_TOP_ROWS] + [(c2,)]
    else:
        tries = [tuple(int(c) for c in cuts)]
    for k, cuts in enumerate(tries):
        try:
            return plan_at(cuts)
        except ValueError:
            if k + 1 == len(tries):
                raise


class TreeIndex:
    """Static device tensors of the child-table schedule: per depth (deepest
    first) the child rows' value sources and parent rows, and each pixel's
    parent node; and the int32 tables of the kernel: each child row's source
    (a pixel's linear index, or -(node id + 1)), each node's first child row
    (nn + 1 bounds), each pixel's parent, and the subtree plan
    (``subtree_plan``; ``cuts`` overrides its cut depths)."""

    __slots__ = ("dims", "device", "n", "nn", "depth_slices", "px_parent_lin", "ch_src", "ch_bounds",
                 "px_parent32", "plan", "sub_host", "links_host", "leaf_host", "grid")

    def __init__(self, dims, device, cuts=None):
        dev = torch.device(device)
        key = tuple(int(d) for d in dims)
        tree = build_tree2(key) if len(key) == 2 else build_tree(key)
        self.dims = tree.dims
        self.device = dev
        self.n = tree.n
        self.nn = tree.node_ch_start.size
        # the pixels' rows as the pixel pass walks them: a 2D field is (ny, nx)
        self.grid = (key[1], key[0]) if len(key) == 2 else (1, self.n)
        # per depth: child value = msbp1[px_linear[ref]] if pixel else
        # node_max[ref], reduced into the parent's row
        self.depth_slices = []
        for lo, hi in reversed(tree.node_depth_ranges):
            s0 = int(tree.node_ch_start[lo])
            s1 = int(tree.node_ch_start[hi - 1] + tree.node_ch_count[hi - 1])
            ispx = tree.ch_is_pixel[s0:s1]
            refs = tree.ch_ref[s0:s1]
            src_px = np.where(ispx, tree.px_linear[np.where(ispx, refs, 0)], 0)
            src_nd = np.where(ispx, 0, refs)
            parent_rows = np.repeat(np.arange(lo, hi), tree.node_ch_count[lo:hi])
            self.depth_slices.append((
                torch.as_tensor(np.ascontiguousarray(ispx), device=dev),
                _long(src_px, dev), _long(src_nd, dev), _long(parent_rows - lo, dev),
                int(lo), int(hi),
            ))
        par = _pixel_parent(tree)
        self.px_parent_lin = _long(par, dev)
        # the kernels' tables
        if self.nn + tree.ch_ref.size >= 2**31:
            raise ValueError(f"the tree of {self.dims} is too large for int32 tables")
        cuts_, depth_lo, nroots, smem, self.sub_host, self.links_host, self.leaf_host = subtree_plan(tree, cuts)
        nx, ny = key[0], key[1]
        self.plan = kernels.SubtreePlan(cuts_, depth_lo, nroots, smem, tuple(_int(t, dev) for t in self.sub_host),
                                        None if self.links_host is None else _int(self.links_host, dev),
                                        torch.as_tensor(self.leaf_host, device=dev), (nx, nx * ny))
        pix = tree.px_linear[np.where(tree.ch_is_pixel, tree.ch_ref, 0)]
        self.ch_src = _int(np.where(tree.ch_is_pixel, pix, -(tree.ch_ref + 1)), dev)
        self.ch_bounds = _int(np.append(tree.node_ch_start, tree.node_ch_start[-1] + tree.node_ch_count[-1]),
                              dev)
        self.px_parent32 = _int(par, dev)


_INDEXES: Dict[Tuple[Tuple[int, ...], str], TreeIndex] = {}


def tree_index(dims, device) -> TreeIndex:
    """The child-table index for ``dims`` on ``device``, made once and cached."""
    key = (tuple(int(d) for d in dims), str(torch.device(device)))
    ti = _INDEXES.get(key)
    if ti is None:
        ti = _INDEXES[key] = TreeIndex(key[0], device)
    return ti


def node_max(msbp1: torch.Tensor, ti: TreeIndex) -> torch.Tensor:
    """Max msb+1 per tree node: per-depth segment maxima over the child
    rows, deepest depth first (every node has at least one child row)."""
    nm = torch.zeros(ti.nn, dtype=_I32, device=msbp1.device)
    for ispx, src_px, src_nd, parent_rows, lo, hi in ti.depth_slices:
        vals = torch.where(ispx, msbp1[src_px], nm[src_nd])
        seg = torch.zeros(hi - lo, dtype=_I32, device=msbp1.device)
        nm[lo:hi] = seg.scatter_reduce_(0, parent_rows, vals, "amax")
    return nm


def schedule_table(mags: torch.Tensor, ti: TreeIndex, iset_regions=None):
    """(num_bp, s, e, node maxima) of the child-table schedule (any 3D dims
    and 2D dims), num_bp an int32 0-d tensor on the device; pm, the msb+1
    of each pixel, is ``msbp1_device(mags)``.  With ``iset_regions`` (a 2D
    field's [(ax_k, ay_k) for k = 0 .. xf], the tree's ``iset_regions[: xf
    + 1]``) iset_s follows, as speck_lis2.iset_significance_device gives
    it.  On a CUDA tensor the ``sched_table`` kernels (two launches); on a
    CPU tensor the plain version."""
    if _dispatch(mags, "schedule_table"):
        return kernels.sched_table(_words32(mags).reshape(-1), ti.ch_src, ti.ch_bounds, ti.px_parent32,
                                   ti.plan, ti.grid, iset_regions)
    pm_ = msbp1_device(mags)
    num_bp = pm_.max()
    out = (num_bp,) + pixel_schedule_ref(mags, ti, num_bp)
    if iset_regions is None:
        return out
    return out + (iset_maxima_ref(pm_.reshape(ti.grid), iset_regions, num_bp),)


def iset_maxima_ref(pm2d: torch.Tensor, regions, num_bp) -> torch.Tensor:
    """The I-set passes of a (ny, nx) msb+1 map: for k = 1 .. xf the pass at
    which level k's region (every pixel outside the corner (ax_k, ay_k) of
    regions[k]) turns significant, NEVER at 0 and where none is; by static
    slices (speck_lis2.iset_significance_ref)."""
    ny, nx = pm2d.shape
    never = torch.full((), _NEVER, dtype=_I32, device=pm2d.device)
    vals = [never]
    for ax, ay in regions[1:]:
        m = torch.zeros((), dtype=_I32, device=pm2d.device)
        if ay < ny:
            m = torch.maximum(m, pm2d[ay:, :].amax().to(_I32))
        if ax < nx and ay > 0:
            m = torch.maximum(m, pm2d[:ay, ax:].amax().to(_I32))
        vals.append(torch.where(m > 0, num_bp - m, never).to(_I32))
    return torch.stack(vals)


def pixel_schedule(mags: torch.Tensor, ti: TreeIndex, num_bp) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s, e, node maxima) of the child-table schedule with a given num_bp,
    for a CPU tensor: the plain version.  A CUDA tensor raises: on the card
    the schedule is ``schedule_table``."""
    if _dispatch(mags, "pixel_schedule"):
        raise ValueError("pixel_schedule takes CPU tensors; on the card call schedule_table")
    return pixel_schedule_ref(mags, ti, num_bp)


def pixel_schedule_ref(mags: torch.Tensor, ti: TreeIndex, num_bp) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s, e, node maxima) in linear pixel order, by child-table segment
    reductions (any dims); num_bp is an int32 0-d tensor."""
    pm_ = msbp1_device(mags)
    nm = node_max(pm_, ti)
    s = torch.where(pm_ > 0, num_bp - pm_, torch.full_like(pm_, _NEVER)).to(_I32)
    node_s = torch.where(nm > 0, num_bp - nm, torch.full_like(nm, _NEVER)).to(_I32)
    return s, node_s[ti.px_parent_lin], nm


class PyramidIndex:
    """Static device tensors of the pyramid-form schedule (3D dyadic dims):
    for the plain version, each pixel's cell of the deepest level
    (``deep_idx``) and, as flat indices into the concatenated pyramid
    levels, each node's box (``nm_src``, in node order) and each pixel's
    parent box (``e_src``); for the kernels, ``plan``
    (``kernels.PyramidPlan``): per-axis tables in place of the n-entry ones
    (each axis's slots' pixels, its pixels' slots and single depths), the
    tiles' level and the deepest level read.  Raises ValueError for dims
    the pyramid cannot serve (wavelet-packet dims), as the original does."""

    __slots__ = ("dims", "device", "levels", "ax_depth", "deep_idx", "nm_src", "e_src", "nn", "plan")

    def __init__(self, dims, device):
        dev = torch.device(device)
        nx, ny, nz = (int(d) for d in dims)
        self.dims = (nx, ny, nz)
        self.device = dev
        pyr = pm.Pyramid((nx, ny, nz))
        tree = build_tree((nx, ny, nz))
        perm = pm._build_tree_perm(pyr, tree)  # raises for packet dims
        self.levels = pyr.levels
        nz_d, ny_d, nx_d = self.ax_depth = (pyr.az.depth, pyr.ay.depth, pyr.ax.depth)
        self.nn = tree.node_ch_start.size
        zi, yi, xi = pyr.az.slot, pyr.ay.slot, pyr.ax.slot
        # each pixel's slot in the deepest level, (2^nz_d, 2^ny_d, 2^nx_d)
        self.deep_idx = _long(
            ((zi[:, None, None] << (ny_d + nx_d)) | (yi[None, :, None] << nx_d) | xi[None, None, :]).reshape(-1),
            dev,
        )
        # level d has shape (2^min(d, nz_d), 2^min(d, ny_d), 2^min(d, nx_d))
        sizes = [1 << (min(d, nz_d) + min(d, ny_d) + min(d, nx_d)) for d in range(self.levels + 1)]
        off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        # node maxima: every node has one depth, so the ids of all depths
        # are a permutation of the nodes and nm is one gather
        nm_src = np.full(self.nn, -1, dtype=np.int64)
        for d, (ids, boxes) in perm.items():
            nm_src[ids] = off[d] + boxes
        if (nm_src < 0).any():
            raise ValueError(f"the pyramid of {self.dims} leaves nodes without a box")
        self.nm_src = _long(nm_src, dev)
        # each pixel's parent box: one level above the depth where all three
        # of its axis intervals reach length 1
        dz = pyr.az.d_single.astype(np.int16)
        dy = pyr.ay.d_single.astype(np.int16)
        dx = pyr.ax.d_single.astype(np.int16)
        pd = np.maximum.outer(np.maximum.outer(dz, dy), dx)
        e_src = np.zeros((nz, ny, nx), dtype=np.int64)
        for d in range(int(pd.max()) + 1):
            mask = pd == d
            if not mask.any():
                continue
            pdep = max(d - 1, 0)
            ddz, ddy, ddx = min(pdep, nz_d), min(pdep, ny_d), min(pdep, nx_d)
            bz = zi >> (nz_d - ddz)
            by = yi >> (ny_d - ddy)
            bx = xi >> (nx_d - ddx)
            flat = off[pdep] + ((bz[:, None, None] << (ddy + ddx)) | (by[None, :, None] << ddx)
                                | bx[None, None, :])
            e_src[mask] = flat[mask]
        self.e_src = _long(e_src.reshape(-1), dev)
        # the kernels' plan: the n-entry deep_idx and e_src give way to per-axis tables
        if off[-1] >= 2**31 or max(self.ax_depth) > 23:
            raise ValueError(f"the pyramid of {self.dims} is too large for int32 tables")
        lmax = max(max(perm), max(int(pd.max()) - 1, 0))
        top = kernels.pyramid_top(self.ax_depth)
        tabs = []
        for t in (pyr.az, pyr.ay, pyr.ax):
            tabs += [t.inv, (t.slot << 8) | t.d_single]
        starts = np.cumsum([0] + [len(a) for a in tabs])
        self.plan = kernels.PyramidPlan(
            dims=(nz, ny, nx), depth=self.ax_depth, levels=self.levels, top=top, lmax=lmax,
            off=tuple(int(v) for v in off[:max(lmax, top) + 2]), axes=_int(np.concatenate(tabs), dev),
            inv=tuple(int(v) for v in starts[0:6:2]), px=tuple(int(v) for v in starts[1:6:2]),
            nm_src=self.nm_src.to(torch.int32))


_PYR_INDEXES: Dict[Tuple[Tuple[int, ...], str], PyramidIndex] = {}


def pyramid_index(dims, device) -> PyramidIndex:
    """The pyramid index for ``dims`` on ``device``, made once and cached;
    ValueError where the pyramid cannot serve the dims."""
    key = (tuple(int(d) for d in dims), str(torch.device(device)))
    pi = _PYR_INDEXES.get(key)
    if pi is None:
        pi = _PYR_INDEXES[key] = PyramidIndex(key[0], device)
    return pi


def schedule_pyramid(mags: torch.Tensor, pi: PyramidIndex):
    """(num_bp, s, e, node maxima in tree order) of the pyramid schedule (3D
    dyadic dims), num_bp an int32 0-d tensor on the device.  On a CUDA
    tensor the ``sched_pyramid`` kernels (two launches); on a CPU tensor the
    plain version."""
    if _dispatch(mags, "schedule_pyramid"):
        return kernels.sched_pyramid(_words32(mags).reshape(-1), pi.plan)
    num_bp = msbp1_device(mags).max()
    return (num_bp,) + pixel_schedule_pyramid_ref(mags, pi, num_bp)


def pixel_schedule_pyramid(mags: torch.Tensor, pi: PyramidIndex, num_bp):
    """``pixel_schedule`` by max-pool pyramids with a given num_bp, for a
    CPU tensor: the plain version.  A CUDA tensor raises: on the card the
    schedule is ``schedule_pyramid``."""
    if _dispatch(mags, "pixel_schedule_pyramid"):
        raise ValueError("pixel_schedule_pyramid takes CPU tensors; on the card call schedule_pyramid")
    return pixel_schedule_pyramid_ref(mags, pi, num_bp)


def pixel_schedule_pyramid_ref(mags: torch.Tensor, pi: PyramidIndex, num_bp):
    """``pixel_schedule`` by max-pool pyramids (3D dyadic dims), plain
    version: the same (s, e, node maxima in tree order)."""
    nz_d, ny_d, nx_d = pi.ax_depth
    pm_ = msbp1_device(mags)
    deep = torch.zeros(1 << (nz_d + ny_d + nx_d), dtype=pm_.dtype, device=pm_.device)
    deep[pi.deep_idx] = pm_
    cur = deep.reshape(1 << nz_d, 1 << ny_d, 1 << nx_d)
    levels = [cur.reshape(-1)]
    for d in range(pi.levels - 1, -1, -1):
        z2 = 2 if d < nz_d else 1
        y2 = 2 if d < ny_d else 1
        x2 = 2 if d < nx_d else 1
        sz, sy, sx = cur.shape
        cur = cur.reshape(sz // z2, z2, sy // y2, y2, sx // x2, x2).amax(dim=(1, 3, 5))
        levels.append(cur.reshape(-1))
    flat = torch.cat(levels[::-1])  # depth 0 (the whole box) first
    nm = flat[pi.nm_src].to(_I32)
    s = torch.where(pm_ > 0, num_bp - pm_, torch.full_like(pm_, _NEVER)).to(_I32)
    bm = flat[pi.e_src]
    e = torch.where(bm > 0, num_bp - bm, torch.full_like(bm, _NEVER)).to(_I32)
    return s, e, nm


def node_passes(nm: torch.Tensor, num_bp) -> torch.Tensor:
    """The walks' node passes from a schedule's node maxima: num_bp - nm
    where nm > 0, else NEVER (int32).  On a CUDA tensor one launch
    (``kernels.node_passes``); on a CPU tensor the plain version."""
    if _dispatch(nm, "node_passes"):
        return kernels.node_passes(_words32(nm), _words32(num_bp))
    return node_passes_ref(nm, num_bp)


def node_passes_ref(nm: torch.Tensor, num_bp) -> torch.Tensor:
    """Plain ``node_passes``."""
    return torch.where(nm > 0, num_bp - nm, _NEVER).to(_I32)


# ---------------------------------------------------------------------------
# Event form (the walks' event tail, ops/speck_lis._event_tail)
# ---------------------------------------------------------------------------
def _expand_fill(ln: torch.Tensor, words, ev_cap: int, widths=None):
    """Interval expansion by forward fill: item k (in order) contributes
    ln[k] consecutive events, and each event receives the item's payload
    ``words`` (int32 [T] each) and its offset within the item's block.

    Returns (filled words, int32 [ev_cap] each; rel int32 [ev_cap], the
    event's index within its block; ev_ok, the events below the total;
    ev_total int32).  With ``widths`` (each word's bit width, which its
    values must fit) the fill is a few cummax passes: each fills (block
    start << pb | a pb-bit chunk of the payload), and block starts strictly
    increase over the items that emit, so the running maximum selects the
    latest start at or before an event and carries its chunk.  Without
    ``widths``, or when ev_cap leaves no payload bits, the reference's
    associative scan runs in its direct form: each event takes the row of
    the last item that starts at or before it (zeros before the first)."""
    dev = ln.device
    ln = ln.to(_I32)
    off = torch.cumsum(ln, dim=0, dtype=_I32) - ln
    ev_total = ln.sum(dtype=_I32)
    # items that emit nothing, and starts past the cap, land in the slot
    # ev_cap, which is dropped (no two emitting items share a start)
    slot = torch.where(ln > 0, torch.clamp(off, max=ev_cap), ev_cap).long()
    j = torch.arange(ev_cap, dtype=_I32, device=dev)
    ev_ok = j < ev_total

    pb = 30 - max(1, (ev_cap - 1).bit_length()) if widths is not None else 0
    if pb >= 1:
        # payload words chopped into pb-bit chunks, each filled behind the
        # (monotone) block-start field
        chunk_src = []  # (word index, low bit, take)
        for wi, wd in enumerate(widths):
            for lo in range(0, int(wd), pb):
                chunk_src.append((wi, lo, min(pb, int(wd) - lo)))
        fills = []
        for wi, lo, take in chunk_src:
            buf = torch.full((ev_cap + 1,), -1, dtype=_I32, device=dev)
            buf[slot] = (off << pb) | ((words[wi] >> lo) & ((1 << take) - 1))
            fills.append(torch.cummax(buf[:ev_cap], dim=0).values)
        rel = j - (fills[0] >> pb)
        filled = [torch.zeros(ev_cap, dtype=_I32, device=dev) for _ in words]
        for (wi, lo, take), f in zip(chunk_src, fills):
            filled[wi] = filled[wi] | ((f & ((1 << take) - 1)) << lo)
        return filled, rel, ev_ok, ev_total

    rows = torch.stack([torch.ones_like(ln), off] + [w.to(_I32) for w in words], dim=1)
    buf = torch.zeros((ev_cap + 1, rows.shape[1]), dtype=_I32, device=dev)
    buf[slot] = rows
    buf = buf[:ev_cap]
    last = torch.cummax(torch.where(buf[:, 0] > 0, j, -1), dim=0).values
    filled = torch.where((last >= 0)[:, None], buf[torch.clamp(last, min=0).long()], 0)
    rel = j - filled[:, 1]
    return [filled[:, 2 + i] for i in range(len(words))], rel, ev_ok, ev_total


def _packbits(bits01: torch.Tensor) -> torch.Tensor:
    """A 0/1 int32 vector (length % 8 == 0) packed LSB-first into bytes."""
    sh = torch.arange(8, dtype=_I32, device=bits01.device)
    return (bits01.reshape(-1, 8) << sh).sum(dim=1, dtype=_I32).to(torch.uint8)


def events_to_segments(p_key: torch.Tensor, sec_key, bits: torch.Tensor, num_bp_cap: int,
                       cap_total: int):
    """Emission events sorted by (pass, within-pass order) into the
    byte-aligned concatenation of the per-pass segments.

    p_key: int32 pass per event (num_bp_cap or more: invalid); sec_key:
    int32 within-pass order, or None when the events are already in
    within-pass order; bits: the events' values.  Returns (buf uint8
    [cap_total], counts int32 [num_bp_cap], total_bytes int32).  Each pass
    gets the (-count) mod 8 zero pad events that end its segment on a byte;
    pads key just after their pass's events, the unused ones past the end,
    so the sorted bits are the stream itself.  With no ``sec_key`` the sort
    is over one fused int32 key (key, index, bit) where it fits, else a
    stable sort of the key; with one, a stable sort of (key, sec_key) as one
    int64 key.  The per-pass counts are a count into num_bp_cap + 1 bins
    (invalid keys in the last)."""
    dev = p_key.device
    EV = p_key.shape[0]
    P = num_bp_cap
    NPAD = 7 * P
    pvals = torch.arange(P, dtype=_I32, device=dev)
    valid = (p_key >= 0) & (p_key < P)
    counts = torch.zeros(P + 1, dtype=_I32, device=dev).scatter_add_(
        0, torch.where(valid, p_key, P).long(), torch.ones(EV, dtype=_I32, device=dev)
    )[:P]
    bc = (counts + 7) // 8
    total_bytes = bc.sum(dtype=_I32)
    needed = bc * 8 - counts  # pad events per pass, in [0, 7]

    # combined key: real events at 2p, kept pads at 2p + 1, the rest last
    big = 2 * P + 2
    key_real = torch.where(p_key < P, p_key * 2, big)
    pad_p = pvals.repeat_interleave(7)
    pad_slot = torch.arange(7, dtype=_I32, device=dev).repeat(P)
    key_pad = torch.where(pad_slot < needed[pad_p.long()], pad_p * 2 + 1, big)
    key_all = torch.cat([key_real.to(_I32), key_pad])
    bit_all = torch.cat([bits.to(_I32), torch.zeros(NPAD, dtype=_I32, device=dev)])

    TT = EV + NPAD
    jbits = max(1, (TT - 1).bit_length())
    if sec_key is None and big.bit_length() + jbits + 1 <= 31:
        # unique keys: the index keeps real events in their order and puts
        # the pads after them
        fused = (key_all << (jbits + 1)) | (torch.arange(TT, dtype=_I32, device=dev) << 1) | bit_all
        bit_sorted = torch.sort(fused).values & 1
    elif sec_key is None:
        bit_sorted = bit_all[torch.sort(key_all, stable=True).indices]
    else:
        sec_all = torch.cat([sec_key.to(_I32), torch.full((NPAD,), 0x7FFFFFFF, dtype=_I32, device=dev)])
        k64 = (key_all.to(torch.int64) << 32) | (sec_all.to(torch.int64) + (1 << 31))
        bit_sorted = bit_all[torch.sort(k64, stable=True).indices]

    # every stream byte is a real event or a kept pad, so at most TT bits
    # are packed; the bytes are zero-padded to the capacity
    k_bits = min(cap_total * 8, ((TT + 7) // 8) * 8)
    if k_bits > TT:
        bit_sorted = torch.cat([bit_sorted, torch.zeros(k_bits - TT, dtype=_I32, device=dev)])
    else:
        bit_sorted = bit_sorted[:k_bits]
    iota = torch.arange(k_bits, dtype=_I32, device=dev)
    packed = _packbits(torch.where(iota < total_bytes * 8, bit_sorted, 0))
    if cap_total > k_bits // 8:
        packed = torch.cat([packed, torch.zeros(cap_total - k_bits // 8, dtype=torch.uint8, device=dev)])
    return packed, counts, total_bytes


__all__ = [
    "TreeIndex",
    "tree_index",
    "node_max",
    "pixel_schedule",
    "pixel_schedule_ref",
    "schedule_table",
    "iset_maxima_ref",
    "subtree_plan",
    "PyramidIndex",
    "pyramid_index",
    "pixel_schedule_pyramid",
    "pixel_schedule_pyramid_ref",
    "schedule_pyramid",
    "node_passes",
    "events_to_segments",
]
