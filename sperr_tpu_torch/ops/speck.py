"""Device SPECK schedule for 3D chunks that are not power-of-two cubes (K15).

PyTorch port of the table and pyramid half of sperr_tpu/ops/speck_jax.py:
``TreeIndex`` / ``tree_index``, ``node_max`` and ``pixel_schedule`` (the
child-table form, any dims), and ``PyramidIndex`` / ``pyramid_index`` and
``pixel_schedule_pyramid`` (the max-pool form, dyadic dims).  Both give, as
``speck_virtual.pixel_schedule_virtual`` does for power-of-two cubes:

  * s  = the pass at which each pixel becomes significant (NEVER for zero);
  * e  = the pass at which each pixel's parent set partitions, exposing it
         into the LIP;
  * nm = the maximum msb+1 of every node of the partition tree, in its BFS
         order (the set-significance oracle of the walk, ops/speck_lis.py).

The indices are static per dims: their host tables come from the partition
tree (codec/speck_wave.py) and, for the pyramid form, ops/pyramid.py; their
device tensors are made once per (dims, device) and cached.  Integer results
equal the JAX package's bit for bit.  Everything runs as torch ops on the
tensors' device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..codec.speck_wave import build_tree
from . import pyramid as pm
from .speck_virtual import msbp1_device

_NEVER = 0x7FFF
_I32 = torch.int32


def _long(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64), device=device)


def _pixel_parent(tree) -> np.ndarray:
    """Parent node of every pixel in linear order: the pixel slots are a
    permutation of the pixels (each appears once as a singleton child), so
    the schedule's e is one gather instead of a scatter."""
    par = np.full(tree.n, -1, dtype=np.int64)
    par[tree.px_linear] = tree.px_parent
    if tree.px_linear.size != tree.n or (par < 0).any():
        raise ValueError(f"the pixel slots of {tree.dims} are not a permutation of the pixels")
    return par


class TreeIndex:
    """Static device tensors of the child-table schedule: per depth (deepest
    first) the child rows' value sources and parent rows, and each pixel's
    parent node."""

    __slots__ = ("dims", "device", "n", "nn", "depth_slices", "px_parent_lin")

    def __init__(self, dims, device):
        dev = torch.device(device)
        tree = build_tree(tuple(int(d) for d in dims))
        self.dims = tree.dims
        self.device = dev
        self.n = tree.n
        self.nn = tree.node_ch_start.size
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
        self.px_parent_lin = _long(_pixel_parent(tree), dev)


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


def pixel_schedule(mags: torch.Tensor, ti: TreeIndex, num_bp) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s, e, node maxima) in linear pixel order, by child-table segment
    reductions (any dims); num_bp is an int32 0-d tensor."""
    pm_ = msbp1_device(mags)
    nm = node_max(pm_, ti)
    s = torch.where(pm_ > 0, num_bp - pm_, torch.full_like(pm_, _NEVER)).to(_I32)
    node_s = torch.where(nm > 0, num_bp - nm, torch.full_like(nm, _NEVER)).to(_I32)
    return s, node_s[ti.px_parent_lin], nm


class PyramidIndex:
    """Static device tensors of the pyramid-form schedule (3D dyadic dims):
    the per-axis slot tables that embed the pixels in a power-of-two box,
    and, as flat indices into the concatenated pyramid levels, each node's
    box (in node order) and each pixel's parent box.  Raises ValueError for
    dims the pyramid cannot serve (wavelet-packet dims), as the original
    does."""

    __slots__ = ("dims", "device", "levels", "ax_depth", "deep_idx", "nm_src", "e_src", "nn")

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


_PYR_INDEXES: Dict[Tuple[Tuple[int, ...], str], PyramidIndex] = {}


def pyramid_index(dims, device) -> PyramidIndex:
    """The pyramid index for ``dims`` on ``device``, made once and cached;
    ValueError where the pyramid cannot serve the dims."""
    key = (tuple(int(d) for d in dims), str(torch.device(device)))
    pi = _PYR_INDEXES.get(key)
    if pi is None:
        pi = _PYR_INDEXES[key] = PyramidIndex(key[0], device)
    return pi


def pixel_schedule_pyramid(mags: torch.Tensor, pi: PyramidIndex, num_bp):
    """``pixel_schedule`` by max-pool pyramids (3D dyadic dims): the same
    (s, e, node maxima in tree order)."""
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


__all__ = [
    "TreeIndex",
    "tree_index",
    "node_max",
    "pixel_schedule",
    "PyramidIndex",
    "pyramid_index",
    "pixel_schedule_pyramid",
]
