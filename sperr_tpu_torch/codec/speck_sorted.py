"""The static path keys of the sorted SPECK emission (the port's copy of
``SortedTree``, ``_insert_digit`` and ``sorted_tree`` from
sperr_tpu/codec/speck_sorted.py).

The serial coder's list-insertion order is a computable total order over
tree nodes:

    O(n) within its level = lex( birth pass b(n),
                                 anchor level (finer first),
                                 O(anchor),
                                 child-index path from the anchor )

so every LIS bit has a static sort key, and the set walk runs as a few sorts
on the device (ops/speck_lis.py).  The per-node arrays here (parent, child
slot, depth and the packed root-path digits) are its static half, built once
per dims from the partition tree (codec/speck_wave.py) and cached.  The
original's host walk ``lis_segments_sorted`` is not copied.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .speck_wave import Tree


class SortedTree:
    """Static per-node arrays for the sorted emission (cached per dims
    alongside the Tree): parent, child slot, depth, packed root-path keys."""

    __slots__ = ("parent", "slot", "depth", "path_hi", "path_lo", "root_rank")


_SORTED: Dict[Tuple[int, int, int], SortedTree] = {}

# path digit layout: depth index d < 12 lives in path_hi at bit 5*(11-d),
# d in [12, 24) in path_lo at bit 5*(23-d); zero-padded below a node's depth
# so a node's key sorts before its descendants'.


def _insert_digit(hi, lo, d, digit):
    in_hi = d < 12
    hi = hi | np.where(in_hi, digit << (5 * (11 - np.minimum(d, 11))), 0)
    lo = lo | np.where(in_hi, 0, digit << (5 * (23 - np.maximum(d, 12))))
    return hi, lo


def sorted_tree(tree: Tree) -> SortedTree:
    # key by tree TYPE too: Tree1(n) and a 3D Tree(n,1,1) share .dims
    key = (type(tree).__name__,) + tuple(tree.dims)
    st = _SORTED.get(key)
    if st is not None:
        return st
    nn = tree.node_ch_start.size
    parent = np.full(nn, -1, dtype=np.int64)
    slot = np.zeros(nn, dtype=np.int64)
    nrows = tree.ch_ref.size
    row_parent = np.repeat(np.arange(nn, dtype=np.int64), tree.node_ch_count)
    ends = np.cumsum(tree.node_ch_count)
    row_slot = (
        np.arange(nrows, dtype=np.int64)
        - np.repeat(ends - tree.node_ch_count, tree.node_ch_count)
    )
    nd_rows = ~tree.ch_is_pixel
    parent[tree.ch_ref[nd_rows]] = row_parent[nd_rows]
    slot[tree.ch_ref[nd_rows]] = row_slot[nd_rows]

    depth = np.zeros(nn, dtype=np.int16)
    hi = np.zeros(nn, dtype=np.int64)
    lo = np.zeros(nn, dtype=np.int64)
    # BFS ranges: parents always resolve in an earlier range
    for lo_, hi_ in tree.node_depth_ranges:
        par = parent[lo_:hi_]
        ok = par >= 0
        idx = np.arange(lo_, hi_)[ok]
        p = par[ok]
        depth[lo_:hi_] = np.where(par < 0, 0, depth[np.maximum(par, 0)] + 1)
        d = depth[idx].astype(np.int64) - 1
        dig = (slot[idx] + 1).astype(np.int64)
        h, l = _insert_digit(hi[p], lo[p], d, dig)
        hi[idx] = h
        lo[idx] = l
    assert int(depth.max(initial=0)) + 2 <= 24, "path packing supports depth <= 24"

    st = SortedTree()
    st.parent = parent
    st.slot = slot
    st.depth = depth
    st.path_hi = hi
    st.path_lo = lo
    rids = getattr(tree, "root_ids", None)
    st.root_rank = (
        {int(r): i for i, r in enumerate(rids)}
        if rids is not None
        else {int(tree.root_id): 0}  # Tree2: single walked root; the I-group
                                     # nodes are parentless but not roots
    )
    _SORTED[key] = st
    return st
