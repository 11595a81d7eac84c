"""The static path keys of the sorted SPECK emission (the port's copy of
``SortedTree``, ``_insert_digit``, ``sorted_tree`` and
``lis_segments_sorted_2d`` from sperr_tpu/codec/speck_sorted.py).

The serial coder's list-insertion order is a computable total order over
tree nodes:

    O(n) within its level = lex( birth pass b(n),
                                 anchor level (finer first),
                                 O(anchor),
                                 child-index path from the anchor )

so every LIS bit has a static sort key, and the set walk runs as a few sorts
on the device (ops/speck_lis.py, ops/speck_lis2.py).  The per-node arrays
here (parent, child slot, depth and the packed root-path digits) are its
static half, built once per dims from the partition tree
(codec/speck_wave.py) and cached.  The 2D host walk
``lis_segments_sorted_2d`` is copied too: ``stitch_2d`` runs it when the
device supplies no LIS segments.  The original's 3D host walk
``lis_segments_sorted`` is not copied.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .speck_wave import _NEVER, Tree


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


def lis_segments_sorted_2d(
    tree,
    node_s: np.ndarray,
    s_lin: np.ndarray,
    signs: np.ndarray,
    num_bp: int,
    iset_s: np.ndarray,
) -> List[np.ndarray]:
    """2D per-pass LIS segments (quad partitions + the QccPack I-set) via
    sorting — byte-identical to the recursive walk with the process_i hook.

    The I-set adds one node class: the group nodes (SPECK2D_INT.cpp
    m_partition_I's three sets per level), parentless in the tree but born
    at the pass their I-level partitions.  Their descendants anchor to them
    with a static event rank, and the bits of an immediate I recursion
    (group partitioned at its own birth pass) are assembled per event at the
    end of the pass — at most num_of_xforms events in the whole stream, so
    that part stays scalar."""
    st = sorted_tree(tree)
    nn = node_s.size
    lev = tree.node_level.astype(np.int64)
    parent = st.parent
    no_parent = parent < 0
    is_walk_root = np.zeros(nn, dtype=bool)
    is_walk_root[tree.root_id] = True
    is_group = no_parent & ~is_walk_root

    # group metadata: event-major rank (k = xf..1, then slot order)
    iset_s = np.asarray(iset_s, dtype=np.int64)
    b_group = np.full(nn, _NEVER, dtype=np.int64)
    irank = np.full(nn, -1, dtype=np.int64)
    r = 0
    for k in range(tree.xf, 0, -1):
        for nid in tree.iset_groups[k]:
            b_group[nid] = int(iset_s[k])
            irank[nid] = r
            r += 1

    s = node_s.astype(np.int64)
    b = np.where(no_parent, 0, s[np.maximum(parent, 0)])
    b = np.where(is_group, b_group, b)

    # anchors: first strict ancestor with smaller birth (or parentless head)
    anchor = np.where(no_parent, np.arange(nn), parent)
    for _ in range(int(st.depth.max()) + 1):
        a_par = parent[anchor]
        move = (~no_parent) & (a_par >= 0) & (b[anchor] == b)
        if not move.any():
            break
        anchor = np.where(move, np.maximum(a_par, 0), anchor)

    O = np.full(nn, -1, dtype=np.int64)
    born = b < _NEVER
    ROOT_FIRST = -(10**6)
    I_CLASS = 10**6  # I-born anchors sort after every level anchor (the
                     # i_hook appends after all level walks)
    nlev = int(lev.max()) + 1
    offsets = np.zeros(nlev, dtype=np.int64)
    bn_all = np.flatnonzero(born)
    b_bn = b[bn_all]
    for bp in np.unique(b_bn):
        sel = bn_all[b_bn == bp]
        lev_sel = lev[sel]
        for t in np.unique(lev_sel):
            grp = sel[lev_sel == t]
            ar = anchor[grp]
            true_root = is_walk_root[grp]
            # A group-node anchor orders by its I event only when the birth
            # happened during that event: the node IS the group (its own
            # arrival), or the group partitioned at its own birth pass.  A
            # group that survived into a list and partitioned later anchors
            # its children like any list entry (level, O).
            g_anc = is_group[ar] & ((grp == ar) | (b[ar] == s[ar]))
            a_lev = np.where(
                true_root, ROOT_FIRST, np.where(g_anc, I_CLASS, -lev[ar])
            )
            a_born = np.where(true_root | is_walk_root[ar], 0, 1)
            a_ord = np.where(
                true_root, 0,
                np.where(g_anc, irank[ar], np.where(is_walk_root[ar], 0, O[ar])),
            )
            order = np.lexsort(
                (st.path_lo[grp], st.path_hi[grp], a_ord, a_born, a_lev)
            )
            O[grp[order]] = offsets[t] + np.arange(grp.size)
            offsets[t] += grp.size
    w = np.full(nn, np.iinfo(np.int64).max, dtype=np.int64)
    worder = np.lexsort((O[bn_all], -lev[bn_all]))
    w[bn_all[worder]] = np.arange(bn_all.size)

    ent = bn_all[worder]
    ent_from = np.where(is_walk_root[ent], 0, b[ent] + 1)
    ent_s = s[ent]

    # active rows
    act = np.flatnonzero(s < _NEVER)
    cnt = tree.node_ch_count[act]
    starts = tree.node_ch_start[act]
    nra = int(cnt.sum())
    rp = np.repeat(act, cnt)
    ends = np.cumsum(cnt)
    gstart = ends - cnt
    rslot = np.arange(nra, dtype=np.int64) - np.repeat(gstart, cnt)
    rows_tbl = np.repeat(starts, cnt) + rslot
    ref = tree.ch_ref[rows_tbl]
    ispx = tree.ch_is_pixel[rows_tbl]
    px_lin = tree.px_linear

    rowpass = s[rp]
    row_sig_pass = np.where(
        ispx, s_lin[px_lin[np.where(ispx, ref, 0)]],
        s[np.where(ispx, 0, ref)],
    ).astype(np.int64)
    row_sign = np.zeros(nra, dtype=np.uint8)
    row_sign[ispx] = signs[px_lin[ref[ispx]]]

    top = np.where((b[rp] < s[rp]) | no_parent[rp], rp, anchor[rp])
    w_top = w[top]

    dq = st.depth[rp].astype(np.int64)
    row_hi, row_lo = _insert_digit(st.path_hi[rp], st.path_lo[rp], dq, rslot + 1)

    sig_now = row_sig_pass == rowpass
    csum = np.cumsum(sig_now.astype(np.int64))
    base = np.repeat(csum[gstart] - sig_now[gstart], cnt)
    prev_any = (csum - sig_now) - base
    last_slot = rslot == np.repeat(cnt, cnt) - 1
    emitted = (prev_any > 0) | (~last_slot)

    # rows whose bits belong to an immediate I recursion (group node
    # partitioned at its own birth pass): assembled in the I segment
    icrit = is_group[top] & (b[top] == s[top]) & (rowpass == s[top])
    nrm = np.flatnonzero(~icrit)
    rorder = nrm[np.argsort(rowpass[nrm], kind="stable")]
    rbounds = np.searchsorted(rowpass[rorder], np.arange(num_bp + 1))

    def block_seg(rows: np.ndarray) -> np.ndarray:
        """Decision + sign bits of a single anchor's rows, walk order."""
        em = rows[emitted[rows]]
        d_bits = (row_sig_pass[em] == rowpass[em]).astype(np.uint8)
        sg = rows[(row_sig_pass[rows] == rowpass[rows]) & ispx[rows]]
        g_bits = row_sign[sg]
        bits = np.concatenate([d_bits, g_bits])
        khi = np.concatenate([row_hi[em], row_hi[sg]])
        klo = np.concatenate([row_lo[em], row_lo[sg]])
        ks = np.concatenate(
            [np.zeros(em.size, np.int8), np.ones(sg.size, np.int8)]
        )
        return bits[np.lexsort((ks, klo, khi))]

    ic_rows = np.flatnonzero(icrit)
    ic_top = top[ic_rows]

    segments: List[np.ndarray] = []
    i_lev = tree.xf
    for p in range(num_bp):
        memb = (ent_from <= p) & (p <= ent_s)
        mi = np.flatnonzero(memb)
        e_bits = (ent_s[mi] == p).astype(np.uint8)
        e_w = w[ent[mi]]
        e_hi = st.path_hi[ent[mi]]
        e_lo = st.path_lo[ent[mi]]
        e_slot = np.zeros(mi.size, dtype=np.int8)

        rows = rorder[rbounds[p] : rbounds[p + 1]]
        em = rows[emitted[rows]]
        d_bits = (row_sig_pass[em] == p).astype(np.uint8)
        d_w = w_top[em]
        d_hi = row_hi[em]
        d_lo = row_lo[em]
        d_slot = np.zeros(em.size, dtype=np.int8)
        sg_rows = rows[(row_sig_pass[rows] == p) & ispx[rows]]
        g_bits = row_sign[sg_rows]
        g_w = w_top[sg_rows]
        g_hi = row_hi[sg_rows]
        g_lo = row_lo[sg_rows]
        g_slot = np.ones(sg_rows.size, dtype=np.int8)

        bits = np.concatenate([e_bits, d_bits, g_bits])
        kw = np.concatenate([e_w, d_w, g_w])
        khi = np.concatenate([e_hi, d_hi, g_hi])
        klo = np.concatenate([e_lo, d_lo, g_lo])
        ks = np.concatenate([e_slot, d_slot, g_slot])
        order = np.lexsort((ks, klo, khi, kw))
        seg = [bits[order]]

        # I-set subsequence (at most xf partitions over the whole stream)
        ibits: List[int] = []
        decide = True
        while i_lev > 0:
            sig = int(iset_s[i_lev]) == p
            if decide:
                ibits.append(1 if sig else 0)
            if not sig:
                break
            k = i_lev
            i_lev -= 1
            counter = 0
            for nid in tree.iset_groups[k]:
                nsig = int(s[nid]) == p
                ibits.append(1 if nsig else 0)
                if nsig:
                    counter += 1
                    seg.append(np.array(ibits, dtype=np.uint8))
                    ibits = []
                    seg.append(block_seg(ic_rows[ic_top == nid]))
            decide = counter != 0
        if ibits:
            seg.append(np.array(ibits, dtype=np.uint8))
        segments.append(np.concatenate(seg) if len(seg) > 1 else seg[0])
    return segments
