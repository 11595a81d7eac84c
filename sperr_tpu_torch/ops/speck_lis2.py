"""Device 2D set walk (K14's walk): quad partitions and the QccPack I-set.

PyTorch port of sperr_tpu/ops/speck_lis2_jax.py: ``Lis2Index`` /
``lis2_index``, ``iset_significance_device`` and ``lis2_segments_device``.
The 2D tree (codec/speck_wave.Tree2) walks like the 3D table walk
(ops/speck_lis.py): pointer-doubled chain anchors, a rank-doubling ladder
for their string ranks, one sort for the born rows' insertion ranks, one
for the walk ranks, one for the items.  The I-set adds three item classes
with computed ranks after every level-walk item: a pending I(k) membership
bit per level, each group's arrival bit, and the rows of a group that
partitions at its own birth pass, re-keyed into the I item space (static
rank 8 (xf - k) + {0; 1 + 2j; 2 + 2j} for k = xf .. 1).  The items'
payload words go to the emission (``return_events="items"``: on the card
K9b's LIS planes and K11, ops/wave_pack.wave_emit_2d_lis, as the 3D walk's
do), or through the 3D walk's event tail (``ops/speck_lis._event_tail``,
the plain form): they expand into events and pack into byte-aligned
per-pass segments, byte for byte those of
codec.speck_sorted.lis_segments_sorted_2d.  On a CUDA tensor the walk runs
the kernels of kernels/walk_table.cu (``speck_lis._table_items_cuda``),
and its I-set passes come with the schedule (``speck.schedule_table`` with
``iset_regions``: the child-table schedule's pixel pass); on a CPU tensor
the plain versions (``_lis2_items_ref``, ``iset_significance_ref``).

As in the table walk, the compactions of the significant sets and of the
born rows are K12 (ascending indices with a sentinel, as the reference's
one-key sorts over unique keys give them), multi-key sorts are one int64
key where the widths fit and chained stable sorts otherwise, and the
scatters whose indices repeat write the repeats only to a sentinel slot
that no read reaches.  Wherever full keys tie, the tied items emit no bits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..codec.speck_sorted import sorted_tree
from ..codec.speck_wave import build_tree2
from . import speck as spk
from .packemit import _dispatch
from .speck_lis import (
    LisIndex, _bcast8, _born_rows, _chain_anchors, _event_tail, _i32, _level_counts, _pack2,
    _parent_rows, _string_ranks, _table_items_cuda, _walk_order, _walk_ranks, lexsort,
)

_NEVER = 0x7FFF
_BIG = 2**31 - 1
_I32 = torch.int32


class Lis2Index:
    """Static device tensors of the 2D walk (cached per dims and device):
    the table walk's per-node and child tables (``LisIndex``'s, from the
    quad/I-set tree), and the I-set's groups: per node whether it is a
    group head, its level k, its rank among the group events and its block
    rank; per group (k = xf .. 1, slot order) its id, level and arrival
    bit rank; ``gsel[k]``, the groups of level k."""

    __slots__ = (
        "dims", "device", "nn", "n", "nrows", "max_ch", "depth_max", "nlev", "xf", "G",
        "parent", "level", "depth", "pw", "ch_start", "ch_count", "ctab",
        "is_group", "k_of", "irank_of", "block_rank_of",
        "group_ids", "group_k", "gbit_rank", "gsel", "ks", "_walk_static",
    )

    def __init__(self, dims, device):
        dev = torch.device(device)
        tree = build_tree2((int(dims[0]), int(dims[1])))
        st = sorted_tree(tree)
        nn = tree.node_ch_start.size
        self.dims = tree.dims
        self.device = dev
        self.nn = nn
        self.n = tree.n
        self.nrows = tree.ch_ref.size
        self.max_ch = int(tree.node_ch_count.max())
        self.depth_max = int(st.depth.max())
        self.xf = int(tree.xf)
        lev = tree.node_level.astype(np.int32)
        self.nlev = int(lev.max()) + 1
        self.parent = _i32(st.parent, dev)
        self.level = _i32(lev, dev)
        self.depth = _i32(st.depth, dev)
        # path words as in LisIndex (a shallow tree needs the first two)
        hi, lo = st.path_hi, st.path_lo
        m30 = (1 << 30) - 1
        pw = np.stack([(hi >> 30) & m30, hi & m30, (lo >> 30) & m30, lo & m30], axis=1)
        self.pw = _i32(pw[:, : 2 if self.depth_max <= 10 else 4], dev)
        self.ch_start = _i32(tree.node_ch_start, dev)
        self.ch_count = _i32(tree.node_ch_count, dev)
        refs = tree.ch_ref
        ispx = tree.ch_is_pixel
        resolved = np.where(ispx, tree.px_linear[np.where(ispx, refs, 0)], tree.n + refs).astype(np.int64)
        self.ctab = _i32((resolved << 1) | ispx.astype(np.int64), dev)

        # group metadata in event order (k = xf .. 1, slot order)
        gids, gks, granks, blk_ranks, gbit_ranks = [], [], [], [], []
        r = 0
        for k in range(self.xf, 0, -1):
            for j, nid in enumerate(tree.iset_groups[k]):
                gids.append(int(nid))
                gks.append(k)
                granks.append(r)
                gbit_ranks.append(8 * (self.xf - k) + 1 + 2 * j)
                blk_ranks.append(8 * (self.xf - k) + 2 + 2 * j)
                r += 1
        self.G = len(gids)
        is_group = np.zeros(nn, dtype=bool)
        k_of = np.zeros(nn, dtype=np.int32)
        irank_of = np.zeros(nn, dtype=np.int32)
        block_rank_of = np.zeros(nn, dtype=np.int32)
        for g, k, rr, br in zip(gids, gks, granks, blk_ranks):
            is_group[g] = True
            k_of[g] = k
            irank_of[g] = rr
            block_rank_of[g] = br
        self.is_group = torch.as_tensor(is_group, device=dev)
        self.k_of = _i32(k_of, dev)
        self.irank_of = _i32(irank_of, dev)
        self.block_rank_of = _i32(block_rank_of, dev)
        self.group_ids = _i32(np.asarray(gids, dtype=np.int32), dev)
        self.group_k = _i32(np.asarray(gks, dtype=np.int32), dev)
        self.gbit_rank = _i32(np.asarray(gbit_ranks, dtype=np.int32), dev)
        gsel = np.zeros((self.xf + 2, max(self.G, 1)), dtype=bool)
        for i, k in enumerate(gks):
            gsel[k, i] = True
        self.gsel = torch.as_tensor(gsel, device=dev)
        self.ks = _i32(np.arange(self.xf, 0, -1), dev)  # the I levels, k = xf .. 1
        self._walk_static = None

    # the table walk's child and path lookups
    children = LisIndex.children
    paths_of = LisIndex.paths_of
    child_paths = LisIndex.child_paths


_LIS2_INDEXES: Dict[Tuple[Tuple[int, int], str], Lis2Index] = {}


def lis2_index(dims, device) -> Lis2Index:
    """The 2D walk's index for ``dims`` = (nx, ny) on ``device``, made once
    and cached."""
    key = ((int(dims[0]), int(dims[1])), str(torch.device(device)))
    li = _LIS2_INDEXES.get(key)
    if li is None:
        li = _LIS2_INDEXES[key] = Lis2Index(key[0], device)
    return li


def iset_significance_device(pm2d: torch.Tensor, tree, num_bp) -> torch.Tensor:
    """iset_s[k] for k = 0 .. xf from the (ny, nx) msb+1 map: the pass at
    which the level-k I region (everything outside the corner (ax_k, ay_k))
    turns significant; index 0 is unused (NEVER).  The plain version, for a
    CPU tensor.  A CUDA tensor raises: on the card the I-set passes come
    with the schedule (``speck.schedule_table(..., iset_regions=...)``,
    kernels/schedule.cu's pixel pass)."""
    if _dispatch(pm2d, "iset_significance_device"):
        raise ValueError("iset_significance_device takes CPU tensors; on the card call speck.schedule_table "
                         "with iset_regions")
    return iset_significance_ref(pm2d, tree, num_bp)


def iset_significance_ref(pm2d: torch.Tensor, tree, num_bp) -> torch.Tensor:
    """Plain ``iset_significance_device``: xf reductions over static
    slices."""
    return spk.iset_maxima_ref(pm2d, tree.iset_regions[: tree.xf + 1], num_bp)


def lis2_segments_device(node_s, s_lin, signs, num_bp, iset_s, li: Lis2Index, num_bp_cap: int,
                         node_cap: int, ev_cap: int, cap_total: int, return_events=False):
    """Every 2D LIS bit on the device.

    ``return_events="items"`` (the emission's form, ops/wave_pack.py):
    (walk-ordered payload words, n_sig), the born-row cap folded into n_sig.
    False (the event form): (buf uint8 [cap_total], counts int32
    [num_bp_cap], total_bytes int32, n_sig int32), buf the byte-aligned
    concatenation of the per-pass segments (``_event_tail``); True: the
    events.  On an event, byte or born-row cap overflow n_sig is raised past
    any node cap, so the caller takes the host engine.  The items come from
    the kernels of kernels/walk_table.cu on a CUDA tensor
    (``speck_lis._table_items_cuda``), from ``_lis2_items_ref`` on a CPU
    tensor."""
    if _dispatch(node_s, "lis2_segments_device"):
        pay_s, n_sig = _table_items_cuda(node_s, s_lin, signs, li, node_cap, iset_s, num_bp)
    else:
        pay_s, n_sig = _lis2_items_ref(node_s, s_lin, signs, num_bp, iset_s, li, node_cap)
    if return_events == "items":
        return pay_s, n_sig
    return _event_tail(pay_s, n_sig, num_bp, num_bp_cap, ev_cap, cap_total, return_events)


def _lis2_items_ref(node_s, s_lin, signs, num_bp, iset_s, li: Lis2Index, node_cap: int):
    """The 2D walk's items, plain version: (walk-ordered payload words [T]
    int32, n_sig int32), the born-row cap folded into n_sig."""
    nn = li.nn
    MC = li.max_ch
    C = node_cap
    xf = li.xf
    G = li.G
    nlev = li.nlev
    dev = node_s.device
    rows = _parent_rows(node_s, s_lin, signs, li, C)

    # ---- anchors and transitive anchor ranks ----------------------------
    # The rank of a born node's anchor chain is the rank of its string of
    # hop words; the walk root, root-anchored nodes and group-critical
    # anchors (static I rank) end a string.
    hops = max(1, (li.depth_max + 2).bit_length())
    J, has_par, par_c, ns_par = _chain_anchors(node_s, li.parent, hops)
    anchor = torch.where(rows.svalid, J[rows.q.long()], rows.q)

    def k_pass(k):  # iset_s at a clipped level
        return iset_s[torch.clamp(k, 0, xf).long()]

    def classes(bid, an):
        """(group-critical anchor, the walk root itself, root-anchored,
        anchor class) of nodes ``bid`` anchored at ``an``: the host's a_lev
        order, the walk root first, then level anchors finer first, then
        the group anchors (the I recursion follows every level walk)."""
        arl = torch.clamp(an, max=nn - 1).long()
        g_anc = li.is_group[arl] & ((bid == an) | (k_pass(li.k_of[arl]) == node_s[arl]))
        root_self = bid == 0
        root_anc = (an == 0) & ~root_self
        aclass = torch.where(
            root_self, 0, torch.where(g_anc, 127, 1 + (63 - torch.clamp(li.level[arl], 0, 63)))
        )
        return g_anc, root_self, root_anc, aclass

    ids = torch.arange(nn, dtype=_I32, device=dev)
    ar_n = torch.where(li.is_group | ~has_par, ids, J[par_c])
    g_anc_n, root_self_n, root_anc_n, aclass_n = classes(ids, ar_n)
    bn_n = torch.where(li.is_group, k_pass(li.k_of), torch.where(has_par, ns_par, 0))
    t_n = torch.where(g_anc_n, torch.clamp(li.irank_of[ar_n.long()], 0, 2047), 0)
    w_n = torch.where(
        root_self_n, 0,
        (1 << 25) | (torch.clamp(bn_n, 0, 63) << 19) | (aclass_n << 12)
        | ((~(root_self_n | root_anc_n)).to(_I32) << 11) | t_n,
    )
    term_n = root_self_n | root_anc_n | g_anc_n | ~has_par
    R_rank = _string_ranks(w_n, torch.where(term_n, nn, ar_n), hops)

    # rows of a group partitioned at its own birth move to the I item space
    anc_l = anchor.long()
    icritq = li.is_group[anc_l] & rows.svalid & (k_pass(li.k_of[anc_l]) == node_s[anc_l])

    # ---- entries: born children, the walk root, the group heads ----------
    bok, c_bid, c_bn, c_an, n_born, CB = _born_rows(rows, anchor, li.n, nn)
    # injected: the walk root (id 0, birth 0) and the G group heads (birth
    # iset_s[k]; absent when their region never partitions)
    g_bn = k_pass(li.group_k)
    inj_id = torch.cat([torch.zeros(1, dtype=_I32, device=dev), li.group_ids])
    inj_bn = torch.cat([torch.zeros(1, dtype=_I32, device=dev), g_bn])
    inj_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), g_bn < _NEVER])
    c_bid = torch.cat([c_bid, torch.where(inj_ok, inj_id, nn)])
    c_bn = torch.cat([c_bn, torch.where(inj_ok, inj_bn, _BIG)])
    c_an = torch.cat([c_an, torch.where(inj_ok, inj_id, nn)])
    bok = torch.cat([bok, inj_ok])
    E = CB + 1 + G

    bidc = torch.clamp(c_bid, max=nn - 1)
    c_lev = li.level[bidc.long()]
    c_pw = li.paths_of(bidc)
    g_anc, root_self, root_anc, aclass = classes(c_bid, c_an)
    k_lba = torch.where(
        bok,
        (c_lev << 20) | (torch.clamp(c_bn, 0, 63) << 14) | (aclass << 7)
        | ((~(root_self | root_anc)).to(_I32) << 6),
        _BIG,
    )
    counts_lev = _level_counts(torch.where(bok, c_lev, nlev), nlev)
    lstarts = torch.cumsum(counts_lev, dim=0, dtype=_I32) - counts_lev
    iota_e = torch.arange(E, dtype=_I32, device=dev)
    # the terminal classes keep their static ranks; (aclass, a_born) in
    # k_lba keeps each class's ranks apart
    a_ord = torch.where(
        g_anc, li.irank_of[torch.clamp(c_an, max=nn - 1).long()],
        torch.where(root_self | root_anc, 0, R_rank[torch.clamp(c_an, max=nn).long()]),
    )
    perm = lexsort([_pack2(k_lba, a_ord)] + c_pw)
    rankpos = torch.empty_like(iota_e).scatter_(0, perm, iota_e)
    o_val = rankpos - lstarts[torch.clamp(c_lev, 0, nlev - 1).long()]
    # entries that are not valid all write the sentinel slot nn, which no
    # read reaches (entries are read at min(id, nn - 1))
    O_buf = torch.zeros(nn + 1, dtype=_I32, device=dev)
    O_buf[torch.where(bok, c_bid, nn).long()] = o_val
    n_sig = torch.maximum(rows.n_sig, torch.where(n_born > CB, _BIG, 0).to(_I32))

    # ---- walk order over the entries (valid first, levels desc, O asc) ---
    w_of_ent, w_buf = _walk_ranks(bok, c_bid, c_lev, O_buf, nlev)
    ent_from = torch.where(root_self, 0, c_bn + 1)
    ent_s = node_s[bidc.long()]

    # ---- child rows: walk rank of the anchor, or the I-space block rank --
    WBASE = E  # the I item space starts after every possible walk rank
    kw_row = _bcast8(torch.where(icritq, WBASE + li.block_rank_of[anc_l], w_buf[anc_l]), MC)
    rp = li.child_paths(_bcast8(rows.q, MC), rows.slot.repeat(C))

    # ---- I items: xf pending-I entries and G group arrival bits ----------
    extra = []
    if xf:
        gid = li.group_ids.long()
        g_sig = node_s[gid] == g_bn
        # I(k)'s birth bit is implied (skipped) when every group of level
        # k + 1 was insignificant at their shared partition pass
        lvl_any = (li.gsel[:, :G] & g_sig[None, :]).any(dim=1)
        k_j = li.ks
        birth = torch.where(k_j == xf, 0, k_pass(k_j + 1))
        omit = ((k_j < xf) & ~lvl_any[torch.clamp(k_j + 1, max=xf + 1).long()]).to(_I32)
        pend_lo = birth + omit
        pend_ok = (birth < _NEVER) & (pend_lo < num_bp)
        pay_pend = (
            1
            | (torch.clamp(pend_lo, 0, 63) << 1)
            | (torch.clamp(k_pass(k_j), 0, 63) << 7)
            | (pend_ok.to(_I32) << 17)
        )
        pay_gbit = (
            (torch.clamp(g_bn, 0, 63) << 1)
            | (g_sig.to(_I32) << 14)
            | ((g_bn < num_bp).to(_I32) << 16)
        )
        nw = len(c_pw)
        extra = [
            (WBASE + 8 * (xf - k_j), [torch.zeros(xf, dtype=_I32, device=dev)] * nw, pay_pend),
            (WBASE + li.gbit_rank, [torch.zeros(G, dtype=_I32, device=dev)] * nw, pay_gbit),
        ]
    pay_s = _walk_order(w_of_ent, c_pw, ent_from, ent_s, bok, kw_row, rp, rows.rowpass,
                        rows.sig_now, rows.emitted, rows.ispx, rows.row_sign, extra)
    return pay_s, n_sig


__all__ = ["Lis2Index", "lis2_index", "iset_significance_device", "iset_significance_ref",
           "lis2_segments_device"]
