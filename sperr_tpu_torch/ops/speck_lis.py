"""Device-side SPECK set walk (K8, and the table walk of K15).

PyTorch port of sperr_tpu/ops/speck_lis_jax.py: ``lis_item_count``,
``LisIndex`` / ``lis_index``, ``_lis_items_virtual`` and
``lis_segments_device`` in its three forms (items, events, segments).  With
codec/speck_sorted.py's total order over tree nodes every LIS bit has a
static sort key, so the set-partition walk is a few sorts: the result is one
payload word per LIS item (list entries and child rows) in walk order, from
which ops/wave_pack.py builds the per-pass emission words, or which the
event tail (``_event_tail``, shared with the 2D walk) expands into events
and packs into per-pass segments.

Two indices serve the walk: ``speck_virtual.VirtualLisIndex`` (power-of-two
cubes: arithmetic children, paths and anchors) and ``LisIndex`` (any dims:
per-node tables from the partition tree, pointer-doubling anchors and a
rank-doubling ladder for their string ranks).  Multi-key sorts are one int64
key where the key widths fit, chained stable sorts otherwise.  Wherever full
keys tie, the tied items emit no bits, so the stream does not depend on
their order.

On a CUDA tensor the virtual walk (``_lis_items_virtual``) runs the hand
kernels of kernels/walk.cu (K7, the row, born-entry and key kernels, and
the stable radix sort, with K12 for its compactions), the table walk
(``_lis_items_table``) and the 2D walk (ops/speck_lis2.py) the kernels of
kernels/walk_table.cu (``_table_items_cuda``: the anchors with K7's
per-level bitmap ranks, each level's hop words ranked first, in place of the
rank-doubling ladder, the rows, the born entries and their walk ranks by
arithmetic in place of a sort, one int64 key per sort with the static path
ranks of ``path_ranks`` in place of the path words) around the same radix
sort, in one cached buffer per index and node cap; on
a CPU tensor their plain versions (``_lis_items_virtual_ref``,
``_lis_items_table_ref``), which sort with ``lexsort`` (chained
``torch.sort``) on every device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..codec.speck_sorted import sorted_tree
from ..codec.speck_wave import build_tree
from . import packemit as pe
from . import speck_virtual as svirt
from .speck import _expand_fill, events_to_segments

_NEVER = 0x7FFF
_BIG = 2**31 - 1
_I32 = torch.int32


class LisIndex:
    """Static device tensors of the table walk (cached per dims and device):
    per node its parent, level, depth and packed path words; the packed
    child table; the roots with their pre-assigned per-level insertion
    ranks."""

    __slots__ = (
        "dims", "device", "nn", "n", "nrows", "max_ch", "depth_max", "nlev", "nroots",
        "parent", "level", "depth", "pw",
        "ch_start", "ch_count", "ctab",
        "root_ids", "root_levels", "O0", "off0", "root_from", "shallow", "_walk_static",
    )

    def __init__(self, dims, device):
        dev = torch.device(device)
        tree = build_tree(tuple(int(d) for d in dims))
        st = sorted_tree(tree)
        nn = tree.node_ch_start.size
        self.dims = tree.dims
        self.device = dev
        self.nn = nn
        self.n = tree.n
        self.nrows = tree.ch_ref.size
        self.max_ch = int(tree.node_ch_count.max())
        self.depth_max = int(st.depth.max())
        lev = tree.node_level.astype(np.int32)
        self.nlev = int(lev.max()) + 1
        self.shallow = self.depth_max <= 10
        self.parent = _i32(st.parent, dev)
        self.level = _i32(lev, dev)
        self.depth = _i32(st.depth, dev)
        # path digits (5 bits each, depth-indexed) re-packed from the host's
        # two 60-bit halves into 30-bit words: digit d -> word d//6, shift
        # 5*(5 - d%6); a shallow tree needs the first two words only
        hi, lo = st.path_hi, st.path_lo
        m30 = (1 << 30) - 1
        pw = np.stack([(hi >> 30) & m30, hi & m30, (lo >> 30) & m30, lo & m30], axis=1)
        self.pw = _i32(pw[:, : 2 if self.shallow else 4], dev)
        self.ch_start = _i32(tree.node_ch_start, dev)
        self.ch_count = _i32(tree.node_ch_count, dev)
        # packed child table: one gather resolves (is_pixel, value index):
        # pixel rows store the linear pixel id, node rows n + node id; bit 0
        # is the pixel flag.  The walk's combined (s | node_s) value table is
        # indexed by the stored id directly.
        refs = tree.ch_ref
        ispx = tree.ch_is_pixel
        resolved = np.where(ispx, tree.px_linear[np.where(ispx, refs, 0)], tree.n + refs).astype(np.int64)
        self.ctab = _i32((resolved << 1) | ispx.astype(np.int64), dev)
        # roots: pre-assigned per-level insertion ranks (they sit in their
        # lists from pass 0, in root_ids order); O and the per-level append
        # offsets start after them
        rids = tree.root_ids.astype(np.int32)
        rlev = tree.root_levels.astype(np.int32)
        self.nroots = rids.size
        O0 = np.zeros(nn, dtype=np.int32)
        off0 = np.zeros(self.nlev, dtype=np.int32)
        for r, L in zip(rids, rlev):
            O0[r] = off0[L]
            off0[L] += 1
        self.root_ids = _i32(rids, dev)
        self.root_levels = _i32(rlev, dev)
        self.O0 = _i32(O0, dev)
        self.off0 = _i32(off0, dev)
        self.root_from = torch.zeros(rids.size, dtype=_I32, device=dev)
        self._walk_static = None

    # -- walk interface (mirrored by speck_virtual.VirtualLisIndex) ---------
    def children(self, q, svalid, slot):
        """Resolve all child slots of compacted parents q via the child
        table: (cnt [C], rvalid, ispx, isnd [C, MC], vidx [C, MC]); vidx is
        the combined value index (pixel linear id, or n + node id)."""
        ql = q.long()
        cnt = torch.where(svalid, self.ch_count[ql], 0)
        rvalid = slot[None, :] < cnt[:, None]
        ridx = torch.clamp(self.ch_start[ql][:, None] + slot[None, :], max=self.nrows - 1)
        crow = self.ctab[ridx.long()]
        ispx = ((crow & 1) == 1) & rvalid
        isnd = ((crow & 1) == 0) & rvalid
        return cnt, rvalid, ispx, isnd, crow >> 1

    def levels_of(self, ids):
        return self.level[ids.long()]

    def paths_of(self, ids):
        pw = self.pw[ids.long()]
        return [pw[:, k] for k in range(pw.shape[1])]

    def child_paths(self, q, rslot):
        """Child-slot path words: the parent's path with digit (slot+1) at
        the parent's depth."""
        ql = q.long()
        dq = self.depth[ql]
        word = dq // 6
        dig = (rslot + 1) << (5 * (5 - dq % 6))
        pw = self.pw[ql]
        zero = torch.zeros_like(dig)
        return [pw[:, k] + torch.where(word == k, dig, zero) for k in range(pw.shape[1])]

    def O0_full(self):
        return torch.cat([self.O0, torch.zeros(1, dtype=_I32, device=self.device)])


_LIS_INDEXES: Dict[Tuple[Tuple[int, ...], str], LisIndex] = {}


def lis_index(dims, device) -> LisIndex:
    """The table walk's index for ``dims`` on ``device``, made once and
    cached."""
    key = (tuple(int(d) for d in dims), str(torch.device(device)))
    li = _LIS_INDEXES.get(key)
    if li is None:
        li = _LIS_INDEXES[key] = LisIndex(key[0], device)
    return li


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32), device=device)


def lis_item_count(li, node_cap: int) -> int:
    """Static item count (entries + child rows) of the walk at a node cap:
    the T dimension of the LIS emission words (ops/wave_pack.py)."""
    C = int(node_cap)
    MC = int(li.max_ch)
    R = C * MC
    if getattr(li, "uniform_children", False):
        CB = min(C, int(li.nn_inner)) * MC
    else:
        CB = min(R, int(li.nn))
    return CB + int(li.nroots) + R


def _bcast8(x: torch.Tensor, mc: int) -> torch.Tensor:
    """[C] -> [C * mc] flat broadcast."""
    return x[:, None].expand(x.shape[0], mc).reshape(-1)


def _tiny_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a tiny table (a plain gather on this device)."""
    return table.to(idx.dtype)[idx.long()]


def _pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key ordering as (hi, lo) for 0 <= hi, lo < 2^31."""
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation (int64) that sorts by keys[0], then keys[1], ... (ties
    keep their input order): chained stable torch.sort calls from the last
    key, on every device.  Only the plain walks call it; the walks' kernels
    sort with ``kernels.radix_lexsort``."""
    perm = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


class WalkLayout(NamedTuple):
    """The virtual walk's static sizes and sort-key widths at a node cap.
    Items: the born entries (CB), the roots, then the child rows (8 C), T in
    all.  The walk sort's first key packs (walk rank, path word 0) as
    rank << pw0 | path, the rank of an unused entry or anchor mapped from
    BIG to tcap (every walk rank is below it); the insertion sort's first
    key packs (level, birth pass, anchor level; anchor rank) and, when
    ``ins_pw`` > 0, the path below them."""

    C: int                  # node cap: parent slots
    take: int               # the significant-set compaction's take, min(C, nn)
    C2: int                 # born parent slots, min(C, nn_inner)
    CB: int                 # born entries, 8 C2
    E: int                  # list entries, CB + nroots
    T: int                  # items
    path_words: int         # 1 (base-9 digits, depth_max <= 6) or 2 (5-bit digits)
    pw0: int                # bits of path word 0 (of 9^(depth_max + 1) - 1, or 30)
    tcap: int               # the walk rank of "none" in the keys (E)
    walk_bits: Tuple[int, ...]  # widths of the walk sort's keys
    wa: int                 # bits of an anchor rank
    lba_bits: int           # bits of (level, pass, anchor level), nlev << 11 for none
    ins_pw: int             # path bits packed into the insertion key (0: apart)
    ins_bits: Tuple[int, ...]   # widths of the insertion sort's keys


def walk_layout(vf, node_cap: int) -> WalkLayout:
    """The ``WalkLayout`` of the virtual walk at ``node_cap``: every key
    below 2^bits of its width (tests hold the widths against the keys)."""
    C = int(node_cap)
    C2 = min(C, int(vf.nn_inner))
    CB = 8 * C2
    E = CB + int(vf.nroots)
    one = vf.depth_max <= 6
    pw0 = (9 ** (vf.depth_max + 1) - 1).bit_length() if one else 30
    more = () if one else (30,)
    wa = max(1, max(vf.rank_plan().counts, default=0).bit_length())
    lba_bits = (vf.nlev << 11).bit_length()
    pack = one and lba_bits + wa + pw0 <= 63
    ins_bits = (lba_bits + wa + pw0,) if pack else (lba_bits + wa, pw0) + more
    return WalkLayout(C, min(C, vf.nn), C2, CB, E, E + 8 * C, 1 if one else 2, pw0, E,
                      (E.bit_length() + pw0,) + more, wa, lba_bits, pw0 if pack else 0, ins_bits)


def _lis_items_virtual(node_s, s_lin, signs, num_bp, vf, node_cap, vtab=None):
    """Walk-ordered emission items for the virtual (power-of-two cube)
    forest: (payload words [T] int32, n_sig int32), the words as
    ``_walk_order`` lays them out (``_lis_items_virtual_ref``).  On a CUDA
    tensor the kernels of kernels/walk.cu (``_lis_items_virtual_cuda``); on
    a CPU tensor the plain version."""
    if pe._dispatch(node_s, "lis_items_virtual"):
        return _lis_items_virtual_cuda(node_s, s_lin, signs, vf, node_cap, vtab)
    return _lis_items_virtual_ref(node_s, s_lin, signs, num_bp, vf, node_cap, vtab)


def _lis_items_virtual_cuda(node_s, s_lin, signs, vf, node_cap, vtab=None):
    """The virtual walk on the card, as ``_lis_items_virtual_ref`` computes
    it: K7 (chain tops, ranks, the significance flags), K12 (the significant
    sets; the eligible parents when the born slots are fewer than the
    parent slots), the rows' payloads, the born entries' insertion keys,
    their radix sort, the entries' walk ranks, payloads and keys, the rows'
    keys, and the walk sort carrying the payloads.  No host wait."""
    lay = walk_layout(vf, node_cap)
    nn = vf.nn
    dev = node_s.device
    forest = vf.walk_forest()
    if vtab is None:
        vtab = svirt.child_value_table(vf, s_lin, signs, node_s)
    plan = vf.rank_plan()
    anc = kernels.anchor_ranks(node_s, forest, plan.dev, plan.host, plan.nsmall, walk=True)
    sid, cnt = pe.compact_flags_rows(anc.sigf.view(torch.bool).reshape(1, nn), lay.take)
    sid, n_sig = sid[0], cnt[0]
    pay = torch.empty(lay.T, dtype=_I32, device=dev)
    key0 = torch.empty(lay.T, dtype=torch.int64, device=dev)
    key1 = torch.empty(lay.T, dtype=_I32, device=dev) if lay.path_words == 2 else None
    elig = kernels.walk_rows(sid, node_s, vtab, forest, lay.C, pay[lay.E:])
    idxE = None
    if 0 < lay.C2 < lay.C:
        idxE = pe.compact_flags_rows(elig.view(torch.bool).reshape(1, lay.C), lay.C2)[0][0]
    ins_keys, counts = kernels.walk_born(sid, idxE, lay.C, node_s, anc.J, anc.R, forest, lay.CB,
                                         vf.nlev, lay.wa, lay.ins_pw, lay.path_words)
    perm = (kernels.radix_lexsort(ins_keys, lay.ins_bits) if lay.CB
            else torch.empty(0, dtype=_I32, device=dev))
    kernels.walk_entries(perm, counts, sid, idxE, lay.C, node_s, anc.J, anc.R, forest, lay.CB,
                         vf.nroots, lay.tcap, lay.pw0, anc.wbuf, pay, key0, key1)
    kernels.walk_rowkeys(sid, lay.C, anc.J, anc.wbuf, forest, lay.tcap, lay.pw0, key0[lay.E:],
                         None if key1 is None else key1[lay.E:])
    if key1 is None:
        return kernels.radix_sort(key0, lay.walk_bits[0], pay)[1], n_sig
    return kernels.gather(pay, kernels.radix_lexsort([key0, key1], lay.walk_bits)), n_sig


def _lis_items_virtual_ref(node_s, s_lin, signs, num_bp, vf, node_cap, vtab=None):
    """Plain version of ``_lis_items_virtual``."""
    nn = vf.nn
    MC = 8
    C = node_cap
    nlev = vf.nlev
    dev = node_s.device
    never = torch.full((), _NEVER, dtype=_I32, device=dev)
    big = torch.full((), _BIG, dtype=_I32, device=dev)
    zero = torch.zeros((), dtype=_I32, device=dev)
    n_sig = (node_s < _NEVER).sum().to(_I32)

    # ---- compacted significant parents ---------------------------------
    iota_nn = torch.arange(nn, dtype=_I32, device=dev)
    sid_s = torch.sort(torch.where(node_s < _NEVER, iota_nn, nn)).values
    if C > nn:
        sid_s = torch.cat([sid_s, torch.full((C - nn,), nn, dtype=_I32, device=dev)])
    sid = sid_s[:C]
    svalid = sid < nn
    q = torch.clamp(sid, max=nn - 1)
    slot = torch.arange(MC, dtype=_I32, device=dev)

    # pixel table values pack clip(s, 0, 127) | sign << 7 [| higher bits];
    # node sections hold raw node_s
    if vtab is None:
        vtab = svirt.child_value_table_ref(vf, s_lin, signs, node_s)
    cnt, rvalid, ispx, isnd, vidx, v = vf.children_rows(q, svalid, slot, vtab)
    rowpass = torch.where(svalid, node_s[q.long()], never)
    row_s = torch.where(rvalid, torch.where(ispx, v & 127, v & _NEVER), never)
    row_sign = ((v >> 7) & 1) == 1

    sig_now = (row_s == rowpass[:, None]) & rvalid
    emitted = (_earlier_sibling(sig_now, slot) | (slot[None, :] != cnt[:, None] - 1)) & rvalid

    # ---- anchors (dense, leaf levels unranked) --------------------------
    J_full, R_full = svirt.dense_anchor_ranks(node_s, vf)
    anchor = torch.where(svalid, J_full[q.long()], q)            # [C]
    anc_c = torch.clamp(anchor, max=nn - 1)
    a_rank_par = R_full[anc_c.long()]
    alev_par = vf.levels_of(anc_c)

    # ---- born rows (parent-form; compaction only when the cap bites) ----
    eligible = isnd[:, 0] & svalid
    C2 = min(C, int(vf.nn_inner))
    if C2 < C:
        key2 = torch.where(eligible, torch.arange(C, dtype=_I32, device=dev), C)
        perm = torch.sort(key2, stable=True).indices[:C2]
        key2_s = key2[perm]
        bok2 = key2_s < C
        qidx = torch.clamp(key2_s, max=C - 1).long()
        bid2 = (torch.clamp(vidx, max=vf.n + nn - 1) - vf.n)[qidx]
        sval2 = (v & _NEVER)[qidx]
        bn2, ar2, al2 = rowpass[perm], a_rank_par[perm], alev_par[perm]
    else:
        bok2 = eligible
        bid2 = torch.clamp(vidx, max=vf.n + nn - 1) - vf.n
        sval2 = v & _NEVER
        bn2, ar2, al2 = rowpass, a_rank_par, alev_par
    CB = C2 * MC
    bok = _bcast8(bok2, MC)
    c_bid = torch.where(bok, bid2.reshape(CB), nn)
    c_bn = torch.where(bok, _bcast8(bn2, MC), big)
    c_arank = torch.where(bok, _bcast8(ar2, MC), zero)
    c_alev5 = torch.where(bok, _bcast8(31 - al2, MC), zero)
    c_s = torch.where(bok, sval2.reshape(CB), never)
    bidc = torch.clamp(c_bid, max=nn - 1)
    c_lev = vf.levels_of(bidc)
    c_pw = vf.sort_paths_of(bidc)

    # ---- insertion ranks: one payload-carrying sort ---------------------
    k_lba = torch.where(
        bok, (c_lev << 11) | (torch.clamp(c_bn, 0, 63) << 5) | c_alev5, big
    )
    perm = lexsort([_pack2(k_lba, c_arank)] + c_pw)
    k_s, bid_s, s_s = k_lba[perm], c_bid[perm], c_s[perm]
    bok_s = k_s < _BIG
    iota_cb = torch.arange(CB, dtype=_I32, device=dev)
    ls_lev = torch.where(bok_s, k_s >> 11, nlev)
    lev_c = torch.clamp(ls_lev, max=nlev - 1)
    # the sorted entries run level by level: each level starts at the
    # exclusive prefix of the per-level counts (the unused entries, last,
    # never read their start)
    counts_lev = _level_counts(ls_lev, nlev)
    lstart = torch.cumsum(counts_lev, dim=0, dtype=_I32) - counts_lev
    o_val = _tiny_lookup(vf.off0, lev_c) + (iota_cb - _tiny_lookup(lstart, lev_c))

    # per-level totals -> suffix above -> walk ranks: O ranks are dense per
    # level (roots 0.., born off0..), so the walk position (levels desc, O
    # asc) is suffix_total(level) + O
    totals = vf.off0 + counts_lev
    rev = torch.cumsum(totals.flip(0), dim=0, dtype=_I32)
    suffix_above = torch.cat([rev.flip(0)[1:], torch.zeros(1, dtype=_I32, device=dev)])
    w_born = torch.where(bok_s, _tiny_lookup(suffix_above, lev_c) + o_val, big)
    w_roots = suffix_above[vf.root_levels.long()] + vf.O0_head

    # ---- anchor walk-rank lookup ----------------------------------------
    w_buf = torch.full((nn + 1,), _BIG, dtype=_I32, device=dev)
    w_buf[torch.where(bok_s, bid_s, nn).long()] = w_born
    w_buf[vf.root_ids.long()] = w_roots
    w_top = _bcast8(w_buf[anc_c.long()], MC)

    # ---- items: entries (born sorted-order ++ roots) ++ child rows ------
    ent_id = torch.cat([bid_s, vf.root_ids])
    ent_ok = torch.cat([bok_s, torch.ones(vf.nroots, dtype=torch.bool, device=dev)])
    ent_from = torch.cat([((k_s >> 5) & 63) + 1, vf.root_from])
    ent_s = torch.cat([s_s, node_s[vf.root_ids.long()]])
    ent_pw = vf.sort_paths_of(torch.clamp(ent_id, max=nn - 1))
    kw_ent = torch.cat([w_born, w_roots])
    rp = vf.sort_child_paths(_bcast8(q, MC), slot.repeat(C))
    pay_s = _walk_order(kw_ent, ent_pw, ent_from, ent_s, ent_ok, w_top, rp, rowpass,
                        sig_now, emitted, ispx, row_sign)
    return pay_s, n_sig


def _earlier_sibling(sig_now: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[C, MC] bool: an earlier slot of the row turned significant, as a bit
    test on each row's significance mask (MC <= 31 slots)."""
    mask = (sig_now.to(_I32) << slot[None, :]).sum(dim=1, dtype=_I32)
    below = (torch.ones_like(slot) << slot) - 1
    return (mask[:, None] & below[None, :]) != 0


def _level_counts(lev: torch.Tensor, nlev: int) -> torch.Tensor:
    """Rows per level, lev in [0, nlev] (nlev marks invalid rows): a count
    into a fixed nlev + 1 bins, so the host never waits for the device."""
    bins = torch.zeros(nlev + 1, dtype=_I32, device=lev.device)
    return bins.scatter_add_(0, lev.long(), torch.ones_like(lev, dtype=_I32))[:nlev]


def _walk_order(kw_ent, ent_pw, ent_from, ent_s, ent_ok, w_top, rp, rowpass, sig_now, emitted,
                ispx, row_sign, extra=()):
    """The walk's last step, shared by every index: the payload words of
    the list entries (one membership bit per pass in [from, s]) and of the
    child rows (a decision bit at the parent's partition pass when it is
    not skipped, then the sign when a pixel turns significant), sorted into
    walk order by (walk rank of the entry or of the row's anchor, path).
    ``extra``: more items, as (walk ranks, path words, payload words), that
    join the sort (the 2D walk's I-set items).

    Payload bits: 0 is_ent | 1-6 lo | 7-12 s | 13 sign | 14 sig_now |
    15 has_sign | 16 dec_emitted | 17 ok."""
    C, MC = sig_now.shape
    R = C * MC
    sig_nowf = sig_now.reshape(R).to(_I32)
    ispxf = ispx.reshape(R)
    pay_ent = (
        1
        | (torch.clamp(ent_from, 0, 63) << 1)
        | (torch.clamp(ent_s, 0, 63) << 7)
        | (ent_ok.to(_I32) << 17)
    )
    pay_row = (
        (torch.clamp(_bcast8(rowpass, MC), 0, 63) << 1)
        | ((row_sign & ispx).reshape(R).to(_I32) << 13)
        | (sig_nowf << 14)
        | ((ispxf & (sig_nowf == 1)).to(_I32) << 15)
        | (emitted.reshape(R).to(_I32) << 16)
    )
    kw_all = torch.cat([kw_ent, w_top] + [kw for kw, _, _ in extra])
    kpath = [torch.cat([e_w, r_w] + [pw[k] for _, pw, _ in extra])
             for k, (e_w, r_w) in enumerate(zip(ent_pw, rp))]
    pay = torch.cat([pay_ent, pay_row] + [p for _, _, p in extra])
    # walk rank and first path word in one key (both below 2^31)
    return pay[lexsort([_pack2(kw_all, kpath[0])] + kpath[1:])]


class _ParentRows(NamedTuple):
    """The child rows of the significant sets (the partitioned parents) of a
    table-backed tree, compacted by K12 and padded to the node cap C with
    invalid ids."""

    n_sig: torch.Tensor     # int32 (): the significant sets
    svalid: torch.Tensor    # bool [C]
    q: torch.Tensor         # int32 [C]: parent ids, clamped below nn
    slot: torch.Tensor      # int32 [MC]
    ispx: torch.Tensor      # bool [C, MC]: a valid pixel row
    isnd: torch.Tensor      # bool [C, MC]: a valid node row
    vidx: torch.Tensor      # int32 [C, MC]: combined value index
    rowpass: torch.Tensor   # int32 [C]: the parent's pass = the children's birth
    row_sign: torch.Tensor  # bool [C, MC]
    sig_now: torch.Tensor   # bool [C, MC]: the child turns significant with its parent
    emitted: torch.Tensor   # bool [C, MC]: its decision bit is emitted


def _parent_rows(node_s, s_lin, signs, li, C: int) -> _ParentRows:
    """Compact the significant sets (K12: ascending ids with the sentinel
    nn, as the reference's one-key sort gives them) and resolve their child
    rows: the child's pass and the pixel sign from one gather of the
    combined value table, and the sibling skip rule (a row's decision is
    emitted unless it is the last slot and no earlier sibling turned
    significant)."""
    nn = li.nn
    dev = node_s.device
    never = torch.full((), _NEVER, dtype=_I32, device=dev)
    sid, n_sig = pe.compact_flags_rows((node_s < _NEVER)[None, :], min(C, nn))
    sid, n_sig = sid[0], n_sig[0]
    if C > nn:  # caps may exceed the node count; pad with invalid ids
        sid = torch.cat([sid, torch.full((C - nn,), nn, dtype=_I32, device=dev)])
    svalid = sid < nn
    q = torch.clamp(sid, max=nn - 1)
    slot = torch.arange(li.max_ch, dtype=_I32, device=dev)
    cnt, rvalid, ispx, isnd, vidx = li.children(q, svalid, slot)
    rowpass = torch.where(svalid, node_s[q.long()], never)
    # combined value table: one gather yields the child's significance pass
    # (s for pixels, node_s for sets) and the pixel sign in bit 15
    sval = torch.cat([s_lin | (signs.to(_I32) << 15), node_s])
    v = sval[torch.where(rvalid, vidx, 0).long()]
    row_s = torch.where(rvalid, v & _NEVER, never)
    sig_now = (row_s == rowpass[:, None]) & rvalid
    emitted = (_earlier_sibling(sig_now, slot) | (slot[None, :] != cnt[:, None] - 1)) & rvalid
    return _ParentRows(n_sig, svalid, q, slot, ispx, isnd, vidx, rowpass, ((v >> 15) & 1) == 1,
                       sig_now, emitted)


def _chain_anchors(node_s, parent, hops: int):
    """Each node's chain top J, its topmost ancestor reachable through
    parents that partition at the node's own pass (the parent pointer,
    doubled ``hops`` times); also whether each node has a parent, the
    clamped parent ids and the parents' passes."""
    has_par = parent >= 0
    par_c = torch.clamp(parent, min=0).long()
    ns_par = node_s[par_c]
    ids = torch.arange(node_s.shape[0], dtype=_I32, device=node_s.device)
    J = torch.where(has_par & (ns_par == node_s), par_c.to(_I32), ids)
    for _ in range(hops):
        J = J[J.long()]
    return J, has_par, par_c, ns_par


def _string_ranks(words, nxt, hops: int) -> torch.Tensor:
    """Ranks [nn + 1] of the strings words[z], words[nxt[z]], ... (nxt = nn
    ends a string; slot nn is the empty string, rank 0) by a rank-doubling
    ladder of (rank, rank of next) sorts; equal strings get equal ranks."""
    nn = words.shape[0]
    dev = words.device
    nxt = torch.cat([nxt.to(_I32), torch.full((1,), nn, dtype=_I32, device=dev)])
    rank = torch.cat([words.to(_I32), torch.zeros(1, dtype=_I32, device=dev)])
    for _ in range(hops):
        nl = nxt.long()
        ks, idx_s = torch.sort(_pack2(rank, rank[nl]))
        diff = torch.cat([torch.zeros(1, dtype=_I32, device=dev), (ks[1:] != ks[:-1]).to(_I32)])
        rank = torch.empty_like(rank).scatter_(0, idx_s, torch.cumsum(diff, dim=0, dtype=_I32))
        nxt = nxt[nl]
    return rank


def _born_rows(rows: _ParentRows, anchor, n: int, nn: int):
    """The node rows born at their parents' partitions, compacted by K12
    into at most min(child slots, nn) entries: (ok, node id, birth pass,
    anchor of the parent; invalid entries carry nn, BIG, nn), the born
    count and the entry cap.  A count past the cap raises n_sig past any
    node cap (host fallback) in the callers."""
    C, MC = rows.isnd.shape
    R = C * MC
    CB = min(R, nn)
    born_idx, n_born = pe.compact_flags_rows(rows.isnd.reshape(1, R), CB)
    born_idx, n_born = born_idx[0], n_born[0]
    bok = born_idx < R
    bi = torch.clamp(born_idx, max=R - 1).long()
    prow = bi // MC
    c_bid = torch.where(bok, rows.vidx.reshape(R)[bi] - n, nn)
    c_bn = torch.where(bok, rows.rowpass[prow], _BIG)
    c_an = torch.where(bok, anchor[prow], nn)
    return bok, c_bid, c_bn, c_an, n_born, CB


def _walk_ranks(ent_ok, ent_id, ent_lev, O_buf, nlev: int):
    """Walk order over the list entries (valid first, levels descending, O
    ascending, then input order): each entry's walk rank, and the ranks by
    node id in a [nn + 1] table whose slot nn collects the invalid entries
    (anchors are node ids below nn, so it is never read)."""
    nn = O_buf.shape[0] - 1
    dev = ent_id.device
    E = ent_id.shape[0]
    wkey = (
        ((~ent_ok).to(torch.int64) << 62)
        | ((nlev - 1 - ent_lev).to(torch.int64) << 32)
        | O_buf[torch.clamp(ent_id, max=nn - 1).long()].to(torch.int64)
    )
    worder = torch.sort(wkey, stable=True).indices
    w_of_ent = torch.empty(E, dtype=_I32, device=dev).scatter_(
        0, worder, torch.arange(E, dtype=_I32, device=dev)
    )
    w_buf = torch.full((nn + 1,), _BIG, dtype=_I32, device=dev)
    w_buf[torch.where(ent_ok, ent_id, nn).long()] = w_of_ent
    return w_of_ent, w_buf


def _lis_items_table(node_s, s_lin, signs, num_bp, li, node_cap):
    """Walk-ordered emission items for a table-backed tree (``LisIndex``,
    any dims): (payload words [T] int32, n_sig int32), the words as
    ``_walk_order`` lays them out.  On a CUDA tensor the kernels of
    kernels/walk_table.cu (``_table_items_cuda``); on a CPU tensor the plain
    version."""
    if pe._dispatch(node_s, "lis_items_table"):
        return _table_items_cuda(node_s, s_lin, signs, li, node_cap)
    return _lis_items_table_ref(node_s, s_lin, signs, num_bp, li, node_cap)


def _lis_items_table_ref(node_s, s_lin, signs, num_bp, li, node_cap):
    """Plain version of ``_lis_items_table``.

    Chain anchors by pointer doubling (J = J[J]), their string ranks by a
    rank-doubling ladder of (rank, rank of next) sorts, the born rows'
    per-level insertion ranks O by one sort, and the walk ranks of the list
    entries (levels descending, O ascending) by another.  The compactions of
    the significant sets and of the born rows are K12 (ascending indices
    with a sentinel), as the reference's one-key sorts give them."""
    nn = li.nn
    MC = li.max_ch
    C = node_cap
    nlev = li.nlev
    dev = node_s.device
    rows = _parent_rows(node_s, s_lin, signs, li, C)

    # ---- anchors and transitive anchor ranks ----------------------------
    # A node's chain anchor is its topmost ancestor reachable through nodes
    # partitioning at the same pass; born entries tie-break by the
    # lexicographic order of the chain's hop-word string
    #   u(z) = O0(z)                              for roots
    #        = (1 | bn(z) | 31 - lev(next(z)))    for born nodes
    # with next(z) = J(parent(z)).  Ranks are only compared between anchors
    # of the same level (the O sort keys the anchor level first).
    hops = max(1, li.depth_max.bit_length())
    J, has_par, par_c, ns_par = _chain_anchors(node_s, li.parent, hops)
    anchor = torch.where(rows.svalid, J[rows.q.long()], rows.q)
    nxt = torch.where(has_par, J[par_c], nn)
    lev_nxt = li.level[torch.clamp(nxt, max=nn - 1).long()]
    u = torch.where(
        has_par, (1 << 11) | (torch.clamp(ns_par, 0, 63) << 5) | (31 - lev_nxt), li.O0
    )
    R_rank = _string_ranks(u, nxt, hops)

    # ---- O: per-level insertion order of born nodes (roots pre-assigned)
    bok, c_bid, c_bn, c_an, n_born, CB = _born_rows(rows, anchor, li.n, nn)
    bidc = torch.clamp(c_bid, max=nn - 1)
    c_lev = li.levels_of(bidc)
    c_pw = li.paths_of(bidc)
    c_alev5 = 31 - li.levels_of(torch.clamp(c_an, max=nn - 1))

    # O within a level = rank by (level, birth pass, anchor level finer
    # first, transitive anchor rank, path), in one sort
    k_lba = torch.where(bok, (c_lev << 11) | (torch.clamp(c_bn, 0, 63) << 5) | c_alev5, _BIG)
    counts_lev = _level_counts(torch.where(bok, c_lev, nlev), nlev)
    lstarts = torch.cumsum(counts_lev, dim=0, dtype=_I32) - counts_lev
    iota_cb = torch.arange(CB, dtype=_I32, device=dev)
    a_rank = R_rank[torch.clamp(c_an, max=nn).long()]
    perm = lexsort([_pack2(k_lba, a_rank)] + c_pw)
    rankpos = torch.empty_like(iota_cb).scatter_(0, perm, iota_cb)
    lc = c_lev.long()
    o_val = li.off0[lc] + (rankpos - lstarts[lc])
    # every row that is not born writes the sentinel slot nn, which no read
    # reaches (entries are read at min(id, nn - 1))
    O_buf = li.O0_full()
    O_buf[torch.where(bok, c_bid, nn).long()] = o_val
    n_sig = torch.maximum(rows.n_sig, torch.where(n_born > CB, _BIG, 0).to(_I32))

    # ---- w: walk order over the list entries (levels desc, O asc) -------
    nroots = li.nroots
    ent_id = torch.cat([c_bid, li.root_ids])
    ent_ok = torch.cat([bok, torch.ones(nroots, dtype=torch.bool, device=dev)])
    w_of_ent, w_buf = _walk_ranks(ent_ok, ent_id, torch.cat([c_lev, li.root_levels]), O_buf, nlev)
    ent_from = torch.cat([c_bn + 1, li.root_from])
    ent_s = node_s[torch.clamp(ent_id, max=nn - 1).long()]
    rz = torch.zeros(nroots, dtype=_I32, device=dev)
    ent_pw = [torch.cat([w, rz]) for w in c_pw]  # roots have empty paths
    w_top = _bcast8(w_buf[anchor.long()], MC)
    rp = li.child_paths(_bcast8(rows.q, MC), rows.slot.repeat(C))
    return _walk_order(w_of_ent, ent_pw, ent_from, ent_s, ent_ok, w_top, rp, rows.rowpass,
                       rows.sig_now, rows.emitted, rows.ispx, rows.row_sign), n_sig


def _dense_rows(cols):
    """Dense ranks of rows given as int64 columns (the first the most
    significant), in lexicographic order, equal rows equal ranks: (ranks,
    the number of distinct rows)."""
    if len(cols) == 1:
        vals, inv = np.unique(cols[0], return_inverse=True)
        return inv.reshape(-1).astype(np.int64), vals.size
    order = np.lexsort(cols[::-1])
    head = np.zeros(order.size, dtype=bool)
    head[:1] = True
    for c in cols:
        cs = c[order]
        head[1:] |= cs[1:] != cs[:-1]
    rs = np.cumsum(head) - 1
    ranks = np.empty_like(rs)
    ranks[order] = rs
    return ranks, int(rs[-1]) + 1 if rs.size else 0


def path_ranks(li):
    """The static path ranks of a ``LisIndex`` or ``Lis2Index``: a dense rank
    over every path value an item of the walk can carry (each node's path,
    each child slot's path, pw[q] + (k + 1) << sh for every k < max_ch,
    padding slots included, and the zero path of the roots and the 2D I
    items), in the order of the path words, equal values equal ranks.
    Returns (pidx int32 [nn]: each node's distinct path value, ptab int32
    [values, max_ch + 1]: a value's path rank, then its child slots', the
    number of distinct values ranked).  The zero path ranks 0."""
    pw = li.pw.cpu().numpy().astype(np.int64)
    depth = li.depth.cpu().numpy().astype(np.int64)
    MC = int(li.max_ch)
    W = pw.shape[1]

    def packed(words):  # the 30-bit words in pairs, one int64 each: the order kept
        return [(words[:, k] << 30) | (words[:, k + 1] if k + 1 < W else 0) for k in range(0, W, 2)]

    pidx, npv = _dense_rows(packed(pw))
    rep = np.zeros(npv, dtype=np.int64)
    rep[pidx] = np.arange(li.nn)
    pv, dv = pw[rep], depth[rep]
    vals = [packed(pv)]
    for k in range(MC):  # the child slots: digit k + 1 at the value's depth
        c = pv.copy()
        wd, sh = dv // 6, 5 * (5 - dv % 6)
        for x in range(W):
            c[:, x] += np.where(wd == x, (k + 1) << sh, 0)
        vals.append(packed(c))
    cols = [np.concatenate([v[j] for v in vals] + [np.zeros(1, np.int64)]) for j in range(len(vals[0]))]
    ranks, nvals = _dense_rows(cols)
    ptab = ranks[:-1].reshape(MC + 1, npv).T
    assert ranks[-1] == 0  # the zero path comes first
    return pidx.astype(np.int32), np.ascontiguousarray(ptab, dtype=np.int32), nvals


class TableStatic(NamedTuple):
    """The table and 2D walks' static data on the card (made once per
    index): the rank plan (K7's format: the levels that hold a node with node
    children, coarse first, every node of each ranked), each level's place in
    it, the static path ranks (``path_ranks``: one int32 per node and max_ch
    + 1 per distinct path value), the widths of the keys' fields, and the
    index's tables as the kernels read them."""

    form: int                      # 0: table (3D), 1: 2D
    plan: "svirt.RankPlan"
    pb: int                        # bits of a path rank
    path_values: int               # distinct path values ranked
    path_bytes: int                # the path ranks' tables (pidx, ptab)
    dlow0: int                     # 1 + the largest rank field of a string that ends with its node
    lba_bits: int                  # bits of the insertion key's (level, pass, class) field
    wa: int                        # bits of an anchor rank (or a 2D group's static rank)
    itop: int                      # 2D: past every static I rank, 8 (xf - k) + {0; 1 + 2j; 2 + 2j}
    tables: Dict[str, torch.Tensor]
    layouts: Dict[int, "TableLayout"]  # by node cap, made once each
    ranks: Dict[int, tuple]            # by cap_bits: (TableRankLayout, its device rows)
    calls: Dict[tuple, tuple]          # by (node cap, cap_bits, device): (stream, its _TableCall)


def table_static(li) -> TableStatic:
    """The ``TableStatic`` of a ``LisIndex`` or a 2D ``Lis2Index``, made once
    and cached on the index.  Raises ValueError for a tree the kernels do not
    take (more than 30 levels or 8 child slots, a ranked level in more than
    16 id spans)."""
    if li._walk_static is not None:
        return li._walk_static
    form = 1 if hasattr(li, "xf") else 0
    dev = li.device
    nn, nlev = li.nn, li.nlev
    if nlev > kernels.TABLE_MAX_LEVELS or li.max_ch > kernels.TABLE_MAX_CHILDREN:
        raise ValueError(f"the walk kernels take at most {kernels.TABLE_MAX_LEVELS} levels and "
                         f"{kernels.TABLE_MAX_CHILDREN} child slots; got {nlev}, {li.max_ch}")
    lev = li.level.cpu().numpy().astype(np.int64)
    cnt = li.ch_count.cpu().numpy().astype(np.int64)
    ctab = li.ctab.cpu().numpy().astype(np.int64)
    # nodes with a node child: the anchors and the nodes of their strings
    row_par = np.repeat(np.arange(nn), cnt)
    inner = np.zeros(nn, bool)
    inner[row_par[(ctab & 1) == 0]] = True
    G = int(getattr(li, "G", 0))
    ns = kernels.RANK_SPANS
    rows, counts, wks = [], [], []
    below = 0
    lev_plan = np.zeros(nlev, np.uint8)
    for L in sorted(set(lev[inner].tolist())):
        ids = np.flatnonzero(lev == L)
        cut = np.flatnonzero(np.diff(ids) != 1) + 1
        sp = [(int(a[0]), int(a[-1]) + 1) for a in np.split(ids, cut)]
        if len(sp) > ns:
            raise ValueError(f"level {L} has {len(sp)} id spans; the rank plan holds {ns}")
        row = np.zeros(kernels.RANK_LEVEL_INTS, dtype=np.int32)
        row[0] = ids.size
        # the low field: the next string's rank + 1, or a 2D group's static rank
        row[1] = max(below.bit_length(), max(G - 1, 0).bit_length())
        row[2] = len(sp)
        for k, (lo, hi) in enumerate(sp):
            row[3 + k], row[3 + ns + k] = lo, hi
        rows.append(row)
        counts.append(int(ids.size))
        wks.append(int(row[1]))
        below = max(below, int(ids.size))
        lev_plan[L] = len(rows)
    nsmall = 0
    while (nsmall < len(rows) and counts[nsmall] <= kernels.RANK_SMALL_MAX
           and 12 + wks[nsmall] <= kernels.RANK_SMALL_BITS):
        nsmall += 1
    host = np.concatenate(rows) if rows else np.zeros(0, dtype=np.int32)
    plan = svirt.RankPlan(host, _i32(host, dev), nsmall, tuple(counts), tuple(wks))
    pidx, ptab, nvals = path_ranks(li)
    names = ("parent", "level", "ch_start", "ch_count", "ctab")
    names += ("O0", "off0", "root_ids", "root_levels") if form == 0 else (
        "k_of", "irank_of", "block_rank_of", "group_ids", "group_k", "gbit_rank")
    tables = {k: getattr(li, k).contiguous() for k in names}
    tables["pidx"], tables["ptab"] = _i32(pidx, dev), _i32(ptab, dev)
    if form == 1:
        tables["is_group"] = li.is_group.to(torch.uint8).contiguous()
        if tables["group_ids"].numel() == 0:  # the kernels read no group; a valid pointer all the same
            for k in ("group_ids", "group_k", "gbit_rank"):
                tables[k] = torch.zeros(1, dtype=_I32, device=dev)
    tables["lev_plan"] = torch.as_tensor(lev_plan, device=dev)
    tables["plan"] = plan.dev if host.size else torch.zeros(1, dtype=_I32, device=dev)
    wa = max(max(counts, default=0), G).bit_length()
    lba = (nlev << 12) if form else (nlev << 11)
    itop = 0
    if form:
        ranks = [li.gbit_rank.cpu().numpy(), li.block_rank_of.cpu().numpy()]
        itop = max([8 * int(li.xf)] + [int(r.max()) + 1 for r in ranks if r.size])
    li._walk_static = TableStatic(form, plan, max(nvals - 1, 0).bit_length(), nvals, 4 * (pidx.size + ptab.size),
                                  max(1, min(G, 2048)), lba.bit_length(), max(1, wa), itop, tables, {}, {}, {})
    return li._walk_static


class TableLayout(NamedTuple):
    """The table or 2D walk's static sizes and sort-key widths at a node cap.
    Items: the list entries (E: the born entries in insertion order, then
    the roots; in 2D the born entries, the walk root and the G group heads,
    all in insertion order), the child rows (R = C MC), and the 2D walk's
    xf pending-I and G arrival items: T in all.  Each sort has one int64
    key: the insertion key packs (level, pass, class; anchor rank; path
    rank), the walk key (walk rank, tcap for none; path rank)."""

    C: int
    take: int             # the significant-set compaction's take, min(C, nn)
    MC: int
    R: int                # child rows
    CB: int               # born entries, min(R, nn)
    NE: int               # entries of the insertion sort
    E: int                # list entries
    T: int                # items
    tcap: int             # the walk rank of "none" (past every walk and I rank)
    wbase: int            # 2D: the I item space's first rank (E)
    ins_bits: int         # width of the insertion key
    walk_bits: int        # width of the walk key


def table_layout(li, node_cap: int) -> TableLayout:
    """The ``TableLayout`` of the table or 2D walk at ``node_cap``: every key
    below 2^bits of its width (tests hold the widths against the keys).
    Raises ValueError where a key would not fit one int64 (2^63)."""
    st = table_static(li)
    C = int(node_cap)
    if C in st.layouts:
        return st.layouts[C]
    MC = int(li.max_ch)
    R = C * MC
    CB = min(R, li.nn)
    if st.form:
        xf, G = int(li.xf), int(li.G)
        NE = E = CB + 1 + G
        T = E + R + xf + G
        tcap, wbase = E + st.itop, E
    else:
        NE, E = CB, CB + int(li.nroots)
        T = E + R
        tcap, wbase = E, E
    ins_bits = st.lba_bits + st.wa + st.pb
    walk_bits = tcap.bit_length() + st.pb
    if ins_bits > 63 or walk_bits > 63:
        raise ValueError(f"the walk's keys take one int64 each: insertion key {st.lba_bits} + {st.wa} + {st.pb} "
                         f"bits (level field, anchor rank, path rank), walk key {tcap.bit_length()} + {st.pb}; "
                         f"at most 63")
    lay = st.layouts[C] = TableLayout(C, min(C, li.nn), MC, R, CB, NE, E, T, tcap, wbase, ins_bits, walk_bits)
    return lay


def table_anchors_ref(node_s, li, iset_s=None):
    """Plain version of the anchors stage of the table and 2D walks
    (``kernels.table_anchors``): (J, R, u, jp), each node's chain top, its
    dense rank among its level's keys (u << wk | the next string's rank + 1,
    or -1 - jp where jp < 0; 0 on the levels the plan does not rank), its
    hop word and the next node of its string, as kernels/walk_table.cu
    table_anchors and rank.cuh write them."""
    st = table_static(li)
    nn, nlev = li.nn, li.nlev
    dev = node_s.device
    z = torch.arange(nn, dtype=_I32, device=dev)
    parent = li.parent
    has = parent >= 0
    sp = torch.where(has, node_s[torch.clamp(parent, min=0).long()], 0)
    cur = torch.where(has, parent, z)
    act = has
    for _ in range(li.depth_max + 1):
        g = parent[cur.long()]
        same = act & (g >= 0) & (node_s[torch.clamp(g, min=0).long()] == sp)
        cur = torch.where(same, g, cur)
        act = same
    J = torch.where(has & (sp == node_s), cur, z)
    lev_cur = li.level[cur.long()]
    if st.form == 0:
        u = torch.where(has, (1 << 11) | (torch.clamp(sp, 0, 63) << 5) | (31 - lev_cur), li.O0)
        jp = torch.where(has, cur, -1)
    else:
        grp = li.is_group
        ar = torch.where(grp | ~has, z, cur).long()
        kp = iset_s[torch.clamp(li.k_of[ar], 0, li.xf).long()]
        ganc = li.is_group[ar] & ((z == ar) | (kp == node_s[ar]))
        ranc = ar == 0
        bn = torch.where(grp, iset_s[torch.clamp(li.k_of, 0, li.xf).long()], torch.where(has, sp, 0))
        acode = torch.where(ganc, nlev + 1, nlev - li.level[ar])
        u = torch.where(z == 0, 0, (torch.clamp(bn, 0, 63) << 6) | (acode << 1) | (~ranc).to(_I32))
        jp = torch.where(ganc, -1 - torch.clamp(li.irank_of[ar], 0, 2047), torch.where(ranc | ~has, -1, ar.to(_I32)))
        jp = torch.where(z == 0, -1, jp)
    u, jp = u.to(_I32), jp.to(_I32)
    R = torch.zeros(nn, dtype=_I32, device=dev)
    rows = st.plan.host.reshape(-1, kernels.RANK_LEVEL_INTS)
    for row in rows:
        wk, ns = int(row[1]), int(row[2])
        ids = torch.cat([torch.arange(int(row[3 + k]), int(row[3 + kernels.RANK_SPANS + k]), device=dev)
                         for k in range(ns)])
        j = jp[ids]
        low = torch.where(j < 0, -1 - j, R[torch.clamp(j, min=0).long()] + 1).to(torch.int64)
        key = (u[ids].to(torch.int64) << wk) | low
        R[ids] = torch.unique(key, sorted=True, return_inverse=True)[1].to(_I32)
    return J.to(_I32), R, u, jp


def table_anchors(node_s, li, iset_s=None, cap_bits=kernels.RANK_CAP_BITS):
    """The anchors stage of the table and 2D walks: (J, R, u, jp) as
    ``table_anchors_ref`` defines them.  On a CUDA tensor the anchors kernel
    and the rank levels (``kernels.table_anchors``: each level's hop words
    ranked first, then its keys on a bitmap; ``cap_bits`` sets the larger
    levels' regions, past which a level's keys take its gated sorted route:
    a lower value drives that route at small sizes); on a CPU tensor the
    plain version.  The results are new tensors."""
    if pe._dispatch(node_s, "table_anchors"):
        with _table_call(li, 1, node_s.device, cap_bits) as call:
            return call.run_anchors(node_s, iset_s)
    return table_anchors_ref(node_s, li, iset_s)


def _table_ranks(st, cap_bits):
    """The rank layout of a ``TableStatic`` at ``cap_bits``, with its rows on
    the card, made once each."""
    if cap_bits not in st.ranks:
        rl = kernels.table_rank_layout(st.plan.host, st.plan.nsmall, cap_bits)
        st.ranks[cap_bits] = (rl, _i32(rl.lay.reshape(-1) if rl.lay.size else np.zeros(1), st.plan.dev.device))
    return st.ranks[cap_bits]


class _TableCall:
    """The device buffer of the table or 2D walk at one node cap, rank
    layout and device: one zeroed allocation carved
    into views (the anchors, the walk rank table, the rank levels' scratch,
    the compactions, the keys, the unsorted payloads, the sorts' scratch),
    and the kernels' ``TableArgs`` filled once; a call sets only its inputs.
    The rank levels leave their hop-word bitmaps and counters zero for the
    next call, so a call that raises drops its buffer (``_table_call``)."""

    def __init__(self, li, st, lay, rl, rows, dev):
        nn = li.nn
        nlv = len(st.plan.counts)
        gk = rl.gated_keys
        i32, i64, u8 = torch.int32, torch.int64, torch.uint8
        spec = [("J", i32, nn), ("R", i32, nn), ("u", i32, nn), ("jp", i32, nn), ("sigf", u8, nn),
                ("wbuf", i32, nn + 1), ("ubm", i32, nlv * kernels.RANK_U_WORDS), ("uw", i32, nlv * kernels.RANK_U_WORDS),
                ("upre", i32, nlv * kernels.RANK_U_WORDS), ("rst", i32, nlv * kernels.RANK_STATE),
                ("sbm", i32, (1 << (kernels.RANK_SMALL_BITS - 5)) if rl.nsmall else 4),
                ("rbm", i32, max(rl.region_words, 4)), ("rgc", i32, max(rl.region_groups, 4)),
                ("rbs", i32, max(rl.bsum_words, 4)), ("rkeys", i32, max(rl.keys, 1)),
                ("gkeys", i64, max(gk, 1)), ("gkbuf", i64, max(gk, 1)), ("gvbuf", i32, max(gk, 1)), ("gvout", i32, max(gk, 1)),
                ("gzbuf", i64, kernels.sort_scratch_words(gk) if gk else 1),
                ("gscr", i32, kernels.rank_scratch_words(gk) if gk else 4),
                ("sid", i32, lay.take), ("sid_count", i32, 1), ("sid_status", i64, -(-nn // kernels.FLAG_TILE)),
                ("bflag", u8, lay.R), ("born_idx", i32, lay.CB), ("born_count", i32, 1),
                ("born_status", i64, -(-lay.R // kernels.FLAG_TILE)), ("counts", i32, li.nlev + 1),
                ("ikey", i64, lay.NE), ("perm", i32, lay.NE), ("pay", i32, lay.T), ("wkey", i64, lay.T),
                ("skbuf", i64, lay.T), ("svbuf", i32, lay.T), ("szbuf", i64, kernels.sort_scratch_words(lay.T))]
        offs, total = [], 0
        for _, dtype, n in spec:
            offs.append(total)
            total += -(-n * torch.empty((), dtype=dtype).element_size() // 16) * 16
        self.buf = torch.zeros(total, dtype=u8, device=dev)
        self.views = {name: self.buf[o:o + n * torch.empty((), dtype=dtype).element_size()].view(dtype)
                      for (name, dtype, n), o in zip(spec, offs)}
        v = self.views
        a = self.args = kernels.TableArgs()
        for k, t in list(st.tables.items()) + list(v.items()):
            if k in kernels.TABLE_POINTERS:
                setattr(a, k, t.data_ptr())
        a.ulay = rows.data_ptr()
        for k in ("nn", "n", "nrows", "nlev"):
            setattr(a, k, int(getattr(li, k)))
        a.form, a.MC = st.form, lay.MC
        a.xf, a.G = (int(li.xf), int(li.G)) if st.form else (0, 0)
        a.nroots = 0 if st.form else int(li.nroots)
        for k in ("C", "take", "CB", "NE", "E", "tcap", "wbase"):
            setattr(a, k, getattr(lay, k))
        a.rows = lay.R
        a.wa, a.pb, a.dlow0 = st.wa, st.pb, st.dlow0
        a.nsmall = rl.nsmall
        a.gzwords, a.gswords = v["gzbuf"].numel(), v["gscr"].numel()
        self.li, self.st, self.lay, self.rl, self.dev = li, st, lay, rl, dev

    def inputs(self, node_s, s_lin=None, signs=None, iset_s=None, num_bp=None):
        """Points the structure at one call's inputs (checked)."""
        li, dev, a = self.li, self.dev, self.args
        ins = {"node_s": node_s}
        if s_lin is not None:
            ins["s_lin"] = s_lin
        if self.st.form:
            ins["iset_s"] = iset_s
            if num_bp is not None:
                ins["num_bp"] = num_bp.reshape(1)
        for k, t in ins.items():
            kernels._require_cuda(t, _I32, k)
            if t.device != dev:
                raise ValueError(f"{k} is on {t.device}, the walk's buffers on {dev}")
        if node_s.shape != (li.nn,):
            raise ValueError(f"node_s must be ({li.nn},); got {tuple(node_s.shape)}")
        if s_lin is not None:
            kernels._require_cuda(signs, torch.bool, "signs")
            if s_lin.shape != (li.n,) or signs.shape != (li.n,) or signs.device != dev:
                raise ValueError(f"s_lin and signs must be ({li.n},) on {dev}; got {tuple(s_lin.shape)}, "
                                 f"{tuple(signs.shape)} on {signs.device}")
            ins["signs"] = signs
        for k, t in ins.items():
            setattr(a, k, t.data_ptr())

    def run_anchors(self, node_s, iset_s=None):
        """The anchors stage alone: (J, R, u, jp), new tensors (the structure
        copied with them in place of the buffer's)."""
        self.inputs(node_s, iset_s=iset_s)
        a = kernels.TableArgs.from_buffer_copy(self.args)
        out = tuple(torch.empty(self.li.nn, dtype=_I32, device=self.dev) for _ in range(4))
        a.J, a.R, a.u, a.jp = (t.data_ptr() for t in out)
        kernels.table_anchors(a, self.dev, self.st.plan.dev, self.st.plan.host, self.rl)
        return out

    def run(self, node_s, s_lin, signs, iset_s, num_bp):
        """The whole walk: (payload words [T], n_sig), both new tensors."""
        lay, v, a, dev = self.lay, self.views, self.args, self.dev
        self.inputs(node_s, s_lin, signs, iset_s, num_bp)
        n_sig = torch.empty((), dtype=_I32, device=dev)
        a.n_sig_out = n_sig.data_ptr()
        kernels.table_anchors(a, dev, self.st.plan.dev, self.st.plan.host, self.rl)
        pe.compact_flags_rows(v["sigf"].view(torch.bool).reshape(1, -1), lay.take,
                              out=(v["sid"].reshape(1, -1), v["sid_count"], v["sid_status"]))
        kernels.table_stage("rows", a, dev)
        pe.compact_flags_rows(v["bflag"].view(torch.bool).reshape(1, -1), lay.CB,
                              out=(v["born_idx"].reshape(1, -1), v["born_count"], v["born_status"]))
        kernels.table_stage("born", a, dev)
        self._sort(v["ikey"], lay.ins_bits, None, v["perm"])
        kernels.table_stage("entries", a, dev)
        kernels.table_stage("rowkeys", a, dev)
        pay = torch.empty(lay.T, dtype=_I32, device=dev)
        self._sort(v["wkey"], lay.walk_bits, v["pay"], pay)
        return pay, n_sig

    def _sort(self, keys, bits, vals, vout):
        """One radix sort of the walk's keys into vout.  Only the first pass
        reads the keys, so they take turns with the one scratch key buffer
        as the passes' outputs: the last pass writes into the keys when the
        passes are even, the second when they are odd."""
        v = self.views
        kbuf = v["skbuf"][:keys.numel()]
        kbuf, kout = (kbuf, keys) if len(kernels.radix_shifts(bits)) % 2 == 0 else (keys, kbuf)
        kernels.radix_sort(keys, bits, vals, out=(kout, vout), scratch=(kbuf, v["svbuf"], v["szbuf"]))


@contextlib.contextmanager
def _cached(cache, key, stream, make):
    """One cached item per ``key``, with the stream it was last used on.
    The item leaves the cache while the block runs, so no two users share
    it (a second concurrent user makes its own, and the one put back last
    stays), and goes back with ``stream`` only when the block ends without
    an exception.  An item held for another stream is dropped and made
    anew: the caching allocator reuses its memory on that stream only, so
    the new stream never overtakes work queued on the old one."""
    held = cache.pop(key, None)
    item = held[1] if held is not None and held[0] == stream else make()
    yield item
    cache[key] = (stream, item)


def _table_call(li, node_cap, dev, cap_bits=kernels.RANK_CAP_BITS):
    """The cached ``_TableCall`` of this index, node cap, rank layout and
    device (``_cached``: one each, whatever the thread or stream), made on
    first use.  After a refused launch it is dropped: its bitmaps and
    counters may not be zero."""
    if dev.type != "cuda":
        raise ValueError(f"the walk's kernels run on a CUDA device; got tensors on {dev}")
    st = table_static(li)

    def make():
        rl, rows = _table_ranks(st, cap_bits)
        return _TableCall(li, st, table_layout(li, node_cap), rl, rows, dev)

    return _cached(st.calls, (int(node_cap), cap_bits, dev.index), torch.cuda.current_stream(dev).cuda_stream, make)


def _table_items_cuda(node_s, s_lin, signs, li, node_cap, iset_s=None, num_bp=None, keep=None,
                      cap_bits=kernels.RANK_CAP_BITS):
    """The table walk (``LisIndex``) or the 2D walk (``Lis2Index``, with its
    I-set passes and num_bp) on the card, as the plain versions compute it:
    the anchors and the string ranks (``table_anchors``), K12 (the
    significant sets), the child rows, K12 (the born rows), the entries'
    insertion keys, their radix sort, the walk ranks, the entries' and rows'
    walk keys, and the walk sort carrying the payloads: one int64 key per
    sort, in the buffers of ``_table_call``.  Returns (payload words [T]
    int32, n_sig int32 ()), new tensors.  No host wait.  ``keep``, a dict,
    receives the call's buffers (J, R, u, jp, sid, ...: views that the next
    call at this node cap and device overwrites) for inspection."""
    with _table_call(li, node_cap, node_s.device, cap_bits) as call:
        out = call.run(node_s, s_lin, signs, iset_s, num_bp)
        if keep is not None:
            keep.update(call.views)
        return out


def _event_tail(pay_s, n_sig, num_bp, num_bp_cap: int, ev_cap: int, cap_total: int,
                return_events=False):
    """The walk's items in walk order -> emission events -> per-pass
    segments (the event tail of the reference's walks).

    Each list entry emits a membership bit per pass in [lo, min(s, num_bp -
    1)], each child row its decision bit and, when a pixel turns
    significant, its sign; ``_expand_fill`` lays the events out in walk
    order.  ``return_events`` True returns (p_key, bit_ev, n_sig), the
    events' passes (num_bp_cap past the total) and bits; False packs them
    (``events_to_segments``) and returns (buf, counts, total_bytes, n_sig).
    An overflow of the event cap, or with False of the byte cap, forces
    n_sig to _BIG, so the caller falls back to the host stitcher."""
    is_ent = (pay_s & 1) == 1
    lo = (pay_s >> 1) & 63
    s6 = (pay_s >> 7) & 63
    hs = (pay_s >> 15) & 1
    dec = (pay_s >> 16) & 1
    ok = (pay_s >> 17) & 1
    ent_hi = torch.minimum(s6, num_bp - 1)
    ln = torch.where(
        is_ent, torch.where((ok == 1) & (lo <= ent_hi), ent_hi - lo + 1, 0), dec + hs
    )
    (payf,), rel, ev_ok, ev_total = _expand_fill(ln, [pay_s], ev_cap, widths=[18])
    is_ent_f = (payf & 1) == 1
    lo_f = (payf >> 1) & 63
    s6_f = (payf >> 7) & 63
    sign_f = (payf >> 13) & 1
    signow_f = (payf >> 14) & 1
    dec_f = (payf >> 16) & 1
    p_ev = torch.where(is_ent_f, lo_f + rel, lo_f)
    is_sign_ev = (~is_ent_f) & (rel == dec_f)  # a sign follows its decision
    bit_ev = torch.where(is_ent_f, s6_f == p_ev, torch.where(is_sign_ev, sign_f == 1, signow_f == 1))
    p_key = torch.where(ev_ok, p_ev, num_bp_cap)
    if return_events:
        over = ev_total > ev_cap
        return p_key, bit_ev, torch.maximum(n_sig, torch.where(over, _BIG, 0).to(_I32))
    buf, counts, total_bytes = events_to_segments(p_key, None, bit_ev, num_bp_cap, cap_total)
    over = (ev_total > ev_cap) | (total_bytes > cap_total)
    return buf, counts, total_bytes, torch.maximum(n_sig, torch.where(over, _BIG, 0).to(_I32))


def lis_segments_device(node_s, s_lin, signs, num_bp, li, num_bp_cap, node_cap,
                        ev_cap=0, cap_total=0, return_events=False, vtab=None):
    """Every LIS bit of a chunk on the device.  ``li`` is a
    ``VirtualLisIndex`` (``vtab``: its combined child value table, if the
    caller made one) or a ``LisIndex``.

    ``return_events="items"`` (the emission's form, ops/wave_pack.py):
    (walk-ordered payload words, n_sig).  True: (p_key, bit_ev, n_sig), the
    events of at most ``ev_cap``; False: (buf uint8 [cap_total], counts
    int32 [num_bp_cap], total_bytes int32, n_sig int32), the byte-aligned
    per-pass segments, bit for bit codec.speck_sorted's (``_event_tail``)."""
    if getattr(li, "uniform_children", False):
        pay_s, n_sig = _lis_items_virtual(node_s, s_lin, signs, num_bp, li, node_cap, vtab=vtab)
    else:
        pay_s, n_sig = _lis_items_table(node_s, s_lin, signs, num_bp, li, node_cap)
    if return_events == "items":
        return pay_s, n_sig
    return _event_tail(pay_s, n_sig, num_bp, num_bp_cap, ev_cap, cap_total, return_events)


__all__ = ["LisIndex", "lis_index", "lis_item_count", "lis_segments_device", "lexsort", "walk_layout",
           "path_ranks", "table_anchors", "table_anchors_ref", "table_layout", "table_static"]
