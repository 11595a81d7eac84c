"""Device-side SPECK set walk for power-of-two cube chunks (K8).

PyTorch port of the virtual-forest part of sperr_tpu/ops/speck_lis_jax.py:
``lis_item_count``, ``_lis_items_virtual`` and the ``return_events="items"``
form of ``lis_segments_device``.  With codec/speck_sorted.py's total order
over tree nodes every LIS bit has a static sort key, so the set-partition
walk is a few sorts: the result is one payload word per LIS item (list
entries and child rows) in walk order, from which ops/wave_pack.py builds
the per-pass emission words.

Multi-key sorts are one int64 key where the key widths fit, chained stable
sorts otherwise.  Wherever full keys tie, the tied items emit no bits, so
the stream does not depend on their order.  The table-form walk (chunk
shapes that are not power-of-two cubes) is not ported: those chunks take
host entropy.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import speck_virtual as svirt

_NEVER = 0x7FFF
_BIG = 2**31 - 1
_I32 = torch.int32


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
    """Permutation that sorts by keys[0], then keys[1], ... (chained stable
    sorts from the last key; ties keep their input order)."""
    perm = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _lis_items_virtual(node_s, s_lin, signs, num_bp, vf, node_cap, vtab=None):
    """Walk-ordered emission items for the virtual (power-of-two cube)
    forest: (payload words [T] int32, n_sig int32).

    Payload bits: 0 is_ent | 1-6 lo | 7-12 s | 13 sign | 14 sig_now |
    15 has_sign | 16 dec_emitted | 17 ok."""
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
        vtab = vf.build_vtab(
            torch.clamp(s_lin, 0, 127) | (signs.to(_I32) << 7), node_s
        )
    cnt, rvalid, ispx, isnd, vidx, v = vf.children_rows(q, svalid, slot, vtab)
    rowpass = torch.where(svalid, node_s[q.long()], never)
    row_s = torch.where(rvalid, torch.where(ispx, v & 127, v & _NEVER), never)
    row_sign = ((v >> 7) & 1) == 1

    sig_now = (row_s == rowpass[:, None]) & rvalid
    sig_i = sig_now.to(_I32)
    prev_any = torch.cumsum(sig_i, dim=1) - sig_i
    last = slot[None, :] == cnt[:, None] - 1
    emitted = ((prev_any > 0) | ~last) & rvalid

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
    newblk = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ls_lev[1:] != ls_lev[:-1]])
    bstart = torch.cummax(torch.where(newblk, iota_cb, zero), dim=0).values
    lev_c = torch.clamp(ls_lev, max=nlev - 1)
    o_val = _tiny_lookup(vf.off0, lev_c) + (iota_cb - bstart)

    # per-level totals -> suffix above -> walk ranks: O ranks are dense per
    # level (roots 0.., born off0..), so the walk position (levels desc, O
    # asc) is suffix_total(level) + O
    counts_lev = torch.bincount(ls_lev.long(), minlength=nlev + 1)[:nlev].to(_I32)
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
    R = C * MC
    ent_id = torch.cat([bid_s, vf.root_ids])
    ent_ok = torch.cat([bok_s, torch.ones(vf.nroots, dtype=torch.bool, device=dev)])
    ent_from = torch.cat([((k_s >> 5) & 63) + 1, vf.root_from])
    ent_s = torch.cat([s_s, node_s[vf.root_ids.long()]])
    ent_pw = vf.sort_paths_of(torch.clamp(ent_id, max=nn - 1))
    kw_ent = torch.cat([w_born, w_roots])

    qb = _bcast8(q, MC)
    slotb = slot.repeat(C)
    rp = vf.sort_child_paths(qb, slotb)
    rowpassf = _bcast8(rowpass, MC)
    sig_nowf = sig_now.reshape(R).to(_I32)
    emittedf = emitted.reshape(R).to(_I32)
    ispxf = ispx.reshape(R)
    row_signf = (row_sign & ispx).reshape(R).to(_I32)

    pay_ent = (
        1
        | (torch.clamp(ent_from, 0, 63) << 1)
        | (torch.clamp(ent_s, 0, 63) << 7)
        | (ent_ok.to(_I32) << 17)
    )
    row_hs = (ispxf & (sig_nowf == 1)).to(_I32)
    pay_row = (
        (torch.clamp(rowpassf, 0, 63) << 1)
        | (row_signf << 13)
        | (sig_nowf << 14)
        | (row_hs << 15)
        | (emittedf << 16)
    )
    kw_all = torch.cat([kw_ent, w_top])
    kpath = [torch.cat([e_w, r_w]) for e_w, r_w in zip(ent_pw, rp)]
    pay = torch.cat([pay_ent, pay_row])
    # walk rank and first path word in one key (both below 2^31)
    return pay[lexsort([_pack2(kw_all, kpath[0])] + kpath[1:])], n_sig


def lis_segments_device(node_s, s_lin, signs, num_bp, li, num_bp_cap, node_cap,
                        ev_cap=0, cap_total=0, return_events="items", vtab=None):
    """The set walk on the device, in its items form: (walk-ordered payload
    words, n_sig).  Only the virtual index and ``return_events="items"``
    are ported."""
    if return_events != "items" or not getattr(li, "uniform_children", False):
        raise NotImplementedError(
            "only the items form of the virtual-forest walk is ported; the "
            "table-form walk is ROADMAP queue 1, entry 11"
        )
    return _lis_items_virtual(node_s, s_lin, signs, num_bp, li, node_cap, vtab=vtab)


__all__ = ["lis_item_count", "lis_segments_device", "lexsort"]
