"""The table and 2D walks' kernels (kernels/walk_table.cu: K15's and K14's
walks, the I-set maxima and the node passes) on the CPU, where the card is
absent: a numpy emulation of the kernels' arithmetic (the anchors' chain
walk and hop words, the per-level ranks of rank.cuh with each level's hop
words ranked first, its gated sorted route, the rows, the entries'
insertion keys, the walk ranks by arithmetic, the walk keys from the static
path ranks and both sorts as stable sorts of their one int64 key) against
the plain versions and sperr_tpu, bit for bit; the 2D items through the
plain planes launch and K11 against sperr_tpu's event form, caps included;
TorchCompressor2D(entropy="wave")'s streams and tiers; the I-set maxima
(since they come with the child-table schedule, its pixel pass's blocks);
the path ranks against the path words; the static key widths and the rank
levels' key spans at the main path's sizes; the kernels' C structure and
constants against their mirrors; and dispatch.  Every result is an integer
and compared exactly."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.codec import speck_wave as jsw
from sperr_tpu.ops import speck_lis2_jax as jsl2
from sperr_tpu.ops import speck_lis_jax as jsl
from sperr_tpu.parallel import batched2d as jb2
from sperr_tpu_torch import kernels
from sperr_tpu_torch.ops import speck as tspk
from sperr_tpu_torch.ops import speck_lis as tsl
from sperr_tpu_torch.ops import speck_lis2 as tsl2
from sperr_tpu_torch.ops import speck_virtual as tsv
from sperr_tpu_torch.ops import wave_pack as twp
from sperr_tpu_torch.parallel import batched2d as tb2

_NEVER = 0x7FFF
_BIG = 2**31 - 1
_NOOP_ROW = 126  # payload of a child row of a padding parent: emits nothing


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops per walk: one thread per worker (several pytest
    workers otherwise wait on each other's parallel regions)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mags(n, seed, density, hi=1 << 14):
    rng = np.random.default_rng(seed)
    if density == "zero":
        return np.zeros(n, np.int32), rng.random(n) < 0.5
    if density == "one":
        m = np.zeros(n, np.int32)
        m[n // 3] = 9
        return m, rng.random(n) < 0.5
    m = (rng.integers(0, hi, size=n) * (rng.random(n) < density)).astype(np.int32)
    return m, rng.random(n) < 0.5


def _inputs3(dims, seed, density):
    """(li, node_s, s, signs, num_bp) of a 3D chunk, from the port's
    child-table schedule."""
    n = dims[0] * dims[1] * dims[2]
    mags, sgn = _mags(n, seed, density)
    mt = torch.from_numpy(mags)
    nb = tsv.msbp1_device(mt).max()
    s, _, nm = tspk.pixel_schedule(mt, tspk.tree_index(dims, "cpu"), nb)
    return tsl.lis_index(dims, "cpu"), tspk.node_passes(nm, nb), s, torch.from_numpy(sgn), nb


def _inputs2(nx, ny, seed, density):
    """(li, node_s, s, signs, num_bp, iset_s, pm) of a 2D field."""
    mags, sgn = _mags(nx * ny, seed, density)
    mt = torch.from_numpy(mags)
    nb, s, _, nm = tspk.schedule_table(mt, tspk.tree_index((nx, ny), "cpu"))
    pm = tsv.msbp1_device(mt)
    tree = jsw.build_tree2((nx, ny))
    iset_s = tsl2.iset_significance_device(pm.reshape(ny, nx), tree, nb)
    return (tsl2.lis2_index((nx, ny), "cpu"), tspk.node_passes(nm, nb), s, torch.from_numpy(sgn), nb,
            iset_s, pm)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------
def _np(t):
    return t.cpu().numpy().astype(np.int64)


def _check_width(keys, bits):
    keys = np.asarray(keys, np.int64)
    assert keys.size == 0 or (keys.min() >= 0 and int(keys.max()) < 2**bits), (int(keys.max()), bits)


def _stable_order(keys, bits):
    """The radix sort's order: stable, by keys[0], then keys[1], ..."""
    for k, b in zip(keys, bits):
        _check_width(k, b)
    return np.lexsort([np.asarray(k, np.int64) for k in keys[::-1]])


def _sorted_ranks(key, bits):
    """rank.cuh's sorted route for a level wider than the bitmaps: the
    stable radix sort carrying each key's position, the heads (a sorted key
    unlike the one before it) as bits over the sorted positions in 8-word
    groups padded to a multiple of 4, one count a group, their exclusive
    prefix, and rank = the heads at or before the sorted position - 1."""
    cnt = key.size
    order = _stable_order([key], [bits])
    sk = key[order]
    groups = (((cnt + 255) >> 8) + 3) & ~3
    head = np.zeros(groups * 256, np.int64)
    head[:cnt] = np.r_[True, sk[1:] != sk[:-1]]
    per = head.reshape(groups, 256)
    gcnt = per.sum(axis=1)
    below = ((np.cumsum(gcnt) - gcnt)[:, None] + np.cumsum(per, axis=1) - per).reshape(-1)
    rank = np.empty(cnt, np.int64)
    rank[order] = below[:cnt] + head[:cnt] - 1
    return rank


def _urank_level(u, low, D, cap_bits, small):
    """rank.cuh's u-ranked route for one level: each hop word's dense rank
    ur among the level's (its bitmap's popcounts), the keys ur D + low, the
    groups they span (a multiple of 4), the presence bitmap's group counts,
    their prefixes within scan blocks of RANK_SCAN_GROUPS groups and the
    blocks' prefixes, and rank = the distinct keys below the key; None
    where a larger level's groups pass its region (2^cap_bits bits: the
    gated sorted route takes it).  Returns (ranks, distinct keys, groups)."""
    words = np.zeros(kernels.RANK_U_WORDS, np.int64)
    np.bitwise_or.at(words, u >> 5, 1 << (u & 31))
    pop = np.array([bin(int(w)).count("1") for w in words])
    upre = np.cumsum(pop) - pop
    x = np.arange(32 * kernels.RANK_U_WORDS)
    below = np.array([bin(int(words[v >> 5]) & ((1 << (v & 31)) - 1)).count("1") for v in x], np.int64)
    ur = upre[u >> 5] + below[u]  # the word's prefix and the popcount below the bit
    assert (low < D).all() and (ur < pop.sum()).all()
    key = ur * D + low
    groups = (((int(pop.sum()) * D + 255) >> 8) + 3) & ~3
    if small:
        groups = (int(pop.sum()) * D + 255) >> 8
        assert groups <= 1 << (kernels.RANK_SMALL_BITS - 8)
    elif groups > (1 << cap_bits) // 256:
        return None, None, groups
    bm = np.zeros(groups * 256, bool)
    bm[key] = True
    gcnt = bm.reshape(groups, 256).sum(axis=1)
    blk = np.arange(groups) // kernels.RANK_SCAN_GROUPS
    gpre = np.zeros(groups, np.int64)
    bsum = np.zeros(blk[-1] + 1, np.int64)
    for b in range(blk[-1] + 1):
        g = gcnt[blk == b]
        gpre[blk == b] = np.cumsum(g) - g
        bsum[b] = g.sum()
    bpre = np.cumsum(bsum) - bsum
    below = np.cumsum(bm) - bm  # within a group: the bits below
    gstart = np.repeat(np.cumsum(gcnt) - gcnt, 256)
    rank = bpre[blk[key >> 8]] + gpre[key >> 8] + (below[key] - gstart[key])
    np.testing.assert_array_equal(rank, np.unique(key, return_inverse=True)[1].reshape(-1))
    return rank, int(bm.sum()), groups


def _emulate_ranks(li, node_s, iset, cap_bits=kernels.RANK_CAP_BITS, info=None):
    """table_anchors and rank.cuh, emulated (the larger levels' regions of
    at most 2^cap_bits bits, an overflowing level ranked by its sorted
    route): (J, R, u, jp, the ranked nodes).  ``info``, a dict, receives
    each level's route and the groups its keys span."""
    st = tsl.table_static(li)
    form = st.form
    T = {k: _np(v) for k, v in st.tables.items()}
    parent, level = T["parent"], T["level"]
    nn, nlev = li.nn, li.nlev
    xf = li.xf if form else 0

    def kpass(k):
        return iset[np.clip(k, 0, xf)]

    # -- table_anchors: the chain walk, J, the hop words
    z = np.arange(nn)
    p = parent
    has = p >= 0
    sp = np.where(has, node_s[np.maximum(p, 0)], 0)
    cur = np.where(has, p, z)
    act = has.copy()
    for _ in range(li.depth_max + 1):
        g = parent[cur]
        same = act & (g >= 0) & (node_s[np.maximum(g, 0)] == sp)
        cur = np.where(same, g, cur)
        act = same
    J = np.where(has & (sp == node_s), cur, z)
    if form == 0:
        u = np.where(has, (1 << 11) | (np.clip(sp, 0, 63) << 5) | (31 - level[cur]), T["O0"])
        jp = np.where(has, cur, -1)
    else:
        grp = T["is_group"] == 1
        ar = np.where(grp | ~has, z, cur)
        ganc = (T["is_group"][ar] == 1) & ((z == ar) | (kpass(T["k_of"][ar]) == node_s[ar]))
        ranc = ar == 0
        bn = np.where(grp, kpass(T["k_of"][z]), np.where(has, sp, 0))
        acode = np.where(ganc, nlev + 1, nlev - level[ar])
        u = np.where(z == 0, 0, (np.clip(bn, 0, 63) << 6) | (acode << 1) | (~ranc).astype(np.int64))
        jp = np.where(ganc, -1 - np.clip(T["irank_of"][ar], 0, 2047), np.where(ranc | ~has, -1, ar))
        jp[0] = -1
    assert u.min() >= 0 and int(u.max()) < 2**12
    # -- rank.cuh: each ranked level's hop words ranked first, then its keys
    # ur D + low on a bitmap (D: the running bound on the low fields), coarse
    # levels first; a larger level that overflows its region by the sorted
    # route
    R = np.zeros(nn, np.int64)
    rows = st.plan.host.reshape(-1, kernels.RANK_LEVEL_INTS)
    rl = kernels.table_rank_layout(st.plan.host, st.plan.nsmall, cap_bits)
    ranked = np.zeros(nn, bool)
    D = st.dlow0
    for lvl, row in enumerate(rows):
        cnt, wk, ns = (int(x) for x in row[:3])
        ids = np.concatenate([np.arange(row[3 + k], row[3 + kernels.RANK_SPANS + k]) for k in range(ns)])
        assert ids.size == cnt and (level[ids] == level[ids[0]]).all()
        assert ranked[jp[ids][jp[ids] >= 0]].all()  # the next strings are ranked first
        low = np.where(jp[ids] < 0, -1 - jp[ids], R[np.maximum(jp[ids], 0)] + 1)
        assert low.max(initial=0) < 2**wk and D <= 2**wk
        key = (u[ids] << wk) | low
        _check_width(key, 12 + wk)
        r, nd, groups = _urank_level(u[ids], low, D, cap_bits, lvl < rl.nsmall)
        route = "bitmap" if r is not None else "gated"
        assert r is not None or lvl in rl.gated  # only a gated level overflows
        # the next level's multiplier: past this level's distinct keys, or
        # after an overflow the static bound 2^wk of the next level
        D = max(D, nd + 1) if r is not None else 2 ** int(rows[min(lvl + 1, len(rows) - 1)][1])
        if r is None:
            r = _sorted_ranks(key, 12 + wk)
        R[ids] = r
        ranked[ids] = True
        if info is not None:
            info[lvl] = (route, groups)
    return J, R, u, jp, ranked


def _emulate(li, node_s_t, s_t, sgn_t, cap, iset_t=None, nb_t=None, cap_bits=kernels.RANK_CAP_BITS, info=None):
    """The walk as kernels/walk_table.cu computes it, launch by launch (the
    rank stage as ``_emulate_ranks``; both sorts as stable sorts of their
    one int64 key, widths checked)."""
    st = tsl.table_static(li)
    lay = tsl.table_layout(li, cap)
    form = st.form
    T = {k: _np(v) for k, v in st.tables.items()}
    level = T["level"]
    pidx, ptab = T["pidx"], T["ptab"].reshape(-1, li.max_ch + 1)
    nn, n, MC, nlev = li.nn, li.n, lay.MC, li.nlev
    node_s, s_lin, sgn = _np(node_s_t), _np(s_t), _np(sgn_t)
    xf = li.xf if form else 0
    iset = _np(iset_t) if form else None
    nbp = int(nb_t) if form else 0

    def kpass(k):
        return iset[np.clip(k, 0, xf)]

    J, R, u, jp, ranked = _emulate_ranks(li, node_s, iset, cap_bits, info)
    # -- K12: the significant sets
    sig = np.flatnonzero(node_s < _NEVER)
    take, C = lay.take, lay.C
    sid = np.full(take, nn, np.int64)
    sid[: min(take, sig.size)] = sig[:take]
    # -- table_rows
    c = np.arange(C)
    sd = np.where(c < take, sid[np.minimum(c, take - 1)], nn)
    ok = sd < nn
    q = np.where(ok, sd, nn - 1)
    cnt = np.where(ok, T["ch_count"][q], 0)
    rowpass = np.where(ok, node_s[q], _NEVER)
    k = np.arange(MC)
    rv = k[None, :] < cnt[:, None]
    crow = T["ctab"][np.minimum(T["ch_start"][q][:, None] + k, li.nrows - 1)]
    px = rv & ((crow & 1) == 1)
    nd = rv & ((crow & 1) == 0)
    vidx = crow >> 1
    val = np.where(px, s_lin[np.clip(vidx, 0, n - 1)] | (sgn[np.clip(vidx, 0, n - 1)] << 15),
                   node_s[np.clip(vidx - n, 0, nn - 1)])
    val = np.where(rv, val, 0)
    sig_now = (rv & ((val & _NEVER) == rowpass[:, None])).astype(np.int64)
    mask = (sig_now << k).sum(axis=1)
    prev = (mask[:, None] & ((1 << k) - 1)) != 0
    emitted = (rv & (prev | (k != cnt[:, None] - 1))).astype(np.int64)
    ispx = px.astype(np.int64)
    pay = np.zeros(lay.T, np.int64)
    pay[lay.E: lay.E + lay.R] = ((np.clip(rowpass, 0, 63) << 1)[:, None] | ((((val >> 15) & 1) & ispx) << 13)
                                 | (sig_now << 14) | ((ispx & sig_now) << 15) | (emitted << 16)).reshape(-1)
    # -- K12: the born rows
    born = np.flatnonzero(nd.reshape(-1))
    bidx = np.full(lay.CB, lay.R, np.int64)
    bidx[: min(lay.CB, born.size)] = born[: lay.CB]
    n_sig_out = _BIG if born.size > lay.CB else sig.size

    def entries(b):
        b = np.asarray(b, np.int64)
        e_ok = np.zeros(b.size, bool)
        bid = np.full(b.size, nn, np.int64)
        bn = np.full(b.size, _BIG, np.int64)
        an = np.full(b.size, nn, np.int64)
        isb = b < lay.CB
        bi = bidx[np.minimum(b, lay.CB - 1)]
        okb = isb & (bi < lay.R)
        qb = np.minimum(sid[np.minimum(np.where(okb, bi, 0) // MC, take - 1)], nn - 1)
        cr = T["ctab"][np.minimum(T["ch_start"][qb] + np.where(okb, bi, 0) % MC, li.nrows - 1)]
        e_ok[okb] = True
        bid[okb] = (cr >> 1)[okb] - n
        bn[okb] = node_s[qb][okb]
        an[okb] = J[qb][okb]
        if form:
            j = b - lay.CB
            root = j == 0
            e_ok[root], bid[root], bn[root], an[root] = True, 0, 0, 0
            gi = (j >= 1)
            gk = np.where(gi, j - 1, 0)
            gbn = kpass(T["group_k"][gk])
            okg = gi & (gbn < _NEVER)
            e_ok[okg], bid[okg], bn[okg], an[okg] = True, T["group_ids"][gk][okg], gbn[okg], T["group_ids"][gk][okg]
        return e_ok, bid, bn, an

    # -- table_born: the insertion keys, the per-level counts
    e_ok, bid, bn, an = entries(np.arange(lay.NE))
    bidc = np.minimum(bid, nn - 1)
    arl = np.minimum(an, nn - 1)
    lev = level[bidc]
    if form == 0:
        lba = np.where(e_ok, (lev << 11) | (np.clip(bn, 0, 63) << 5) | (31 - level[arl]), nlev << 11)
        arank = np.where(e_ok, R[arl], 0)
    else:
        ganc = (T["is_group"][arl] == 1) & ((bid == an) | (kpass(T["k_of"][arl]) == node_s[arl]))
        rself = bid == 0
        ranc = (an == 0) & ~rself
        acode = np.where(rself, 0, np.where(ganc, nlev + 1, nlev - level[arl]))
        lba = np.where(e_ok, (lev << 12) | (np.clip(bn, 0, 63) << 6) | (acode << 1)
                       | (~(rself | ranc)).astype(np.int64), nlev << 12)
        arank = np.where(e_ok, np.where(ganc, T["irank_of"][arl], np.where(rself | ranc, 0, R[arl])), 0)
    if form == 0:
        assert (~e_ok | ranked[arl]).all()  # every valid entry's anchor is ranked
    assert arank.max(initial=0) < 2**st.wa and lba.max() < 2**st.lba_bits
    ikey = (((lba << st.wa) | arank) << st.pb) | ptab[pidx[bidc], 0]
    counts = np.bincount(lev[e_ok], minlength=nlev + 1)
    perm = _stable_order([ikey], [lay.ins_bits])
    # -- table_entries: the walk ranks by arithmetic
    start = np.cumsum(counts[:nlev]) - counts[:nlev]
    off0 = T["off0"] if form == 0 else np.zeros(nlev, np.int64)
    tot = off0 + counts[:nlev]
    suffix = np.r_[np.cumsum(tot[::-1])[::-1][1:], 0]
    nroots = 0 if form else li.nroots
    e_ok, bid, bn, an = entries(perm)
    bidc = np.minimum(bid, nn - 1)
    lev = level[bidc]
    i = np.arange(lay.NE)
    w = np.where(e_ok, suffix[lev] + off0[lev] + i - start[lev], i + nroots)
    wbuf = np.full(nn + 1, _BIG, np.int64)
    wbuf[bid[e_ok]] = w[e_ok]
    frm = np.where(e_ok & ~((form == 1) & (bid == 0)), bn + 1, 0)
    pay[: lay.NE] = (1 | (np.clip(frm, 0, 63) << 1) | (np.clip(node_s[bidc], 0, 63) << 7)
                     | (e_ok.astype(np.int64) << 17))
    wkey = np.zeros(lay.T, np.int64)

    def put(idx, wr, prank):
        assert np.max(wr, initial=0) <= lay.tcap
        wkey[idx] = (wr << st.pb) | prank

    put(slice(0, lay.NE), w, ptab[pidx[bidc], 0])
    if form == 0:
        r = np.arange(li.nroots)
        rid = T["root_ids"]
        wr = suffix[T["root_levels"]] + T["O0"][rid]
        wbuf[rid] = wr
        pay[lay.NE: lay.E] = 1 | (np.clip(node_s[rid], 0, 63) << 7) | (1 << 17)
        put(slice(lay.NE, lay.E), wr, 0)  # the roots' zero path
    # -- table_rowkeys: the rows' walk keys, the 2D I items
    anc = np.where(ok, J[q], q)
    wr = np.minimum(wbuf[anc], lay.tcap)
    if form:
        crit = ok & (T["is_group"][anc] == 1) & (kpass(T["k_of"][anc]) == node_s[anc])
        wr = np.where(crit, lay.wbase + T["block_rank_of"][anc], wr)
    put(slice(lay.E, lay.E + lay.R), np.repeat(wr, MC), ptab[pidx[q], 1:].reshape(-1))  # padding slots too
    if form:
        G = li.G
        kj = xf - np.arange(xf)
        birth = np.where(kj == xf, 0, kpass(kj + 1))
        gk, gid = T["group_k"][:G], T["group_ids"][:G]
        gsig = node_s[gid] == kpass(gk)
        anyk = np.array([bool((gsig & (gk == kk + 1)).any()) for kk in kj], bool)
        lo = birth + ((kj < xf) & ~anyk)
        okp = (birth < _NEVER) & (lo < nbp)
        o = lay.E + lay.R
        pay[o: o + xf] = 1 | (np.clip(lo, 0, 63) << 1) | (np.clip(kpass(kj), 0, 63) << 7) | (okp << 17)
        put(slice(o, o + xf), lay.wbase + 8 * (xf - kj), 0)
        gbn = kpass(gk)
        pay[o + xf: o + xf + G] = (np.clip(gbn, 0, 63) << 1) | (gsig << 14) | ((gbn < nbp) << 16)
        put(slice(o + xf, o + xf + G), lay.wbase + T["gbit_rank"][:G], 0)
    perm = _stable_order([wkey], [lay.walk_bits])
    return pay[perm], n_sig_out, J, R


# (dims, seed, density, node cap as a fraction of the node count): packet
# and pyramid (dyadic) chunks, every density, all-zero and one-pixel inputs,
# caps below and above the node count
_CASES3 = [((24, 24, 16), 0, 0.3, 1.0), ((23, 15, 13), 1, 0.5, 1.0), ((20, 20, 20), 2, 0.2, 0.25),
           ((32, 32, 16), 3, 0.02, 2.0), ((23, 16, 16), 4, 0.9, 1.0), ((64, 64, 25), 5, 0.05, 1.0),
           ((24, 24, 16), 6, "zero", 1.0), ((23, 15, 13), 7, "one", 1.0)]


@functools.lru_cache(maxsize=None)
def _jax_items(dims, cap):
    lj = jsl.lis_index(dims)
    return jax.jit(lambda ns, s, g, nb: jsl.lis_segments_device(ns, s, g, nb, lj, 34, cap, 0, 0,
                                                                return_events="items"))


@pytest.mark.parametrize("dims,seed,density,frac", _CASES3)
def test_table_walk_emulation_equals_plain_and_jax(dims, seed, density, frac):
    li, node_s, s, sgn, nb = _inputs3(dims, seed, density)
    cap = max(16, int(li.nn * frac))
    pay, n_sig, J, R = _emulate(li, node_s, s, sgn, cap)
    pr, nsr = tsl._lis_items_table_ref(node_s, s, sgn, nb, li, cap)
    assert n_sig == int(nsr)
    np.testing.assert_array_equal(pay, pr.numpy())  # padding items included
    Jr, *_ = tsl._chain_anchors(node_s, li.parent, max(1, li.depth_max.bit_length()))
    np.testing.assert_array_equal(J, Jr.numpy())
    pj, nj = _jax_items(dims, cap)(jnp.asarray(node_s.numpy()), jnp.asarray(s.numpy()),
                                   jnp.asarray(sgn.numpy()), jnp.asarray(nb.numpy()))
    pj = np.asarray(pj)
    assert int(nj) == n_sig and pj.shape == pay.shape
    # XLA's unstable sorts may place padding rows among the rows they tie with
    np.testing.assert_array_equal(pay[pay != _NOOP_ROW], pj[pj != _NOOP_ROW])


_SHAPES2 = [(33, 57), (64, 48), (32, 32), (128, 41)]
_CASES2 = [(nx, ny, seed, d) for (nx, ny), seed in zip(_SHAPES2, range(4)) for d in (0.4, 0.02)] + [
    (33, 57, 9, 0.95), (64, 48, 10, "zero"), (33, 57, 11, "one"), (57, 33, 12, 0.3)]


@functools.lru_cache(maxsize=None)
def _jax_events(dims, cap, ev_cap, cap_total):
    li2 = jsl2.lis2_index(dims)
    return jax.jit(lambda ns, s, g, nb, iset: jsl2.lis2_segments_device(
        ns, s, g, nb, iset, li2, 34, cap, ev_cap, cap_total))


def _jax_event_form(nx, ny, node_s, s, sgn, nb, iset_s, cap, ev_cap, cap_total):
    return [np.asarray(v) for v in _jax_events((nx, ny), cap, ev_cap, cap_total)(
        jnp.asarray(node_s.numpy()), jnp.asarray(s.numpy()), jnp.asarray(sgn.numpy()),
        jnp.asarray(nb.numpy()), jnp.asarray(iset_s.numpy()))]


@pytest.mark.parametrize("nx,ny,seed,density", _CASES2)
def test_2d_walk_emulation_equals_plain_and_jax(nx, ny, seed, density):
    li, node_s, s, sgn, nb, iset_s, _ = _inputs2(nx, ny, seed, density)
    pay, n_sig, _, _ = _emulate(li, node_s, s, sgn, li.nn, iset_s, nb)
    pr, nsr = tsl2._lis2_items_ref(node_s, s, sgn, nb, iset_s, li, li.nn)
    assert n_sig == int(nsr)
    np.testing.assert_array_equal(pay, pr.numpy())
    # the born entries, the walk root and group heads, the rows, the I items
    R = li.nn * li.max_ch
    assert pay.shape == (min(R, li.nn) + 1 + 2 * li.G + R + li.xf,) == (tsl.table_layout(li, li.nn).T,)
    # the emulated items through the event tail equal sperr_tpu's event form
    n = nx * ny
    ev_cap, cap_total = 6 * n + 4096, 2 * n + 64
    ours = tsl._event_tail(torch.from_numpy(pay.astype(np.int32)), torch.tensor(n_sig, dtype=torch.int32), nb,
                           34, ev_cap, cap_total)
    for a, b in zip(ours, _jax_event_form(nx, ny, node_s, s, sgn, nb, iset_s, li.nn, ev_cap, cap_total)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("case", ["table", "pyramid", "2d", "2d one"])
def test_plain_anchor_stage_equals_the_emulation(case):
    """table_anchors_ref, the plain version phase 3 holds the anchors kernel
    against (J, R, u, jp), equals the emulated kernel's J and per-level R."""
    if case in ("table", "pyramid"):
        li, node_s, s, sgn, nb = _inputs3((24, 24, 16) if case == "table" else (23, 15, 13), 3, 0.3)
        iset_s = None
        _, _, J, R = _emulate(li, node_s, s, sgn, li.nn)
    else:
        li, node_s, s, sgn, nb, iset_s, _ = _inputs2(64, 48, 4, 0.3 if case == "2d" else "one")
        _, _, J, R = _emulate(li, node_s, s, sgn, li.nn, iset_s, nb)
    Jr, Rr, u, jp = tsl.table_anchors_ref(node_s, li, iset_s)
    np.testing.assert_array_equal(Jr.numpy(), J)
    np.testing.assert_array_equal(Rr.numpy(), R)
    assert u.dtype == jp.dtype == torch.int32 and int(u.min()) >= 0 and int(u.max()) < 2**12


@pytest.mark.parametrize("case", ["table", "pyramid", "2d", "2d one", "2d dense", "table gated", "pyramid gated",
                                  "2d gated", "2d one gated", "2d dense gated"])
def test_sorted_rank_levels_give_the_plain_walk(case):
    """The rank levels under a lower cap give the walks' own ranks and the
    plain walk's payload words bit for bit: every level past 16 key bits
    gated on regions of 2^16 bits (``cap_bits = 16``: the levels within
    them ranked as the walks rank them, the others on the smaller region
    or by their sorted route), or every level on regions of 2^8 bits
    (``cap_bits = 8``: none ranked in one block, every key set past its
    region), each through its gated sorted route."""
    gated = case.endswith(" gated")
    case = case.removesuffix(" gated")
    if case in ("table", "pyramid"):
        li, node_s, s, sgn, nb = _inputs3((24, 24, 16) if case == "table" else (23, 15, 13), 5, 0.3)
        iset_s = None
        want = tsl._lis_items_table_ref(node_s, s, sgn, nb, li, li.nn)
    else:
        nx, ny, density = {"2d": (64, 48, 0.3), "2d one": (33, 57, "one"), "2d dense": (128, 41, 0.9)}[case]
        li, node_s, s, sgn, nb, iset_s, _ = _inputs2(nx, ny, 6, density)
        want = tsl2._lis2_items_ref(node_s, s, sgn, nb, iset_s, li, li.nn)
    st = tsl.table_static(li)
    cap_bits = 8 if gated else 16
    rl = kernels.table_rank_layout(st.plan.host, st.plan.nsmall, cap_bits)
    info = {}
    pay, n_sig, J, R = _emulate(li, node_s, s, sgn, li.nn, iset_s, nb, cap_bits=cap_bits, info=info)
    bits = [12 + w for w in st.plan.wks]
    if not gated:  # the levels past 16 bits gated, those within them not
        assert rl.gated == tuple(k for k, b in enumerate(bits) if b > 16) and rl.gated
        assert all(info[k][0] == "bitmap" for k, b in enumerate(bits) if b <= 16)
    else:
        assert rl.nsmall == 0 and {r for r, _ in info.values()} == {"gated"}
    _, _, J0, R0 = _emulate(li, node_s, s, sgn, li.nn, iset_s, nb)
    np.testing.assert_array_equal(R, R0)
    np.testing.assert_array_equal(J, J0)
    np.testing.assert_array_equal(pay, want[0].numpy())
    assert n_sig == int(want[1])


@pytest.mark.parametrize("dims", [(4096, 4096), (7200, 3600), (256, 256, 200)])
def test_rank_plan_takes_fields_past_the_main_path_sizes(dims):
    """The walks take fields and chunks wider than the main path's: every
    key of the walk within its width (``_widths_hold``), every rank level on
    a bitmap (none sorted), and a larger level on a region of 2^27 bits at
    most, gated to its sorted route where its static 12 + wk bits pass that
    (at 3600 x 7200 the finest level's 33)."""
    # built apart from the index cache, so the worker does not keep it
    li = tsl2.Lis2Index(dims, "cpu") if len(dims) == 2 else tsl.LisIndex(dims, "cpu")
    st, lay = _widths_hold(li, li.nn)
    rl = kernels.table_rank_layout(st.plan.host, st.plan.nsmall)
    bits = [12 + w for w in st.plan.wks]
    assert len(rl.cap_bits) == len(bits) - rl.nsmall and max(rl.cap_bits) <= kernels.RANK_CAP_BITS
    assert rl.gated == tuple(k for k, b in enumerate(bits) if b > kernels.RANK_CAP_BITS and k >= rl.nsmall)
    assert (dims == (7200, 3600)) <= (max(bits) == 33)
    assert lay.T < 2**31


def test_breakdown_of_a_table_chunk_runs_on_the_cpu():
    from sperr_tpu_torch.runtime import device_bench as tdb
    r = tdb.wave_entropy_breakdown(16, iters=1, device="cpu", dims=(16, 12, 10))
    assert r["dims"] == (16, 12, 10) and r["full_pack_cum_s"] > 0 and set(r["timed"].values()) == {"cpu"}


# ---------------------------------------------------------------------------
# the 2D LIS bits through K9's planes launch (no pixel field) and K11
# (plain versions)
# ---------------------------------------------------------------------------
# (shape, seed, density, node cap: None = nn, ev_cap: None = 6 n + 4096,
# cap_total: None = 2 n + 64): fitting fields, the event cap (700, as
# tests/test_torch_wave2d.py's overflow case), the byte cap, a node cap
# below the significant sets
@pytest.mark.parametrize("nx,ny,seed,density,cap,ev_cap,cap_total", [
    (64, 48, 0, 0.4, None, None, None), (33, 57, 1, 0.02, None, None, None),
    (128, 41, 2, 0.95, None, None, None), (64, 48, 3, "one", None, None, None),
    (64, 48, 0, 0.4, None, 700, None), (64, 48, 0, 0.4, None, None, 100),
    (33, 57, 4, 0.4, 50, None, None), (32, 32, 5, "zero", None, None, None),
])
def test_2d_items_through_k9b_and_k11_equal_the_event_form(nx, ny, seed, density, cap, ev_cap, cap_total):
    li, node_s, s, sgn, nb, iset_s, _ = _inputs2(nx, ny, seed, density)
    n = nx * ny
    cap = li.nn if cap is None else cap
    ev_cap = 6 * n + 4096 if ev_cap is None else ev_cap
    cap_total = 2 * n + 64 if cap_total is None else cap_total
    pay, n_sig = tsl2.lis2_segments_device(node_s, s, sgn, nb, iset_s, li, 34, cap, ev_cap, cap_total,
                                           return_events="items")
    buf, counts, total, n_sig2 = twp.wave_emit_2d_lis(pay, n_sig, nb, 34, ev_cap, cap_total)
    want = _jax_event_form(nx, ny, node_s, s, sgn, nb, iset_s, cap, ev_cap, cap_total)
    assert int(n_sig2) == int(want[3])  # the same overflows raise n_sig
    assert buf.dtype == torch.uint8 and buf.shape == (cap_total,) and counts.shape == (34,)
    events = int(counts.sum())
    if events <= ev_cap and int(total) <= cap_total:
        for a, b in zip((buf, counts, total), want):
            np.testing.assert_array_equal(a.numpy(), b)
    else:
        assert int(n_sig2) == _BIG
    # the plain event form on the same items, as it was
    ev = tsl2.lis2_segments_device(node_s, s, sgn, nb, iset_s, li, 34, cap, ev_cap, cap_total)
    for a, b in zip(ev, want):
        np.testing.assert_array_equal(a.numpy(), b)


def _event_program(mags, signs, index, caps, num_bp_cap):
    """The 2D program with the LIS bits in the event form (as it ran before
    the planes launch and K11 route)."""
    ti, li2, tree2 = index
    nx, ny = tree2.dims
    num_bp, s, e, nm = tspk.schedule_table(mags, ti)
    pm = tsv.msbp1_device(mags)
    px, px_c, px_total, px_over = twp.wave_emit_2d_pixels(
        mags, signs, s, e, num_bp, caps["px_bp"], caps["px_evb"], caps["px_out"], caps["wexp_px"])
    node_s = tspk.node_passes(nm, num_bp)
    iset_s = tsl2.iset_significance_device(pm.reshape(ny, nx), tree2, num_bp)
    lis, lis_c, lis_total, n_sig = tsl2.lis2_segments_device(
        node_s, s, signs, num_bp, iset_s, li2, num_bp_cap, caps["node_cap"], caps["ev_cap"], caps["cap_total"])
    return dict(num_bp=num_bp, px=px, px_c=px_c, px_total=px_total, px_over=px_over | (num_bp > caps["px_bp"]),
                lis=lis, lis_c=lis_c, lis_total=lis_total, n_sig=n_sig)


def _fields(nx, ny, seed):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(np.cumsum(rng.normal(size=(3, ny, nx)), axis=1), axis=2) * 0.01
    noisy = rng.normal(size=(2, ny, nx))
    const = np.full((1, ny, nx), 0.25)
    return np.concatenate([smooth, noisy, const]).astype(np.float32)


@pytest.mark.parametrize("nx,ny,mode,quality", [(64, 48, "pwe", 1e-2), (33, 57, "pwe", 1e-3),
                                                (64, 48, "psnr", 60.0)])
def test_wave2d_streams_and_tiers_equal_the_event_form_and_host(nx, ny, mode, quality, monkeypatch):
    f = _fields(nx, ny, nx + ny)
    host = tb2.TorchCompressor2D((nx, ny), device="cpu")
    wave = tb2.TorchCompressor2D((nx, ny), device="cpu", entropy="wave")
    want = host.compress_batch(f, mode, quality)
    got = wave.compress_batch(f, mode, quality)
    assert got == want
    tiers, chunks = list(wave.last_wave_tiers), wave.last_wave_chunks
    assert tiers[-1] is None and chunks >= 2
    monkeypatch.setattr(tb2, "_wave_emit_field", _event_program)
    ev = tb2.TorchCompressor2D((nx, ny), device="cpu", entropy="wave")
    assert ev.compress_batch(f, mode, quality) == want
    assert ev.last_wave_tiers == tiers and ev.last_wave_chunks == chunks


def test_wave2d_streams_equal_jax():
    """The port's wave streams equal sperr_tpu's wave compressor's on every
    field whose host-entropy streams agree between the packages (their f32
    fronts may round a field apart), with as many fields on the device."""
    nx, ny = 64, 48
    y, x = np.mgrid[0:ny, 0:nx]
    smooth = np.sin(x * 0.3) * np.cos(y * 0.2)
    rng = np.random.default_rng(8)
    g = np.round(np.stack([smooth * 2.0, 1.5 * smooth[::-1], smooth[:, ::-1] + 0.3 * rng.normal(size=(ny, nx)),
                           rng.normal(size=(ny, nx))]) * 16)
    g[:, 0, 0] -= g.sum(axis=(1, 2))
    f = (g / 16).astype(np.float32)
    t = jb2.TpuCompressor2D((nx, ny), entropy="wave")
    want = t.compress_batch(f, "pwe", 1e-2)
    want_host = jb2.TpuCompressor2D((nx, ny)).compress_batch(f, "pwe", 1e-2)
    p = tb2.TorchCompressor2D.from_jax(t, "cpu")
    got = p.compress_batch(f, "pwe", 1e-2)
    got_host = tb2.TorchCompressor2D((nx, ny), device="cpu").compress_batch(f, "pwe", 1e-2)
    same = [k for k in range(len(f)) if got_host[k] == want_host[k]]
    assert len(same) >= 3
    for k in same:
        assert got[k] == want[k]
    assert got == got_host and want == want_host
    assert p.last_wave_chunks == t.last_wave_chunks == len(f)


# ---------------------------------------------------------------------------
# the I-set maxima
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nx,ny,seed,density", [(33, 57, 0, 0.3), (64, 48, 1, 0.01), (128, 41, 2, "one"),
                                                (32, 32, 3, "zero"), (200, 150, 4, 0.5)])
def test_iset_max_equals_jax(nx, ny, seed, density):
    li, _, _, _, nb, iset_s, pm = _inputs2(nx, ny, seed, density)
    tree = jsw.build_tree2((nx, ny))
    want = np.asarray(jsl2.iset_significance_device(jnp.asarray(pm.numpy().reshape(ny, nx)), tree,
                                                    jnp.asarray(nb.numpy())))
    np.testing.assert_array_equal(iset_s.numpy(), want)
    ref = tsl2.iset_significance_ref(pm.reshape(ny, nx), tree, nb)
    np.testing.assert_array_equal(ref.numpy(), want)
    # the schedule's pixel pass: blocks of kPixTile pixels of one row (the
    # row's test uniform in a block); a pixel counts for level k when it is
    # past the corner (y >= ay_k or x >= ax_k); the maxima, then num_bp - max
    # or NEVER
    fused = tspk.schedule_table(torch.from_numpy(_mags(nx * ny, seed, density)[0]),
                                tspk.tree_index((nx, ny), "cpu"), iset_regions=tree.iset_regions[: tree.xf + 1])
    np.testing.assert_array_equal(fused[4].numpy(), want)
    pmn = pm.numpy().reshape(ny, nx).astype(np.int64)
    tile = kernels.SCHED_PIX_TILE
    g = [0] * (tree.xf + 1)
    for y in range(ny):
        for x0 in range(0, nx, tile):
            blk = pmn[y, x0:x0 + tile]
            xs = np.arange(x0, x0 + blk.size)
            for k in range(1, tree.xf + 1):
                ax, ay = tree.iset_regions[k]
                g[k] = max(g[k], int(blk.max() if y >= ay or x0 >= ax else np.where(xs >= ax, blk, 0).max()))
    emu = [_NEVER] + [int(nb) - m if m > 0 else _NEVER for m in g[1:]]
    np.testing.assert_array_equal(np.asarray(emu), want)
    assert tree.xf <= kernels.ISET_MAX_LEVELS


def test_node_passes_equal_the_schedule_form():
    rng = np.random.default_rng(3)
    nm = torch.from_numpy(rng.integers(0, 20, 5000).astype(np.int32))
    nb = torch.tensor(19, dtype=torch.int32)
    np.testing.assert_array_equal(tspk.node_passes(nm, nb).numpy(),
                                  torch.where(nm > 0, nb - nm, _NEVER).numpy())


# ---------------------------------------------------------------------------
# the static key widths at the main path's sizes
# ---------------------------------------------------------------------------
def _widths_hold(li, cap):
    st = tsl.table_static(li)
    lay = tsl.table_layout(li, cap)
    rl = kernels.table_rank_layout(st.plan.host, st.plan.nsmall)  # every level on a bitmap
    assert len(rl.cap_bits) == len(st.plan.counts) - rl.nsmall and all(c <= kernels.RANK_CAP_BITS for c in rl.cap_bits)
    assert sum(st.plan.counts) <= li.nn and max(st.plan.counts) < 2**st.wa
    assert st.lba_bits == ((li.nlev << (12 if st.form else 11))).bit_length() and li.nlev <= 30
    # the largest insertion and walk keys, one int64 each
    top_ins = (((li.nlev << (12 if st.form else 11)) << st.wa) | (2**st.wa - 1)) << st.pb | (2**st.pb - 1)
    assert top_ins < 2**lay.ins_bits <= 2**63
    assert (lay.tcap << st.pb | (2**st.pb - 1)) < 2**lay.walk_bits <= 2**63
    assert lay.tcap >= lay.E
    # every path rank within its width; the static tables under 8 bytes a
    # node and 4 a pixel
    ptab = st.tables["ptab"]
    assert int(ptab.max()) == st.path_values - 1 < 2**st.pb and int(ptab.min()) == 0
    assert st.path_bytes == 4 * (li.nn + ptab.numel()) < 8 * li.nn + 4 * li.n
    return st, lay


@pytest.mark.parametrize("dims", [(1024, 1024), (3600, 1800)])
def test_2d_key_widths_hold_at_the_main_path_sizes(dims):
    li = tsl2.lis2_index(dims, "cpu")
    st, lay = _widths_hold(li, li.nn)
    R = li.nn * li.max_ch
    assert lay.T == min(R, li.nn) + 1 + 2 * li.G + R + li.xf
    # one key per sort: at 1024^2 the two sorts take 12 digit passes, two
    # histograms with them (the walk call's radix launches, at most 14)
    passes = len(kernels.radix_shifts(lay.ins_bits)) + len(kernels.radix_shifts(lay.walk_bits))
    assert passes + 2 <= (14 if dims == (1024, 1024) else 16)


@pytest.mark.parametrize("dims", [(256, 256, 100), (256, 244, 100), (118, 128, 97)])
def test_table_key_widths_hold_at_the_main_path_sizes(dims):
    li = tsl.lis_index(dims, "cpu")
    st, lay = _widths_hold(li, li.nn)
    assert lay.T == tsl.lis_item_count(li, li.nn)
    passes = len(kernels.radix_shifts(lay.ins_bits)) + len(kernels.radix_shifts(lay.walk_bits))
    assert passes + 2 <= 15  # the walk call's radix launches


def _path_values(li):
    """Every path value an item of the walk carries, as (path word tuples
    [m, W], their path ranks [m]): each node's, each node's max_ch child
    slots' (padding slots included), and the zero path (rank 0)."""
    st = tsl.table_static(li)
    pw = li.pw.numpy().astype(np.int64)
    depth = li.depth.numpy().astype(np.int64)
    pidx, ptab = _np(st.tables["pidx"]), _np(st.tables["ptab"]).reshape(-1, li.max_ch + 1)
    vals, ranks = [pw], [ptab[pidx, 0]]
    for k in range(li.max_ch):
        c = pw.copy()
        for x in range(pw.shape[1]):
            c[:, x] += np.where(depth // 6 == x, (k + 1) << (5 * (5 - depth % 6)), 0)
        vals.append(c)
        ranks.append(ptab[pidx, 1 + k])
    vals.append(np.zeros((1, pw.shape[1]), np.int64))
    ranks.append(np.zeros(1, np.int64))
    return np.concatenate(vals), np.concatenate(ranks)


@pytest.mark.parametrize("dims", [(24, 24, 16), (23, 15, 13), (64, 64, 25), (20, 20, 20), (118, 128, 97),
                                  (33, 57), (64, 48), (128, 41), (200, 150)])
def test_path_ranks_order_and_tie_as_the_path_words(dims):
    """The static path ranks order every path value as its path words do
    and give equal values equal ranks, dense from 0: each node, each child
    slot below max_ch (padding included) and the zero path, on forests of
    several roots (the 3D shapes' 8-18 roots share the zero path, the 2D
    walk root and group heads too)."""
    li = tsl2.lis2_index(dims, "cpu") if len(dims) == 2 else tsl.lis_index(dims, "cpu")
    vals, ranks = _path_values(li)
    order = np.lexsort(vals.T[::-1])
    v, r = vals[order], ranks[order]
    new = np.r_[True, (v[1:] != v[:-1]).any(axis=1)]
    np.testing.assert_array_equal(r, np.cumsum(new) - 1)  # ascending with the words, equal for equal
    st = tsl.table_static(li)
    assert st.path_values == int(new.sum()) and st.pb == (st.path_values - 1).bit_length()
    assert (li.pw.numpy() == 0).all(axis=1).sum() >= (3 if len(dims) == 2 else 8)  # roots on the zero path


def _smooth(shape, seed):
    """A smooth field: 24 random separable sine modes and a little noise
    (the recipe of chip_smoke.py's Turbulence1024-like fields)."""
    rng = np.random.default_rng(seed)
    f = np.zeros(shape, np.float32)
    for _ in range(24):
        term = np.float32(rng.normal(scale=0.4))
        for ax, n in enumerate(shape):
            t = np.linspace(0.0, 1.0, n, dtype=np.float32)
            fr, ph = rng.uniform(0.5, 8.0), rng.uniform(0, 2 * np.pi)
            term = term * np.sin(2 * np.pi * fr * t + ph).reshape([-1 if a == ax else 1 for a in range(len(shape))])
        f += term
    return f + rng.normal(scale=0.001, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1024, 1024), (100, 256, 256)])
def test_hop_word_ranks_keep_every_bitmap_small(shape):
    """At the smoke's 1024^2 field and Hurricane packet chunk shapes, on a
    smooth field's node passes, each rank level's keys (its hop-word rank
    times D, plus the low field) span at most 2^26 bits, so every level ranks
    on a bitmap of 8 MB or less and none overflows to its sorted route; the
    ranks equal the plain anchors stage's."""
    from sperr_tpu_torch.ops import cdf97
    from sperr_tpu_torch.parallel import batched as tb

    x = torch.from_numpy(_smooth(shape, 3)[None])
    two_d = len(shape) == 2
    fwd, inv = (cdf97.dwt2d, cdf97.idwt2d) if two_d else (cdf97.dwt3d, cdf97.idwt3d_)
    mags = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", fwd, inv)["mags"][0].reshape(-1).contiguous()
    if two_d:
        ny, nx = shape
        nb, _, _, nm = tspk.schedule_table(mags, tspk.tree_index((nx, ny), "cpu"))
        pm = tsv.msbp1_device(mags)
        li = tsl2.lis2_index((nx, ny), "cpu")
        iset = tsl2.iset_significance_device(pm.reshape(ny, nx), jsw.build_tree2((nx, ny)), nb)
    else:
        li, si = tb._wave_index(shape[::-1], "cpu")
        nb, _, _, nm = tb._schedule(mags, si)
        iset = None
    node_s = tspk.node_passes(nm, nb)
    info = {}
    J, R, _, _, _ = _emulate_ranks(li, _np(node_s), None if iset is None else _np(iset), info=info)
    assert {r for r, _ in info.values()} == {"bitmap"}
    assert max(g for _, g in info.values()) * 256 <= 2**26
    Jr, Rr, _, _ = tsl.table_anchors_ref(node_s, li, iset)
    np.testing.assert_array_equal(R, Rr.numpy())
    np.testing.assert_array_equal(J, Jr.numpy())


# ---------------------------------------------------------------------------
# the kernels' structure and constants, and dispatch
# ---------------------------------------------------------------------------
def _source(name):
    return open(os.path.join(os.path.dirname(kernels.__file__), name)).read()


def test_table_args_fields_match_the_source():
    src = _source("walk_table.cu")
    body = src[src.index("struct TableArgs {"):src.index("};", src.index("struct TableArgs {"))]
    names = []
    for line in body.splitlines()[1:]:
        line = line.split("//")[0].strip()
        if not line:
            continue
        decl = line.rstrip(";")
        for part in decl.split(","):
            m = re.search(r"(\w+)(\[\w+\])?\s*$", part.strip())
            names.append(m.group(1))
    assert names == [f[0] for f in kernels.TableArgs._fields_]
    consts = dict((k, v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kMaxLevels"]) - 2 == kernels.TABLE_MAX_LEVELS
    assert int(consts["kMaxChildren"]) == kernels.TABLE_MAX_CHILDREN
    sched = dict(re.findall(r"constexpr int (\w+) = (\d+);", _source("schedule.cu")))
    assert int(sched["kMaxIset"]) == kernels.ISET_MAX_LEVELS
    rank = _source("rank.cuh")
    rc = dict((k, v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", rank))
    assert int(rc["kUWords"]) == kernels.RANK_U_WORDS and int(rc["kULay"]) == kernels.RANK_ULAY
    assert "kStInts = %d" % kernels.RANK_STATE in rank
    import ctypes
    assert ctypes.sizeof(kernels.TableArgs) == 8 * len(names)


def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)
    names = ("table_anchors", "table_walk", "sched_table", "node_passes", "radix_sort", "emit_stage")
    before = {k: kernels.launches[k] for k in names}
    li, node_s, s, sgn, nb = _inputs3((24, 24, 16), 0, 0.3)
    tsl.lis_segments_device(node_s, s, sgn, nb, li, 34, li.nn, return_events="items")
    li2, node_s2, s2, sgn2, nb2, iset_s, pm = _inputs2(33, 57, 0, 0.3)
    pay, n_sig = tsl2.lis2_segments_device(node_s2, s2, sgn2, nb2, iset_s, li2, 34, li2.nn, 10**5, 10**5,
                                           return_events="items")
    twp.wave_emit_2d_lis(pay, n_sig, nb2, 34, 10**5, 10**5)
    tsl2.iset_significance_device(pm.reshape(57, 33), jsw.build_tree2((33, 57)), nb2)
    tspk.schedule_table(pm, tspk.tree_index((33, 57), "cpu"), iset_regions=jsw.build_tree2((33, 57)).iset_regions)
    assert {k: kernels.launches[k] for k in names} == before


def test_meta_and_cuda_less_calls_raise():
    li = tsl2.lis2_index((33, 57), "cpu")
    meta = torch.zeros(li.nn, dtype=torch.int32, device="meta")
    for call in (lambda: tspk.node_passes(meta, meta[0]),
                 lambda: tsl2.iset_significance_device(meta.reshape(-1, 1), jsw.build_tree2((33, 57)), 0),
                 lambda: tsl2.lis2_segments_device(meta, meta, meta, 0, meta, li, 34, li.nn, 1, 1,
                                                   return_events="items")):
        with pytest.raises(ValueError):
            call()
    cpu = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.node_passes(cpu, cpu[:1])
    with pytest.raises(ValueError):
        kernels.sched_table(cpu, cpu, cpu[:2], cpu, tspk.tree_index((8, 8), "cpu").plan, (8, 8),
                            regions=[(0, 0), (4, 4)])
    with pytest.raises(ValueError):
        kernels.table_anchors(kernels.TableArgs(), "cpu", cpu, np.zeros(0, np.int32),
                              kernels.table_rank_layout(np.zeros(0, np.int32), 0))
    with pytest.raises((ValueError, RuntimeError)):
        kernels.table_stage("rows", kernels.TableArgs(), "cpu")
    with pytest.raises(ValueError):
        kernels.table_stage("nowhere", kernels.TableArgs(), "cpu")
    with pytest.raises(ValueError):  # a CPU tensor is not the card's
        tsl._table_items_cuda(li.level, cpu, cpu.bool(), li, li.nn, cpu, cpu[0])


def test_walk_buffer_cache_keeps_one_per_cap_and_device():
    """The walk's buffer cache (``speck_lis._cached``, keyed by node cap,
    cap_bits and device): calls from two short-lived threads on one stream
    leave one cached buffer; a concurrent second user makes its own and one
    of the two stays; a call on another stream makes a new one and leaves
    one, held for that stream; a call that raises leaves none."""
    import threading

    cache, made, key = {}, [], (5, kernels.RANK_CAP_BITS, 0)

    def make():
        made.append(object())
        return made[-1]

    def use(stream):
        with tsl._cached(cache, key, stream, make) as item:
            return item

    got = []
    for _ in range(2):
        t = threading.Thread(target=lambda: got.append(use(7)))
        t.start()
        t.join()
    assert len(made) == 1 and got == [made[0], made[0]] and cache == {key: (7, made[0])}
    with tsl._cached(cache, key, 7, make) as first, tsl._cached(cache, key, 7, make) as second:
        assert first is made[0] and second is made[1]
    assert len(cache) == 1 and cache[key][0] == 7
    assert use(8) is made[2] and cache == {key: (8, made[2])}
    with pytest.raises(RuntimeError):
        with tsl._cached(cache, key, 8, make):
            raise RuntimeError("a refused launch")
    assert cache == {}


def test_launch_names_are_registered():
    for name in ("table_anchors", "table_walk", "sched_table", "node_passes"):
        assert name in kernels.launches
    assert "iset_max" not in kernels.launches  # the I-set passes are the schedule's pixel pass
    assert any(src.endswith("walk_table.cu") for src in kernels.SOURCES)
    assert any(h.endswith("rank.cuh") for h in kernels.HEADERS)
    kernels.reset_launch_counts()
    assert all(v == 0 for v in kernels.launches.values())
