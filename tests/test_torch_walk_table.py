"""The table and 2D walks' kernels (kernels/walk_table.cu: K15's and K14's
walks, the I-set maxima and the node passes) on the CPU, where the card is
absent: a numpy emulation of the kernels' arithmetic (the anchors' chain
walk and hop words, the per-level ranks of rank.cuh, the rows, the entries'
insertion keys, the walk ranks by arithmetic, the walk keys and both sorts
as stable sorts over the packed keys) against the plain versions and
sperr_tpu, bit for bit; the 2D items through the plain K9b and K11 against
sperr_tpu's event form, caps included; TorchCompressor2D(entropy="wave")'s
streams and tiers; the I-set maxima; the static key widths at the main
path's sizes; the kernels' C structure and constants against their
mirrors; and dispatch.  Every result is an integer and compared exactly."""

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
    nb, pm, s, _, nm = tspk.schedule_table(mt, tspk.tree_index((nx, ny), "cpu"))
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


def _emulate(li, node_s_t, s_t, sgn_t, cap, iset_t=None, nb_t=None, bitmap_bits=kernels.RANK_BITMAP_BITS):
    """The walk as kernels/walk_table.cu computes it, launch by launch
    (the rank levels whose keys are wider than ``bitmap_bits`` sorted)."""
    st = tsl.table_static(li)
    lay = tsl.table_layout(li, cap)
    form = st.form
    T = {k: _np(v) for k, v in st.tables.items()}
    parent, level, depth, pw = T["parent"], T["level"], T["depth"], T["pw"].reshape(li.nn, -1)
    W = pw.shape[1]
    nn, n, MC, nlev = li.nn, li.n, lay.MC, li.nlev
    node_s, s_lin, sgn = _np(node_s_t), _np(s_t), _np(sgn_t)
    xf = li.xf if form else 0
    iset = _np(iset_t) if form else None
    nbp = int(nb_t) if form else 0

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
    # -- rank.cuh: each ranked level's dense ranks, coarse levels first (the
    # bitmaps' ranks are the dense ranks of np.unique)
    R = np.zeros(nn, np.int64)
    rows = st.plan.host.reshape(-1, kernels.RANK_LEVEL_INTS)
    nbitmap = kernels.rank_layout(st.plan.host, st.plan.nsmall, bitmap_bits).nbitmap
    ranked = np.zeros(nn, bool)
    for lvl, row in enumerate(rows):
        cnt, wk, ns = (int(x) for x in row[:3])
        ids = np.concatenate([np.arange(row[3 + k], row[3 + kernels.RANK_SPANS + k]) for k in range(ns)])
        assert ids.size == cnt and (level[ids] == level[ids[0]]).all()
        assert ranked[jp[ids][jp[ids] >= 0]].all()  # the next strings are ranked first
        low = np.where(jp[ids] < 0, -1 - jp[ids], R[np.maximum(jp[ids], 0)] + 1)
        assert low.max(initial=0) < 2**wk
        key = (u[ids] << wk) | low
        _check_width(key, 12 + wk)
        R[ids] = (np.unique(key, return_inverse=True)[1].reshape(-1) if lvl < nbitmap
                  else _sorted_ranks(key, 12 + wk))
        ranked[ids] = True
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
    key0 = (lba << st.wa) | arank
    pws = [pw[bidc, w] >> st.pwz[w] for w in range(W)]
    if lay.ipack:
        key0 = (key0 << lay.ipack) | pws[0]
    counts = np.bincount(lev[e_ok], minlength=nlev + 1)
    perm = _stable_order([key0] + [pws[w] for w in lay.ins_words], lay.ins_bits)
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
    wk0 = np.zeros(lay.T, np.int64)
    wpw = [np.zeros(lay.T, np.int64) for _ in range(W)]

    def put(idx, wr, paths):
        wk0[idx] = (wr << lay.wpack) | (paths[0] >> st.pwz[0]) if lay.wpack else wr
        for x in range(W):
            wpw[x][idx] = paths[x] >> st.pwz[x]

    put(slice(0, lay.NE), w, [pw[bidc, x] for x in range(W)])
    if form == 0:
        r = np.arange(li.nroots)
        rid = T["root_ids"]
        wr = suffix[T["root_levels"]] + T["O0"][rid]
        wbuf[rid] = wr
        pay[lay.NE: lay.E] = 1 | (np.clip(node_s[rid], 0, 63) << 7) | (1 << 17)
        put(slice(lay.NE, lay.E), wr, [np.zeros(r.size, np.int64)] * W)
    # -- table_rowkeys: the rows' walk keys, the 2D I items
    anc = np.where(ok, J[q], q)
    wr = np.minimum(wbuf[anc], lay.tcap)
    if form:
        crit = ok & (T["is_group"][anc] == 1) & (kpass(T["k_of"][anc]) == node_s[anc])
        wr = np.where(crit, lay.wbase + T["block_rank_of"][anc], wr)
    dq = depth[q]
    cp = [pw[q, x][:, None] + np.where((dq // 6 == x)[:, None], (k + 1)[None, :] << (5 * (5 - dq % 6))[:, None], 0)
          for x in range(W)]
    put(slice(lay.E, lay.E + lay.R), np.repeat(wr, MC), [a.reshape(-1) for a in cp])
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
        put(slice(o, o + xf), lay.wbase + 8 * (xf - kj), [np.zeros(xf, np.int64)] * W)
        gbn = kpass(gk)
        pay[o + xf: o + xf + G] = (np.clip(gbn, 0, 63) << 1) | (gsig << 14) | ((gbn < nbp) << 16)
        put(slice(o + xf, o + xf + G), lay.wbase + T["gbit_rank"][:G], [np.zeros(G, np.int64)] * W)
    perm = _stable_order([wk0] + [wpw[x] for x in lay.walk_words], lay.walk_bits)
    for x in range(W):  # a path word with no key is 0 everywhere
        if x not in lay.walk_words and not (x == 0 and lay.wpack):
            assert not wpw[x].any()
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


@pytest.mark.parametrize("case", ["table", "pyramid", "2d", "2d one", "2d dense"])
def test_sorted_rank_levels_give_the_plain_walk(case):
    """The rank levels through rank.cuh's sorted route (here every level
    past 16 key bits, as bitmap_bits = 16 makes it on the card; by default
    the levels past 32 bits, from about 3600 x 7200 on) give the bitmaps'
    ranks and the plain walk's payload words bit for bit."""
    if case in ("table", "pyramid"):
        li, node_s, s, sgn, nb = _inputs3((24, 24, 16) if case == "table" else (23, 15, 13), 5, 0.3)
        iset_s = None
        want = tsl._lis_items_table_ref(node_s, s, sgn, nb, li, li.nn)
    else:
        nx, ny, density = {"2d": (64, 48, 0.3), "2d one": (33, 57, "one"), "2d dense": (128, 41, 0.9)}[case]
        li, node_s, s, sgn, nb, iset_s, _ = _inputs2(nx, ny, 6, density)
        want = tsl2._lis2_items_ref(node_s, s, sgn, nb, iset_s, li, li.nn)
    st = tsl.table_static(li)
    lay = kernels.rank_layout(st.plan.host, st.plan.nsmall, 16)
    assert lay.nbitmap < len(st.plan.counts)  # the route is taken
    pay, n_sig, J, R = _emulate(li, node_s, s, sgn, li.nn, iset_s, nb, bitmap_bits=16)
    _, _, J0, R0 = _emulate(li, node_s, s, sgn, li.nn, iset_s, nb)
    np.testing.assert_array_equal(R, R0)
    np.testing.assert_array_equal(J, J0)
    np.testing.assert_array_equal(pay, want[0].numpy())
    assert n_sig == int(want[1])


@pytest.mark.parametrize("dims", [(4096, 4096), (7200, 3600), (256, 256, 200)])
def test_rank_plan_takes_fields_past_the_main_path_sizes(dims):
    """The walks take fields and chunks wider than the main path's: every
    key of the walk within its width (``_widths_hold``), and each rank level
    on a route that takes it: the bitmaps up to 32 key bits, the sorted
    route past them (at 3600 x 7200 the finest level's 33 bits)."""
    # built apart from the index cache, so the worker does not keep it
    li = tsl2.Lis2Index(dims, "cpu") if len(dims) == 2 else tsl.LisIndex(dims, "cpu")
    st, lay = _widths_hold(li, li.nn)
    rl = kernels.rank_layout(st.plan.host, st.plan.nsmall)
    assert all(b <= kernels.RANK_BITMAP_BITS for b in rl.bits[: rl.nbitmap])
    assert all(kernels.RANK_BITMAP_BITS < b <= 43 for b in rl.bits[rl.nbitmap:])
    assert rl.nbitmap == len(rl.bits) - (dims == (7200, 3600))
    assert lay.T < 2**31


def test_breakdown_of_a_table_chunk_runs_on_the_cpu():
    from sperr_tpu_torch.runtime import device_bench as tdb
    r = tdb.wave_entropy_breakdown(16, iters=1, device="cpu", dims=(16, 12, 10))
    assert r["dims"] == (16, 12, 10) and r["full_pack_cum_s"] > 0 and set(r["timed"].values()) == {"cpu"}


# ---------------------------------------------------------------------------
# the 2D LIS bits through K9b and K11 (plain versions)
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
    the K9b and K11 route)."""
    ti, li2, tree2 = index
    nx, ny = tree2.dims
    num_bp, pm, s, e, nm = tspk.schedule_table(mags, ti)
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
    # the kernel's arithmetic: a pixel counts for level k when it is past the
    # corner (y >= ay_k or x >= ax_k); the maxima, then num_bp - max or NEVER
    pmn = pm.numpy().reshape(ny, nx).astype(np.int64)
    yy, xx = np.mgrid[0:ny, 0:nx]
    emu = [_NEVER]
    for k in range(1, tree.xf + 1):
        ax, ay = tree.iset_regions[k]
        m = int(np.where((yy >= ay) | (xx >= ax), pmn, 0).max())
        emu.append(int(nb) - m if m > 0 else _NEVER)
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
    rl = kernels.rank_layout(st.plan.host, st.plan.nsmall)  # every level on a route that takes it
    assert rl.bits == tuple(12 + w for w in st.plan.wks)
    assert sum(st.plan.counts) <= li.nn and max(st.plan.counts) < 2**st.wa
    assert st.lba_bits == ((li.nlev << (12 if st.form else 11))).bit_length() and li.nlev <= 30
    # the largest insertion and walk keys
    top_ins = ((((li.nlev << (12 if st.form else 11)) << st.wa) | (2**st.wa - 1)) << lay.ipack)
    assert top_ins < 2**lay.ins_bits[0] <= 2**63
    assert (lay.tcap << lay.wpack) < 2**lay.walk_bits[0] <= 2**63
    assert lay.tcap >= lay.E and lay.wpack == st.pwb[0]
    # every path word, of a node or a child row, within its shifted width
    pw = li.pw.numpy().astype(np.int64)
    depth = li.depth.numpy().astype(np.int64)
    cnt = li.ch_count.numpy().astype(np.int64)
    for w in range(pw.shape[1]):
        vals = [pw[:, w]]
        for kk in range(int(cnt.max())):
            d = depth[cnt > kk]
            vals.append(pw[cnt > kk, w] + np.where(d // 6 == w, (kk + 1) << (5 * (5 - d % 6)), 0))
        v = np.concatenate(vals)
        assert (v & ((1 << st.pwz[w]) - 1) == 0).all()
        _check_width(v >> st.pwz[w], st.pwb[w])
    return st, lay


@pytest.mark.parametrize("dims", [(1024, 1024), (3600, 1800)])
def test_2d_key_widths_hold_at_the_main_path_sizes(dims):
    li = tsl2.lis2_index(dims, "cpu")
    st, lay = _widths_hold(li, li.nn)
    R = li.nn * li.max_ch
    assert lay.T == min(R, li.nn) + 1 + 2 * li.G + R + li.xf
    # the walk key packs path word 0; the rank bitmaps stay within 2^31 bits
    assert lay.wpack and max(12 + w for w in st.plan.wks) <= 31


@pytest.mark.parametrize("dims", [(256, 256, 100), (256, 244, 100), (118, 128, 97)])
def test_table_key_widths_hold_at_the_main_path_sizes(dims):
    li = tsl.lis_index(dims, "cpu")
    st, lay = _widths_hold(li, li.nn)
    assert lay.T == tsl.lis_item_count(li, li.nn)
    assert lay.ipack and lay.wpack  # both first keys hold path word 0


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
    assert int(consts["kMaxPathWords"]) == kernels.TABLE_PATH_WORDS
    assert int(consts["kMaxIset"]) == kernels.ISET_MAX_LEVELS
    import ctypes
    assert ctypes.sizeof(kernels.TableArgs) == 8 * (len(names) + 3 * 3)


def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)
    names = ("table_anchors", "table_walk", "iset_max", "node_passes", "radix_sort", "emit_planes")
    before = {k: kernels.launches[k] for k in names}
    li, node_s, s, sgn, nb = _inputs3((24, 24, 16), 0, 0.3)
    tsl.lis_segments_device(node_s, s, sgn, nb, li, 34, li.nn, return_events="items")
    li2, node_s2, s2, sgn2, nb2, iset_s, pm = _inputs2(33, 57, 0, 0.3)
    pay, n_sig = tsl2.lis2_segments_device(node_s2, s2, sgn2, nb2, iset_s, li2, 34, li2.nn, 10**5, 10**5,
                                           return_events="items")
    twp.wave_emit_2d_lis(pay, n_sig, nb2, 34, 10**5, 10**5)
    tsl2.iset_significance_device(pm.reshape(57, 33), jsw.build_tree2((33, 57)), nb2)
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
        kernels.iset_max(cpu.reshape(8, 8), [(0, 0), (4, 4)], cpu[:1])
    with pytest.raises(ValueError):
        kernels.table_anchors(kernels.TableArgs(), "cpu", cpu, np.zeros(0, np.int32), 0)
    with pytest.raises((ValueError, RuntimeError)):
        kernels.table_stage("rows", kernels.TableArgs(), "cpu")
    with pytest.raises(ValueError):
        kernels.table_stage("nowhere", kernels.TableArgs(), "cpu")
    with pytest.raises(ValueError):  # a CPU tensor is not the card's
        tsl._table_items_cuda(li.level, cpu, cpu.bool(), li, li.nn, cpu, cpu[0])


def test_launch_names_are_registered():
    for name in ("table_anchors", "table_walk", "iset_max", "node_passes"):
        assert name in kernels.launches
    assert any(src.endswith("walk_table.cu") for src in kernels.SOURCES)
    assert any(h.endswith("rank.cuh") for h in kernels.HEADERS)
    kernels.reset_launch_counts()
    assert all(v == 0 for v in kernels.launches.values())
