"""The port's schedule, forest and set walk (sperr_tpu_torch/ops/
speck_virtual.py, speck_lis.py) against sperr_tpu/ops/speck_virtual.py and
speck_lis_jax.py on the same integer inputs, on the CPU: the index constants,
(s, e, nm), the anchors and the walk-ordered payload words, bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import speck_jax as sj
from sperr_tpu.ops import speck_lis_jax as jsl
from sperr_tpu.ops import speck_virtual as jsv
from sperr_tpu_torch.ops import speck_lis as tsl
from sperr_tpu_torch.ops import speck_virtual as tsv

_NEVER = 0x7FFF
# payload words of the padding items (a parent slot past the significant
# ones, an unused born entry); they emit no bit, and ties among them may
# fall in any order in either package
_NOOP_PAYLOADS = (126, 1 | (63 << 1) | (63 << 7))


def _mags(n, seed, density=0.4, hi=1 << 15):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, size=n) * (rng.random(n) < density)).astype(np.uint32)


def _indexes(N):
    return jsv.virtual_lis_index((N, N, N)), tsv.virtual_lis_index((N, N, N), "cpu")


def test_pow2_cube_predicate():
    for d in ((16, 16, 16), (256, 256, 256), (16, 16, 8), (96, 96, 96), (128, 128, 41), (2, 2, 2)):
        assert tsv._is_pow2_cube(d) == jsv._is_pow2_cube(d)
    with pytest.raises(ValueError):
        tsv.VirtualLisIndex((16, 16, 8), "cpu")


@pytest.mark.parametrize("N", [16, 32, 256])
def test_index_constants_equal_jax(N):
    vj, vt = _indexes(N)
    for name in ("dims", "K", "n", "nn", "nn_inner", "nroots", "depth_max", "nlev", "nt",
                 "h_slog_starts"):
        assert getattr(vt, name) == getattr(vj, name), name
    for name in ("h_slog", "h_org", "h_depth_base", "h_r0", "h_A8"):
        np.testing.assert_array_equal(getattr(vt, name), getattr(vj, name))
    for name in ("r_slog", "r_org", "r_level", "depth_base", "r0", "root_ids", "root_levels",
                 "root_from", "off0", "O0_head", "A8"):
        np.testing.assert_array_equal(getattr(vt, name).numpy(), np.asarray(getattr(vj, name)), name)
    np.testing.assert_array_equal(vt.O0_full().numpy(), np.asarray(vj.O0_full()))
    assert tsv.virtual_lis_index((N, N, N), "cpu") is vt


@pytest.mark.parametrize("N", [16, 32])
def test_id_arithmetic_equal_jax(N):
    vj, vt = _indexes(N)
    ids = np.arange(vj.nn, dtype=np.int32)
    jt, tt = jnp.asarray(ids), torch.from_numpy(ids)
    for a, b in zip(vt.decode(tt), vj.decode(jt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for fn in ("parents_of", "levels_of"):
        np.testing.assert_array_equal(getattr(vt, fn)(tt).numpy(), np.asarray(getattr(vj, fn)(jt)))
    for fn in ("paths_of", "sort_paths_of"):
        for a, b in zip(getattr(vt, fn)(tt), getattr(vj, fn)(jt)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    r = np.arange(vj.nroots, dtype=np.int32)
    for a, b in zip(vt.org_of_roots(torch.from_numpy(r)), vj.org_of_roots(jnp.asarray(r))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(N)
    q = rng.integers(0, vj.nn, 300).astype(np.int32)
    valid = rng.random(300) < 0.8
    slot = np.arange(8, dtype=np.int32)
    ours = vt.children(torch.from_numpy(q), torch.from_numpy(valid), torch.from_numpy(slot))
    theirs = vj.children(jnp.asarray(q), jnp.asarray(valid), jnp.asarray(slot))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rs = np.tile(slot, 300)
    qq = np.repeat(q, 8)
    for fn in ("child_paths", "sort_child_paths"):
        for a, b in zip(getattr(vt, fn)(torch.from_numpy(qq), torch.from_numpy(rs)),
                        getattr(vj, fn)(jnp.asarray(qq), jnp.asarray(rs))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# the JAX side runs jitted, one compile per shape shared by all cases (its
# op-by-op dispatch compiles every primitive and is ~10x slower here)
@functools.lru_cache(maxsize=None)
def _jax_schedule(N):
    vj = jsv.virtual_lis_index((N, N, N))

    def run(mags):
        pm = sj.msbp1_device(mags)
        nb = jnp.max(pm)
        s, e, nm = jsv.pixel_schedule_virtual(mags, vj, nb)
        node_s = jnp.where(nm > 0, nb - nm, _NEVER).astype(jnp.int32)
        return pm, nb, (s, e, nm), node_s, jsv.dense_anchor_ranks(node_s, vj)

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _jax_walk(N, cap):
    vj = jsv.virtual_lis_index((N, N, N))
    return jax.jit(
        lambda node_s, s, sgn, nb: jsl.lis_segments_device(
            node_s, s, sgn, nb, vj, 34, cap, 0, 0, return_events="items"
        )
    )


def _schedules(N, mags):
    vj, vt = _indexes(N)
    pmj, nbj, sch_j, node_sj, anchors_j = _jax_schedule(N)(jnp.asarray(mags))
    mt = torch.from_numpy(mags.astype(np.int32))
    pmt = tsv.msbp1_device(mt)
    nbt = pmt.max()
    np.testing.assert_array_equal(pmt.numpy(), np.asarray(pmj))
    sch_t = tsv.pixel_schedule_virtual(mt, vt, nbt)
    return (vj, nbj, sch_j, node_sj, anchors_j), (vt, nbt, sch_t)


@pytest.mark.parametrize("N,seed,density", [(16, 0, 0.4), (32, 1, 0.7), (32, 2, 0.05), (32, 4, 0.3)])
def test_schedule_and_anchor_ranks_equal_jax(N, seed, density):
    mags = _mags(N**3, seed, density)
    (vj, nbj, sch_j, node_sj, anchors_j), (vt, nbt, sch_t) = _schedules(N, mags)
    for a, b in zip(sch_t, sch_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    nm_t = sch_t[2]
    node_st = torch.where(nm_t > 0, nbt - nm_t, _NEVER).to(torch.int32)
    np.testing.assert_array_equal(node_st.numpy(), np.asarray(node_sj))
    for a, b in zip(tsv.dense_anchor_ranks(node_st, vt), anchors_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _walks(N, mags, sgn, node_cap=None):
    (vj, nbj, (sj_, _, _), node_sj, _), (vt, nbt, (st_, _, nm_t)) = _schedules(N, mags)
    node_st = torch.where(nm_t > 0, nbt - nm_t, _NEVER).to(torch.int32)
    cap = vj.nn if node_cap is None else node_cap
    pj, nsj = _jax_walk(N, cap)(node_sj, sj_, jnp.asarray(sgn), nbj)
    pt, nst = tsl.lis_segments_device(node_st, st_, torch.from_numpy(sgn), nbt, vt, 34, cap,
                                      return_events="items")
    assert int(nst) == int(nsj)
    pj, pt = np.asarray(pj), pt.numpy()
    assert pt.shape == pj.shape == (tsl.lis_item_count(vt, cap),)
    return pj, pt


def _assert_items_equal(pj, pt):
    # the padding items' order among themselves is not fixed (the JAX sorts
    # are unstable); every other item sits at the same place
    for p in _NOOP_PAYLOADS:
        assert (pj == p).sum() == (pt == p).sum()
    keep = ~np.isin(pj, _NOOP_PAYLOADS)
    np.testing.assert_array_equal(pt[~np.isin(pt, _NOOP_PAYLOADS)], pj[keep])


@pytest.mark.parametrize(
    "N,seed,density,cap_frac",
    [(16, 0, 0.4, 1.0), (32, 1, 0.7, 1.0), (32, 2, 0.05, 1.0), (32, 3, 0.3, 0.05),
     (32, 5, 0.6, 0.05)],
)
def test_walk_items_equal_jax(N, seed, density, cap_frac):
    n = N**3
    mags = _mags(n, seed, density)
    sgn = np.random.default_rng(seed + 100).random(n) < 0.5
    nn = tsv.virtual_lis_index((N, N, N), "cpu").nn
    cap = nn if cap_frac >= 1.0 else max(64, int(nn * cap_frac))
    _assert_items_equal(*_walks(N, mags, sgn, cap))


@pytest.mark.parametrize("fill", ["zeros", "single", "ones"])
def test_walk_degenerate_fields(fill):
    N = 32
    mags = np.zeros(N**3, np.uint32)
    if fill == "single":
        mags[12345] = 7
    elif fill == "ones":
        mags[:] = 1
    _assert_items_equal(*_walks(N, mags, np.ones(N**3, bool)))


def test_lexsort_is_a_stable_multikey_sort():
    rng = np.random.default_rng(1)
    keys = [rng.integers(0, 4, 500) for _ in range(3)]
    perm = tsl.lexsort([torch.from_numpy(k) for k in keys]).numpy()
    np.testing.assert_array_equal(perm, np.lexsort(keys[::-1]))


@functools.lru_cache(maxsize=None)
def _jax_event_walk(N, cap, ev_cap, cap_total, form):
    vj = jsv.virtual_lis_index((N, N, N))
    return jax.jit(
        lambda node_s, s, sgn, nb: jsl.lis_segments_device(
            node_s, s, sgn, nb, vj, 34, cap, ev_cap, cap_total, return_events=form
        )
    )


# the event tail after the virtual walk: events (True) and packed segments
# (False), array for array; a small ev_cap or cap_total overflows and forces
# n_sig to _BIG in both packages
@pytest.mark.parametrize("form", [True, False])
@pytest.mark.parametrize("seed,density,ev_cap,cap_total", [
    (7, 0.4, 1 << 16, 1 << 13), (8, 0.05, 1 << 14, 1 << 12), (9, 0.4, 64, 1 << 13),
    (10, 0.4, 1 << 16, 16),
])
def test_walk_event_tail_equals_jax(form, seed, density, ev_cap, cap_total):
    N = 16
    n = N**3
    mags = _mags(n, seed, density)
    sgn = np.random.default_rng(seed + 100).random(n) < 0.5
    (vj, nbj, (sj_, _, _), node_sj, _), (vt, nbt, (st_, _, nm_t)) = _schedules(N, mags)
    node_st = torch.where(nm_t > 0, nbt - nm_t, _NEVER).to(torch.int32)
    got = tsl.lis_segments_device(node_st, st_, torch.from_numpy(sgn), nbt, vt, 34, vt.nn, ev_cap,
                                  cap_total, return_events=form)
    want = _jax_event_walk(N, vj.nn, ev_cap, cap_total, form)(node_sj, sj_, jnp.asarray(sgn), nbj)
    assert len(got) == len(want) == (3 if form else 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    overflow = int(want[-1]) == tsl._BIG
    assert overflow == (ev_cap == 64 or (not form and cap_total == 16))
    if not form and not overflow:
        # the packed bytes are the items form's bits: the sum of the
        # per-pass byte counts
        assert int(got[2]) == int(((got[1] + 7) // 8).sum())
