"""The device SPECK schedule of the port (sperr_tpu_torch/ops/speck_virtual.py
``schedule_virtual``, ops/speck.py ``schedule_table`` and
``schedule_pyramid``, the kernels of kernels/schedule.cu) against
sperr_tpu's ``msbp1_device``, ``pixel_schedule_virtual``,
``pixel_schedule``, ``pixel_schedule_pyramid`` and, for 2D fields,
``iset_significance_device`` on the same integer inputs, on the CPU (the
kernels' plain versions).  Every comparison is bit for bit: all results
are integers.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 3 holds them
against these plain versions there).  What can be checked here: the static
tables they read (the cube schedule's nm segments, the child tables' int32
rows and subtree plans, the pyramid's int32 copies), numpy emulations of
the cube kernels' index arithmetic (morton slots, the block cubes' pyramid
levels, the segment search) and of the child-table kernels (the subtree
launches' staged rows and slots, the last block's depths above the cut,
the pixel pass with its I-level maxima), and that a CPU tensor never
reaches the kernel library."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.codec import speck_wave as jsw
from sperr_tpu.ops import speck_jax as sj
from sperr_tpu.ops import speck_lis2_jax as jsl2
from sperr_tpu.ops import speck_virtual as jsv
from sperr_tpu_torch import kernels
from sperr_tpu_torch.codec import speck_wave as tsw
from sperr_tpu_torch.ops import speck as tspk
from sperr_tpu_torch.ops import speck_lis2 as tsl2
from sperr_tpu_torch.ops import speck_virtual as tsv

_NEVER = 0x7FFF
_CASES = ["sparse", "dense", "all zero", "single pixel", "2^31 - 1"]
# the dims of tests/test_torch_wave_table.py, and two small 2D fields
_TREE_DIMS = [(24, 24, 16), (32, 32, 16), (64, 64, 25)]
_PYRAMID_DIMS = [(23, 16, 16), (23, 15, 13), (20, 20, 20)]
_DIMS_2D = [(40, 24), (64, 64)]


def _mags(n, case, seed=0):
    rng = np.random.default_rng(seed + n)
    if case == "sparse":
        return (rng.integers(0, 1 << 16, n) * (rng.random(n) < 0.03)).astype(np.int32)
    if case == "dense":
        return rng.integers(1, 1 << 20, n).astype(np.int32)
    m = np.zeros(n, np.int32)
    if case == "single pixel":
        m[n // 3] = 5
    elif case == "2^31 - 1":
        m[:] = rng.integers(0, 1 << 8, n) * (rng.random(n) < 0.2)
        m[n - 1] = 2**31 - 1
    return m


@functools.lru_cache(maxsize=None)
def _jax_virtual(N):
    vj = jsv.virtual_lis_index((N, N, N))

    def run(mags):
        nb = jnp.max(sj.msbp1_device(mags))
        return (nb,) + tuple(jsv.pixel_schedule_virtual(mags, vj, nb))

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _jax_table(dims, form):
    idx = sj.pyramid_index(dims) if form == "pyramid" else sj.tree_index(dims)
    sched = sj.pixel_schedule_pyramid if form == "pyramid" else sj.pixel_schedule

    def run(mags):
        pm = sj.msbp1_device(mags)
        nb = jnp.max(pm)
        return (nb, pm) + tuple(sched(mags, idx, nb))

    return jax.jit(run)


def _equal(got, want, names):
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("N", [2, 4, 16, 32])
def test_schedule_virtual_equals_jax(N, case):
    mags = _mags(N**3, case)
    got = tsv.schedule_virtual(torch.from_numpy(mags), tsv.virtual_lis_index((N, N, N), "cpu"))
    want = _jax_virtual(N)(jnp.asarray(mags))
    assert got[0].shape == ()
    _equal(got, want, ("num_bp", "s", "e", "nm"))
    if case == "all zero":
        assert int(got[0]) == 0 and (got[1] == _NEVER).all() and (got[2] == _NEVER).all()
        assert not got[3].any()
    if case == "2^31 - 1":
        assert int(got[0]) == 31


def _morton_levels(pm: np.ndarray, K: int):
    """The morton max pyramid of the 2x2x2 box maxima, grids 0 .. K-1, from
    the morton order's definition (x lowest, then y, then z)."""
    N, h = 1 << K, 1 << (K - 1)
    box = pm.reshape(h, 2, h, 2, h, 2).max(axis=(1, 3, 5))  # (z, y, x)
    z, y, x = np.meshgrid(np.arange(h), np.arange(h), np.arange(h), indexing="ij")
    mort = np.zeros_like(z)
    for t in range(max(K - 1, 1)):
        mort |= (((x >> t) & 1) << (3 * t)) | (((y >> t) & 1) << (3 * t + 1)) | (((z >> t) & 1) << (3 * t + 2))
    top = np.zeros(h**3, pm.dtype)
    top[mort.reshape(-1)] = box.reshape(-1)
    M = [None] * K
    M[K - 1] = top
    for g in range(K - 2, -1, -1):
        M[g] = M[g + 1].reshape(-1, 8).max(axis=1)
    assert N**3 == pm.size
    return M


@pytest.mark.parametrize("N", [2, 4, 8, 16, 32, 64])
def test_nm_segments_rebuild_nm(N):
    """The cube kernel's segment table, used in a plain table-driven gather,
    rebuilds the node maxima exactly; its rows are in output order and
    cover every node once."""
    vt = tsv.virtual_lis_index((N, N, N), "cpu")
    segs = vt.h_nm_segs
    np.testing.assert_array_equal(vt.nm_segs.numpy(), segs)
    assert segs.dtype == np.int32 and segs.shape[1] == 4 and 1 <= len(segs) <= kernels.SCHED_MAX_SEGS
    np.testing.assert_array_equal(segs[:, 3], np.concatenate([[0], np.cumsum(segs[:, 2] - segs[:, 1])[:-1]]))
    assert int((segs[:, 2] - segs[:, 1]).sum()) == vt.nn
    mags = _mags(N**3, "sparse", seed=N)
    pm = tsv.msbp1_device(torch.from_numpy(mags)).numpy()
    M = _morton_levels(pm, vt.K)
    nm = np.concatenate([M[g][lo:hi] for g, lo, hi, _ in segs])
    np.testing.assert_array_equal(nm, np.asarray(_jax_virtual(N)(jnp.asarray(mags))[3]))


def _emulate_cube_kernels(mags: np.ndarray, vf):
    """kernels/schedule.cu's cube schedule as numpy: launch 1 with its
    block cubes of S^3 boxes (morton slots, the levels each block writes,
    the block maxima), launch 2 with its small-levels block, its per-box
    s and e and its segment search."""

    def spread3(v):
        return sum(((v >> t) & 1) << (3 * t) for t in range(10))

    def morton3(x, y, z):
        return spread3(x) | (spread3(y) << 1) | (spread3(z) << 2)

    def level_off(g):
        return ((1 << (3 * g)) - 1) // 7

    def sched_of(v, nb):
        return nb - v if v > 0 else _NEVER

    K = vf.K
    N, Kh = 1 << K, K - 1
    j = min(Kh, 3)
    bb, S = Kh - j, 1 << j
    pm = np.array([int(v).bit_length() if v > 0 else 0 for v in mags], np.int64)
    M = np.full(level_off(K), -1, np.int64)
    num_bp = 0

    def rows(bx, by, bz):
        return [((2 * bz + (r >> 1)) * N + (2 * by + (r & 1))) * N + 2 * bx for r in range(4)]

    for b in range(1 << (3 * bb)):
        B1 = (1 << bb) - 1
        Bx, By, Bz = b & B1, (b >> bb) & B1, b >> (2 * bb)
        mb = morton3(Bx, By, Bz)
        cell = {}
        for t in range(S**3):
            tx, ty, tz = t & (S - 1), (t >> j) & (S - 1), t >> (2 * j)
            bm = max(max(pm[r], pm[r + 1]) for r in rows((Bx << j) | tx, (By << j) | ty, (Bz << j) | tz))
            ml = morton3(tx, ty, tz)
            M[level_off(Kh) + (mb << (3 * j)) + ml] = cell[ml] = bm
        cnt = S**3
        for lev in range(1, j + 1):
            cnt >>= 3
            for t in range(cnt):
                cell[t] = max(cell[8 * t + k] for k in range(8))
                M[level_off(Kh - lev) + (mb << (3 * (j - lev))) + t] = cell[t]
        num_bp = max(num_bp, cell[0])
    gmin = 0 if K - 1 < 3 else K - 4
    assert (M[level_off(gmin):] >= 0).all() and (M[: level_off(gmin)] < 0).all()
    for g in range(gmin - 1, -1, -1):
        for c in range(1 << (3 * g)):
            M[level_off(g) + c] = max(M[level_off(g + 1) + 8 * c + k] for k in range(8))
    s = np.empty(N**3, np.int64)
    e = np.empty(N**3, np.int64)
    h1 = (1 << Kh) - 1
    for box in range(1 << (3 * Kh)):
        rs = rows(box & h1, (box >> Kh) & h1, box >> (2 * Kh))
        ev = sched_of(max(max(pm[r], pm[r + 1]) for r in rs), num_bp)
        for r in rs:
            s[r], s[r + 1] = sched_of(pm[r], num_bp), sched_of(pm[r + 1], num_bp)
            e[r] = e[r + 1] = ev
    segs = vf.h_nm_segs
    nm = np.empty(vf.nn, np.int64)
    for i in range(vf.nn):
        q = 0
        while q + 1 < len(segs) and segs[q + 1][3] <= i:
            q += 1
        g, lo, _, out = segs[q]
        nm[i] = M[level_off(g) + lo + (i - out)]
    return num_bp, s, e, nm


@pytest.mark.parametrize("N,case", [(2, "dense"), (4, "sparse"), (8, "2^31 - 1"), (16, "sparse"),
                                    (32, "dense")])
def test_cube_kernel_layout_emulated(N, case):
    """The cube kernels' index arithmetic, emulated: equal to the plain
    version.  N = 32 takes the small-levels block (grids below K - 4)."""
    mags = _mags(N**3, case, seed=1)
    vt = tsv.virtual_lis_index((N, N, N), "cpu")
    want = tsv.schedule_virtual(torch.from_numpy(mags), vt)
    for name, a, b in zip(("num_bp", "s", "e", "nm"), _emulate_cube_kernels(mags, vt), want):
        np.testing.assert_array_equal(a, b.numpy(), name)


@pytest.mark.parametrize("dims,form", [(d, "tree") for d in _TREE_DIMS + _DIMS_2D]
                         + [(d, "pyramid") for d in _PYRAMID_DIMS])
@pytest.mark.parametrize("case", ["sparse", "2^31 - 1"])
def test_table_pyramid_2d_equal_jax(dims, form, case):
    n = int(np.prod(dims))
    mags = _mags(n, case, seed=sum(dims))
    mt = torch.from_numpy(mags)
    nbj, pmj, *want = _jax_table(dims, form)(jnp.asarray(mags))
    if form == "pyramid":
        got = tspk.schedule_pyramid(mt, tspk.pyramid_index(dims, "cpu"))
    else:
        nb, *rest = tspk.schedule_table(mt, tspk.tree_index(dims, "cpu"))
        np.testing.assert_array_equal(tsv.msbp1_device(mt).numpy(), np.asarray(pmj), "pm")
        got = (nb, *rest)
    _equal(got, (nbj, *want), ("num_bp", "s", "e", "nm"))
    # a given num_bp, past the largest: every pass shifts
    nb_big = int(nbj) + 3
    idx = tspk.pyramid_index(dims, "cpu") if form == "pyramid" else tspk.tree_index(dims, "cpu")
    fn = tspk.pixel_schedule_pyramid if form == "pyramid" else tspk.pixel_schedule
    jfn = sj.pixel_schedule_pyramid if form == "pyramid" else sj.pixel_schedule
    jidx = sj.pyramid_index(dims) if form == "pyramid" else sj.tree_index(dims)
    _equal(fn(mt, idx, nb_big), jfn(jnp.asarray(mags), jidx, jnp.int32(nb_big)), ("s", "e", "nm"))


@pytest.mark.parametrize("dims", _TREE_DIMS + _DIMS_2D)
def test_table_int32_rows(dims):
    """The child-table kernel's int32 rows describe the same reduction as
    the plain version's per-depth slices."""
    ti = tspk.tree_index(dims, "cpu")
    assert ti.ch_bounds.numel() == ti.nn + 1 and int(ti.ch_bounds[0]) == 0
    np.testing.assert_array_equal(ti.px_parent32.numpy(), ti.px_parent_lin.numpy())
    lo_hi = list(zip(ti.plan.depth_lo[:-1], ti.plan.depth_lo[1:]))[::-1]  # deepest first
    assert [(lo, hi) for *_, lo, hi in ti.depth_slices] == lo_hi
    src = ti.ch_src.numpy()
    bounds = ti.ch_bounds.numpy()
    for ispx, src_px, src_nd, parent_rows, lo, hi in ti.depth_slices:
        rows = src[bounds[lo]:bounds[hi]]
        np.testing.assert_array_equal(rows >= 0, ispx.numpy())
        np.testing.assert_array_equal(np.where(rows >= 0, rows, 0), np.where(ispx.numpy(), src_px.numpy(), 0))
        np.testing.assert_array_equal(np.where(rows < 0, -(rows + 1), 0), np.where(ispx.numpy(), 0, src_nd.numpy()))
        np.testing.assert_array_equal(np.repeat(np.arange(hi - lo), np.diff(bounds[lo:hi + 1])),
                                      parent_rows.numpy())


def _emulate_table_kernels(mags: np.ndarray, ti, regions=None, seed=0):
    """kernels/schedule.cu's child-table schedule as numpy: the subtree
    launch's blocks in a random order, each staging its rows (a pixel
    child's msb+1 read as it is staged, a node child past gfrom from nm,
    the others as their slot + kNodeMark) and its nodes' row starts in
    16-bit slots, then reducing its depths deepest first (a thread per node,
    at most kMaxChildren rows); with two cuts, each group's done counter,
    and the block that ends last among a group's reduces the group; the
    last block to end its units, the depths above the top cut and num_bp;
    the pixel pass in blocks of kPixTile pixels of one row, with the I
    levels' region maxima (the row's test uniform in a block, and the
    column's but in the block that holds the corner's edge).  Returns
    (num_bp, s, e, nm, iset_s or None)."""
    rng = np.random.default_rng(seed)
    mark, tile = kernels.SCHED_NODE_MARK, kernels.SCHED_PIX_TILE
    cuts, depth_lo, nroots, smem, _, _, _, (row, plane) = ti.plan
    src, bounds = ti.ch_src.numpy().astype(np.int64), ti.ch_bounds.numpy().astype(np.int64)
    pmv = np.array([int(v).bit_length() for v in mags], np.int64)
    nm = np.full(ti.nn, -1, np.int64)

    def reduce_depths(nlo, nhi, rlo, rhi, gfrom, leaves=False):
        nb = np.concatenate([[0], np.cumsum(np.subtract(nhi, nlo))])
        rb = np.concatenate([[0], np.cumsum(np.subtract(rhi, rlo))])
        nodes, rows = int(nb[-1]), int(rb[-1])
        staged_nodes, staged_rows = (int(nb[-2]), int(rb[-2])) if leaves else (nodes, rows)
        assert 2 * staged_rows + 2 * (staged_nodes + 1) + nodes <= smem and rows < 1 << 16
        srow = np.empty(rows, np.int64)
        for j in range(len(nlo)):
            c = src[rlo[j]:rhi[j]]
            ids = -(c + 1)
            glob = (c < 0) & (ids >= gfrom)
            own = (c < 0) & ~glob
            if own.any():  # a node child staged here: the next depth's
                assert j + 1 < len(nlo) and (ids[own] >= nlo[j + 1]).all() and (ids[own] < nhi[j + 1]).all()
            assert (nm[ids[glob]] >= 0).all()  # written by a block that ended before
            v = np.where(c >= 0, pmv[np.maximum(c, 0)], np.where(glob, nm[np.maximum(ids, 0)], 0))
            if own.any():
                v[own] = mark + nb[j + 1] + ids[own] - nlo[j + 1]
            srow[rb[j]:rb[j + 1]] = v
        srow_px = np.concatenate([src[rlo[j]:rhi[j]] for j in range(len(nlo))])  # the leaves' rows, checked
        sstart = np.concatenate([rb[j] + bounds[nlo[j]:nhi[j]] - rlo[j] for j in range(len(nlo))] + [[rows]])
        assert (sstart < 1 << 16).all() and (srow < 1 << 16).all()
        assert (np.diff(sstart) <= kernels.SCHED_MAX_CHILDREN).all()
        snm = np.empty(nodes, np.int64)
        for j in range(len(nlo) - 1, -1, -1):
            for L in range(nb[j], nb[j + 1]):
                if leaves and j == len(nlo) - 1:  # a leaf: its box, from the leaf table
                    box = int(ti.leaf_host[nlo[j] - depth_lo[-2] + L - nb[j]])
                    base = box >> 3
                    px = [base + ((k >> 2) & 1) * plane + ((k >> 1) & 1) * row + (k & 1)
                          for k in range(8) if not k & ~box & 7]
                    assert sorted(px) == sorted(srow_px[sstart[L]:sstart[L + 1]].tolist())
                    snm[L] = pmv[px].max()
                    continue
                x = srow[sstart[L]:sstart[L + 1]]
                snm[L] = np.where(x < mark, x, snm[np.maximum(x - mark, 0)]).max()
            nm[nlo[j]:nhi[j]] = snm[nb[j]:nb[j + 1]]
        return snm

    def unit(sub, b, gfrom, leaves=False):
        reduce_depths(sub[0, :, b], sub[0, :, b + 1], sub[1, :, b], sub[1, :, b + 1], gfrom, leaves)

    sub0 = ti.sub_host[0]
    nblk = sub0.shape[2] - 1
    if len(cuts) == 2:
        links = ti.links_host
        ngrp = ti.sub_host[1].shape[2] - 1
        glo, ghi, need = links[:nblk], links[nblk:2 * nblk], links[2 * nblk:]
        assert links.size == 2 * nblk + ngrp and (ghi - glo + 1).max() <= kernels.SCHED_MAX_GROUPS
        cnt = np.zeros(ngrp, np.int64)
    done = 0
    for b in rng.permutation(nblk):
        unit(sub0, b, 1 << 62, True)
        if len(cuts) == 1:
            done += 1
            continue
        for g in range(glo[b], ghi[b] + 1):
            cnt[g] += 1
            if cnt[g] == need[g]:  # this block ends the group's last
                unit(ti.sub_host[1], g, depth_lo[cuts[0]])
                done += 1
    assert done == (nblk if len(cuts) == 1 else ngrp)
    top = cuts[-1]
    if top:
        snm = reduce_depths(depth_lo[:top], depth_lo[1:top + 1], bounds[list(depth_lo[:top])],
                            bounds[list(depth_lo[1:top + 1])], depth_lo[top])
        num_bp = int(snm[:nroots].max())
    else:
        num_bp = int(nm[:nroots].max())
    assert (nm >= 0).all()

    def sched_of(v):
        return np.where(v > 0, num_bp - v, _NEVER)

    ny, nx = ti.grid
    px_parent = ti.px_parent32.numpy()
    s = sched_of(pmv)
    e = sched_of(nm[px_parent])
    iset_s = None
    if regions is not None:
        g = np.zeros(len(regions), np.int64)
        p2 = pmv.reshape(ny, nx)
        for y in range(ny):
            for x0 in range(0, nx, tile):
                blk = p2[y, x0:x0 + tile]
                xs = np.arange(x0, x0 + blk.size)
                for k in range(1, len(regions)):
                    ax, ay = regions[k]
                    r = blk.max() if y >= ay or x0 >= ax else np.where(xs >= ax, blk, 0).max()
                    g[k] = max(g[k], r)
        iset_s = sched_of(g)
        iset_s[0] = _NEVER
    return num_bp, s, e, nm, iset_s


# packet chunks (3D shapes of tests/test_torch_wave_table.py), an uneven edge
# chunk, a dyadic chunk and 2D fields; each with the default plan and a
# forced one of the other form (one subtree launch, or two)
_EMU_CASES = [((64, 64, 25), None), ((64, 64, 25), (3, 1)), ((61, 61, 25), None), ((61, 64, 25), (2, 0)),
              ((23, 16, 16), None), ((23, 16, 16), (2, 1)), ((33, 57), None), ((33, 57), (3, 1)),
              ((40, 24), (2,)), ((64, 64), None), ((100, 70), (4, 2))]


@pytest.mark.parametrize("dims,cuts", _EMU_CASES)
@pytest.mark.parametrize("case", ["sparse", "single pixel", "2^31 - 1"])
def test_table_kernels_emulated_equal_jax(dims, cuts, case):
    """The child-table kernels' arithmetic, emulated: equal to sperr_tpu's
    pixel_schedule (and, for a 2D field, iset_significance_device) and to
    the plain version."""
    n = int(np.prod(dims))
    mags = _mags(n, case, seed=sum(dims))
    ti = tspk.TreeIndex(dims, "cpu", cuts=cuts)
    if cuts is not None:
        assert ti.plan.cuts == cuts
    regions = tsw.build_tree2(dims).iset_regions if len(dims) == 2 else None
    got = _emulate_table_kernels(mags, ti, regions, seed=n)
    nbj, pmj, *want = _jax_table(dims, "tree")(jnp.asarray(mags))
    assert got[0] == int(nbj)
    for name, a, b in zip(("s", "e", "nm"), got[1:4], want):
        np.testing.assert_array_equal(a, np.asarray(b), name)
    plain = tspk.schedule_table(torch.from_numpy(mags), ti, iset_regions=regions)
    for name, a, b in zip(("num_bp", "s", "e", "nm"), plain, got):
        np.testing.assert_array_equal(a.numpy(), b, name)
    if regions is not None:
        nx, ny = dims
        tree = jsw.build_tree2(dims)
        jset = jsl2.iset_significance_device(jnp.asarray(pmj).reshape(ny, nx), tree, nbj)
        np.testing.assert_array_equal(got[4], np.asarray(jset), "iset_s")
        np.testing.assert_array_equal(plain[4].numpy(), np.asarray(jset), "iset_s")


@pytest.mark.parametrize("dims", [(61, 64, 25), (33, 57), (100, 70)])
def test_int64_leaf_table_emulated_equal_jax(dims, monkeypatch):
    """A field whose boxes start at or past pixel SCHED_LEAF32 takes the
    int64 leaf table: forced here at a small size, the same boxes (the
    kernel's leaf64 route), and the schedule equal to sperr_tpu's."""
    n = int(np.prod(dims))
    mags = _mags(n, "sparse", seed=n)
    narrow = tspk.TreeIndex(dims, "cpu")
    monkeypatch.setattr(tspk, "SCHED_LEAF32", 0)
    ti = tspk.TreeIndex(dims, "cpu")
    assert narrow.leaf_host.dtype == np.int32 and ti.leaf_host.dtype == np.int64
    assert ti.plan.leaf.dtype == torch.int64
    np.testing.assert_array_equal(ti.leaf_host, narrow.leaf_host)
    got = _emulate_table_kernels(mags, ti, seed=1)
    nbj, _, *want = _jax_table(dims, "tree")(jnp.asarray(mags))
    assert got[0] == int(nbj)
    for name, a, b in zip(("s", "e", "nm"), got[1:4], want):
        np.testing.assert_array_equal(a, np.asarray(b), name)


@pytest.mark.parametrize("dims", [(40, 24), (33, 57), (64, 64)] + _TREE_DIMS[:1])
def test_schedule_table_keywords(dims):
    """The I-set passes with the schedule: the 4-tuple unchanged, then
    iset_s = iset_significance_ref on pm (msbp1_device); a 3D index has
    the 4-tuple alone."""
    n = int(np.prod(dims))
    mt = torch.from_numpy(_mags(n, "sparse", seed=3))
    ti = tspk.tree_index(dims, "cpu")
    base = tspk.schedule_table(mt, ti)
    assert len(base) == 4 and all(t.dtype == torch.int32 for t in base)
    np.testing.assert_array_equal(base[0].numpy(), tsv.msbp1_device(mt).max().numpy())
    if len(dims) == 2:
        tree = tsw.build_tree2(dims)
        nx, ny = dims
        pm = tsv.msbp1_device(mt).reshape(ny, nx)
        got = tspk.schedule_table(mt, ti, iset_regions=tree.iset_regions[: tree.xf + 1])
        assert len(got) == 5
        for a, b in zip(base, got[:4]):
            assert torch.equal(a, b)
        want = tsl2.iset_significance_ref(pm, tree, base[0])
        assert got[4].dtype == torch.int32 and torch.equal(got[4], want)
        assert torch.equal(tsl2.iset_significance_device(pm, tree, base[0]), want)


def test_subtree_plan_raises_on_a_depth_not_ordered_by_parent():
    """The subtree plan's premise: two node children of different parents
    swapped at depth 1 leave the depth unordered by parent."""
    tree = tsw.build_tree2((16, 16))
    fake = types.SimpleNamespace(**{k: getattr(tree, k) for k in tree.__slots__})
    ref = tree.ch_ref.copy()
    rows = np.flatnonzero(~tree.ch_is_pixel)
    lo, hi = tree.node_depth_ranges[1]
    a, b = rows[(ref[rows] >= lo) & (ref[rows] < hi)][[0, -1]]  # depth 1's first and last nodes
    ref[a], ref[b] = ref[b], ref[a]
    fake.ch_ref = ref
    with pytest.raises(ValueError, match="not ordered by parent"):
        tspk.subtree_plan(fake)
    tspk.subtree_plan(types.SimpleNamespace(**{k: getattr(tree, k) for k in tree.__slots__}))


@pytest.mark.parametrize("dims", [(256, 256, 100), (244, 244, 100), (256, 244, 100), (1024, 1024),
                                  (3600, 1800)])
def test_subtree_plans_at_the_main_path_sizes(dims):
    """The Hurricane packet and edge chunks', a 1024^2 and the 1800 x 3600
    field's plans: at most two subtree launches, each depth's ranges tiled
    by the blocks in order, the rows their nodes' own, every block a run of
    whole subtrees within SCHED_ROWS rows (or one node within
    SCHED_CUT_ROWS) and its shared bytes, the depths above the top cut
    within SCHED_TOP_ROWS rows, and the leaves' boxes."""
    tree = tsw.build_tree2(dims) if len(dims) == 2 else tsw.build_tree(dims)
    cuts, depth_lo, nroots, smem, subs, links, leaf = tspk.subtree_plan(tree)
    bounds = np.concatenate([[0], np.cumsum(tree.node_ch_count)])
    assert 1 <= len(cuts) <= 2 and nroots == depth_lo[1] and depth_lo[-1] == tree.node_ch_start.size
    assert bounds[depth_lo[cuts[-1]]] <= tspk.SCHED_TOP_ROWS and smem <= tspk.SCHED_SMEM
    stops = (len(depth_lo) - 1,) + cuts[:1]
    for c, stop, sub in zip(cuts, stops, subs):
        assert sub.shape[:2] == (2, stop - c) and 2 <= sub.shape[2] <= depth_lo[c + 1] - depth_lo[c] + 1
        for j in range(stop - c):
            assert sub[0, j, 0] == depth_lo[c + j] and sub[0, j, -1] == depth_lo[c + j + 1]
            assert (np.diff(sub[0, j]) >= 0).all()
            np.testing.assert_array_equal(sub[1, j], bounds[sub[0, j]])
        assert (np.diff(sub[0, 0]) > 0).all()  # each block or group at least one node of its cut
        nodes = np.diff(sub[0], axis=1).sum(axis=0)
        rows = np.diff(sub[1], axis=1).sum(axis=0)
        one = np.diff(sub[0, 0]) == 1  # a block or group of one node may pass SCHED_ROWS
        assert (rows[~one] <= tspk.SCHED_ROWS).all()
        if c == cuts[0]:
            assert rows.max() <= max(tspk.SCHED_ROWS, tspk.SCHED_CUT_ROWS)
        staged_nodes, staged_rows = nodes, rows
        if c == cuts[0]:  # the leaves' rows and row starts are not staged
            staged_nodes, staged_rows = nodes - np.diff(sub[0, -1]), rows - np.diff(sub[1, -1])
        assert (2 * staged_rows + 2 * staged_nodes + 2 + nodes).max() <= smem
    # the leaves: boxes of at most 2 x 2 x 2 pixels whose sizes are their rows'
    assert leaf.size == depth_lo[-1] - depth_lo[-2] and leaf.dtype == np.int32
    sides = [((leaf >> k) & 1) + 1 for k in range(3)]
    np.testing.assert_array_equal(sides[0] * sides[1] * sides[2], tree.node_ch_count[depth_lo[-2]:])
    if len(cuts) == 2:
        nblk, ngrp = subs[0].shape[2] - 1, subs[1].shape[2] - 1
        glo, ghi, need = links[:nblk], links[nblk:2 * nblk], links[2 * nblk:]
        assert links.size == 2 * nblk + ngrp and (glo <= ghi).all() and (np.diff(glo) >= 0).all()
        assert (ghi - glo + 1).max() <= kernels.SCHED_MAX_GROUPS
        # each group's blocks hold its descendants at the first cut, which end where the next group's begin
        reach = np.zeros(ngrp, np.int64)
        for b in range(nblk):
            reach[glo[b]:ghi[b] + 1] += 1
        np.testing.assert_array_equal(reach, need)
        assert (need >= 1).all()
    else:
        assert links is None


def test_sched_table_struct_and_constants_match_the_source():
    """kernels.SchedTable against schedule.cu's struct, field for field,
    and the constants the host mirrors."""
    import ctypes
    import os
    import re

    src = open(os.path.join(os.path.dirname(kernels.__file__), "schedule.cu")).read()
    body = src[src.index("struct SchedTable {"):src.index("};", src.index("struct SchedTable {"))]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [re.search(r"(\w+)(\[[^\]]*\])?\s*$", part.strip()).group(1) for part in decl.split(",")]
    assert names == [f[0] for f in kernels.SchedTable._fields_]
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["kMaxDepth"] == kernels.SCHED_MAX_DEPTH and consts["kMaxIset"] == kernels.ISET_MAX_LEVELS
    assert consts["kNodeMark"] == kernels.SCHED_NODE_MARK and consts["kPixTile"] == kernels.SCHED_PIX_TILE
    assert consts["kMaxChildren"] == kernels.SCHED_MAX_CHILDREN
    assert consts["kMaxGroups"] == kernels.SCHED_MAX_GROUPS
    assert "kZeroWords = 2 + kMaxIset + 1;" in src and kernels.SCHED_ZERO_WORDS == 2 + kernels.ISET_MAX_LEVELS + 1
    # 14 pointers, n, levels, three pairs, nine ints, the depth starts and the corners, to 8 bytes
    assert ctypes.sizeof(kernels.SchedTable) == -(-(14 * 8 + 8 + 4 * (1 + 6 + 9 + 33 + 34)) // 8) * 8


def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)
    mags = torch.from_numpy(_mags(16**3, "sparse"))
    vt = tsv.virtual_lis_index((16, 16, 16), "cpu")
    nb = tsv.schedule_virtual(mags, vt)[0]
    tsv.pixel_schedule_virtual(mags, vt, nb)
    for dims, form in ((_TREE_DIMS[0], "tree"), (_DIMS_2D[0], "tree"), (_PYRAMID_DIMS[0], "pyramid")):
        m = torch.from_numpy(_mags(int(np.prod(dims)), "sparse"))
        if form == "tree":
            nb = tspk.schedule_table(m, tspk.tree_index(dims, "cpu"))[0]
            tspk.pixel_schedule(m, tspk.tree_index(dims, "cpu"), nb)
        else:
            nb = tspk.schedule_pyramid(m, tspk.pyramid_index(dims, "cpu"))[0]
            tspk.pixel_schedule_pyramid(m, tspk.pyramid_index(dims, "cpu"), nb)
    assert not any(kernels.launches[k] for k in ("sched_boxmax", "sched_virtual", "sched_table",
                                                 "sched_pyramid"))


def test_meta_tensors_raise():
    vt = tsv.virtual_lis_index((4, 4, 4), "cpu")
    ti = tspk.tree_index(_DIMS_2D[0], "cpu")
    pi = tspk.pyramid_index(_PYRAMID_DIMS[0], "cpu")
    meta = torch.zeros(64, dtype=torch.int32, device="meta")
    for call in (
        lambda: tsv.schedule_virtual(meta, vt),
        lambda: tsv.pixel_schedule_virtual(meta, vt, 3),
        lambda: tspk.schedule_table(meta, ti),
        lambda: tspk.pixel_schedule(meta, ti, 3),
        lambda: tspk.schedule_pyramid(meta, pi),
        lambda: tspk.pixel_schedule_pyramid(meta, pi, 3),
    ):
        with pytest.raises(ValueError, match="no .* kernel for tensors on meta"):
            call()


def test_schedule_kernels_registered_and_refuse_cpu_tensors():
    assert any(s.endswith("schedule.cu") for s in kernels.SOURCES)
    for name in ("sched_boxmax", "sched_virtual", "sched_table", "sched_pyramid"):
        assert name in kernels.launches
    w = torch.zeros(64, dtype=torch.int32)
    b = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sched_boxmax(w, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sched_virtual(b, torch.zeros(9, dtype=torch.uint8), w[:1],
                              torch.zeros((1, 4), dtype=torch.int32), 2, 9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sched_table(w, w, w[:2], w, tspk.tree_index(_DIMS_2D[0], "cpu").plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sched_pyramid(w, w, 3, (2, 2, 2), w, w[:9])
    assert kernels.pyramid_cells(1) == 1 and kernels.pyramid_cells(8) == sum(8**g for g in range(8))
