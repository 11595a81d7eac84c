"""The device SPECK schedule of the port (sperr_tpu_torch/ops/speck_virtual.py
``schedule_virtual``, ops/speck.py ``schedule_table`` and
``schedule_pyramid``, the kernels of kernels/schedule.cu) against
sperr_tpu's ``msbp1_device``, ``pixel_schedule_virtual``,
``pixel_schedule`` and ``pixel_schedule_pyramid`` on the same integer
inputs, on the CPU (the kernels' plain versions).  Every comparison is bit
for bit: all results are integers.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 3 holds them
against these plain versions there).  What can be checked here: the static
tables they read (the cube schedule's nm segments, the child tables' int32
rows, the pyramid's int32 copies), a numpy emulation of the cube kernels'
index arithmetic (morton slots, the block cubes' pyramid levels, the
segment search), and that a CPU tensor never reaches the kernel library."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import speck_jax as sj
from sperr_tpu.ops import speck_virtual as jsv
from sperr_tpu_torch import kernels
from sperr_tpu_torch.ops import speck as tspk
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
        nb, pm, *rest = tspk.schedule_table(mt, tspk.tree_index(dims, "cpu"))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(pmj), "pm")
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
    assert [(lo, hi) for *_, lo, hi in ti.depth_slices] == list(ti.depths)
    np.testing.assert_array_equal(ti.px_parent32.numpy(), ti.px_parent_lin.numpy())
    src = ti.ch_src.numpy()
    bounds = ti.ch_bounds.numpy()
    for ispx, src_px, src_nd, parent_rows, lo, hi in ti.depth_slices:
        rows = src[bounds[lo]:bounds[hi]]
        np.testing.assert_array_equal(rows >= 0, ispx.numpy())
        np.testing.assert_array_equal(np.where(rows >= 0, rows, 0), np.where(ispx.numpy(), src_px.numpy(), 0))
        np.testing.assert_array_equal(np.where(rows < 0, -(rows + 1), 0), np.where(ispx.numpy(), 0, src_nd.numpy()))
        np.testing.assert_array_equal(np.repeat(np.arange(hi - lo), np.diff(bounds[lo:hi + 1])),
                                      parent_rows.numpy())


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
        kernels.sched_table(w, w, w[:2], ((0, 1),), w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sched_pyramid(w, w, 3, (2, 2, 2), w, w[:9])
    assert kernels.pyramid_cells(1) == 1 and kernels.pyramid_cells(8) == sum(8**g for g in range(8))
