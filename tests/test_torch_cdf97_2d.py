"""The port's 2D CDF 9/7 transforms and multi-resolution inverses
(sperr_tpu_torch/ops/cdf97.py) against sperr_tpu's whole-plane Pallas kernels
K2/K3 (run in interpret mode, as tests/test_pallas_kernels.py runs them) and
its f32 engine cdf97_jax.

On the CPU the transforms run the plain version level by level; the CUDA
kernels K2/K3 are held against the same plain version, bit for bit, on the
card by chip_smoke.py.  Their host-side plan (kernels.plane_plan: the
launches per level, grids, shared bytes and scratch) is pure Python and is
tested here.  Tolerance: 2e-5 * max|x|, f32 roundoff over a few
levels of lifting (XLA may contract multiply-adds into FMAs; the port rounds
each operation)."""

import numpy as np
import pytest
import torch

from sperr_tpu.ops import cdf97_jax as cj
from sperr_tpu.ops import pallas_kernels as pk
from sperr_tpu.utils.dims import calc_approx_detail_len, coarsened_resolutions, num_of_xforms
from sperr_tpu_torch import kernels
from sperr_tpu_torch.ops import cdf97 as ct

SHAPES_2D = [(3, 64, 64), (2, 48, 80), (1, 127, 127), (2, 19, 27)]
# lengths odd at several levels: 113 -> 57 -> 29 -> 15, 225 -> 113 -> 57
ODD_2D = (1, 113, 225)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tol(x):
    return 2e-5 * float(np.abs(x).max())


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_ref_matches_pallas_kernels(shape):
    x = _rand(shape, seed=shape[1])
    ours = ct.dwt2d_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(pk.dwt2d_pallas(x, interpret=True)),
                               rtol=0, atol=_tol(x))
    back = ct.idwt2d_ref(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(back, np.asarray(pk.idwt2d_pallas(ours, interpret=True)),
                               rtol=0, atol=_tol(x))
    np.testing.assert_allclose(back, x, rtol=0, atol=_tol(x))


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_ref_matches_cdf97_jax(shape):
    x = _rand(shape, seed=shape[2])
    ours = ct.dwt2d_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(cj.dwt2d(x)), rtol=0, atol=_tol(x))
    back = ct.idwt2d_ref(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(back, np.asarray(cj.idwt2d(ours)), rtol=0, atol=_tol(x))


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_dispatching_transforms_equal_ref_on_cpu(shape):
    x = torch.from_numpy(_rand(shape, seed=7))
    fwd = ct.dwt2d(x)
    torch.testing.assert_close(fwd, ct.dwt2d_ref(x), rtol=0, atol=0)
    torch.testing.assert_close(ct.idwt2d(fwd), ct.idwt2d_ref(fwd), rtol=0, atol=0)
    # in place on a contiguous tensor, and through the lifting dispatcher
    y = x.clone()
    assert ct.dwt2d_(y) is y
    torch.testing.assert_close(y, fwd, rtol=0, atol=0)
    torch.testing.assert_close(ct.dwt2d_ref(x, lift=ct.lift_axis), fwd, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 48, 80), (1, 127, 127)])
def test_level_by_level_inverse_composes_to_the_full_inverse(shape):
    x = torch.from_numpy(_rand(shape, seed=11))
    coeffs = ct.dwt2d(x)
    levels = num_of_xforms(min(shape[-2:]))
    y = coeffs.clone()
    for lev in range(levels, 0, -1):
        ct.idwt2d_(y, lev, lev - 1)
    torch.testing.assert_close(y, ct.idwt2d(coeffs), rtol=0, atol=0)
    # and any split into a coarse and a fine part
    z = coeffs.clone()
    ct.idwt2d_(z, levels, 2)
    ct.idwt2d_(z, 2, 0)
    torch.testing.assert_close(z, y, rtol=0, atol=0)


def test_fewer_levels_and_small_planes():
    x = _rand((2, 40, 56), seed=5)
    ours = ct.dwt2d(torch.from_numpy(x), levels=2).numpy()
    np.testing.assert_allclose(ours, np.asarray(cj.dwt2d(x, levels=2)), rtol=0, atol=_tol(x))
    # planes too small for one level pass through unchanged
    s = torch.from_numpy(_rand((3, 8, 30), seed=6))
    torch.testing.assert_close(ct.dwt2d(s), s, rtol=0, atol=0)
    torch.testing.assert_close(ct.idwt2d(s), s, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 48, 80), (1, 127, 127), (19, 27), ODD_2D])
def test_idwt2d_multi_res_matches_jax(shape):
    x = _rand(shape, seed=shape[-1])
    full, hier = ct.idwt2d_multi_res(torch.from_numpy(x))
    full_j, hier_j = cj.idwt2d_multi_res(x)
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), rtol=0, atol=_tol(x))
    torch.testing.assert_close(full, ct.idwt2d(torch.from_numpy(x)), rtol=0, atol=0)
    res = coarsened_resolutions((shape[-1], shape[-2], 1))
    assert len(hier) == len(hier_j) == len(res) > 0
    for h, hj, r in zip(hier, hier_j, res):
        assert tuple(h.shape) == tuple(hj.shape) == shape[:-2] + (r[1], r[0])
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=_tol(x))


@pytest.mark.parametrize("shape", [(32, 32, 32), (2, 19, 27, 33)])
def test_idwt3d_multi_res_matches_jax(shape):
    x = _rand(shape, seed=sum(shape))
    full, hier = ct.idwt3d_multi_res(torch.from_numpy(x))
    full_j, hier_j = cj.idwt3d_multi_res(x)
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), rtol=0, atol=_tol(x))
    torch.testing.assert_close(full, ct.idwt3d(torch.from_numpy(x)), rtol=0, atol=0)
    res = coarsened_resolutions((shape[-1], shape[-2], shape[-3]))
    assert len(hier) == len(hier_j) == len(res) > 0
    for h, hj, r in zip(hier, hier_j, res):
        assert tuple(h.shape) == tuple(hj.shape) == shape[:-3] + (r[2], r[1], r[0])
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=_tol(x))


def test_idwt3d_multi_res_non_dyadic_has_empty_hierarchy():
    x = _rand((12, 32, 32), seed=3)  # dims (32, 32, 12): a wavelet packet
    full, hier = ct.idwt3d_multi_res(torch.from_numpy(x))
    full_j, hier_j = cj.idwt3d_multi_res(x)
    assert hier == () and len(hier_j) == 0
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), rtol=0, atol=_tol(x))


def _approx(n, lev):
    return calc_approx_detail_len(n, lev)[0]


def _covers(el, shift, tiles):
    """Tiles of 28 output pairs from pair -shift cover pairs 0 .. el-1, and
    each holds at least one of them."""
    owned = [range(28 * t - shift, 28 * t - shift + 28) for t in range(tiles)]
    return (set().union(*owned) >= set(range(el))
            and all(r.start < el and r.stop > 0 for r in owned))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(3, 127, 127), (2, 19, 27)])
def test_plane_plan_at_the_smoke_shapes(shape, inverse):
    B, ny, nx = shape
    levels = num_of_xforms(min(ny, nx))
    plan = kernels.plane_plan(B, ny, nx, inverse, levels)
    order = list(range(levels, 0, -1)) if inverse else list(range(levels))
    assert [r.level for r in plan.launches] == order
    shift = 2 if inverse else 0
    for r in plan.launches:
        corner = r.level - 1 if inverse else r.level
        assert (r.ly, r.lx) == (_approx(ny, corner), _approx(nx, corner))
        ty, tx = -(-(r.ly - r.ly // 2) // 28), -(-(r.lx - r.lx // 2 + shift) // 28)
        assert r.grid == B * ty * tx
        assert _covers(r.lx - r.lx // 2, shift, tx) and _covers(r.ly - r.ly // 2, 0, ty)
        assert r.shared_bytes == kernels.PLANE_SHARED_BYTES == 20736
    # the approximations between launches, in two regions used in turn
    mids = [(_approx(ny, lev - 1 if inverse else lev + 1), _approx(nx, lev - 1 if inverse else lev + 1))
            for lev in order][:-1]
    assert [(s.ly, s.lx) for s in plan.scratch] == mids
    for m, s in enumerate(plan.scratch):
        assert s.pitch % 4 == 0 and s.lx <= s.pitch < s.lx + 4
        assert s.offset == (0 if m % 2 == 0 else max(B * t.ly * t.pitch for t in plan.scratch[0::2]))
        assert s.offset + B * s.ly * s.pitch <= plan.scratch_floats


def test_plane_plan_partial_inverse():
    plan = kernels.plane_plan(1, 127, 127, True, 4, 2)
    assert [(r.level, r.ly, r.lx, r.grid) for r in plan.launches] == [(4, 16, 16, 1), (3, 32, 32, 1)]
    assert [(s.ly, s.lx, s.pitch, s.offset) for s in plan.scratch] == [(16, 16, 16, 0)]
    assert plan.scratch_floats == 256
    with pytest.raises(ValueError, match="forward transform starts at level 0"):
        kernels.plane_plan(1, 127, 127, False, 4, 2)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 3, 2), (1, 2, 7)])
def test_plane_plan_two_sample_lines(shape):
    B, ny, nx = shape
    for inverse in (False, True):
        (run,) = kernels.plane_plan(B, ny, nx, inverse, 1).launches
        assert (run.ly, run.lx, run.grid) == (ny, nx, B)
        assert kernels.plane_plan(B, ny, nx, inverse, 1).scratch == ()
    with pytest.raises(ValueError, match="shorter than 2 samples"):
        kernels.plane_plan(B, ny, nx, False, 2)


def test_plane_plan_takes_lines_the_whole_line_kernels_refused():
    # a 60000-sample line needed 240000 bytes of shared memory, more than
    # the 227 KB a block of the old whole-line design could hold
    plan = kernels.plane_plan(1, 16, 60000, False, 1)
    assert [(r.ly, r.lx, r.grid, r.shared_bytes) for r in plan.launches] == [
        (16, 60000, -(-30000 // 28), 20736)]
    assert kernels.plane_plan(1, 60000, 16, True, 1).launches[0].grid == -(-30000 // 28)
    # what the kernels cannot take: a grid past 2^31 - 1 blocks
    with pytest.raises(ValueError, match="a launch takes at most"):
        kernels.plane_plan(2**31, 16, 16, False, 1)


def test_plane_plan_keeps_every_approximation_for_the_hierarchy():
    plan = kernels.plane_plan(2, 113, 225, True, 4, 0, keep=True)
    sizes = [2 * s.ly * s.pitch for s in plan.scratch]
    assert [(s.ly, s.lx) for s in plan.scratch] == [(15, 29), (29, 57), (57, 113)]
    assert [s.offset for s in plan.scratch] == [0, sizes[0], sizes[0] + sizes[1]]
    assert plan.scratch_floats == sum(sizes)


@pytest.mark.parametrize("inverse", [False, True])
def test_plane_descriptors_chain_the_launches(inverse):
    B, ny, nx = ODD_2D
    plan = kernels.plane_plan(B, ny, nx, inverse, 4)
    desc = kernels._plane_desc(plan, ny, nx, ny, nx, inverse)
    rows = np.array(desc[:]).reshape(len(plan.launches), 15)
    # launch k writes where launch k+1 reads: (base, offset, pitch, plane)
    src = rows[:, [12, 0, 1, 2]]
    dst = rows[:, [13, 3, 4, 5]]
    np.testing.assert_array_equal(src[1:], dst[:-1])
    assert tuple(src[0]) == (0, 0, nx, ny * nx)       # the input
    assert tuple(dst[-1]) == (2, 0, nx, ny * nx)      # the output
    assert set(rows[:, 14]) == {0 if inverse else 2}  # details: read or written
    for r, (k, off, pitch, plane) in zip(plan.launches[1:], src[1:]):
        s = plan.scratch[list(plan.launches).index(r) - 1]
        assert (k, off, pitch, plane) == (1, 4 * s.offset, s.pitch, s.ly * s.pitch)
    np.testing.assert_array_equal(rows[:, 9:12], [[r.ly, r.lx, r.grid] for r in plan.launches])


@pytest.mark.parametrize("shape", SHAPES_2D + [ODD_2D])
def test_2d_forms_match_jax(shape):
    x = _rand(shape, seed=sum(shape))
    xt = torch.from_numpy(x)
    fwd = ct.dwt2d(xt)
    assert np.array_equal(xt.numpy(), x)  # the input is left alone
    np.testing.assert_allclose(fwd.numpy(), np.asarray(cj.dwt2d(x)), rtol=0, atol=_tol(x))
    y = xt.clone()
    assert ct.dwt2d_(y) is y
    torch.testing.assert_close(y, fwd, rtol=0, atol=0)
    c = fwd.numpy().copy()
    inv = ct.idwt2d(fwd)
    assert np.array_equal(fwd.numpy(), c)
    np.testing.assert_allclose(inv.numpy(), np.asarray(cj.idwt2d(c)), rtol=0, atol=_tol(x))
    np.testing.assert_allclose(inv.numpy(), x, rtol=0, atol=_tol(x))
    z = fwd.clone()
    assert ct.idwt2d_(z) is z
    torch.testing.assert_close(z, inv, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 48, 80), (1, 127, 127), ODD_2D])
def test_partial_inverse_forms_match_jax(shape):
    x = _rand(shape, seed=shape[-1] + 1)
    levels = num_of_xforms(min(shape[-2:]))
    lo = 2
    c = np.asarray(cj.dwt2d(x))
    ly, lx = _approx(shape[-2], lo), _approx(shape[-1], lo)
    # the JAX reference: the corner of level lo, inverted by levels - lo levels
    ref = c.copy()
    ref[..., :ly, :lx] = np.asarray(cj.idwt2d(c[..., :ly, :lx], levels - lo))
    ct_c = torch.from_numpy(c.copy())
    part = ct.idwt2d(ct_c, levels, lo)
    assert np.array_equal(ct_c.numpy(), c)
    np.testing.assert_allclose(part.numpy(), ref, rtol=0, atol=_tol(x))
    # outside the corner the coefficients pass through unchanged
    np.testing.assert_array_equal(part.numpy()[..., ly:, :], c[..., ly:, :])
    np.testing.assert_array_equal(part.numpy()[..., :, lx:], c[..., :, lx:])
    z = ct_c.clone()
    assert ct.idwt2d_(z, levels, lo) is z
    torch.testing.assert_close(z, part, rtol=0, atol=0)
    # and it is close to the forward transform of lo levels
    np.testing.assert_allclose(part.numpy(), np.asarray(cj.dwt2d(x, levels=lo)), rtol=0, atol=_tol(x))
