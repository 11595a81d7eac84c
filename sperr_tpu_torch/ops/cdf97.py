"""CDF 9/7 wavelet transform in f32: PyTorch port of sperr_tpu/ops/cdf97_jax.py.

Every transform is a sequence of one-axis lifting levels on a sub-box at the
origin of a (B, nz, ny, nx) tensor, updated in place (the port's form of
``_set_corner3``).  On a CUDA tensor each level is one launch of the
hand-written kernel (kernels/cdf97_lift.cu); on a CPU tensor it is the plain
version ``lift_axis_ref``, which performs the same operations in the same
order, each rounded on its own.  ``dwt3d_ref``/``idwt3d_ref`` run the plain
version on any device, so the kernel can be held against it on the card.

The 2D transforms are the exception: on a CUDA tensor the kernels K2
(forward) and K3 (inverse) (kernels/cdf97_2d.cu) run every level of a batch
of planes, one fused launch per level, out of place; ``dwt2d_ref``/
``idwt2d_ref`` run the same levels one lifting pass at a time.

The public transforms return a new tensor and leave their input alone; the
``*_`` forms transform a contiguous tensor in place, which the codec uses to
keep one buffer per chunk.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils.dims import calc_approx_detail_len, can_use_dyadic, num_of_xforms
from .cdf97_np import ALPHA, BETA, DELTA, EPSILON, GAMMA, INV_EPSILON

# The lifting constants rounded to f32 exactly as cdf97_jax's dt.type(ALPHA)
# rounds them, in the order the kernel takes them.
LIFT_CONSTS = np.array(
    [ALPHA, BETA, GAMMA, DELTA, EPSILON, INV_EPSILON], dtype=np.float32
)
_A, _B, _G, _D, _E, _IE = (float(v) for v in LIFT_CONSTS)

Box = Tuple[int, int, int]
LiftFn = Callable[[torch.Tensor, int, Box, bool], None]


def _neighbors(even, odd, el: int, ol: int):
    """Boundary-clamped neighbours along the last axis (_lift_neighbors):
    even[min(j+1, el-1)], odd[max(i-1, 0)], odd[min(i, ol-1)]."""
    if el == ol:
        e_r = torch.cat([even[..., 1:ol], even[..., el - 1 : el]], dim=-1)
        o_l = torch.cat([odd[..., 0:1], odd[..., 0 : el - 1]], dim=-1)
        o_r = odd
    else:
        e_r = even[..., 1 : ol + 1]
        o_l = torch.cat([odd[..., 0:1], odd], dim=-1)
        o_r = torch.cat([odd, odd[..., ol - 1 : ol]], dim=-1)
    return e_r, o_l, o_r


def _analysis(seg: torch.Tensor) -> torch.Tensor:
    """Gather then one forward lifting level along the last axis."""
    n = seg.shape[-1]
    el, ol = n - n // 2, n // 2
    even, odd = seg[..., 0::2], seg[..., 1::2]
    e_r, _, _ = _neighbors(even, odd, el, ol)
    odd = odd + _A * (even[..., :ol] + e_r)
    _, o_l, o_r = _neighbors(even, odd, el, ol)
    even = even + _B * (o_l + o_r)
    e_r, _, _ = _neighbors(even, odd, el, ol)
    odd = odd + _G * (even[..., :ol] + e_r)
    _, o_l, o_r = _neighbors(even, odd, el, ol)
    even = _E * (even + _D * (o_l + o_r))
    odd = odd * (-_IE)
    return torch.cat([even, odd], dim=-1)


def _synthesis(seg: torch.Tensor) -> torch.Tensor:
    """One inverse lifting level along the last axis, then interleave."""
    n = seg.shape[-1]
    el, ol = n - n // 2, n // 2
    even, odd = seg[..., :el], seg[..., el:]
    odd = odd * (-_E)
    _, o_l, o_r = _neighbors(even, odd, el, ol)
    even = even * _IE - _D * (o_l + o_r)
    e_r, _, _ = _neighbors(even, odd, el, ol)
    odd = odd - _G * (even[..., :ol] + e_r)
    _, o_l, o_r = _neighbors(even, odd, el, ol)
    even = even - _B * (o_l + o_r)
    e_r, _, _ = _neighbors(even, odd, el, ol)
    odd = odd - _A * (even[..., :ol] + e_r)
    out = torch.empty_like(seg)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def lift_axis_ref(x: torch.Tensor, axis: int, box: Box, inverse: bool) -> None:
    """Plain version of one lifting level (kernels/cdf97_lift.cu): along
    ``axis`` of the sub-box ``box`` = (lz, ly, lx) of x (B, nz, ny, nx), in
    place."""
    lz, ly, lx = box
    seg = x[:, :lz, :ly, :lx].movedim(axis, -1)
    seg.copy_(_synthesis(seg) if inverse else _analysis(seg))


def lift_axis(x: torch.Tensor, axis: int, box: Box, inverse: bool) -> None:
    """The lifting kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.is_cuda:
        kernels.cdf97_lift(x, axis, box, inverse, LIFT_CONSTS)
    elif x.device.type == "cpu":
        lift_axis_ref(x, axis, box, inverse)
    else:
        raise ValueError(f"no lifting kernel for tensors on {x.device}")


# ---------------------------------------------------------------------------
# Multi-level drivers on x (B, nz, ny, nx), in place; the level loops of
# cdf97_jax (:136-316).  x is axis -1, y is -2, z is -3.
# ---------------------------------------------------------------------------
def _dwt3d_level(x, lx: int, ly: int, lz: int, lift: LiftFn) -> None:
    for axis in (-1, -2, -3):
        lift(x, axis, (lz, ly, lx), False)


def _idwt3d_level(x, lx: int, ly: int, lz: int, lift: LiftFn) -> None:
    for axis in (-3, -2, -1):
        lift(x, axis, (lz, ly, lx), True)


def _dwt2d_level(x, lx: int, ly: int, lift: LiftFn) -> None:
    nz = x.shape[1]
    lift(x, -1, (nz, ly, lx), False)  # rows (X) first
    lift(x, -2, (nz, ly, lx), False)  # then columns (Y)


def _idwt2d_level(x, lx: int, ly: int, lift: LiftFn) -> None:
    nz = x.shape[1]
    lift(x, -2, (nz, ly, lx), True)
    lift(x, -1, (nz, ly, lx), True)


def _dwt3d4(x, lift: LiftFn) -> None:
    _, nz, ny, nx = x.shape
    dyadic = can_use_dyadic((nx, ny, nz))
    if dyadic is not None:
        for lev in range(dyadic):
            lx, _ = calc_approx_detail_len(nx, lev)
            ly, _ = calc_approx_detail_len(ny, lev)
            lz, _ = calc_approx_detail_len(nz, lev)
            _dwt3d_level(x, lx, ly, lz, lift)
        return
    # wavelet packet: full 1D transform along Z, then full 2D per XY slice
    length = nz
    for _ in range(num_of_xforms(nz)):
        lift(x, -3, (length, ny, nx), False)
        length -= length // 2
    for lev in range(num_of_xforms(min(nx, ny))):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        _dwt2d_level(x, lx, ly, lift)


def _idwt3d4(x, lift: LiftFn) -> None:
    _, nz, ny, nx = x.shape
    dyadic = can_use_dyadic((nx, ny, nz))
    if dyadic is not None:
        for lev in range(dyadic, 0, -1):
            lx, _ = calc_approx_detail_len(nx, lev - 1)
            ly, _ = calc_approx_detail_len(ny, lev - 1)
            lz, _ = calc_approx_detail_len(nz, lev - 1)
            _idwt3d_level(x, lx, ly, lz, lift)
        return
    for lev in range(num_of_xforms(min(nx, ny)), 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev - 1)
        ly, _ = calc_approx_detail_len(ny, lev - 1)
        _idwt2d_level(x, lx, ly, lift)
    for lev in range(num_of_xforms(nz), 0, -1):
        length, _ = calc_approx_detail_len(nz, lev - 1)
        lift(x, -3, (length, ny, nx), True)


def _as4(x: torch.Tensor, trailing: int) -> torch.Tensor:
    """View x (..., [nz,] [ny,] nx) as (B, nz, ny, nx); x must be contiguous
    so that updates of the view land in x."""
    if x.dtype != torch.float32:
        raise ValueError(f"the transform is f32; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the in-place transform needs a contiguous tensor")
    shape = (1,) * (3 - trailing) + tuple(x.shape[x.dim() - trailing :])
    return x.view((-1,) + shape)


def dwt3d_(x: torch.Tensor, lift: LiftFn = lift_axis) -> torch.Tensor:
    """Full 3D forward transform of x (..., nz, ny, nx), in place."""
    _dwt3d4(_as4(x, 3), lift)
    return x


def idwt3d_(x: torch.Tensor, lift: LiftFn = lift_axis) -> torch.Tensor:
    _idwt3d4(_as4(x, 3), lift)
    return x


def dwt3d(x: torch.Tensor) -> torch.Tensor:
    return dwt3d_(x.clone(memory_format=torch.contiguous_format))


def idwt3d(x: torch.Tensor) -> torch.Tensor:
    return idwt3d_(x.clone(memory_format=torch.contiguous_format))


def dwt3d_ref(x: torch.Tensor) -> torch.Tensor:
    """``dwt3d`` through the plain lifting version, on any device."""
    return dwt3d_(x.clone(memory_format=torch.contiguous_format), lift_axis_ref)


def idwt3d_ref(x: torch.Tensor) -> torch.Tensor:
    return idwt3d_(x.clone(memory_format=torch.contiguous_format), lift_axis_ref)


def dwt1d(x: torch.Tensor, levels: int | None = None) -> torch.Tensor:
    """Forward transform along the last axis of x (..., n)."""
    out = x.clone(memory_format=torch.contiguous_format)
    x4 = _as4(out, 1)
    n = x4.shape[-1]
    levels = num_of_xforms(n) if levels is None else levels
    length = n
    for _ in range(levels):
        lift_axis(x4, -1, (1, 1, length), False)
        length -= length // 2
    return out


def idwt1d(x: torch.Tensor, levels: int | None = None) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    x4 = _as4(out, 1)
    n = x4.shape[-1]
    levels = num_of_xforms(n) if levels is None else levels
    for lev in range(levels, 0, -1):
        length, _ = calc_approx_detail_len(n, lev - 1)
        lift_axis(x4, -1, (1, 1, length), True)
    return out


# ---------------------------------------------------------------------------
# 2D: on a CUDA tensor the kernels K2/K3 (kernels/cdf97_2d.cu) run every
# level of a batch of planes, one launch per level, out of place; the plain
# version runs the same levels one lifting pass at a time, in place.
# ---------------------------------------------------------------------------
def _as3(x: torch.Tensor) -> torch.Tensor:
    """View x (..., ny, nx) as (B, ny, nx); x must be contiguous f32."""
    return _as4(x, 2)[:, 0]


def _levels2(x3: torch.Tensor, levels: int | None) -> int:
    return num_of_xforms(min(x3.shape[-1], x3.shape[-2])) if levels is None else levels


def _no_kernel(x: torch.Tensor) -> ValueError:
    return ValueError(f"no 2D transform kernel for tensors on {x.device}")


def _corner(x: torch.Tensor, lev: int) -> Tuple[int, int]:
    return (calc_approx_detail_len(x.shape[-2], lev)[0], calc_approx_detail_len(x.shape[-1], lev)[0])


def _dwt2d_levels(x3, lev_lo: int, lev_hi: int, lift: LiftFn) -> None:
    x4 = x3[:, None]
    ny, nx = x3.shape[-2], x3.shape[-1]
    for lev in range(lev_lo, lev_hi):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        _dwt2d_level(x4, lx, ly, lift)


def _idwt2d_levels(x3, lev_hi: int, lev_lo: int, lift: LiftFn) -> None:
    x4 = x3[:, None]
    ny, nx = x3.shape[-2], x3.shape[-1]
    for lev in range(lev_hi, lev_lo, -1):
        lx, _ = calc_approx_detail_len(nx, lev - 1)
        ly, _ = calc_approx_detail_len(ny, lev - 1)
        _idwt2d_level(x4, lx, ly, lift)


def dwt2d(x: torch.Tensor, levels: int | None = None) -> torch.Tensor:
    """Forward transform of the trailing (ny, nx) planes of x into a new
    tensor, x left alone: K2 on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.is_cuda:
        x3 = _as3(x.contiguous())
        levels = _levels2(x3, levels)
        if levels == 0:
            return x.clone(memory_format=torch.contiguous_format)
        return kernels.dwt2d_full(x3, LIFT_CONSTS, levels).view(x.shape)
    if x.device.type != "cpu":
        raise _no_kernel(x)
    return dwt2d_(x.clone(memory_format=torch.contiguous_format), levels)


def dwt2d_(x: torch.Tensor, levels: int | None = None) -> torch.Tensor:
    """``dwt2d`` in place on a contiguous x; on a CUDA tensor K2 writes a
    new tensor that is copied back."""
    x3 = _as3(x)
    if x3.is_cuda:
        if _levels2(x3, levels) > 0:
            x3.copy_(dwt2d(x3, levels))
    elif x3.device.type == "cpu":
        _dwt2d_levels(x3, 0, _levels2(x3, levels), lift_axis_ref)
    else:
        raise _no_kernel(x)
    return x


def idwt2d(x: torch.Tensor, levels: int | None = None, lev_lo: int = 0) -> torch.Tensor:
    """Undo levels ``levels .. lev_lo+1`` (default: all) of the 2D transform
    of x into a new tensor, x left alone: K3 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.is_cuda:
        x3 = _as3(x.contiguous())
        levels = _levels2(x3, levels)
        if levels <= lev_lo:
            return x.clone(memory_format=torch.contiguous_format)
        corner = kernels.idwt2d_full(x3, LIFT_CONSTS, levels, lev_lo)
        if lev_lo == 0:
            return corner.view(x.shape)
        out = x3.clone()
        ly, lx = corner.shape[-2:]
        out[:, :ly, :lx] = corner
        return out.view(x.shape)
    if x.device.type != "cpu":
        raise _no_kernel(x)
    return idwt2d_(x.clone(memory_format=torch.contiguous_format), levels, lev_lo)


def idwt2d_(x: torch.Tensor, levels: int | None = None, lev_lo: int = 0) -> torch.Tensor:
    """``idwt2d`` in place on a contiguous x; on a CUDA tensor K3 writes the
    corner of level ``lev_lo`` out of place and it is copied back."""
    x3 = _as3(x)
    levels = _levels2(x3, levels)
    if x3.is_cuda:
        if levels > lev_lo:
            ly, lx = _corner(x3, lev_lo)
            x3[:, :ly, :lx].copy_(kernels.idwt2d_full(x3, LIFT_CONSTS, levels, lev_lo))
    elif x3.device.type == "cpu":
        _idwt2d_levels(x3, levels, lev_lo, lift_axis_ref)
    else:
        raise _no_kernel(x)
    return x


def dwt2d_ref(x: torch.Tensor, levels: int | None = None, lift: LiftFn = lift_axis_ref):
    """``dwt2d`` one lifting pass at a time through ``lift``, on any device:
    the plain version by default; ``lift=lift_axis`` is the per-axis lifting
    kernel on a CUDA tensor (2 launches per level)."""
    out = x.clone(memory_format=torch.contiguous_format)
    x3 = _as3(out)
    _dwt2d_levels(x3, 0, _levels2(x3, levels), lift)
    return out


def idwt2d_ref(x: torch.Tensor, levels: int | None = None, lift: LiftFn = lift_axis_ref):
    out = x.clone(memory_format=torch.contiguous_format)
    x3 = _as3(out)
    _idwt2d_levels(x3, _levels2(x3, levels), 0, lift)
    return out


# ---------------------------------------------------------------------------
# Multi-resolution inverses (cdf97_jax.py:255-293): the hierarchy of coarse
# approximations, coarsest first, as utils.dims.coarsened_resolutions lists
# them.
# ---------------------------------------------------------------------------
def idwt2d_multi_res(x: torch.Tensor):
    """-> (full inverse of x (..., ny, nx), tuple of coarse approximations).
    On a CUDA tensor one K3 call whose launches each keep their output, from
    which the approximations are taken; on a CPU tensor the plain version
    undoes one level at a time and copies each corner out."""
    ny, nx = x.shape[-2], x.shape[-1]
    levels = num_of_xforms(min(nx, ny))
    lead = x.shape[:-2]
    if x.is_cuda and levels > 0:
        x3 = _as3(x.contiguous())
        out, lls = kernels.idwt2d_full(x3, LIFT_CONSTS, levels, 0, hierarchy=True)
        ly, lx = _corner(x3, levels)
        hier = [x3[:, :ly, :lx].clone()] + lls
        return out.view(x.shape), tuple(h.reshape(lead + h.shape[-2:]) for h in hier)
    out = x.clone(memory_format=torch.contiguous_format)
    hier = []
    for lev in range(levels, 0, -1):
        ly, lx = _corner(out, lev)
        hier.append(out[..., :ly, :lx].clone())
        idwt2d_(out, lev, lev - 1)
    return out, tuple(hier)


def idwt3d_multi_res(x: torch.Tensor):
    """-> (full inverse of x (..., nz, ny, nx), tuple of coarse
    approximations).  Non-dyadic dims invert as a wavelet packet with an
    empty hierarchy, as the reference does."""
    out = x.clone(memory_format=torch.contiguous_format)
    x4 = _as4(out, 3)
    _, nz, ny, nx = x4.shape
    dyadic = can_use_dyadic((nx, ny, nz))
    if dyadic is None:
        _idwt3d4(x4, lift_axis)
        return out, ()
    hier = []
    for lev in range(dyadic, 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        lz, _ = calc_approx_detail_len(nz, lev)
        hier.append(out[..., :lz, :ly, :lx].clone())
        lx, _ = calc_approx_detail_len(nx, lev - 1)
        ly, _ = calc_approx_detail_len(ny, lev - 1)
        lz, _ = calc_approx_detail_len(nz, lev - 1)
        _idwt3d_level(x4, lx, ly, lz, lift_axis)
    return out, tuple(hier)
