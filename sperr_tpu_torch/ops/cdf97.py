"""CDF 9/7 wavelet transform in f32: PyTorch port of sperr_tpu/ops/cdf97_jax.py.

Every transform is a sequence of one-axis lifting levels on a sub-box at the
origin of a (B, nz, ny, nx) tensor, updated in place (the port's form of
``_set_corner3``).  On a CUDA tensor each level is one launch of the
hand-written kernel (kernels/cdf97_lift.cu); on a CPU tensor it is the plain
version ``lift_axis_ref``, which performs the same operations in the same
order, each rounded on its own.  ``dwt3d_ref``/``idwt3d_ref`` run the plain
version on any device, so the kernel can be held against it on the card.

The public transforms return a new tensor and leave their input alone; the
``*_`` forms transform a contiguous tensor in place, which the codec uses to
keep one buffer per chunk.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from sperr_tpu.ops.cdf97_np import ALPHA, BETA, DELTA, EPSILON, GAMMA, INV_EPSILON
from sperr_tpu.utils.dims import calc_approx_detail_len, can_use_dyadic, num_of_xforms

from .. import kernels

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


def dwt2d(x: torch.Tensor, levels: int | None = None) -> torch.Tensor:
    """Forward transform of the trailing (ny, nx) planes of x."""
    out = x.clone(memory_format=torch.contiguous_format)
    x4 = _as4(out, 2)
    ny, nx = x4.shape[-2], x4.shape[-1]
    levels = num_of_xforms(min(nx, ny)) if levels is None else levels
    for lev in range(levels):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        _dwt2d_level(x4, lx, ly, lift_axis)
    return out


def idwt2d(x: torch.Tensor, levels: int | None = None) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    x4 = _as4(out, 2)
    ny, nx = x4.shape[-2], x4.shape[-1]
    levels = num_of_xforms(min(nx, ny)) if levels is None else levels
    for lev in range(levels, 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev - 1)
        ly, _ = calc_approx_detail_len(ny, lev - 1)
        _idwt2d_level(x4, lx, ly, lift_axis)
    return out
