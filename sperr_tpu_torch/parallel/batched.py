"""Chunked 3D codec with the dense stages on a torch device.

PyTorch port of sperr_tpu/parallel/batched.py (``TpuCompressor3D`` with
``entropy="host" | "wave"`` and ``transfer="sparse" | "dense"``, and
``TpuDecompressor3D``, both of its branches).  Per chunk, the device runs

    condition (mean) -> dwt3d -> q -> fused midtread quantize (K1)
    [PWE: inverse quantize -> idwt3d -> residual scan]

With ``entropy="host"`` the quantized values return to the host, where the
shared C++ engine encodes each chunk on a thread pool: the sparse transfer
compacts the nonzeros and the outliers on the device first (K12) and copies
only those, the dense transfer copies the dense arrays.  With
``entropy="wave"`` the device also computes every SPECK bit of each chunk
(ops/speck_virtual.py for power-of-two cubes, ops/speck.py for any other
shape; speck_lis.py, wave_pack.py) through a ladder of capacity tiers, and
the host only stitches the packed segments; both write the same bytes.  The decoder parses each chunk on the
host, in full or (the hybrid split, on a CUDA device by default) its control
bits only, with the refinement bits spread and the magnitudes rebuilt on the
device (ops/wave_unpack.py, K13); it reconstructs on the device through the
same functions that the encoder's residual scan simulates, so that scan
certifies this decoder.

A batch of chunks can be split over several devices (``devices=``, the
port of the reference's chunk mesh): each sub-batch is cut along its chunk
axis into one contiguous part per device, each part runs on its device from
a host thread of its own, and the host stage keeps its one pool.  Every
device stage computes each chunk on its own, so the bytes and the decodes do
not depend on the split.

Streams are SPERR format, as the reference's.  Arithmetic is f32.
"""

from __future__ import annotations

import copy
import functools
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec import outlier as outlier_mod
from ..codec import speck_int_np as sp
from ..codec import speck_wave as sw
from ..errors import first_chunk_failure
from ..ops import cdf97
from ..ops import condition as cond_host
from ..ops import packemit as pe
from ..ops import quantize as qz
from ..ops import speck as spk
from ..ops import speck_lis as sl
from ..ops import speck_virtual as svirt
from ..ops import wave_pack as wp
from ..ops import wave_unpack as wup
from ..runtime.engine import default_engine
from ..runtime.native import residual_outliers as _native_residual_outliers
from ..stream import tools
from ..utils.dims import chunk_volume, coarsened_resolutions, coarsened_resolutions_chunked
from ..utils.packing import pack_8_booleans

_MODES = ("psnr", "pwe", "rate")
_EPS32 = float(np.finfo(np.float32).eps)
_WAVE_NEVER = 0x7FFF  # matches codec.speck_wave._NEVER
# decoder's device working set bound per sub-batch, in elements (the decode
# keeps ~3x the chunk bytes on the device)
_DECODE_ELEM_BUDGET = 1 << 28


def _resolve_device(device) -> torch.device:
    """The device the caller named; "cuda" without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def chunk_devices(devices=None) -> List[torch.device]:
    """The devices a batch is split over (the counterpart of sperr_tpu's
    ``make_chunk_mesh``): ``devices`` resolved, by default every CUDA
    device (raises without a GPU).  A list may name a device more than once,
    and its devices are all CUDA or all CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: name the devices")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices is empty")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices must all be CUDA or all CPU; got {[str(d) for d in devs]}")
    return devs


def _device_list(device, devices) -> List[torch.device]:
    """An entry point's ``device`` (default "cuda") or ``devices`` (a list
    for ``chunk_devices``); naming both raises."""
    if devices is None:
        return [_resolve_device("cuda" if device is None else device)]
    if device is not None:
        raise ValueError("pass device or devices, not both")
    if isinstance(devices, (str, torch.device)):
        raise ValueError(f"devices must be a list of devices; got {devices!r}")
    return chunk_devices(devices)


def _placement(device) -> dict:
    """``from_jax``'s ``device`` as an entry point's keyword: a list or tuple
    is ``devices``, anything else ``device``."""
    if isinstance(device, (list, tuple)):
        return {"devices": list(device)}
    return {"device": device}


def _split(n: int, parts: int) -> List[Tuple[int, int]]:
    """[a, b) bounds of ``parts`` contiguous pieces of n items, the first
    n % parts of them one item longer (a piece may be empty)."""
    q, r = divmod(n, parts)
    bounds = [0]
    for j in range(parts):
        bounds.append(bounds[-1] + q + (j < r))
    return list(zip(bounds[:-1], bounds[1:]))


def _on_devices(ndev: int, tasks):
    """Run ``tasks``, a list of (device slot, thunk), the thunks of each slot
    in order on a host thread of their own (inline for one slot); return
    their results in the order of ``tasks``.  Every thread ends before the
    first failure raises."""
    if ndev == 1:
        return [fn() for _, fn in tasks]
    out = [None] * len(tasks)

    def run(j):
        for t, (slot, fn) in enumerate(tasks):
            if slot == j:
                out[t] = fn()

    with ThreadPoolExecutor(max_workers=ndev) as pool:
        futures = [pool.submit(run, j) for j in range(ndev)]
    for f in futures:
        f.result()
    return out


# ---------------------------------------------------------------------------
# Device-side dense stages
# ---------------------------------------------------------------------------
def _per_row(fn, *rows: torch.Tensor) -> torch.Tensor:
    """fn applied to each row of the (B, ...) arguments on its own: a float
    reduction then runs the same way whatever the batch holds."""
    return torch.cat([fn(*(r[b : b + 1] for r in rows)) for b in range(rows[0].shape[0])])


def _dense_encode_rows(batch: torch.Tensor, mode: str, quality: float, residual: str,
                       forward, inverse_, out_cap: Optional[int] = None):
    """The dense front on batch (B, ...): condition -> ``forward`` -> q ->
    quantize (K1) [PWE: inverse quantize -> ``inverse_`` (its result is
    used; it may transform in place or out of place) -> residual].  The
    mean runs row by row; the transforms, the PSNR search (K16: its sums'
    order depends on n alone) and K1 take the whole batch, and every line
    of them is computed on its own.

    ``out_cap`` set is the wave program's front (sperr_tpu
    ``_encode_core_wave``): the "margin" residual scans at max(tol - eta, 0)
    and flags ``margin_bad``, and the outliers leave as the first
    ``out_cap`` indices (K12) with their values and the count ``n_out``
    instead of the dense ``outlier_mask`` and ``diff``."""
    B = batch.shape[0]
    n = batch[0].numel()
    flat = batch.reshape(B, n)
    f32 = np.float32

    v0 = flat[:, 0:1]
    is_const = torch.all(flat == v0, dim=1)
    mean = _per_row(lambda r: torch.mean(r, dim=1), flat)
    conditioned = flat - mean[:, None]
    if mode == "psnr":
        rng = torch.amax(conditioned, dim=1) - torch.amin(conditioned, dim=1)

    # conditioned stays needed by the f32/margin residual, so transform a copy
    coeffs = forward(conditioned.reshape(batch.shape)).reshape(B, n)

    if mode == "psnr":
        q = qz.estimate_q_psnr_batched(coeffs, rng, quality)
    elif mode == "pwe":
        q = torch.full((B,), quality * 1.5, dtype=batch.dtype, device=batch.device)
    else:  # rate: magnitudes must stay exactly representable in f32
        amax = torch.amax(torch.abs(coeffs), dim=1)
        q = amax / torch.full_like(amax, qz.RATE_MAX_MAG_DEVICE)

    mags, signs, maxmag = qz.midtread_quantize_batched_best(coeffs, q)

    out = dict(
        is_const=is_const, v0=v0[:, 0], mean=mean, q=q,
        mags=mags, signs=signs, maxmag=maxmag,
    )
    if mode == "pwe" and residual != "none":
        rec = qz.midtread_inv_quantize_batched(mags, signs, q)
        rec = inverse_(rec.reshape(batch.shape)).reshape(B, n)
        if residual == "dual":
            # decoder-exact residual (the ops of _dense_decode, in its
            # order: rec + mean, then the difference) plus a guard window
            diff = flat - (rec + mean[:, None])
            eta = float(f32(8.0)) * _EPS32 * torch.amax(torch.abs(flat), dim=1)
            kappa = torch.minimum(
                torch.full_like(eta, float(f32(0.25 * quality))),
                torch.maximum(torch.full_like(eta, float(f32(0.05 * quality))), 2.0 * eta),
            )
            out["eta_sim"] = eta
            out["kappa"] = kappa
            thr = (float(f32(quality)) - kappa)[:, None]
        elif residual == "margin" and out_cap is not None:
            # eta bounds |diff_f32 - diff_f64|: scanning at tol - eta keeps
            # unflagged points within tol for an f64 decoder while eta <= tol/4
            diff = conditioned - rec
            scale = torch.maximum(
                torch.abs(q) * maxmag.to(q.dtype), torch.amax(torch.abs(conditioned), dim=1)
            )
            eta = float(f32(256.0)) * _EPS32 * scale
            out["margin_bad"] = eta > float(f32(quality / 4.0))
            thr = torch.clamp(float(f32(quality)) - eta, min=0.0)[:, None]
        else:
            diff = conditioned - rec
            thr = float(f32(quality))
        omask = torch.abs(diff) > thr
        if out_cap is None:
            out["outlier_mask"] = omask
            out["diff"] = diff
        else:
            out["n_out"] = omask.sum(dim=1).to(torch.int32)
            oi, _ = pe.compact_flags_rows(omask, out_cap)
            ov = torch.gather(diff, 1, torch.clamp(oi, max=n - 1).long())
            out["out_idx"] = oi
            out["out_vals"] = torch.where(oi < n, ov, torch.zeros_like(ov))
    return out


def _dense_encode(batch: torch.Tensor, mode: str, quality: float, residual: str = "f32"):
    """batch (B, lz, ly, lx) f32 on the device -> dict of per-chunk results.

    Runs chunk by chunk, so every result is independent of how chunks are
    grouped (the reference's ``seq`` form): no reduction spans two chunks."""
    outs = [
        _dense_encode_rows(batch[b : b + 1], mode, quality, residual, cdf97.dwt3d, cdf97.idwt3d_)
        for b in range(batch.shape[0])
    ]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _nonzeros(mags: torch.Tensor, signs: torch.Tensor, cap: int):
    """The nonzero compaction of (B, n) quantized values (K12): the
    ascending indices of each row's first min(cap, n) nonzeros with the
    sentinel n after them, the signed values there (0 at the sentinel) and
    each row's nonzero count, which may exceed cap."""
    n = mags.shape[1]
    idx, nnz = pe.compact_flags_rows(mags != 0, min(cap, n))
    ic = torch.clamp(idx, max=n - 1).long()
    m = torch.gather(mags, 1, ic)
    vals = torch.where(idx < n, torch.where(torch.gather(signs, 1, ic), m, -m), 0)
    return idx, vals, nnz


def _dense_encode_sparse(batch: torch.Tensor, mode: str, quality: float, cap: int, out_cap: int,
                         residual: str = "f32"):
    """The sparse program (sperr_tpu ``_dense_encode_sparse``), chunk by
    chunk: the wave program's front (``_dense_encode_rows`` with
    ``out_cap``: the outliers' first min(out_cap, n) indices, their values
    and ``n_out``; "margin" scans at max(tol - eta, 0)), then the nonzero
    compaction (``_nonzeros``: ``idx``, ``vals``, ``nnz``) in place of the
    dense magnitudes and signs, and ``absmax``, max|x| per chunk."""
    n = batch[0].numel()
    outs = []
    for b in range(batch.shape[0]):
        row = batch[b : b + 1]
        o = _dense_encode_rows(row, mode, quality, residual, cdf97.dwt3d, cdf97.idwt3d_,
                               out_cap=min(out_cap, n))
        o["idx"], o["vals"], o["nnz"] = _nonzeros(o.pop("mags"), o.pop("signs"), cap)
        o["absmax"] = torch.amax(torch.abs(row.reshape(1, n)), dim=1)
        outs.append(o)
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _inverse(shape, multi_res: bool):
    if len(shape) == 3:
        return cdf97.idwt3d_multi_res if multi_res else cdf97.idwt3d_
    return cdf97.idwt2d_multi_res if multi_res else cdf97.idwt2d


def _dense_decode(mags, signs, q, mean, shape):
    """Reconstruction of B chunks (shape (lz, ly, lx)) or planes (shape
    (ny, nx)): inverse quantize -> inverse transform -> + mean.  The
    encoder's dual residual simulates exactly these operations."""
    B = mags.shape[0]
    coeffs = qz.midtread_inv_quantize_batched(mags, signs, q)
    rec = _inverse(shape, False)(coeffs.reshape((B,) + tuple(shape)))
    return rec + mean.view((B,) + (1,) * len(shape)).to(rec.dtype)


def _dense_decode_multires(mags, signs, q, mean, shape):
    """``_dense_decode`` plus the hierarchy of coarse reconstructions,
    coarsest first, each plus the mean but without outlier corrections (the
    reference's semantics, SPECK_FLT.cpp:592-603)."""
    B = mags.shape[0]
    coeffs = qz.midtread_inv_quantize_batched(mags, signs, q)
    rec, hier = _inverse(shape, True)(coeffs.reshape((B,) + tuple(shape)))
    m = mean.view((B,) + (1,) * len(shape)).to(rec.dtype)
    return rec + m, tuple(h + m for h in hier)


# ---------------------------------------------------------------------------
# Host helpers, copied from sperr_tpu.parallel.batched (which imports jax);
# tests/test_torch_isolation.py holds each copy against its original.
# ---------------------------------------------------------------------------
def _residual_outliers(ll, dims3, q, mean, orig, tol):
    """Strict-PWE outlier set: positions/errors where the exact f64 decode
    reconstruction misses `orig` by more than `tol` (ascending positions,
    the reference's scan order, SPECK_FLT.cpp:461-486), scanned by the C++
    engine (runtime/native), which raises if it cannot be built."""
    return _native_residual_outliers(ll, dims3, q, mean, orig, tol)


def _sim_outlier_corr(e: float, tol: float, tol_dec: float) -> float:
    """Exact scalar simulation of outlier.encode_outliers followed by
    outlier.decode_outliers for one error value: quantize by `tol`, decode
    with the bias corrections against the decoder-visible tolerance
    `tol_dec` (= header q / 1.5)."""
    nq = np.rint(e * (1.0 / tol))
    if nq == 0.0:
        return 0.0
    mag = 1.1 if abs(nq) == 1.0 else abs(nq) - 0.25
    sgn = 1.0 if nq >= 0.0 else -1.0
    return float(mag * (tol_dec * sgn))


def _certify_dual(pos64, errs64, pos32, errs32, tol: float, eta: float, q_hdr: float):
    """Merge the exact-f64 and decoder-exact-f32 residual scans into one
    certified outlier set.

    Output set S = {|err64| > tol} ∪ {|err32| > tol - eta}; each point's fed
    error value is chosen so the simulated correction bounds BOTH residuals:
    |err64 - corr| <= tol and |err32 - corr| + eta <= tol.  Returns
    (positions, values, certified); certified=False when some point in S is
    missing one residual value or no candidate passes — the f64 contract
    still holds then, but the f32 device decoder is not certified for this
    chunk."""
    tol_dec = q_hdr / 1.5
    m64 = {int(p): float(e) for p, e in zip(pos64, errs64)}
    m32 = {int(p): float(e) for p, e in zip(pos32, errs32)}
    S = sorted(
        {p for p, e in m64.items() if abs(e) > tol}
        | {p for p, e in m32.items() if abs(e) > tol - eta}
    )
    pos, vals, ok = [], [], True
    for p in S:
        e64, e32 = m64.get(p), m32.get(p)
        if e64 is None:
            # |err64| <= tol - kappa: the f64 bound holds without a
            # correction, and feeding the f32 value could break it
            ok = False
            continue
        if e32 is None:
            ok = False
            e = e64
        else:
            for e in (e64, e32):
                c = _sim_outlier_corr(e, tol, tol_dec)
                if c != 0.0 and abs(e64 - c) <= tol and abs(e32 - c) + eta <= tol:
                    break
            else:
                ok = False
                if abs(e64) <= tol:
                    continue
                e = e64
        pos.append(p)
        vals.append(e)
    return (
        np.asarray(pos, dtype=np.int64),
        np.asarray(vals, dtype=np.float64),
        ok,
    )


def _width_for(maxmag: int) -> int:
    if maxmag <= 0xFF:
        return 8
    if maxmag <= 0xFFFF:
        return 16
    if maxmag <= 0xFFFFFFFF:
        return 32
    return 64


def _condi_header(is_const: bool, v0: float, nval: int, mean: float, q: float) -> bytes:
    if is_const:
        flags = pack_8_booleans([True, 0, 0, 0, 0, 0, 0, True])
        return struct.pack("<BQd", flags, nval, float(v0))
    flags = pack_8_booleans([True, 0, 0, 0, 0, 0, 0, False])
    return struct.pack("<Bdd", flags, float(mean), float(q))


# Wave-path capacity ladder, copied from sperr_tpu.parallel.batched:
# (node_frac, evb_frac, out_frac, bp_cap, wexp_frac) per tier -- fractions of
# the partition-tree node count, the emission pieces and the output bytes,
# the tier's bitplane cap, and the exposed-pixel compaction's fraction of n.
# Chunks that overflow a tier retry at the next; past the last, or with
# num_bp > num_bp_cap, they take host entropy.
DEFAULT_WAVE_TIERS = ((0.5, 0.5, 0.5, 16, 0.75), (1.0, 1.0, 1.0, 34, 1.0))
DEFAULT_WAVE_TIERS_BIG = (
    (1.0 / 20, 1.0 / 8, 1.0 / 24, 14, 1.0 / 20),
    (1.0 / 4, 1.0 / 4, 1.0 / 16, 22, 1.0 / 4),
    (1.0 / 2, 1.0 / 2, 1.0 / 2, 16, 1.0),
    (1.0, 1.0, 1.0, 16, 1.0),
    (1.0, 1.0, 1.0, 34, 1.0),
)


def wave_tiers_for(n: int):
    """Default capacity ladder for an n-voxel chunk (see above)."""
    return DEFAULT_WAVE_TIERS if n < (1 << 21) else DEFAULT_WAVE_TIERS_BIG


def _wave_caps(li, dims3, tier, num_bp_cap: int) -> Dict[str, int]:
    """The static caps of one tier, integer for integer those of sperr_tpu's
    ``_dense_encode_wave`` (which sizes its emission arrays by them)."""
    node_frac, evb_frac, out_frac, bp_cap, wexp_frac = tier
    n = dims3[0] * dims3[1] * dims3[2]
    nn = int(li.nn)
    node_cap = nn if node_frac >= 1.0 else max(2048, min(nn, int(nn * node_frac)))
    P = bp_cap if bp_cap else num_bp_cap
    wexp_cap = 0 if wexp_frac >= 1.0 else max(8192, min(n, int(n * wexp_frac)))
    T = sl.lis_item_count(li, node_cap)
    Tp = -(-T // 128) * 128
    npad = -(-(wexp_cap or n) // 256) * 256
    cells = P * (2 * npad + 2 * Tp + npad)
    np_pieces = cells // 256
    # evb fractions are calibrated against the compacted matrix geometry
    np_cal = P * (3 * (npad if wexp_cap else -(-n // 16)) + 2 * Tp) // 256
    evb_wide = min(np_pieces, max(1 << 20, n // 2))
    out_wide = min(((cells // 8 + 3 * num_bp_cap) // 4 + 1) * 4, 8 * n)
    evb_cap = evb_wide if evb_frac >= 1.0 else max(8192, min(evb_wide, int(np_cal * evb_frac)))
    out_cap_bytes = (
        out_wide
        if out_frac >= 1.0
        else max(16384, min(out_wide, (int(out_wide * out_frac) // 4) * 4))
    )
    return dict(node_cap=node_cap, P=P, wexp_cap=wexp_cap, T=T, Tp=Tp, npad=npad,
                cells=cells, evb_cap=evb_cap, out_cap_bytes=out_cap_bytes)


_INDEX_LOCKS: Dict[Tuple[int, ...], threading.Lock] = {}
_INDEX_LOCKS_GUARD = threading.Lock()


def _index_lock(dims) -> threading.Lock:
    """The lock under which the indexes of chunks or fields of ``dims`` are
    built and looked up: device threads that need one at once build it once
    (the host trees under it are shared by every device)."""
    with _INDEX_LOCKS_GUARD:
        return _INDEX_LOCKS.setdefault(tuple(int(d) for d in dims), threading.Lock())


def _wave_index(dims3, device):
    """(walk index, schedule index) of chunks of dims3 on device, as
    sperr_tpu's ``_dense_encode_wave`` chooses them: the virtual forest for
    power-of-two cubes (both roles); otherwise the table walk (``LisIndex``)
    with the pyramid-form schedule where its index builds (dyadic dims), the
    child-table schedule where it does not.  Each index is made once per
    (dims, device) and cached."""
    with _index_lock(dims3):
        if svirt._is_pow2_cube(dims3):
            vf = svirt.virtual_lis_index(dims3, device)
            return vf, vf
        try:
            si = spk.pyramid_index(dims3, device)
        except ValueError:
            si = spk.tree_index(dims3, device)
        return sl.lis_index(dims3, device), si


def _schedule(mags: torch.Tensor, si):
    """(num_bp, s, e, node maxima) through the schedule that ``si`` serves,
    num_bp on the device: K5 and K6 fused for a virtual forest, K15's
    pyramid or child-table form otherwise."""
    if isinstance(si, svirt.VirtualLisIndex):
        return svirt.schedule_virtual(mags, si)
    if isinstance(si, spk.PyramidIndex):
        return spk.schedule_pyramid(mags, si)
    return spk.schedule_table(mags, si)


def _wave_emit_chunk(mags: torch.Tensor, signs: torch.Tensor, li, caps: Dict[str, int], si=None):
    """The device entropy stage of one chunk at one tier: schedule (K5 and
    K6 for a virtual forest, K15 otherwise; ``si`` is the schedule index,
    None for ``li`` itself) -> walk (K7 and K8, or K15's table walk) ->
    emission (K9-K12).  Returns the WaveEmit and ``fits`` (node cap
    honoured, no overflow, num_bp <= the tier's bitplane cap), all on the
    device."""
    num_bp, s, e, nm = _schedule(mags, li if si is None else si)
    node_s = spk.node_passes(nm, num_bp)
    em = wp.wave_emit_3d(
        mags, signs, s, e, node_s, num_bp, li, caps["P"], caps["node_cap"],
        caps["evb_cap"], caps["out_cap_bytes"], caps["wexp_cap"],
    )
    fits = (em.n_sig <= caps["node_cap"]) & ~em.overflow & (em.num_bp <= caps["P"])
    return em, fits


def _stitch_wave(wave, k: int, dims3, budget: int) -> bytes:
    """Host half of the device-entropy path: per-pass concatenation of the
    device's packed LIP / LIS / refinement segments plus the stream header
    (byte-identical to the host engines)."""
    num_bp = int(wave["num_bp"][k])
    if num_bp == 0:
        return sw._pack_stream(np.empty(0, np.uint8), 0, 0)

    # packed buffer layout (ops/wave_pack.py): class-major rows -- all LIP
    # passes, then LIS, then refinement -- each row byte-aligned
    P = int(wave["bp_cap"])
    counts = wave["counts"][k].astype(np.int64)  # [3 * bp_cap]
    buf = wave["seg"][k]
    bc = (counts + 7) // 8
    offs = np.cumsum(bc) - bc

    def seg(p, c):
        b = c * P + p
        return np.unpackbits(buf[offs[b] : offs[b] + bc[b]], bitorder="little")[: int(counts[b])]

    lip_segments = [seg(p, 0) for p in range(num_bp)]
    lis_segments = [seg(p, 1) for p in range(num_bp)]
    ref_segments = [seg(p, 2) for p in range(num_bp)]
    return sw.stitch_3d(num_bp, lip_segments, lis_segments, ref_segments, budget)


def _group_parts(chunks, elem_budget: int, keep=None, ndev: int = 1):
    """Chunk indices grouped by shape (lz, ly, lx), each group cut into
    sub-batches of at most ``elem_budget`` elements (at least one chunk),
    whose size is a multiple of ``ndev`` where it exceeds it (sperr_tpu
    keeps its sub-batches mesh-divisible the same way)."""
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for i, c in enumerate(chunks):
        if keep is None or i in keep:
            groups.setdefault((c[5], c[3], c[1]), []).append(i)
    parts = []
    for shape, idxs in groups.items():
        bmax = max(1, int(elem_budget // max(1, shape[0] * shape[1] * shape[2])))
        if bmax > ndev:
            bmax -= bmax % ndev
        for s0 in range(0, len(idxs), bmax):
            parts.append((shape, idxs[s0 : s0 + bmax]))
    return parts


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------
class TorchCompressor3D:
    """Chunked 3D compressor: dense stages on ``device``, SPECK on the host
    (``entropy="host"``) or on the device (``entropy="wave"``).

    ``device``: "cuda" (the default), "cuda:N" or "cpu"; "cuda" without a
    GPU raises.  ``devices``, in place of ``device``: a list of devices
    (``chunk_devices``) that each sub-batch is split over, in contiguous
    parts of its chunks, one host thread per device; a device may appear
    more than once.  The containers equal a one-device run's byte for byte,
    and ``loader`` is then called from those threads.  ``pwe_strict`` selects how the PWE bound is certified, as in
    ``TpuCompressor3D``: True (dual: exact f64 and this port's f32 decoder),
    "f64" (f64 decoders only), "device" (margin scan; the host-entropy path
    certifies on the host, the wave path scans on the device at
    max(tol - eta, 0) unless eta > tol/4) or False (f32 scan at tol).

    With ``entropy="wave"`` every SPECK bit of a chunk, of any shape, is
    computed on the device through the tier ladder ``wave_tiers`` (None: the
    defaults of ``wave_tiers_for``) and only stream-sized segments (plus the
    quantized values, where the host needs them) cross to the host.
    Constant chunks, chunks past the last tier and chunks with num_bp >
    ``num_bp_cap`` take host entropy; both routes write the same bytes.

    ``transfer``: how the quantized values reach the host, as in
    ``TpuCompressor3D``.  "sparse" (the default) compacts the nonzeros (at
    most ``sparse_cap_frac`` of a chunk) and the outliers on the device
    (K12) and copies only those; on the wave route the exposure compaction
    of the tier that held a chunk is its view of the nonzeros.  A chunk past
    a cap re-runs through the dense front on the device, and its dense
    results are copied.  "dense" copies the dense arrays.  Both transfers
    write the same containers, except under ``pwe_strict="device"`` with
    host entropy: there the sparse transfer keeps the device's scan at
    max(tol - eta, 0) and rescans on the host only the chunks with eta >
    tol/4, where the dense transfer rescans every chunk on the host, so the
    outlier sets may differ (the reference's behaviour).

    After each compress, ``last_uncertified_chunks`` counts the PWE chunks
    whose f32-decoder bound could not be certified (the f64 bound holds for
    them) and ``last_uncertified_ids`` names them in chunk order;
    ``last_wave_chunks`` counts the chunks the device entropy path encoded
    and ``last_wave_tiers`` names the tier (0-based) that held each chunk,
    or None where it took host entropy; ``last_d2h_bytes`` counts the bytes
    copied from the devices to the host.
    """

    def __init__(
        self,
        vol_dims: Tuple[int, int, int],
        chunk_dims: Tuple[int, int, int] = (256, 256, 256),
        *,
        device=None,
        devices=None,
        num_threads: Optional[int] = None,
        pwe_strict=True,
        entropy: str = "host",
        transfer: str = "sparse",
    ):
        if entropy not in ("host", "wave"):
            raise ValueError(f"entropy must be 'host' or 'wave'; got {entropy!r}")
        if transfer not in ("sparse", "dense"):
            raise ValueError(f"transfer must be 'sparse' or 'dense'; got {transfer!r}")
        if pwe_strict not in (True, False, "f64", "device"):
            raise ValueError(f"pwe_strict must be True, False, 'f64' or 'device'; got {pwe_strict!r}")
        self.vol_dims = tuple(int(d) for d in vol_dims)
        self.chunk_dims = tuple(
            min(max(1, int(chunk_dims[i])), self.vol_dims[i]) for i in range(3)
        )
        self.devices = _device_list(device, devices)
        self.device = self.devices[0]
        self.engine = default_engine()
        self.num_threads = num_threads
        self.pwe_strict = pwe_strict
        self.entropy = entropy
        self.transfer = transfer
        # the sparse program's cap on a chunk's nonzeros, a fraction of n
        self.sparse_cap_frac = 0.5
        self._count_lock = threading.Lock()
        # device working set bounds, in elements per sub-batch: the dense
        # path keeps ~6x the input bytes on the device; the wave path keeps
        # each chunk's quantized values for the tier retries
        self.dense_elem_budget = 1 << 28
        self.wave_elem_budget = 1 << 24
        self.num_bp_cap = 34
        self.wave_tiers = None
        self.last_uncertified_chunks = 0
        self.last_uncertified_ids: List[int] = []
        self.last_wave_chunks = 0
        self.last_wave_tiers: List[Optional[int]] = []
        self.last_d2h_bytes = 0

    @classmethod
    def from_jax(cls, tpu_compressor, device) -> "TorchCompressor3D":
        """Settings of a ``sperr_tpu`` ``TpuCompressor3D`` (either entropy,
        either transfer).  ``device``: one device, or a list of devices that
        its chunk mesh, if it has one, maps onto (``devices=``)."""
        t = tpu_compressor
        if np.dtype(t.dtype) != np.float32:
            raise NotImplementedError(f"dtype {np.dtype(t.dtype)} is not ported")
        out = cls(
            t.vol_dims, t.chunk_dims, **_placement(device), num_threads=t.num_threads,
            pwe_strict=t.pwe_strict, entropy=t.entropy, transfer=t.transfer,
        )
        out.sparse_cap_frac = t.sparse_cap_frac
        out.dense_elem_budget = t.dense_elem_budget
        out.wave_elem_budget = t.wave_elem_budget
        out.num_bp_cap = t.num_bp_cap
        out.wave_tiers = t.wave_tiers
        return out

    def _wave_fits(self, wave, k: int) -> bool:
        """True when chunk row k's device emission fit every cap; num_bp >
        num_bp_cap routes to the host engine (never to a wider tier)."""
        return bool(wave["fits"][k]) and int(wave["num_bp"][k]) <= self.num_bp_cap

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        with self._count_lock:
            self.last_d2h_bytes += t.numel() * t.element_size()
        return t.cpu().numpy()

    def _trim(self, t: torch.Tensor, counts: np.ndarray, capn: int, rows=None) -> np.ndarray:
        """The first columns of t (B, cap), as many as the largest of
        ``counts`` rounded up to 1024 and at most ``capn`` (sperr_tpu's
        ``_trim_rows``), of ``rows`` (None: all), on the host."""
        m = int(counts.max()) if counts.size else 0
        t = t[:, : min(capn, -(-m // 1024) * 1024)]
        return self._to_host(t if rows is None else t[rows])

    def _sparse_caps(self, n: int) -> Tuple[int, int]:
        """(cap, out_cap) of the sparse program for n-voxel chunks, as the
        reference sizes them."""
        return max(1024, int(n * self.sparse_cap_frac)), max(256, n // 64)

    def _dense_rerun(self, row, mode: str, quality: float, resid_mode: str, want_ll: bool = True):
        """A chunk past a cap of a compaction re-runs through the dense
        front on the device.  Returns its signed values (None without
        ``want_ll``) and its outliers (positions and values; None without a
        device scan), on the host.  In margin mode the dense front scans at
        tol, as the reference's does."""
        d = _dense_encode(row, mode, quality, resid_mode)
        ll = self._to_host(torch.where(d["signs"][0], d["mags"][0], -d["mags"][0])) if want_ll else None
        scan = None
        if "outlier_mask" in d:
            p = torch.nonzero(d["outlier_mask"][0]).flatten()
            scan = (self._to_host(p), self._to_host(d["diff"][0][p]).astype(np.float64))
        return ll, scan

    def compress(self, vol: np.ndarray, mode: str, quality: float) -> bytes:
        nx, ny, nz = self.vol_dims
        is_float = np.asarray(vol).dtype == np.float32
        vol3 = np.asarray(vol).reshape(nz, ny, nx)
        chunks = chunk_volume(self.vol_dims, self.chunk_dims)

        def loader(c):
            return vol3[c[4] : c[4] + c[5], c[2] : c[2] + c[3], c[0] : c[0] + c[1]]

        streams = self.compress_chunks(chunks, loader, mode, quality)
        header = tools.generate_header(
            self.vol_dims, self.chunk_dims, [len(s) for s in streams], is_float
        )
        return header + b"".join(streams)

    def compress_chunks(self, chunks, loader, mode: str, quality: float) -> List[bytes]:
        """Compress an explicit chunk list.  ``loader(spec)`` returns a
        chunk's data shaped (lz, ly, lx); specs are (x0, lx, y0, ly, z0, lz)
        as utils.dims.chunk_volume makes them.  Returns one SPECK_FLT stream
        per spec, in order, with no container header."""
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}; got {mode!r}")
        quality = float(quality)
        if mode != "pwe" or self.pwe_strict is False:
            resid_mode = "f32"
        elif self.pwe_strict == "device":
            resid_mode = "margin"
        elif self.pwe_strict == "f64":
            resid_mode = "none"
        else:
            resid_mode = "dual"

        self.last_d2h_bytes = 0
        streams: List[Optional[bytes]] = [None] * len(chunks)
        uncertified = [0] * len(chunks)
        wave_tier: List[Optional[int]] = [None] * len(chunks)
        wave = self.entropy == "wave"
        elem_budget = self.wave_elem_budget if wave else self.dense_elem_budget
        # the device stages run sub-batch by sub-batch (the budget bounds the
        # device working set), each cut into one part per device; the host
        # stage of every chunk then runs in one pool
        ndev = len(self.devices)
        tasks, parts = [], []
        for (lz, ly, lx), idxs in _group_parts(chunks, elem_budget, ndev=ndev):
            for j, (a, b) in enumerate(_split(len(idxs), ndev)):
                if a < b:
                    parts.append((idxs[a:b], (lx, ly, lz)))
                    tasks.append((j, functools.partial(
                        self._device_stage, self.devices[j], [chunks[i] for i in idxs[a:b]], loader,
                        (lx, ly, lz), mode, quality, resid_mode,
                    )))
        jobs = []
        for (idxs, dims3), g in zip(parts, _on_devices(ndev, tasks)):
            jobs += [(g, k, gi, dims3) for k, gi in enumerate(idxs)]

        def encode_one(job) -> bytes:
            g, k, gi, dims3 = job
            n = dims3[0] * dims3[1] * dims3[2]
            budget = int(quality * n) if mode == "rate" else 0
            if bool(g.small["is_const"][k]):
                return _condi_header(True, float(g.small["v0"][k]), n, 0.0, 0.0)
            # strict/margin PWE store the reference's exact f64
            # q = 1.5*tol (SPECK_FLT.cpp:281) in the header
            q = (
                1.5 * quality
                if mode == "pwe" and resid_mode in ("none", "margin", "dual")
                else float(g.small["q"][k])
            )
            mean = float(g.small["mean"][k])
            condi = _condi_header(False, 0.0, 0, mean, q)
            wv = g.waves[k]
            if wv is not None and self._wave_fits(wv, 0):
                wave_tier[gi] = g.tiers[k]
                body = _stitch_wave(wv, 0, dims3, budget)
            else:
                mags, signs = g.mags_signs(k)
                body = self.engine.encode(
                    3, mags, signs, dims3, _width_for(int(g.small["maxmag"][k])), budget
                )
            if mode != "pwe":
                return condi + body

            def orig_row():
                return np.ascontiguousarray(loader(chunks[gi]), dtype=np.float64).ravel()

            if resid_mode == "dual":
                eta = float(g.small["eta_sim"][k])
                kappa = float(g.small["kappa"][k])
                pos64, errs64 = _residual_outliers(
                    g.ll(k), dims3, q, mean, orig_row(), quality - kappa
                )
                pos32, errs32 = g.dev_scan(k)
                pos, errs, cert_ok = _certify_dual(
                    pos64, errs64, pos32, errs32, quality, eta, q
                )
                if not (cert_ok and eta <= 0.125 * quality):
                    uncertified[gi] = 1
            elif g.host_resid(k):
                # exact f64 decoder-visible residual on the host
                pos, errs = _residual_outliers(g.ll(k), dims3, q, mean, orig_row(), quality)
            else:
                pos, errs = g.dev_scan(k)
            out_stream = b""
            if pos.size:
                out_stream = outlier_mod.encode_outliers(pos, errs, n, quality)
            return condi + body + out_stream

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            for job, s in zip(jobs, pool.map(encode_one, jobs)):
                streams[job[2]] = s

        self.last_uncertified_chunks = sum(uncertified)
        self.last_uncertified_ids = [i for i, u in enumerate(uncertified) if u]
        self.last_wave_tiers = wave_tier
        self.last_wave_chunks = sum(t is not None for t in wave_tier)
        return streams

    def _device_stage(self, device, specs, loader, dims3, mode: str, quality: float,
                      resid_mode: str) -> "_Group":
        """The device stage of one part of a sub-batch (chunks of one shape)
        on ``device``."""
        batch = np.stack([np.ascontiguousarray(loader(c)) for c in specs]).astype(np.float32)
        dev = torch.from_numpy(batch).to(device)
        if self.entropy == "wave":
            return self._wave_group(dev, dims3, mode, quality, resid_mode)
        if self.transfer == "sparse":
            return self._sparse_group(dev, mode, quality, resid_mode)
        return self._dense_group(dev, mode, quality, resid_mode)

    def _dense_group(self, dev, mode: str, quality: float, resid_mode: str) -> "_Group":
        """Host entropy: the dense results of every chunk go to the host."""
        dense = {k: self._to_host(v) for k, v in _dense_encode(dev, mode, quality, resid_mode).items()}

        def dev_scan(k):
            p = np.flatnonzero(dense["outlier_mask"][k])
            return p, np.asarray(dense["diff"][k][p], dtype=np.float64)

        return _Group(
            dense,
            mags_signs=lambda k: (dense["mags"][k], dense["signs"][k]),
            ll=lambda k: np.where(dense["signs"][k], 1, -1) * dense["mags"][k].astype(np.int64),
            dev_scan=dev_scan,
            # the dense path certifies margin mode on the host
            host_resid=lambda k: resid_mode in ("none", "margin"),
        )

    def _sparse_group(self, dev, mode: str, quality: float, resid_mode: str) -> "_Group":
        """Host entropy, sparse transfer: the sparse program's scalars, then
        its compactions trimmed to the rows' largest counts; a chunk past
        ``cap`` or ``out_cap`` re-runs through the dense front.  The outliers
        of a margin_bad chunk, whose residual the host scans, are not read."""
        n = dev[0].numel()
        cap, out_cap = self._sparse_caps(n)
        sp = _dense_encode_sparse(dev, mode, quality, cap, out_cap, resid_mode)
        small = {k: self._to_host(v) for k, v in sp.items() if v.dim() == 1}
        scanned = "n_out" in small
        over = small["nnz"] > cap
        if scanned:
            if "margin_bad" in small:
                small["n_out"] = np.where(small["margin_bad"], 0, small["n_out"])
            over |= small["n_out"] > out_cap
        views: Dict[int, object] = {}
        scans: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        good = np.flatnonzero(~over)
        if good.size:
            rows = None if good.size == over.size else torch.from_numpy(good).to(dev.device)
            nnz = small["nnz"][good]
            idx = self._trim(sp["idx"], nnz, cap, rows)
            vals = self._trim(sp["vals"], nnz, cap, rows)
            if scanned:
                n_out = small["n_out"][good]
                oi = self._trim(sp["out_idx"], n_out, out_cap, rows)
                ov = self._trim(sp["out_vals"], n_out, out_cap, rows)
            for j, k in enumerate(good):
                views[k] = (idx[j, : nnz[j]], vals[j, : nnz[j]])
                if scanned:
                    scans[k] = (oi[j, : n_out[j]].astype(np.int64), ov[j, : n_out[j]].astype(np.float64))
        del sp
        for k in np.flatnonzero(over):
            views[k], scans[k] = self._dense_rerun(dev[k : k + 1], mode, quality, resid_mode)
        mags_signs, ll = _views(n, views)
        return _Group(
            small, mags_signs=mags_signs, ll=ll, dev_scan=scans.__getitem__,
            # the dense re-run certifies margin mode on the host
            host_resid=lambda k: resid_mode == "none"
            or (resid_mode == "margin" and bool(over[k] or small["margin_bad"][k])),
        )

    def _fetch_wave(self, em, fits, P: int) -> dict:
        """A chunk's emission on the host, in the batch-of-one layout that
        ``_wave_fits`` and ``_stitch_wave`` read: scalars and counts first,
        then the packed segments trimmed to the stream when the chunk fits."""
        sc = self._to_host(torch.stack([
            em.num_bp.long(), em.total_bytes.long(), fits.long(), em.n_sig.long(), em.n_nz.long(),
        ]))
        w = {
            "num_bp": sc[0:1], "total_bytes": sc[1:2], "fits": sc[2:3] != 0,
            "n_sig": sc[3:4], "n_nz": sc[4:5], "counts": self._to_host(em.counts)[None],
            "bp_cap": P,
        }
        b = min(int(sc[1]), em.seg.shape[0]) if sc[2] else 0
        w["seg"] = self._to_host(em.seg[:b])[None]
        return w

    def _wave_group(self, dev, dims3, mode: str, quality: float, resid_mode: str) -> "_Group":
        """Device entropy over one group of chunks, chunk by chunk: the dense
        front (with the wave program's outlier compaction), the emission at
        the first tier, then the retry ladder over the chunks that overflowed
        a cap (the front is kept, not recomputed).  The host gets a chunk's
        quantized values where it needs them: the chunks that take host
        entropy, and PWE chunks whose residual it scans."""
        B = dev.shape[0]
        n = dims3[0] * dims3[1] * dims3[2]
        sparse = self.transfer == "sparse"
        # the wave program's outlier cap: smooth PWE data has few outliers;
        # chunks with more re-run through the front at the sparse program's
        # cap, past that through the dense front
        wave_out_cap = max(1024, n // 1024)
        cap, out_cap = self._sparse_caps(n)
        tiers = self.wave_tiers if self.wave_tiers is not None else wave_tiers_for(n)
        li, si = _wave_index(dims3, dev.device)
        caps = [_wave_caps(li, dims3, t, self.num_bp_cap) for t in tiers]

        fronts = []
        waves: List[Optional[dict]] = [None] * B
        tier_of: List[Optional[int]] = [None] * B
        exposed: List[Optional[tuple]] = [None] * B

        def emit(k: int, t: int) -> None:
            em, fits = _wave_emit_chunk(fronts[k]["mags"][0], fronts[k]["signs"][0], li, caps[t], si)
            waves[k] = self._fetch_wave(em, fits, caps[t]["P"])
            tier_of[k] = t
            # the tier's exposure compaction is a superset of the nonzeros
            view = sparse and 0 < caps[t]["wexp_cap"] < n
            exposed[k] = (em.exp_idx, em.exp_ll, em.n_exp) if view else None

        for k in range(B):
            fronts.append(_dense_encode_rows(
                dev[k : k + 1], mode, quality, resid_mode, cdf97.dwt3d, cdf97.idwt3d_,
                out_cap=wave_out_cap,
            ))
            emit(k, 0)
        # retry ladder: chunks that overflowed a cap re-run at the next, wider
        # tier; only num_bp > num_bp_cap goes straight to host entropy
        for t in range(1, len(caps)):
            bad = [
                k for k in range(B)
                if not self._wave_fits(waves[k], 0)
                and int(waves[k]["num_bp"][0]) <= self.num_bp_cap
            ]
            if not bad:
                break
            for k in bad:
                emit(k, t)

        keys = ["is_const", "v0", "mean", "q", "maxmag"]
        if mode == "pwe" and resid_mode != "none":
            keys.append("n_out")
        if resid_mode == "dual":
            keys += ["eta_sim", "kappa"]
        if mode == "pwe" and resid_mode == "margin":
            keys.append("margin_bad")
        small = {key: self._to_host(torch.cat([o[key] for o in fronts])) for key in keys}

        views: Dict[int, object] = {}
        scans: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for k, o in enumerate(fronts):
            if bool(small["is_const"][k]):
                continue
            fits = self._wave_fits(waves[k], 0)
            margin_bad = resid_mode == "margin" and bool(small["margin_bad"][k])
            if not fits or (mode == "pwe" and (resid_mode in ("dual", "none") or margin_bad)):
                views[k] = self._wave_view(o, exposed[k] if fits else None, cap)
            if "n_out" not in small or margin_bad:
                continue  # no device scan, or the host scans the residual
            m = int(small["n_out"][k])
            if m <= wave_out_cap:
                scans[k] = (
                    self._to_host(o["out_idx"][0, :m]).astype(np.int64),
                    self._to_host(o["out_vals"][0, :m]).astype(np.float64),
                )
            elif sparse and m <= out_cap:
                o2 = _dense_encode_rows(
                    dev[k : k + 1], mode, quality, resid_mode, cdf97.dwt3d, cdf97.idwt3d_,
                    out_cap=min(out_cap, n),
                )
                scans[k] = (
                    self._to_host(o2["out_idx"][0, :m]).astype(np.int64),
                    self._to_host(o2["out_vals"][0, :m]).astype(np.float64),
                )
                del o2
            else:
                _, scans[k] = self._dense_rerun(dev[k : k + 1], mode, quality, resid_mode, want_ll=False)
        mags_signs, ll = _views(n, views)
        return _Group(
            small, mags_signs=mags_signs, ll=ll, dev_scan=scans.__getitem__,
            host_resid=lambda k: resid_mode == "none"
            or (resid_mode == "margin" and bool(small["margin_bad"][k])),
            waves=waves,
            tiers=tier_of,
        )

    def _wave_view(self, front, exposed, cap: int):
        """A wave chunk's quantized values on the host.  Dense transfer: the
        dense signed row.  Sparse transfer: the exposure compaction of the
        tier that held the chunk (``exposed``) where it has one, else the
        nonzeros compacted from the front (K12), and past ``cap`` the dense
        row."""
        mags, signs = front["mags"], front["signs"]
        if self.transfer == "sparse":
            if exposed is not None:
                idx, ll, n_exp = exposed
            else:
                idx, ll, n_exp = _nonzeros(mags, signs, cap)
                idx, ll = idx[0], ll[0]
            m = int(self._to_host(n_exp.reshape(-1))[0])
            if m <= idx.shape[0]:
                return self._to_host(idx[:m]), self._to_host(ll[:m])
        return self._to_host(torch.where(signs[0], mags[0], -mags[0]))


def _views(n: int, views: Dict[int, object]):
    """``mags_signs(k)`` and ``ll(k)`` of chunks whose quantized values
    reached the host as a dense signed int32 row or as (ascending indices,
    signed values) of a superset of the nonzeros, rebuilt by scatter."""

    def ll(k) -> np.ndarray:
        v = views[k]
        if isinstance(v, np.ndarray):
            return v.astype(np.int64)
        out = np.zeros(n, np.int64)
        out[v[0]] = v[1]
        return out

    def mags_signs(k):
        v = views[k]
        if isinstance(v, np.ndarray):
            return np.abs(v), v >= 0
        mags = np.zeros(n, np.int32)
        signs = np.ones(n, bool)
        mags[v[0]] = np.abs(v[1])
        signs[v[0]] = v[1] >= 0
        return mags, signs

    return mags_signs, ll


class _Group:
    """What the host stage needs of one group of chunks: per-chunk scalars
    (``small``); ``mags_signs(k)``, ``ll(k)`` (int64 quantized values),
    ``dev_scan(k)`` (the device's outlier positions and errors) and
    ``host_resid(k)`` (whether the PWE residual is scanned on the host);
    the device emissions (``waves``, None where a chunk takes host entropy)
    and the tier that held each."""

    def __init__(self, small, mags_signs, ll, dev_scan, host_resid, waves=None, tiers=None):
        B = len(small["is_const"])
        self.small = small
        self.mags_signs = mags_signs
        self.ll = ll
        self.dev_scan = dev_scan
        self.host_resid = host_resid
        self.waves = waves if waves is not None else [None] * B
        self.tiers = tiers if tiers is not None else [None] * B


def _evw_cap(n: int) -> int:
    """The hybrid decode's cap on a chunk's active (pass, word) refinement
    slots, as the reference sets it (sperr_tpu TpuDecompressor3D): a chunk
    past it is parsed in full on the host."""
    return max(1 << 16, n // 64)


class _HostParse:
    """SPECK_FLT streams of B chunks or planes of n values, parsed on the
    host: dense magnitudes and signs, q, mean, the value of each constant
    stream and the outlier corrections.

    With ``control`` (3D only, the hybrid decode) the host runs the C++
    engine's control-only parse of each stream of 1 to 32 bitplanes, and
    ``device_mags`` rebuilds those rows' magnitudes on the device (K13).
    ``route[k]`` says how row k was parsed: None (a constant stream),
    "control", or the reason for a full parse: "hybrid off", "num_bp" (0 or
    more than 32 bitplanes) or "evw_cap" (more active refinement words than
    ``_evw_cap``).  ``h2d_bytes`` counts the bytes copied to the device."""

    def __init__(self, B: int, n: int, control: bool = False):
        self.n = n
        self.mags = np.zeros((B, n), dtype=np.int32)
        self.signs = np.ones((B, n), dtype=bool)
        self.qs = np.zeros(B, dtype=np.float64)
        self.means = np.zeros(B, dtype=np.float64)
        self.consts: List[Optional[float]] = [None] * B
        self.outliers: List = [None] * B
        self.control = control
        self.spass = np.empty((B, n), dtype=np.uint8) if control else None
        # per control-parsed row: (ref_off, ref_avail, num_bp, SPECK stream)
        self.ctl: List[Optional[tuple]] = [None] * B
        self.route: List[Optional[str]] = [None] * B
        self.h2d_bytes = 0

    def rows(self, a: int, b: int) -> "_HostParse":
        """Rows a .. b-1 as a _HostParse of their own, for one device: its
        arrays are views of these, its lists copies, ``h2d_bytes`` 0."""
        part = copy.copy(self)
        for name in ("mags", "signs", "qs", "means", "spass", "consts", "outliers", "ctl", "route"):
            v = getattr(self, name)
            setattr(part, name, None if v is None else v[a:b])
        part.h2d_bytes = 0
        return part

    def parse(self, engine, k: int, cs: bytes, ndim: int, dims3) -> None:
        condi = cs[:17]
        if cond_host.is_constant(condi[0]):
            _, val = struct.unpack_from("<Qd", condi, 1)
            self.consts[k] = val
            return
        q = self.qs[k] = cond_host.retrieve_q(condi)
        (mean,) = struct.unpack_from("<d", condi, 1)
        self.means[k] = mean
        if not (q > 0.0 and np.isfinite(q) and np.isfinite(mean)):
            raise tools.StreamError(f"invalid conditioner q={q}")
        pos = 17
        num_bp = cs[pos]
        width = sp.uint_width_for_num_bitplanes(num_bp)
        full_len = sp.speck_int_stream_full_len(cs[pos : pos + 9])
        speck_len = min(full_len, len(cs) - pos)
        sbuf = cs[pos : pos + speck_len]
        if self.control and 0 < num_bp <= 32:
            # control-only parse: refinement segments skipped, their bits
            # spread on the device (device_mags)
            spass, g, roff, ravail, nbp, _ = engine.decode3d_control(sbuf, dims3, width)
            self.spass[k] = spass
            self.signs[k] = g
            self.ctl[k] = (roff, ravail, nbp, sbuf)
            self.route[k] = "control"
        else:
            m, g = engine.decode(ndim, sbuf, dims3, width)
            self.mags[k] = m.astype(np.int32)
            self.signs[k] = g
            self.route[k] = "num_bp" if self.control else "hybrid off"
        pos += speck_len
        if pos + 9 <= len(cs):
            o_len = sp.speck_int_stream_full_len(cs[pos : pos + 9])
            if len(cs) - pos == o_len:
                self.outliers[k] = outlier_mod.decode_outliers(
                    cs[pos : pos + o_len], self.n, q / 1.5, engine=engine
                )

    def parse_all(self, engine, streams, ids, ndim: int, dims3, num_threads) -> None:
        """Parse streams[k] into row k on a thread pool; a failure raises as
        the ChunkError of the smallest id in ``ids``."""

        def parse_i(k):
            try:
                self.parse(engine, k, streams[k], ndim, dims3)
            except Exception as e:  # noqa: BLE001 - reduced below
                return (ids[k], e)

        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            first_chunk_failure(pool.map(parse_i, range(len(streams))))

    def _up(self, arr: np.ndarray, device, dtype=None) -> torch.Tensor:
        """A host array on the device, its bytes counted."""
        self.h2d_bytes += arr.nbytes
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device, dtype)

    def device_mags(self, engine, device, dims3) -> torch.Tensor:
        """The (B, n) magnitudes on the device.  Rows parsed in full ship
        from the host (int16 when every magnitude allows); control-parsed
        rows are rebuilt on the device (ops/wave_unpack.py, K13 on a CUDA
        device), and a row whose active refinement words exceed
        ``_evw_cap`` is parsed in full on the host after all (the
        reference's route, sperr_tpu/parallel/batched.py:1747-1759)."""
        B, n = self.mags.shape
        rows = [k for k in range(B) if self.ctl[k] is not None]
        if not rows:
            mags = self.mags
            if mags.size and mags.max() < 32768:
                mags = mags.astype(np.int16)
            return self._up(mags, device)
        Bh = len(rows)
        # the plain version's pass window: most streams run <= 16 bitplanes
        p_cap = 16 if max(self.ctl[k][2] for k in rows) <= 16 else 32
        rof = np.zeros((Bh, 32), np.int32)
        rav = np.zeros((Bh, 32), np.int32)
        nbps = np.zeros(Bh, np.int32)
        bodies = [bytes(self.ctl[k][3][9:]) for k in rows]
        wmat = np.zeros((Bh, max(8, max((len(b) + 11) // 4 for b in bodies))), np.uint32)
        for j, k in enumerate(rows):
            roff, ravail, nbp, _ = self.ctl[k]
            rof[j, :nbp] = roff.astype(np.int64)
            rav[j, :nbp] = ravail.astype(np.int64)
            nbps[j] = nbp
            body = bodies[j]
            wrd = np.frombuffer(body + b"\0" * ((-len(body)) % 4 + 8), dtype="<u4")
            wmat[j, : wrd.size] = wrd
        rec, ovf = wup.reconstruct_mags_batched(
            self._up(self.spass if Bh == B else self.spass[rows], device),
            self._up(wmat.view(np.int32), device), self._up(rof, device),
            self._up(rav, device), self._up(nbps, device), p_cap, _evw_cap(n),
        )
        for j in np.flatnonzero(ovf.cpu().numpy()):
            k = rows[j]
            _, _, nbp, sbuf = self.ctl[k]
            m, g = engine.decode(3, sbuf, dims3, sp.uint_width_for_num_bitplanes(nbp))
            self.mags[k] = m.astype(np.int32)
            self.signs[k] = g
            self.ctl[k] = None
            self.route[k] = "evw_cap"
        live = [j for j, k in enumerate(rows) if self.ctl[k] is not None]
        if len(live) == B:
            return rec
        # merge: rows parsed in full ship up, device rows stay put
        out = torch.zeros((B, n), dtype=torch.int32, device=device)
        host = [k for k in range(B) if self.route[k] not in (None, "control")]
        if host:
            out[host] = self._up(self.mags[host], device)
        if live:
            out[[rows[j] for j in live]] = rec[live]
        return out

    def reconstruct(self, device, shape, multi_res: bool = False, engine=None, dims3=None):
        """The device half: ``_dense_decode`` (or ``_dense_decode_multires``)
        of every row, as tensors on ``device`` shaped (B,) + shape.
        ``engine`` and ``dims3`` serve the full parse of control-parsed rows
        that the device sends back."""
        args = (
            self.device_mags(engine, device, dims3),
            self._up(self.signs, device),
            self._up(self.qs, device, torch.float32),
            self._up(self.means, device, torch.float32),
            tuple(shape),
        )
        return _dense_decode_multires(*args) if multi_res else _dense_decode(*args)

    def correct(self, k: int, block: np.ndarray) -> np.ndarray:
        """Row k's reconstruction with its outlier corrections, in place."""
        if self.outliers[k] is not None:
            pos, corr = self.outliers[k]
            flat = block.reshape(-1)
            flat[pos] += corr.astype(flat.dtype)
        return block


class TorchDecompressor3D:
    """Chunked 3D decompressor: SPECK parsed on the host, reconstruction on
    ``device`` ("cuda", the default, "cuda:N" or "cpu"), or split over
    ``devices`` as ``TorchCompressor3D`` splits its batches (the volume is
    the same element for element).

    ``hybrid``: how the chunks' SPECK streams are consumed.
      None (auto): on a CUDA device, the hybrid split of sperr_tpu's
        TpuDecompressor3D: the host runs the C++ engine's control-only parse
        (LIP/LIS bits walked, refinement segments skipped) and the device
        spreads the refinement bits and rebuilds the magnitudes
        (ops/wave_unpack.py, K13).  On the CPU the full host parse runs.
      True / False: force the split (on the CPU with K13's plain version) /
        the full host parse.
    Chunks of 0 or more than 32 bitplanes, and chunks with more active
    refinement words than ``_evw_cap``, are parsed in full on the host, as
    in the reference; the output is the same either way.  After each
    decompress, ``last_hybrid_chunks`` counts the chunks rebuilt on the
    device, ``last_full_parse_chunks`` the chunks parsed in full by reason
    ("hybrid off", "num_bp", "evw_cap"), and ``last_h2d_bytes`` the bytes
    copied to the device."""

    def __init__(self, *, device=None, devices=None, num_threads: Optional[int] = None,
                 hybrid: Optional[bool] = None):
        self.devices = _device_list(device, devices)
        self.device = self.devices[0]
        self.engine = default_engine()
        self.num_threads = num_threads
        self.hybrid = hybrid
        self.hierarchy: List[np.ndarray] = []
        self.last_hybrid_chunks = 0
        self.last_full_parse_chunks: Dict[str, int] = {}
        self.last_h2d_bytes = 0

    def _hybrid_enabled(self) -> bool:
        if self.hybrid is None:
            return self.device.type == "cuda" and hasattr(self.engine, "decode3d_control")
        if self.hybrid and not hasattr(self.engine, "decode3d_control"):
            raise ValueError(f"hybrid=True needs an engine with decode3d_control; "
                             f"{type(self.engine).__name__} has none")
        return bool(self.hybrid)

    def decompress(
        self,
        stream: bytes,
        to_host: bool = True,
        multi_res: bool = False,
        only: Optional[Sequence[int]] = None,
    ):
        """Decode a container stream -> (volume, vol_dims).

        to_host=True returns a numpy f32 volume (nz, ny, nx).  to_host=False
        returns {(z0, y0, x0, lz, ly, lx): tensor on the device} of chunk
        blocks.  ``only``: chunk ids to decode (with to_host=True the volume
        outside them is uninitialized).

        multi_res=True also assembles the coarse-resolution hierarchy into
        ``self.hierarchy``, coarsest first, as
        utils.dims.coarsened_resolutions_chunked lists it (empty unless the
        chunks divide the volume and are dyadic).  It needs to_host=True and
        no ``only``."""
        if multi_res and not to_host:
            raise ValueError("multi_res decode requires to_host=True")
        if multi_res and only is not None:
            raise ValueError("multi_res decode does not support `only`")
        h = tools.parse_header(stream)
        nx, ny, nz = h.vol_dims
        chunks = chunk_volume(h.vol_dims, h.chunk_dims)
        vol = np.empty((nz, ny, nx), dtype=np.float32) if to_host else {}
        keep = None if only is None else set(int(i) for i in only)

        hierarchy: List[np.ndarray] = []
        hier_chunks: List = []
        if multi_res:
            vol_res = coarsened_resolutions_chunked(h.vol_dims, h.chunk_dims)
            chunk_res = coarsened_resolutions(h.chunk_dims)
            hierarchy = [np.empty((r[2], r[1], r[0]), dtype=np.float32) for r in vol_res]
            hier_chunks = [chunk_volume(vol_res[i], chunk_res[i]) for i in range(len(vol_res))]

        def hier_blocks(gi):
            for lev, arr in enumerate(hierarchy):
                hc = hier_chunks[lev][gi]
                yield lev, arr[hc[4] : hc[4] + hc[5], hc[2] : hc[2] + hc[3], hc[0] : hc[0] + hc[1]]

        control = self._hybrid_enabled()
        self.last_hybrid_chunks = 0
        self.last_full_parse_chunks = {}
        self.last_h2d_bytes = 0
        ndev = len(self.devices)

        def rebuild(hp: _HostParse, device, idxs, dims3) -> _HostParse:
            # one device's part of a sub-batch: reconstruction, then its
            # chunks' blocks (disjoint from every other part's)
            lx, ly, lz = dims3
            rec = hp.reconstruct(device, (lz, ly, lx), multi_res, self.engine, dims3)
            hier_np = []
            if multi_res:
                rec, hier = rec
                hier_np = [t.cpu().numpy() for t in hier]
            if to_host:
                rech = rec.cpu().numpy()
                for k, gi in enumerate(idxs):
                    c = chunks[gi]
                    zz = slice(c[4], c[4] + c[5])
                    yy = slice(c[2], c[2] + c[3])
                    xx = slice(c[0], c[0] + c[1])
                    if hp.consts[k] is not None:
                        vol[zz, yy, xx] = hp.consts[k]
                        for _, dst in hier_blocks(gi):
                            dst[...] = hp.consts[k]
                        continue
                    vol[zz, yy, xx] = hp.correct(k, rech[k])
                    for lev, dst in hier_blocks(gi):
                        dst[...] = hier_np[lev][k]
            else:
                for k, gi in enumerate(idxs):
                    c = chunks[gi]
                    key = (c[4], c[2], c[0], c[5], c[3], c[1])
                    if hp.consts[k] is not None:
                        vol[key] = torch.full(
                            (c[5], c[3], c[1]), hp.consts[k], dtype=torch.float32, device=device,
                        )
                        continue
                    block = rec[k]
                    if hp.outliers[k] is not None:
                        pos, corr = hp.outliers[k]
                        p = torch.from_numpy(np.asarray(pos, dtype=np.int64)).to(device)
                        cv = torch.from_numpy(corr.astype(np.float32)).to(device)
                        flat = block.reshape(-1)
                        flat[p] = flat[p] + cv
                    vol[key] = block
            return hp

        for (lz, ly, lx), idxs in _group_parts(chunks, _DECODE_ELEM_BUDGET, keep, ndev):
            hp = _HostParse(len(idxs), lx * ly * lz, control=control)
            streams = []
            for gi in idxs:
                off, ln = h.chunk_offsets[gi * 2], h.chunk_offsets[gi * 2 + 1]
                streams.append(stream[off : off + ln])
            hp.parse_all(self.engine, streams, idxs, 3, (lx, ly, lz), self.num_threads)
            tasks = [
                (j, functools.partial(rebuild, hp.rows(a, b), self.devices[j], idxs[a:b], (lx, ly, lz)))
                for j, (a, b) in enumerate(_split(len(idxs), ndev)) if a < b
            ]
            for part in _on_devices(ndev, tasks):
                self.last_h2d_bytes += part.h2d_bytes
                for r in part.route:
                    if r == "control":
                        self.last_hybrid_chunks += 1
                    elif r is not None:
                        self.last_full_parse_chunks[r] = self.last_full_parse_chunks.get(r, 0) + 1
        self.hierarchy = hierarchy
        return vol, h.vol_dims
