"""Chunked 3D codec with the dense stages on a torch device and SPECK on the host.

PyTorch port of the dense-transfer path of sperr_tpu/parallel/batched.py
(``TpuCompressor3D(entropy="host", transfer="dense")`` and the full host-parse
branch of ``TpuDecompressor3D``).  Per chunk, the device runs

    condition (mean) -> dwt3d -> q -> fused midtread quantize (K1)
    [PWE: inverse quantize -> idwt3d -> residual scan]

and the dense quantized arrays return to the host, where the shared C++
engine encodes each chunk on a thread pool.  The decoder parses every chunk
on the host and reconstructs on the device through the same functions that
the encoder's residual scan simulates, so that scan certifies this decoder.

Streams are SPERR format, as the reference's.  Arithmetic is f32.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sperr_tpu.codec import outlier as outlier_mod
from sperr_tpu.codec import speck_int_np as sp
from sperr_tpu.errors import first_chunk_failure
from sperr_tpu.ops import condition as cond_host
from sperr_tpu.runtime.engine import default_engine
from sperr_tpu.stream import tools
from sperr_tpu.utils.dims import chunk_volume, coarsened_resolutions, coarsened_resolutions_chunked
from sperr_tpu.utils.packing import pack_8_booleans

from ..ops import cdf97
from ..ops import quantize as qz

_MODES = ("psnr", "pwe", "rate")
_EPS32 = float(np.finfo(np.float32).eps)
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


# ---------------------------------------------------------------------------
# Device-side dense stages
# ---------------------------------------------------------------------------
def _per_row(fn, *rows: torch.Tensor) -> torch.Tensor:
    """fn applied to each row of the (B, ...) arguments on its own: a float
    reduction then runs the same way whatever the batch holds."""
    return torch.cat([fn(*(r[b : b + 1] for r in rows)) for b in range(rows[0].shape[0])])


def _dense_encode_rows(batch: torch.Tensor, mode: str, quality: float, residual: str,
                       forward, inverse_):
    """The dense front on batch (B, ...): condition -> ``forward`` -> q ->
    quantize (K1) [PWE: inverse quantize -> ``inverse_`` (in place) ->
    residual].  Float reductions run row by row; the transforms and K1 take
    the whole batch, and every line of them is computed on its own."""
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
        q = _per_row(lambda c, r: qz.estimate_q_psnr_batched(c, r, quality), coeffs, rng)
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
            out["outlier_mask"] = torch.abs(diff) > thr
        else:
            diff = conditioned - rec
            out["outlier_mask"] = torch.abs(diff) > float(f32(quality))
        out["diff"] = diff
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


def _inverse(shape, multi_res: bool):
    if len(shape) == 3:
        return cdf97.idwt3d_multi_res if multi_res else cdf97.idwt3d_
    return cdf97.idwt2d_multi_res if multi_res else cdf97.idwt2d_


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
_NATIVE_RESID = None  # cached: native binding, or False if unavailable


def _residual_outliers(ll, dims3, q, mean, orig, tol):
    """Strict-PWE outlier set: positions/errors where the exact f64 decode
    reconstruction misses `orig` by more than `tol` (ascending positions,
    the reference's scan order, SPECK_FLT.cpp:461-486)."""
    global _NATIVE_RESID
    if _NATIVE_RESID is None:
        try:
            from sperr_tpu.runtime.native import residual_outliers as nat

            _NATIVE_RESID = nat
        except Exception:
            _NATIVE_RESID = False
    if _NATIVE_RESID:
        return _NATIVE_RESID(ll, dims3, q, mean, orig, tol)
    from sperr_tpu.ops import cdf97_np

    lx, ly, lz = dims3
    rec = (q * np.asarray(ll, dtype=np.float64)).reshape(lz, ly, lx)
    rec = cdf97_np.idwt3d(rec).ravel()
    err = (orig - mean) - rec
    pos = np.flatnonzero(np.abs(err) > tol)
    return pos, err[pos]


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


def _group_parts(chunks, elem_budget: int, keep=None):
    """Chunk indices grouped by shape (lz, ly, lx), each group cut into
    sub-batches of at most ``elem_budget`` elements (at least one chunk)."""
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for i, c in enumerate(chunks):
        if keep is None or i in keep:
            groups.setdefault((c[5], c[3], c[1]), []).append(i)
    parts = []
    for shape, idxs in groups.items():
        bmax = max(1, int(elem_budget // max(1, shape[0] * shape[1] * shape[2])))
        for s0 in range(0, len(idxs), bmax):
            parts.append((shape, idxs[s0 : s0 + bmax]))
    return parts


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------
class TorchCompressor3D:
    """Chunked 3D compressor: dense stages on ``device``, SPECK on the host.

    ``device`` is required ("cuda", "cuda:N" or "cpu"); "cuda" without a GPU
    raises.  ``pwe_strict`` selects how the PWE bound is certified, as in
    ``TpuCompressor3D``: True (dual: exact f64 and this port's f32 decoder),
    "f64" (f64 decoders only), "device" (margin scan; the dense path
    certifies on the host) or False (f32 scan at tol).

    After each compress, ``last_uncertified_chunks`` counts the PWE chunks
    whose f32-decoder bound could not be certified (the f64 bound holds for
    them) and ``last_uncertified_ids`` names them in chunk order.
    """

    def __init__(
        self,
        vol_dims: Tuple[int, int, int],
        chunk_dims: Tuple[int, int, int] = (256, 256, 256),
        *,
        device,
        num_threads: Optional[int] = None,
        pwe_strict=True,
        entropy: str = "host",
        transfer: str = "dense",
    ):
        if entropy != "host":
            raise NotImplementedError(
                f"entropy={entropy!r}: the device entropy path is ROADMAP "
                "queue 1, entries 5-8 (packemit, schedule, set walk, wave emit)"
            )
        if transfer != "dense":
            raise NotImplementedError(
                f"transfer={transfer!r}: the sparse transfer is ROADMAP "
                "queue 1, entry 15 (left out unless a measurement asks for it)"
            )
        if pwe_strict not in (True, False, "f64", "device"):
            raise ValueError(f"pwe_strict must be True, False, 'f64' or 'device'; got {pwe_strict!r}")
        self.vol_dims = tuple(int(d) for d in vol_dims)
        self.chunk_dims = tuple(
            min(max(1, int(chunk_dims[i])), self.vol_dims[i]) for i in range(3)
        )
        self.device = _resolve_device(device)
        self.engine = default_engine()
        self.num_threads = num_threads
        self.pwe_strict = pwe_strict
        # device working set bound, in elements per sub-batch (the dense
        # path keeps ~6x the input bytes on the device)
        self.dense_elem_budget = 1 << 28
        self.last_uncertified_chunks = 0
        self.last_uncertified_ids: List[int] = []

    @classmethod
    def from_jax(cls, tpu_compressor, device) -> "TorchCompressor3D":
        """Settings of a ``sperr_tpu`` ``TpuCompressor3D`` that runs the dense
        host-entropy path (``entropy="host"``, ``transfer="dense"``, no mesh)."""
        t = tpu_compressor
        if t.entropy != "host":
            raise NotImplementedError(f"entropy={t.entropy!r} is not ported")
        if t.transfer != "dense":
            raise NotImplementedError(f"transfer={t.transfer!r} is not ported")
        if t.mesh is not None:
            raise NotImplementedError("a device mesh is not ported (ROADMAP queue 1, entry 13)")
        if np.dtype(t.dtype) != np.float32:
            raise NotImplementedError(f"dtype {np.dtype(t.dtype)} is not ported")
        out = cls(
            t.vol_dims, t.chunk_dims, device=device,
            num_threads=t.num_threads, pwe_strict=t.pwe_strict,
        )
        out.dense_elem_budget = t.dense_elem_budget
        return out

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

        streams: List[Optional[bytes]] = [None] * len(chunks)
        uncertified = [0] * len(chunks)
        for (lz, ly, lx), idxs in _group_parts(chunks, self.dense_elem_budget):
            n = lx * ly * lz
            batch = np.stack(
                [np.ascontiguousarray(loader(chunks[i])) for i in idxs]
            ).astype(np.float32)
            dev = torch.from_numpy(batch).to(self.device)
            res = _dense_encode(dev, mode, quality, resid_mode)
            dense = {k: v.cpu().numpy() for k, v in res.items()}
            del dev, res
            budget = int(quality * n) if mode == "rate" else 0

            def encode_one(k: int) -> bytes:
                gi = idxs[k]
                if bool(dense["is_const"][k]):
                    return _condi_header(True, float(dense["v0"][k]), n, 0.0, 0.0)
                # strict/margin PWE store the reference's exact f64
                # q = 1.5*tol (SPECK_FLT.cpp:281) in the header
                q = (
                    1.5 * quality
                    if mode == "pwe" and resid_mode in ("none", "margin", "dual")
                    else float(dense["q"][k])
                )
                mean = float(dense["mean"][k])
                condi = _condi_header(False, 0.0, 0, mean, q)
                mags, signs = dense["mags"][k], dense["signs"][k]
                body = self.engine.encode(
                    3, mags, signs, (lx, ly, lz), _width_for(int(dense["maxmag"][k])), budget
                )
                if mode != "pwe":
                    return condi + body

                def ll_row():
                    mg = mags.astype(np.int64)
                    return np.where(signs, mg, -mg)

                def orig_row():
                    return np.ascontiguousarray(loader(chunks[gi]), dtype=np.float64).ravel()

                def dev_scan():
                    p = np.flatnonzero(dense["outlier_mask"][k])
                    return p, np.asarray(dense["diff"][k][p], dtype=np.float64)

                if resid_mode == "dual":
                    eta = float(dense["eta_sim"][k])
                    kappa = float(dense["kappa"][k])
                    pos64, errs64 = _residual_outliers(
                        ll_row(), (lx, ly, lz), q, mean, orig_row(), quality - kappa
                    )
                    pos32, errs32 = dev_scan()
                    pos, errs, cert_ok = _certify_dual(
                        pos64, errs64, pos32, errs32, quality, eta, q
                    )
                    if not (cert_ok and eta <= 0.125 * quality):
                        uncertified[gi] = 1
                elif resid_mode in ("none", "margin"):
                    # exact f64 decoder-visible residual on the host
                    pos, errs = _residual_outliers(
                        ll_row(), (lx, ly, lz), q, mean, orig_row(), quality
                    )
                else:
                    pos, errs = dev_scan()
                out_stream = b""
                if pos.size:
                    out_stream = outlier_mod.encode_outliers(pos, errs, n, quality)
                return condi + body + out_stream

            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                for k, s in enumerate(pool.map(encode_one, range(len(idxs)))):
                    streams[idxs[k]] = s

        self.last_uncertified_chunks = sum(uncertified)
        self.last_uncertified_ids = [i for i, u in enumerate(uncertified) if u]
        return streams


class _HostParse:
    """SPECK_FLT streams of B chunks or planes of n values, parsed on the
    host: dense magnitudes and signs, q, mean, the value of each constant
    stream and the outlier corrections."""

    def __init__(self, B: int, n: int):
        self.n = n
        self.mags = np.zeros((B, n), dtype=np.int32)
        self.signs = np.ones((B, n), dtype=bool)
        self.qs = np.zeros(B, dtype=np.float64)
        self.means = np.zeros(B, dtype=np.float64)
        self.consts: List[Optional[float]] = [None] * B
        self.outliers: List = [None] * B

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
        width = sp.uint_width_for_num_bitplanes(cs[pos])
        full_len = sp.speck_int_stream_full_len(cs[pos : pos + 9])
        speck_len = min(full_len, len(cs) - pos)
        m, g = engine.decode(ndim, cs[pos : pos + speck_len], dims3, width)
        self.mags[k] = m.astype(np.int32)
        self.signs[k] = g
        pos += speck_len
        if pos + 9 <= len(cs):
            o_len = sp.speck_int_stream_full_len(cs[pos : pos + 9])
            if len(cs) - pos == o_len:
                self.outliers[k] = outlier_mod.decode_outliers(cs[pos : pos + o_len], self.n, q / 1.5)

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

    def reconstruct(self, device, shape, multi_res: bool = False):
        """The device half: ``_dense_decode`` (or ``_dense_decode_multires``)
        of every row, as tensors on ``device`` shaped (B,) + shape."""
        mags = self.mags
        # narrow the host->device transfer when magnitudes allow
        if mags.size and mags.max() < 32768:
            mags = mags.astype(np.int16)
        args = (
            torch.from_numpy(mags).to(device),
            torch.from_numpy(self.signs).to(device),
            torch.from_numpy(self.qs).to(device, torch.float32),
            torch.from_numpy(self.means).to(device, torch.float32),
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
    ``device`` ("cuda", "cuda:N" or "cpu"; required)."""

    def __init__(self, *, device, num_threads: Optional[int] = None):
        self.device = _resolve_device(device)
        self.engine = default_engine()
        self.num_threads = num_threads
        self.hierarchy: List[np.ndarray] = []

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

        for (lz, ly, lx), idxs in _group_parts(chunks, _DECODE_ELEM_BUDGET, keep):
            hp = _HostParse(len(idxs), lx * ly * lz)
            streams = []
            for gi in idxs:
                off, ln = h.chunk_offsets[gi * 2], h.chunk_offsets[gi * 2 + 1]
                streams.append(stream[off : off + ln])
            hp.parse_all(self.engine, streams, idxs, 3, (lx, ly, lz), self.num_threads)
            rec = hp.reconstruct(self.device, (lz, ly, lx), multi_res)
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
                            (c[5], c[3], c[1]), hp.consts[k], dtype=torch.float32,
                            device=self.device,
                        )
                        continue
                    block = rec[k]
                    if hp.outliers[k] is not None:
                        pos, corr = hp.outliers[k]
                        p = torch.from_numpy(np.asarray(pos, dtype=np.int64)).to(self.device)
                        cv = torch.from_numpy(corr.astype(np.float32)).to(self.device)
                        flat = block.reshape(-1)
                        flat[p] = flat[p] + cv
                    vol[key] = block
        self.hierarchy = hierarchy
        return vol, h.vol_dims
