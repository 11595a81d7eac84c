"""Batched 2D codec: many equal-shaped 2D fields, dense stages on a torch device.

PyTorch port of the host-entropy path of sperr_tpu/parallel/batched2d.py
(``TpuCompressor2D(entropy="host")`` and ``TpuDecompressor2D``).  B fields
(time steps, ensemble members, z-slices) go through

    condition (mean) -> dwt2d (K2) -> q -> fused midtread quantize (K1)
    [PWE: inverse quantize -> idwt2d (K3) -> residual scan]

as one batch on the device; the dense quantized arrays return to the host,
where the shared C++ engine encodes each field with SPECK2D on a thread pool.
The decoder parses every stream on the host and reconstructs on the device
through the functions the encoder's residual simulates (K3), so the dual
certificate covers it.

Conventions are the JAX path's: ``dims = (nx, ny)``, fields are (ny, nx),
the engine codes (nx, ny, 1), and the host's exact f64 residual scans the
field as the wavelet-packet 3D transform with nz = 1, which is the 2D
transform.  Streams are reference-format 2D payloads: [10-byte header when
requested] conditioner (17 B), SPECK, [outliers]
(utilities/sperr2d.cpp:278-290).  Arithmetic is f32.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..codec import outlier as outlier_mod
from ..ops import cdf97
from ..runtime.engine import default_engine
from ..stream import tools
from .batched import (
    _DECODE_ELEM_BUDGET,
    _MODES,
    _HostParse,
    _certify_dual,
    _condi_header,
    _dense_encode_rows,
    _resolve_device,
    _residual_outliers,
    _width_for,
)

_HEADER_2D = 10


def _dense_encode2(batch: torch.Tensor, mode: str, quality: float, residual: str = "dual"):
    """batch (B, ny, nx) f32 on the device -> dict of per-field results
    (dense ``mags``/``signs``, and for PWE ``diff``/``outlier_mask``).

    The means and the PSNR search run field by field and K2, K1 and K3 take
    the whole batch, computing each line on its own, so a field's results
    do not depend on the batch it came in."""
    return _dense_encode_rows(batch, mode, quality, residual, cdf97.dwt2d, cdf97.idwt2d)


def _resid_mode(mode: str, pwe_strict) -> str:
    if mode != "pwe" or pwe_strict is False:
        return "f32"
    return "none" if pwe_strict == "f64" else "dual"


class TorchCompressor2D:
    """Batched 2D compressor: dense stages on ``device``, SPECK on the host.

    ``dims``: (nx, ny).  ``device`` is required ("cuda", "cuda:N" or "cpu").
    ``pwe_strict``: True (dual certificate: exact f64 decoders and this
    port's f32 decoder), "f64" (f64 decoders only) or False (f32 scan at
    tol).  ``with_header`` prefixes each stream with the 10-byte 2D header.
    ``compress_batch`` cuts the batch into sub-batches of at most
    ``elem_budget`` elements; ``last_uncertified_chunks`` counts the PWE
    fields of the last call whose f32-decoder bound was not certified (the
    f64 bound holds for them)."""

    def __init__(
        self,
        dims: Tuple[int, int],
        *,
        device,
        pwe_strict=True,
        with_header: bool = False,
        num_threads: Optional[int] = None,
        entropy: str = "host",
    ):
        if entropy != "host":
            raise NotImplementedError(
                f"entropy={entropy!r}: the 2D device entropy path is ROADMAP "
                "queue 1, entry 12 (quad/I-set walk and pixel emission, K14)"
            )
        if pwe_strict not in (True, False, "f64"):
            raise ValueError(f"pwe_strict must be True, False or 'f64'; got {pwe_strict!r}")
        self.dims = (int(dims[0]), int(dims[1]))
        self.device = _resolve_device(device)
        self.engine = default_engine()
        self.num_threads = num_threads
        self.pwe_strict = pwe_strict
        self.with_header = with_header
        # device working set bound, in elements per sub-batch
        self.elem_budget = 1 << 25
        self.last_uncertified_chunks = 0

    @classmethod
    def from_jax(cls, tpu_compressor2d, device) -> "TorchCompressor2D":
        """Settings of a ``sperr_tpu`` ``TpuCompressor2D`` that runs the
        host-entropy path (``entropy="host"``, no mesh, f32)."""
        t = tpu_compressor2d
        if t.entropy != "host":
            raise NotImplementedError(f"entropy={t.entropy!r} is not ported")
        if t.mesh is not None:
            raise NotImplementedError("a device mesh is not ported (ROADMAP queue 1, entry 13)")
        if np.dtype(t.dtype) != np.float32:
            raise NotImplementedError(f"dtype {np.dtype(t.dtype)} is not ported")
        out = cls(
            t.dims, device=device, pwe_strict=t.pwe_strict,
            with_header=t.with_header, num_threads=t.num_threads,
        )
        out.elem_budget = t.elem_budget
        return out

    def compress(self, field: np.ndarray, mode: str, quality: float) -> bytes:
        return self.compress_batch(np.asarray(field)[None], mode, quality)[0]

    def compress_batch(self, fields: np.ndarray, mode: str, quality: float) -> List[bytes]:
        """fields (B, ny, nx) -> B streams, in order."""
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}; got {mode!r}")
        nx, ny = self.dims
        fields = np.asarray(fields)
        is_float = fields.dtype == np.float32
        fields = fields.reshape(-1, ny, nx)
        bmax = max(1, self.elem_budget // (nx * ny))
        streams: List[bytes] = []
        uncertified = 0
        for s0 in range(0, fields.shape[0], bmax):
            part, unc = self._compress_part(fields[s0 : s0 + bmax], mode, float(quality), is_float)
            streams.extend(part)
            uncertified += unc
        self.last_uncertified_chunks = uncertified
        return streams

    def _compress_part(self, fields, mode: str, quality: float, is_float: bool):
        nx, ny = self.dims
        n = nx * ny
        B = fields.shape[0]
        batch = np.ascontiguousarray(fields, dtype=np.float32)
        resid_mode = _resid_mode(mode, self.pwe_strict)
        res = _dense_encode2(torch.from_numpy(batch).to(self.device), mode, quality, resid_mode)
        dense = {k: v.cpu().numpy() for k, v in res.items()}
        del res
        budget = int(quality * n) if mode == "rate" else 0
        hdr = tools.generate_2d_header(self.dims, is_float) if self.with_header else b""
        uncertified = [0] * B

        def encode_one(k: int) -> bytes:
            if bool(dense["is_const"][k]):
                return hdr + _condi_header(True, float(dense["v0"][k]), n, 0.0, 0.0)
            # strict PWE stores the reference's exact f64 q = 1.5*tol
            q = 1.5 * quality if resid_mode in ("none", "dual") else float(dense["q"][k])
            mean = float(dense["mean"][k])
            condi = _condi_header(False, 0.0, 0, mean, q)
            mags, signs = dense["mags"][k], dense["signs"][k]
            body = self.engine.encode(
                2, mags, signs, (nx, ny, 1), _width_for(int(dense["maxmag"][k])), budget
            )
            if mode != "pwe":
                return hdr + condi + body

            def exact_scan(tol):
                # the exact f64 decoder-visible residual, on the host
                mg = mags.astype(np.int64)
                ll = np.where(signs, mg, -mg)
                orig = np.asarray(batch[k], dtype=np.float64).ravel()
                return _residual_outliers(ll, (nx, ny, 1), q, mean, orig, tol)

            if resid_mode == "none":
                pos, errs = exact_scan(quality)
            else:
                # the device's f32 residual scan
                pos = np.flatnonzero(dense["outlier_mask"][k])
                errs = np.asarray(dense["diff"][k][pos], dtype=np.float64)
                if resid_mode == "dual":
                    eta = float(dense["eta_sim"][k])
                    kappa = float(dense["kappa"][k])
                    pos64, errs64 = exact_scan(quality - kappa)
                    pos, errs, cert_ok = _certify_dual(pos64, errs64, pos, errs, quality, eta, q)
                    if not (cert_ok and eta <= 0.125 * quality):
                        uncertified[k] = 1
            out_stream = b""
            if len(pos):
                out_stream = outlier_mod.encode_outliers(pos, errs, n, quality)
            return hdr + condi + body + out_stream

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            streams = list(pool.map(encode_one, range(B)))
        return streams, sum(uncertified)


class TorchDecompressor2D:
    """Batched 2D decompressor: SPECK parsed on the host, reconstruction
    (K3) on ``device`` ("cuda", "cuda:N" or "cpu"; required).

    After a ``multi_res`` decode, ``hierarchy[k]`` holds field k's coarse
    reconstructions, coarsest first, as utils.dims.coarsened_resolutions
    lists them (with the mean, without outlier corrections)."""

    def __init__(self, dims: Tuple[int, int], *, device, num_threads: Optional[int] = None):
        self.dims = (int(dims[0]), int(dims[1]))
        self.device = _resolve_device(device)
        self.engine = default_engine()
        self.num_threads = num_threads
        self.hierarchy: List[List[np.ndarray]] = []

    def decompress(self, stream: bytes, multi_res: bool = False, with_header: bool = False) -> np.ndarray:
        return self.decompress_batch([stream], multi_res=multi_res, with_header=with_header)[0]

    def decompress_batch(
        self, streams: List[bytes], multi_res: bool = False, with_header: bool = False
    ) -> List[np.ndarray]:
        """B streams -> B f32 fields (ny, nx); ``with_header``: each stream
        starts with the 10-byte 2D header, which must name ``dims``."""
        nx, ny = self.dims
        n = nx * ny
        bodies = []
        for cs in streams:
            cs = bytes(cs)
            if with_header:
                hdims, _ = tools.parse_2d_header(cs)
                if hdims != (nx, ny):
                    raise tools.StreamError(f"2D header dims {hdims} differ from {(nx, ny)}")
                cs = cs[_HEADER_2D:]
            bodies.append(cs)

        out: List[np.ndarray] = []
        self.hierarchy = []
        bmax = max(1, _DECODE_ELEM_BUDGET // n)
        for s0 in range(0, len(bodies), bmax):
            part = bodies[s0 : s0 + bmax]
            hp = _HostParse(len(part), n)
            hp.parse_all(self.engine, part, list(range(s0, s0 + len(part))), 2, (nx, ny, 1), self.num_threads)
            rec = hp.reconstruct(self.device, (ny, nx), multi_res)
            hier_np = []
            if multi_res:
                rec, hier = rec
                hier_np = [t.cpu().numpy() for t in hier]
            rech = rec.cpu().numpy()
            for k in range(len(part)):
                if hp.consts[k] is not None:
                    out.append(np.full((ny, nx), hp.consts[k], dtype=np.float32))
                    self.hierarchy.append(
                        [np.full(h.shape[1:], hp.consts[k], dtype=np.float32) for h in hier_np]
                    )
                    continue
                out.append(hp.correct(k, rech[k]))
                self.hierarchy.append([h[k] for h in hier_np])
        return out
