"""Batched 2D codec: many equal-shaped 2D fields, dense stages on a torch device.

PyTorch port of sperr_tpu/parallel/batched2d.py (``TpuCompressor2D`` with
``entropy="host"`` or ``"wave"``, and ``TpuDecompressor2D``).  B fields
(time steps, ensemble members, z-slices) go through

    condition (mean) -> dwt2d (K2) -> q -> fused midtread quantize (K1)
    [PWE: inverse quantize -> idwt2d (K3) -> residual scan]

as one batch on the device.  With ``entropy="host"`` the quantized values
return to the host, where the shared C++ engine encodes each field with
SPECK2D on a thread pool: the sparse transfer (the default, as the
reference's only one) compacts each field's nonzeros and outliers on the
device first (K12) and copies only those, the dense transfer copies the
dense arrays.  With ``entropy="wave"`` the device also
computes every SPECK bit of each field (K14: the child-table schedule,
ops/speck.py; the pixel emission, ops/wave_pack.wave_emit_2d_pixels; the
quad/I-set walk, ops/speck_lis2.py) through a ladder of event caps, and the
host only concatenates the packed segments (codec/speck_wave.stitch_2d);
both write the same bytes.  The decoder parses every stream on the host and
reconstructs on the device through the functions the encoder's residual
simulates (K3), so the dual certificate covers it.

Conventions are the JAX path's: ``dims = (nx, ny)``, fields are (ny, nx),
the engine codes (nx, ny, 1), and the host's exact f64 residual scans the
field as the wavelet-packet 3D transform with nz = 1, which is the 2D
transform.  A batch can be split over several devices (``devices=``), as
the 3D drivers split theirs.  Streams are reference-format 2D payloads:
[10-byte header when requested] conditioner (17 B), SPECK, [outliers]
(utilities/sperr2d.cpp:278-290).  Arithmetic is f32.
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codec import outlier as outlier_mod
from ..codec import speck_wave as sw
from ..ops import cdf97
from ..ops import speck as spk
from ..ops import speck_lis2 as sl2
from ..ops import wave_pack as wp
from ..runtime.engine import default_engine
from ..stream import tools
from .batched import (
    _DECODE_ELEM_BUDGET,
    _MODES,
    _Group,
    _HostParse,
    _certify_dual,
    _condi_header,
    _dense_encode_rows,
    _device_list,
    _index_lock,
    _nonzeros,
    _on_devices,
    _placement,
    _residual_outliers,
    _split,
    _trim,
    _views,
    _width_for,
)

_HEADER_2D = 10


def _dense_encode2(batch: torch.Tensor, mode: str, quality: float, residual: str = "dual"):
    """batch (B, ny, nx) f32 on the device -> dict of per-field results
    (dense ``mags``/``signs``, and for PWE ``diff``/``outlier_mask``).

    The means run field by field; K2, the PSNR search (K16), K1 and K3
    take the whole batch, computing each field or line on its own, so a
    field's results do not depend on the batch it came in."""
    return _dense_encode_rows(batch, mode, quality, residual, cdf97.dwt2d, cdf97.idwt2d)


def _dense_encode2_sparse(batch: torch.Tensor, mode: str, quality: float, cap: int, out_cap: int,
                          residual: str = "dual"):
    """The sparse program on batch (B, ny, nx) (sperr_tpu ``_dense_encode2``):
    the front with the outliers' first min(out_cap, n) indices, their values
    and ``n_out`` (K12), then the nonzero compaction (``_nonzeros``, K12:
    ``idx``, ``vals``, ``nnz``) in place of the dense magnitudes and signs.
    The whole batch goes through each stage, as in ``_dense_encode2``.  A
    constant field has no nonzeros, as in the reference: its values are never
    read, and in PSNR and rate modes its zero range leaves q = 0."""
    n = batch[0].numel()
    out = _dense_encode_rows(batch, mode, quality, residual, cdf97.dwt2d, cdf97.idwt2d,
                             out_cap=min(out_cap, n))
    mags = torch.where(out["is_const"][:, None], 0, out.pop("mags"))
    out["idx"], out["vals"], out["nnz"] = _nonzeros(mags, out.pop("signs"), cap)
    return out


def _resid_mode(mode: str, pwe_strict) -> str:
    if mode != "pwe" or pwe_strict is False:
        return "f32"
    return "none" if pwe_strict == "f64" else "dual"


def _wave_caps2(n: int, num_bp_cap: int, node_cap: int, ev_cap: int) -> Dict[str, int]:
    """The static caps of one tier of the 2D device entropy program, integer
    for integer those that sperr_tpu's ``_dense_encode2_wave`` derives when
    ``TpuCompressor2D`` calls it (``wave_cap`` = n): the walk's node and
    event caps and its segment bytes; the pixel classes' bitplane cap
    (fields with more bitplanes take the host engine), exposure cap (0: no
    compaction), pieces and output bytes."""
    px_bp = min(num_bp_cap, 18)
    px_cells = px_bp * 3 * (-(-n // 256) * 256)
    return dict(
        node_cap=node_cap, ev_cap=ev_cap, cap_total=min(n, (2 * n * (num_bp_cap + 4)) // 8 + 8),
        px_bp=px_bp, wexp_px=0, px_evb=px_cells // 256,
        px_out=min(((px_cells // 8 + 2 * px_bp) // 4 + 1) * 4, 4 * n),
    )


def _wave_index2(dims2, device):
    """(child-table schedule index, walk index, quad/I-set tree) of fields of
    dims2 = (nx, ny) on device, each made once and cached."""
    with _index_lock(dims2):
        return spk.tree_index(dims2, device), sl2.lis2_index(dims2, device), sw.build_tree2(dims2)


def _wave_emit_field(mags: torch.Tensor, signs: torch.Tensor, index, caps: Dict[str, int],
                     num_bp_cap: int) -> Dict[str, torch.Tensor]:
    """The 2D device entropy program of one field at one tier (sperr_tpu's
    ``_dense_encode2_wave`` per field): the child-table schedule with num_bp
    and the I-set passes (``sched_table``, no pm) -> LIP and refinement
    emission (K9's planes launch with no payload, K11) -> node passes
    (``node_passes``) -> quad/I-set walk (kernels/walk_table.cu, K12
    compactions, the radix sort) -> its payload words' LIS planes (K9's
    planes launch with no pixel field) packed by K11.  On a CUDA tensor
    every launch from the schedule to K11's last is a hand kernel.  Every
    result stays on the device; ``px_over`` includes num_bp past the pixel
    classes' bitplane cap."""
    ti, li2, tree2 = index
    num_bp, s, e, nm, iset_s = spk.schedule_table(mags, ti, iset_regions=tree2.iset_regions[: tree2.xf + 1])
    px, px_c, px_total, px_over = wp.wave_emit_2d_pixels(
        mags, signs, s, e, num_bp, caps["px_bp"], caps["px_evb"], caps["px_out"], caps["wexp_px"]
    )
    node_s = spk.node_passes(nm, num_bp)
    pay_s, n_sig = sl2.lis2_segments_device(
        node_s, s, signs, num_bp, iset_s, li2, num_bp_cap, caps["node_cap"], caps["ev_cap"],
        caps["cap_total"], return_events="items",
    )
    lis, lis_c, lis_total, n_sig = wp.wave_emit_2d_lis(pay_s, n_sig, num_bp, num_bp_cap, caps["ev_cap"],
                                                       caps["cap_total"])
    return dict(num_bp=num_bp.to(torch.int32), px=px, px_c=px_c, px_total=px_total,
                px_over=px_over | (num_bp > caps["px_bp"]), lis=lis, lis_c=lis_c,
                lis_total=lis_total, n_sig=n_sig)


class TorchCompressor2D:
    """Batched 2D compressor: dense stages on ``device``, SPECK on the host
    (``entropy="host"``) or on the device (``entropy="wave"``).

    ``dims``: (nx, ny).  ``device``: "cuda" (the default; raises without a
    GPU), "cuda:N" or "cpu"; or ``devices``, a list of devices that each
    sub-batch is split over in contiguous parts, one host thread per device
    (a device may appear more than once; the streams are the same).
    ``pwe_strict``: True (dual certificate: exact f64 decoders and this
    port's f32 decoder), "f64" (f64 decoders only) or False (f32 scan at
    tol).  ``with_header`` prefixes each stream with the
    10-byte 2D header.  ``compress_batch`` cuts the batch into sub-batches
    of at most ``elem_budget`` elements.

    With ``entropy="wave"`` each field's SPECK bits are computed on the
    device at the event caps ``wave_event_tiers`` (multiples of the pixel
    count): the first tier runs every field, and the fields that overflow
    it retry one at a time at the next.  Constant fields, fields with more
    than 18 bitplanes (the pixel classes' cap; they cannot fit any tier)
    and fields past the last tier take the host engine; both routes write
    the same bytes.

    ``transfer``: how the quantized values reach the host.  "sparse" (the
    default; sperr_tpu's ``TpuCompressor2D`` always compacts) compacts each
    field's nonzeros (at most ``cap`` = max(1024, min(n, n *
    ``sparse_cap_frac``))) and its device-scanned outliers (at most
    ``out_cap``: n at ``sparse_cap_frac`` >= 1, else max(256, n / 16)) on the
    device (K12) and copies them trimmed to the part's largest counts; on
    the wave route only the fields whose values the host needs (those that
    take the host engine, and PWE fields under the dual or f64 certificate)
    are compacted and copied.  A field past a cap raises ``ValueError``, as
    the reference does; at the default ``sparse_cap_frac`` of 1.0 none can
    be.  "dense" copies the dense magnitudes, signs, outlier mask and
    residual of every field (host route) or each such field's dense signed
    row (wave route).  Both transfers write the same streams.

    After each compress, ``last_uncertified_chunks`` counts the PWE fields
    whose f32-decoder bound was not certified (the f64 bound holds for
    them); ``last_wave_chunks`` counts the fields the device entropy path
    encoded and ``last_wave_tiers`` names the tier (0-based) that held each,
    or None; ``last_d2h_bytes`` counts the bytes copied from the device to
    the host."""

    def __init__(
        self,
        dims: Tuple[int, int],
        *,
        device=None,
        devices=None,
        pwe_strict=True,
        with_header: bool = False,
        num_threads: Optional[int] = None,
        entropy: str = "host",
        transfer: str = "sparse",
    ):
        if entropy not in ("host", "wave"):
            raise ValueError(f"entropy must be 'host' or 'wave'; got {entropy!r}")
        if transfer not in ("sparse", "dense"):
            raise ValueError(f"transfer must be 'sparse' or 'dense'; got {transfer!r}")
        if pwe_strict not in (True, False, "f64"):
            raise ValueError(f"pwe_strict must be True, False or 'f64'; got {pwe_strict!r}")
        self.dims = (int(dims[0]), int(dims[1]))
        self.devices = _device_list(device, devices)
        self.device = self.devices[0]
        self.engine = default_engine()
        self.num_threads = num_threads
        self.pwe_strict = pwe_strict
        self._count_lock = threading.Lock()
        self.with_header = with_header
        self.entropy = entropy
        self.transfer = transfer
        # the sparse transfer's caps, as a fraction of n (the reference's:
        # exact, no field can pass them)
        self.sparse_cap_frac = 1.0
        # device working set bound, in elements per sub-batch
        self.elem_budget = 1 << 25
        self.num_bp_cap = 34
        # event caps of the wave path's tiers, in multiples of the pixel count
        self.wave_event_tiers = (1.25, 3, 8)
        self.last_uncertified_chunks = 0
        self.last_wave_chunks = 0
        self.last_wave_tiers: List[Optional[int]] = []
        self.last_d2h_bytes = 0

    @classmethod
    def from_jax(cls, tpu_compressor2d, device) -> "TorchCompressor2D":
        """Settings of a ``sperr_tpu`` ``TpuCompressor2D`` (either entropy,
        f32; the sparse transfer, its only one).  ``device``: one device, or
        a list of devices that its mesh, if it has one, maps onto
        (``devices=``).  Its ``pwe_strict="device"``, which it certifies as
        the dual certificate, maps to True."""
        t = tpu_compressor2d
        if np.dtype(t.dtype) != np.float32:
            raise NotImplementedError(f"dtype {np.dtype(t.dtype)} is not ported")
        out = cls(
            t.dims, **_placement(device), pwe_strict=True if t.pwe_strict == "device" else t.pwe_strict,
            with_header=t.with_header, num_threads=t.num_threads, entropy=t.entropy,
        )
        out.sparse_cap_frac = t.sparse_cap_frac
        out.elem_budget = t.elem_budget
        out.num_bp_cap = t.num_bp_cap
        out.wave_event_tiers = tuple(t.wave_event_tiers)
        return out

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        with self._count_lock:
            self.last_d2h_bytes += t.numel() * t.element_size()
        return t.cpu().numpy()

    def _sparse_caps(self, n: int) -> Tuple[int, int]:
        """(cap, out_cap) of the sparse transfer for n-pixel fields, as the
        reference sizes them."""
        frac = self.sparse_cap_frac
        return max(1024, min(n, int(n * frac))), (n if frac >= 1.0 else max(256, n // 16))

    @staticmethod
    def _check_caps(small, cap: int, out_cap: int) -> None:
        """The reference's refusal of a part with a field past a cap."""
        nnz = small["nnz"]
        n_out = small.get("n_out")
        if (nnz > cap).any() or (n_out is not None and (n_out > out_cap).any()):
            raise ValueError(
                "2D compaction capacity exceeded; raise sparse_cap_frac "
                f"(nnz max {int(nnz.max())} > cap {cap} or outliers "
                f"{int(n_out.max()) if n_out is not None else 0} > {out_cap})"
            )

    def _wave_fits(self, wave, k: int, n: int) -> bool:
        """True when field row k's device emission fit every cap."""
        nc, evc, wc = wave["caps"]
        cap_total = min(n, (2 * wc * (self.num_bp_cap + 4)) // 8 + 8)
        return (
            int(wave["n_sig"][k]) <= nc
            and not bool(wave["px_over"][k])
            and int(wave["num_bp"][k]) <= min(self.num_bp_cap, 18)
            and int(wave["lis_total"][k]) <= cap_total
        )

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
        ndev = len(self.devices)
        if bmax > ndev:
            bmax -= bmax % ndev  # sub-batches that the devices divide
        streams: List[bytes] = []
        uncertified = 0
        tiers: List[Optional[int]] = []
        self.last_d2h_bytes = 0
        for s0 in range(0, fields.shape[0], bmax):
            part, unc, part_tiers = self._compress_part(fields[s0 : s0 + bmax], mode, float(quality), is_float)
            streams.extend(part)
            uncertified += unc
            tiers.extend(part_tiers)
        self.last_uncertified_chunks = uncertified
        self.last_wave_tiers = tiers
        self.last_wave_chunks = sum(t is not None for t in tiers)
        return streams

    def _compress_part(self, fields, mode: str, quality: float, is_float: bool):
        nx, ny = self.dims
        n = nx * ny
        B = fields.shape[0]
        batch = np.ascontiguousarray(fields, dtype=np.float32)
        resid_mode = _resid_mode(mode, self.pwe_strict)
        # one contiguous part of the fields per device; field i is row
        # i - a of its part's group
        ndev = len(self.devices)
        parts = [(j, a, b) for j, (a, b) in enumerate(_split(B, ndev)) if a < b]
        groups = _on_devices(ndev, [
            (j, functools.partial(self._device_stage, self.devices[j], batch[a:b], mode, quality, resid_mode))
            for j, a, b in parts
        ])
        row = [(g, i - a) for g, (_, a, b) in zip(groups, parts) for i in range(a, b)]
        budget = int(quality * n) if mode == "rate" else 0
        hdr = tools.generate_2d_header(self.dims, is_float) if self.with_header else b""
        uncertified = [0] * B
        wave_tier: List[Optional[int]] = [None] * B

        def encode_one(i: int) -> bytes:
            g, k = row[i]
            if bool(g.small["is_const"][k]):
                return hdr + _condi_header(True, float(g.small["v0"][k]), n, 0.0, 0.0)
            # strict PWE stores the reference's exact f64 q = 1.5*tol
            q = 1.5 * quality if resid_mode in ("none", "dual") else float(g.small["q"][k])
            mean = float(g.small["mean"][k])
            condi = _condi_header(False, 0.0, 0, mean, q)
            wv = g.waves[k]
            if wv is not None and self._wave_fits(wv, 0, n):
                wave_tier[i] = g.tiers[k]
                body = self._stitch_wave2(wv, 0, budget)
            else:
                mags, signs = g.mags_signs(k)
                body = self.engine.encode(
                    2, mags, signs, (nx, ny, 1), _width_for(int(g.small["maxmag"][k])), budget
                )
            if mode != "pwe":
                return hdr + condi + body

            def exact_scan(tol):
                # the exact f64 decoder-visible residual, on the host
                orig = np.asarray(batch[i], dtype=np.float64).ravel()
                return _residual_outliers(g.ll(k), (nx, ny, 1), q, mean, orig, tol)

            if resid_mode == "none":
                pos, errs = exact_scan(quality)
            else:
                # the device's f32 residual scan
                pos, errs = g.dev_scan(k)
                if resid_mode == "dual":
                    eta = float(g.small["eta_sim"][k])
                    kappa = float(g.small["kappa"][k])
                    pos64, errs64 = exact_scan(quality - kappa)
                    pos, errs, cert_ok = _certify_dual(pos64, errs64, pos, errs, quality, eta, q)
                    if not (cert_ok and eta <= 0.125 * quality):
                        uncertified[i] = 1
            out_stream = b""
            if len(pos):
                out_stream = outlier_mod.encode_outliers(pos, errs, n, quality)
            return hdr + condi + body + out_stream

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            streams = list(pool.map(encode_one, range(B)))
        return streams, sum(uncertified), wave_tier

    def _device_stage(self, device, fields: np.ndarray, mode: str, quality: float,
                      resid_mode: str) -> _Group:
        """The device stage of one part of a sub-batch on ``device``."""
        x = torch.from_numpy(fields).to(device)
        if self.entropy == "wave":
            return self._wave_group(x, mode, quality, resid_mode)
        if self.transfer == "sparse":
            return self._sparse_group(x, mode, quality, resid_mode)
        return self._dense_group(x, mode, quality, resid_mode)

    def _dense_group(self, x, mode: str, quality: float, resid_mode: str) -> _Group:
        """Host entropy: the dense results of every field go to the host."""
        dense = {k: self._to_host(v) for k, v in _dense_encode2(x, mode, quality, resid_mode).items()}

        def dev_scan(k):
            pos = np.flatnonzero(dense["outlier_mask"][k])
            return pos, np.asarray(dense["diff"][k][pos], dtype=np.float64)

        return _Group(
            dense,
            mags_signs=lambda k: (dense["mags"][k], dense["signs"][k]),
            ll=lambda k: np.where(dense["signs"][k], 1, -1) * dense["mags"][k].astype(np.int64),
            dev_scan=dev_scan,
            host_resid=lambda k: resid_mode == "none",
        )

    def _sparse_group(self, x, mode: str, quality: float, resid_mode: str) -> _Group:
        """Host entropy, sparse transfer: the sparse program's scalars, then
        its compactions trimmed to the part's largest counts; a field past a
        cap raises."""
        n = x[0].numel()
        cap, out_cap = self._sparse_caps(n)
        sp = _dense_encode2_sparse(x, mode, quality, cap, out_cap, resid_mode)
        small = {k: self._to_host(v) for k, v in sp.items() if v.dim() == 1}
        self._check_caps(small, cap, out_cap)
        nnz = small["nnz"]
        idx = _trim(self._to_host, sp["idx"], nnz, cap)
        vals = _trim(self._to_host, sp["vals"], nnz, cap)
        views = {k: (idx[k, : nnz[k]], vals[k, : nnz[k]]) for k in range(len(nnz))}
        scans: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if "n_out" in small:
            n_out = small["n_out"]
            oi = _trim(self._to_host, sp["out_idx"], n_out, out_cap)
            ov = _trim(self._to_host, sp["out_vals"], n_out, out_cap)
            scans = {k: (oi[k, : n_out[k]].astype(np.int64), ov[k, : n_out[k]].astype(np.float64))
                     for k in range(len(n_out))}
        mags_signs, ll = _views(n, views)
        return _Group(
            small, mags_signs=mags_signs, ll=ll, dev_scan=scans.__getitem__,
            host_resid=lambda k: resid_mode == "none",
        )

    def _fetch_wave(self, w: Dict[str, torch.Tensor], caps: Dict[str, int], n: int) -> dict:
        """A field's device emission on the host, in the batch-of-one layout
        that ``_wave_fits`` and ``_stitch_wave2`` read: scalars and counts
        first, then the packed segments trimmed to the stream when the field
        fits."""
        names = ("num_bp", "px_total", "px_over", "lis_total", "n_sig")
        sc = self._to_host(torch.stack([w[k].to(torch.int64) for k in names]))
        out = {k: sc[i : i + 1] for i, k in enumerate(names)}
        out["px_over"] = out["px_over"] != 0
        out["caps"] = (caps["node_cap"], caps["ev_cap"], n)
        P = caps["px_bp"]
        cnt = self._to_host(torch.cat([w["px_c"], w["lis_c"]]))
        out["px_c"], out["lis_c"] = cnt[None, : 2 * P], cnt[None, 2 * P :]
        fits = self._wave_fits(out, 0, n)
        out["px"] = self._to_host(w["px"][: int(sc[1]) if fits else 0])[None]
        out["lis"] = self._to_host(w["lis"][: int(sc[3]) if fits else 0])[None]
        return out

    def _wave_group(self, x, mode: str, quality: float, resid_mode: str) -> _Group:
        """Device entropy over one sub-batch: the dense front (with the
        outliers compacted on the device, K12), every field's program at
        the first tier, then the retry ladder over the fields that overflowed
        (the front is kept, not recomputed).  A tier's programs are all
        issued before their results are read.  The host then gets the
        quantized values of the fields that need them: with the sparse
        transfer their nonzeros, compacted in one K12 call and copied
        trimmed, with the dense transfer each one's dense signed row."""
        B = x.shape[0]
        nx, ny = self.dims
        n = nx * ny
        sparse = self.transfer == "sparse"
        cap, out_cap = self._sparse_caps(n)
        front = _dense_encode_rows(x, mode, quality, resid_mode, cdf97.dwt2d, cdf97.idwt2d,
                                   out_cap=min(out_cap, n) if sparse else n)
        mags, signs = front["mags"], front["signs"]
        index = _wave_index2(self.dims, x.device)
        node_cap = index[1].nn  # exact: the walk never overflows on nodes
        caps = [_wave_caps2(n, self.num_bp_cap, node_cap, max(4096, int(t * n)))
                for t in self.wave_event_tiers]

        def run(ks, c):
            outs = [_wave_emit_field(mags[k], signs[k], index, c, self.num_bp_cap) for k in ks]
            return [self._fetch_wave(o, c, n) for o in outs]

        waves: List[Optional[dict]] = run(range(B), caps[0])
        tier_of: List[Optional[int]] = [0] * B
        for t in range(1, len(caps)):
            # num_bp over the pixel classes' cap fails every tier (the
            # reference retries such fields all the same)
            bad = [k for k in range(B) if not self._wave_fits(waves[k], 0, n)
                   and int(waves[k]["num_bp"][0]) <= caps[t]["px_bp"]]
            if not bad:
                break
            for k, w in zip(bad, run(bad, caps[t])):
                waves[k], tier_of[k] = w, t

        keys = ["is_const", "v0", "mean", "q", "maxmag"]
        if mode == "pwe" and resid_mode != "none":
            keys.append("n_out")
        if resid_mode == "dual":
            keys += ["eta_sim", "kappa"]
        if sparse:
            # every field's nonzero count (none in a constant field, as in
            # the sparse program): a part with a field past a cap is
            # refused, as the reference refuses it
            front["nnz"] = torch.where(front["is_const"], 0, (mags != 0).sum(dim=1, dtype=torch.int32))
            keys.append("nnz")
        small = {key: self._to_host(front[key]) for key in keys}
        if sparse:
            self._check_caps(small, cap, out_cap)
        need = [k for k in range(B) if not bool(small["is_const"][k])
                and (not self._wave_fits(waves[k], 0, n) or resid_mode in ("dual", "none"))]
        if sparse and need:
            rows = None if len(need) == B else torch.tensor(need, device=x.device)
            idx, vals, _ = _nonzeros(mags if rows is None else mags[rows],
                                     signs if rows is None else signs[rows], cap)
            nnz = small["nnz"][need]
            idx, vals = (_trim(self._to_host, t, nnz, cap) for t in (idx, vals))
            views = {k: (idx[j, : nnz[j]], vals[j, : nnz[j]]) for j, k in enumerate(need)}
        else:
            views = {k: self._to_host(torch.where(signs[k], mags[k], -mags[k])) for k in need}
        scans: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if "n_out" in small:
            for k in range(B):
                if bool(small["is_const"][k]):
                    continue
                m = int(small["n_out"][k])
                scans[k] = (
                    self._to_host(front["out_idx"][k, :m]).astype(np.int64),
                    self._to_host(front["out_vals"][k, :m]).astype(np.float64),
                )
        mags_signs, ll = _views(n, views)
        return _Group(
            small,
            mags_signs=mags_signs,
            ll=ll,
            dev_scan=scans.__getitem__,
            host_resid=lambda k: resid_mode == "none",
            waves=waves,
            tiers=tier_of,
        )

    def _stitch_wave2(self, wave, k: int, budget: int) -> bytes:
        """Host half of the 2D device-entropy path: pure per-pass
        concatenation of the device's packed LIP / LIS / refinement
        segments (a copy of sperr_tpu's ``TpuCompressor2D._stitch_wave2``)."""
        nx, ny = self.dims
        num_bp = int(wave["num_bp"][k])
        if num_bp == 0:
            return sw._pack_stream(np.empty(0, np.uint8), 0, 0)

        def unconcat(buf, bit_counts):
            bc = (bit_counts.astype(np.int64) + 7) // 8
            offs = np.cumsum(bc) - bc
            return [
                np.unpackbits(buf[offs[p] : offs[p] + bc[p]], bitorder="little")[: int(bit_counts[p])]
                for p in range(num_bp)
            ]

        # pixel classes come packed class-major (LIP rows then refinement
        # rows, P = the px bitplane cap) from wave_emit_2d_pixels
        P = min(self.num_bp_cap, 18)
        px_c = wave["px_c"][k].astype(np.int64)
        pbc = (px_c + 7) // 8
        poffs = np.cumsum(pbc) - pbc
        pbuf = wave["px"][k]

        def pseg(p, cls):
            b = cls * P + p
            return np.unpackbits(pbuf[poffs[b] : poffs[b] + pbc[b]], bitorder="little")[: int(px_c[b])]

        lip_segments = [pseg(p, 0) for p in range(num_bp)]
        ref_segments = [pseg(p, 1) for p in range(num_bp)]
        lis_segments = unconcat(wave["lis"][k], wave["lis_c"][k])
        return sw.stitch_2d(
            None, None, None, (nx, ny), num_bp, lip_segments, ref_segments, budget,
            lis_segments=lis_segments,
        )


class TorchDecompressor2D:
    """Batched 2D decompressor: SPECK parsed on the host, reconstruction
    (K3) on ``device`` ("cuda", the default, "cuda:N" or "cpu"), or split
    over ``devices`` as ``TorchCompressor2D`` splits its batches.

    After a ``multi_res`` decode, ``hierarchy[k]`` holds field k's coarse
    reconstructions, coarsest first, as utils.dims.coarsened_resolutions
    lists them (with the mean, without outlier corrections)."""

    def __init__(self, dims: Tuple[int, int], *, device=None, devices=None,
                 num_threads: Optional[int] = None):
        self.dims = (int(dims[0]), int(dims[1]))
        self.devices = _device_list(device, devices)
        self.device = self.devices[0]
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
        ndev = len(self.devices)
        bmax = max(1, _DECODE_ELEM_BUDGET // n)
        if bmax > ndev:
            bmax -= bmax % ndev

        def rebuild(hp: _HostParse, device, rech: np.ndarray):
            # one part's fields, rebuilt on its device and copied into rech
            rec = hp.reconstruct(device, (ny, nx), multi_res)
            hier = []
            if multi_res:
                rec, hier = rec
            torch.from_numpy(rech).copy_(rec)
            return [t.cpu().numpy() for t in hier]

        for s0 in range(0, len(bodies), bmax):
            part = bodies[s0 : s0 + bmax]
            hp = _HostParse(len(part), n)
            hp.parse_all(self.engine, part, list(range(s0, s0 + len(part))), 2, (nx, ny, 1), self.num_threads)
            rech = np.empty((len(part), ny, nx), dtype=np.float32)
            hiers = _on_devices(ndev, [
                (j, functools.partial(rebuild, hp.rows(a, b), self.devices[j], rech[a:b]))
                for j, (a, b) in enumerate(_split(len(part), ndev)) if a < b
            ])
            hier_np = [np.concatenate(levels) for levels in zip(*hiers)]
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
