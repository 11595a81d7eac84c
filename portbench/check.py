"""The comparison that decides ``correct``.

Each number compared has its limit in the cell's traffic file
(``limits``): the limits' keys say which numbers a cell compares, and every
answer of the sample is held to each limit that applies to its op:

  err64  max |value - field| / tol, the answer decoded by the plain
         reference (float64, ``reference/``): the PWE guarantee under the
         exact decoder.  Encodes, PWE mode.
  err32  max |value - field| / tol, the answer decoded by the port's own
         decoder (TorchDecompressor3D / 2D), or, of a decode, the answer
         itself: the guarantee under the port's f32 decoder.  PWE mode.
  gap    max |port's values - reference's float64 decode| / scale, where
         the port's values are a decode's answer or an encode's answer
         decoded by the port; scale is tol in PWE mode, else the fields'
         value range (1).
  bpp    an encode's stream bits per value (a rate's budget).
  psnr_gap_db   quality - the PSNR (dB) of the reference's decode against
         the field, over the field's range (a PSNR target).

An answer that cannot be decoded, or is missing, reads inf.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import decode as ref


def _err(values, orig: np.ndarray, tol: float, device) -> float:
    """max |values - orig| / tol, in float64 on ``device``."""
    if isinstance(values, np.ndarray):
        values = torch.from_numpy(np.ascontiguousarray(values))
    o = torch.from_numpy(np.ascontiguousarray(orig)).to(device, torch.float64)
    return float((values.to(device, torch.float64).reshape(o.shape) - o).abs().max()) / tol


def reference_decode(stream, cell, dtype=torch.float64) -> torch.Tensor:
    """The reference's decode of one request's stream(s), on the cell's
    device, in ``dtype`` (the read cell's control runs it in bfloat16)."""
    if cell.ndim == 3:
        return ref.decode_container(stream, cell.device, dtype)
    return ref.decode_fields(stream, cell.dims, cell.device, dtype)


def _port_decode(stream, cell) -> np.ndarray:
    if cell.ndim == 3:
        return cell.dec.decompress(stream, to_host=True)[0]
    return np.stack(cell.dec.decompress_batch(list(stream)))


def _guarded(fn, *args) -> float:
    try:
        v = fn(*args)
    except Exception as e:  # a stream the decoder refuses fails its answer
        print(f"check: {type(e).__name__}: {e}", file=sys.stderr)
        return math.inf
    return v if math.isfinite(v) else math.inf


def _psnr(values: torch.Tensor, orig: np.ndarray, device) -> float:
    o = torch.from_numpy(np.ascontiguousarray(orig)).to(device, torch.float64)
    mse = float((values.to(device, torch.float64).reshape(o.shape) - o).pow(2).mean())
    rng = float(o.max() - o.min())
    return 20 * math.log10(rng) - 10 * math.log10(max(mse, 1e-300))


ENCODE = ("err64", "err32", "gap", "bpp", "psnr_gap_db")
DECODE = ("gap", "err32")


def compare(cell, kept: List[Tuple[int, object]]) -> Tuple[Dict[str, dict], int]:
    """The sampled answers [(request index, answer)] against the limits ->
    ({name: {value, limit, ok}}, answers that failed a limit)."""
    limits = cell.traffic["limits"]
    tol = cell.tol
    scale = tol if cell.mode == "pwe" else 1.0
    worst = {k: -math.inf for k in limits}
    failed = 0
    decoded = {}  # the reference's float64 decode of each distinct stream
    for i, answer in kept:
        ids = cell.field_ids(i)
        orig = cell.fields[ids[0]] if cell.ndim == 3 else cell.fields[ids.start:ids.stop]
        nums = {}
        if cell.op_of(i) == "encode":
            want = [k for k in ENCODE if k in limits]
            ref64 = {}

            def reference():
                if "v" not in ref64:
                    ref64["v"] = reference_decode(answer, cell)
                return ref64["v"]

            if "err64" in want:
                nums["err64"] = _guarded(lambda: _err(reference(), orig, tol, cell.device))
            if "err32" in want or "gap" in want:
                port = {}

                def port_values():
                    if "v" not in port:
                        port["v"] = _port_decode(answer, cell)
                    return port["v"]

                if "err32" in want:
                    nums["err32"] = _guarded(lambda: _err(port_values(), orig, tol, cell.device))
                if "gap" in want:
                    def gap_enc():
                        r = reference()
                        v = torch.from_numpy(np.ascontiguousarray(port_values())).to(r.device, torch.float64)
                        return float((v.reshape(r.shape) - r).abs().max()) / scale

                    nums["gap"] = _guarded(gap_enc)
            if "bpp" in want:
                nbytes = len(answer) if cell.ndim == 3 else sum(len(x) for x in answer)
                nums["bpp"] = 8.0 * nbytes / orig.size
            if "psnr_gap_db" in want:
                nums["psnr_gap_db"] = _guarded(lambda: cell.quality - _psnr(reference(), orig, cell.device))
        else:
            want = [k for k in DECODE if k in limits]
            j = cell.group(i)
            got = torch.from_numpy(np.ascontiguousarray(answer)).to(cell.device)

            def gap():
                if j not in decoded:
                    decoded[j] = reference_decode(cell.streams[j], cell)
                d = decoded[j]
                return float((got.to(d.device, torch.float64) - d).abs().max()) / scale

            if "gap" in want:
                nums["gap"] = _guarded(gap)
            if "err32" in want:
                nums["err32"] = _guarded(lambda: _err(got, orig, tol, cell.device))
        bad = False
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
            bad |= not v <= limits[k]
        failed += bad
    # a number that no answer gave (no answer of its op kept) is not met
    worst = {k: v if v > -math.inf else math.inf for k, v in worst.items()}
    checks = {k: {"value": worst[k], "limit": float(limits[k]), "ok": worst[k] <= limits[k]}
              for k in limits}
    return checks, failed
