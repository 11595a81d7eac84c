"""Quality metrics (RMSE, L-infinity, PSNR, mean/var) — host and device.

Parity targets: sperr_helper.cpp:429-523 (calc_stats) and :594-643
(calc_mean_var).  The host versions are plain numpy (the port's copy of
sperr_tpu/utils/stats.py); ``calc_stats_device`` runs torch ops on the
tensors' own device, for use inside the device pipeline (e.g. PWE
verification without fetching the volume).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def calc_stats(a: np.ndarray, b: np.ndarray) -> Tuple[float, float, float, float, float]:
    """(rmse, linfty, psnr, min(a), max(a)); psnr uses the range of `a`."""
    amin, amax = float(a.min()), float(a.max())
    if np.array_equal(a, b):
        return 0.0, 0.0, float("inf"), amin, amax
    d = np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64))
    linfty = float(d.max())
    mse = float(np.mean(d * d))
    rng = amax - amin
    return math.sqrt(mse), linfty, 10.0 * math.log10(rng * rng / mse), amin, amax


def calc_mean_var(a: np.ndarray) -> Tuple[float, float]:
    a = np.asarray(a, dtype=np.float64)
    m = float(a.mean())
    return m, float(np.mean((a - m) ** 2))


def accuracy_gain(orig: np.ndarray, recon: np.ndarray, stream_bytes: int) -> float:
    """The reference's "Accuracy Gain" metric: log2(sigma/rmse) - bpp
    (utilities/sperr3d.cpp:380-382)."""
    rmse = calc_stats(orig, recon)[0]
    sigma = math.sqrt(calc_mean_var(orig)[1])
    bpp = stream_bytes * 8.0 / orig.size
    return float("inf") if rmse == 0 else math.log2(sigma / rmse) - bpp


def calc_stats_device(a: torch.Tensor, b: torch.Tensor):
    """Device-side stats of f32 tensors: 0-d tensors (rmse, linfty, psnr,
    min, max) on the tensors' device, computed in f32; the host is not
    synchronized."""
    d = torch.abs(a - b)
    mse = torch.mean(d * d)
    amin, amax = torch.amin(a), torch.amax(a)
    rng = amax - amin
    psnr = 10.0 * torch.log10(rng * rng / mse)
    return torch.sqrt(mse), torch.amax(d), psnr, amin, amax
