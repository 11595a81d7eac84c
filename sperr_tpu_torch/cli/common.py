"""Shared CLI helpers: argument handling, stats printing, file I/O (the port's
copy of sperr_tpu/cli/common.py)."""

from __future__ import annotations

import math
import sys

import numpy as np


def read_floats(path: str, ftype: int) -> np.ndarray:
    dtype = np.float32 if ftype == 32 else np.float64
    return np.fromfile(path, dtype=dtype)


def write_array(path: str, arr: np.ndarray, dtype) -> None:
    np.ascontiguousarray(arr, dtype=dtype).tofile(path)


def calc_stats(a: np.ndarray, b: np.ndarray):
    """(rmse, linfty, psnr, min, max) like sperr_helper.cpp:429-523."""
    amin, amax = float(a.min()), float(a.max())
    if np.array_equal(a, b):
        return 0.0, 0.0, float("inf"), amin, amax
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    linfty = float(d.max())
    mse = float(np.mean(d * d))
    rmse = math.sqrt(mse)
    rng = amax - amin
    psnr = 10.0 * math.log10(rng * rng / mse)
    return rmse, linfty, psnr, amin, amax


def print_stats(orig: np.ndarray, recon: np.ndarray, stream_len: int) -> None:
    total = orig.size
    bpp = stream_len * 8.0 / total
    rmse, linfty, psnr, amin, amax = calc_stats(orig, recon)
    sigma = float(np.std(orig.astype(np.float64)))
    gain = math.log2(sigma / rmse) - bpp if rmse > 0 else float("inf")
    print(f"Input range = ({amin:.2e}, {amax:.2e}), L-Infty = {linfty:.2e}")
    print(f"Bitrate = {bpp:.2f}, PSNR = {psnr:.2f}dB, Accuracy Gain = {gain:.2f}")


def die(msg: str) -> "None":
    print(msg, file=sys.stderr)
    raise SystemExit(1)
