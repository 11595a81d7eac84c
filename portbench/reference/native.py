"""The reference's SPECK bit decoder: ``speck.cpp`` beside this file.

``speck.cpp`` is a frozen copy of the C++ SPECK coder of the JAX package,
the reference implementation (``sperr_tpu/runtime/native/speck.cpp``, which
the port's ``sperr_tpu_torch/runtime/native/speck.cpp`` equalled when this
benchmark was written), cut to its decoder: ``st_speck_decode`` is its one
entry point.  SPECK's sorting
pass reads one bit at a time in an order that depends on every bit before it,
so no array library can run it; a plain sequential decoder in C++ is the
straightforward implementation of the format.  The copy lives in the
benchmark's folder so that a later change to the program cannot change the
yardstick.

The library is built with g++ on first use into ``_build/`` beside this file
(a fixed path inside the checkout) under a file lock, and reused after.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "speck.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
_LIB = os.path.join(BUILD_DIR, "libportbench_speck.so")
_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}
_lock = threading.Lock()
_lib = None


def _build() -> None:
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-DNDEBUG", "-shared", "-fPIC", SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", b"") or b""
        raise RuntimeError(f"the reference decoder failed to build ({' '.join(cmd)}): {e}\n"
                           f"{err.decode(errors='replace')}") from e
    os.replace(tmp, _LIB)


def lib() -> ct.CDLL:
    """Build (once) and load the decoder library."""
    global _lib
    with _lock:
        if _lib is None:
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(SRC):
                    _build()
            handle = ct.CDLL(_LIB)
            handle.st_speck_decode.restype = ct.c_int64
            handle.st_speck_decode.argtypes = [
                ct.c_int, ct.c_int, ct.c_void_p, ct.c_uint64,
                ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_void_p, ct.c_void_p,
            ]
            _lib = handle
        return _lib


def width_for(num_bitplanes: int) -> int:
    """The integer width a stream of ``num_bitplanes`` planes decodes into."""
    for w in (8, 16, 32):
        if num_bitplanes <= w:
            return w
    return 64


def decode(ndim: int, stream: bytes, dims, width: int):
    """A SPECK integer stream (its 9-byte header included) of an ``ndim``-D
    array of ``dims`` (nx, ny, nz) -> (magnitudes uint64, signs bool), flat,
    x fastest.  Raises ``ValueError`` on a stream the decoder refuses."""
    nx, ny, nz = (int(d) for d in dims)
    n = nx * ny * nz
    mags = np.empty(n, dtype=_DTYPES[width])
    signs = np.empty(n, dtype=np.uint8)
    buf = bytes(stream)
    rtn = lib().st_speck_decode(ndim, width, buf, len(buf), nx, ny, nz,
                                mags.ctypes.data_as(ct.c_void_p), signs.ctypes.data_as(ct.c_void_p))
    if rtn < 0:
        raise ValueError(f"SPECK decode refused the stream: {rtn}")
    return mags.astype(np.uint64), signs.astype(bool)
