"""Native (C++) SPECK entropy engine: build, load, and ctypes wrapper (the
port's copy of sperr_tpu/runtime/native, without the flat C ABI).

The shared library is compiled from ``flt.cpp`` and ``speck.cpp`` beside this
file on first use, with g++ -O3, into ``_build/``.  The build goes to a
per-pid temp file that is renamed into place under a file lock, so concurrent builds never
see a partial library.  A missing compiler or a failed build or load raises.
ctypes calls release the GIL, so a Python thread pool over chunks scales
across host cores (the reference's OpenMP model).
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "flt.cpp")  # includes speck.cpp (single TU)
_SRC_DEPS = (os.path.join(_DIR, "speck.cpp"), _SRC)
BUILD_DIR = os.path.join(_DIR, "_build")
_LIB_NAME = "libsperr_torch_native.so"
CXX = "g++"
_lock = threading.Lock()

_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}


def _build_lib(lib_path: str) -> None:
    # -ffp-contract=off: the float pipeline must round exactly once per op
    # for byte-parity of streams with the exact host engine / reference.
    # -fno-math-errno lets rint/fabs loops vectorize (neither sets errno);
    # value semantics are unchanged, so stream parity is preserved.
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [
        CXX, "-O3", "-std=c++17", "-DNDEBUG", "-ffp-contract=off",
        "-fno-math-errno",
        "-shared", "-fPIC", "-march=native", _SRC, "-o", tmp,
    ]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        except subprocess.CalledProcessError:
            # the same build without -march=native
            cmd = [c for c in cmd if c != "-march=native"]
            subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", b"") or b""
        raise RuntimeError(
            f"the C++ SPECK engine failed to build ({' '.join(cmd)}): {e}\n"
            f"{err.decode(errors='replace')}"
        ) from e
    os.replace(tmp, lib_path)


def _load():
    lib_path = os.path.join(BUILD_DIR, _LIB_NAME)
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        # one build at a time across processes; the others wait and load
        with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(lib_path) or any(
                os.path.getmtime(lib_path) < os.path.getmtime(s) for s in _SRC_DEPS
            ):
                _build_lib(lib_path)
        lib = ct.CDLL(lib_path)
    lib.st_speck_encode.restype = ct.c_int64
    lib.st_speck_encode.argtypes = [
        ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p,
        ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.POINTER(ct.c_void_p),
    ]
    lib.st_speck_decode.restype = ct.c_int64
    lib.st_speck_decode.argtypes = [
        ct.c_int, ct.c_int, ct.c_void_p, ct.c_uint64,
        ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_void_p, ct.c_void_p,
    ]
    lib.st_speck_decode3d_control.restype = ct.c_int64
    lib.st_speck_decode3d_control.argtypes = [
        ct.c_int, ct.c_void_p, ct.c_uint64,
        ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_uint64),
    ]
    lib.st_free.argtypes = [ct.c_void_p]
    lib.st_compress_chunk.restype = ct.c_int64
    lib.st_compress_chunk.argtypes = [
        ct.c_int, ct.c_void_p, ct.c_int,
        ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_int, ct.c_double, ct.POINTER(ct.c_void_p),
    ]
    lib.st_decompress_chunk.restype = ct.c_int64
    lib.st_decompress_chunk.argtypes = [
        ct.c_int, ct.c_void_p, ct.c_uint64,
        ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_void_p,
    ]
    lib.st_compress_chunk2.restype = ct.c_int64
    lib.st_compress_chunk2.argtypes = [
        ct.c_int, ct.c_void_p, ct.c_int,
        ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_int, ct.c_double, ct.c_int, ct.POINTER(ct.c_void_p),
    ]
    lib.st_decompress_chunk2.restype = ct.c_int64
    lib.st_decompress_chunk2.argtypes = [
        ct.c_int, ct.c_void_p, ct.c_uint64,
        ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_int, ct.c_void_p,
    ]
    lib.st_compress_chunk_strided.restype = ct.c_int64
    lib.st_compress_chunk_strided.argtypes = [
        ct.c_void_p, ct.c_int, ct.c_uint64, ct.c_uint64,
        ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_int, ct.c_double, ct.c_int, ct.POINTER(ct.c_void_p),
    ]
    lib.st_decompress_chunk_strided.restype = ct.c_int64
    lib.st_decompress_chunk_strided.argtypes = [
        ct.c_void_p, ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_int, ct.c_void_p,
    ]
    lib.st_residual_outliers.restype = ct.c_int64
    lib.st_residual_outliers.argtypes = [
        ct.c_void_p, ct.c_uint64, ct.c_uint64, ct.c_uint64,
        ct.c_double, ct.c_double, ct.c_void_p, ct.c_double,
        ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_void_p),
    ]
    return lib


def residual_outliers(ll, dims, q, mean, orig, tol):
    """Exact f64 decoder-visible PWE residual for the device fast path:
    rec = IDWT(q·ll) in the decoder's own arithmetic; returns (pos, err)
    where |(orig − mean) − rec| > tol, positions ascending
    (SPECK_FLT.cpp:461-486 semantics against the f64 decode path)."""
    import numpy as np

    lib = _load()
    ll = np.ascontiguousarray(ll, dtype=np.int32)
    orig = np.ascontiguousarray(orig, dtype=np.float64)
    nx, ny, nz = dims
    assert ll.size == orig.size == nx * ny * nz
    pos_p = ct.c_void_p(None)
    err_p = ct.c_void_p(None)
    m = lib.st_residual_outliers(
        ll.ctypes.data_as(ct.c_void_p), nx, ny, nz,
        ct.c_double(q), ct.c_double(mean),
        orig.ctypes.data_as(ct.c_void_p), ct.c_double(tol),
        ct.byref(pos_p), ct.byref(err_p),
    )
    if m < 0:
        raise MemoryError("st_residual_outliers failed")
    try:
        pos = np.ctypeslib.as_array(
            ct.cast(pos_p, ct.POINTER(ct.c_uint64)), shape=(m,)
        ).copy() if m else np.zeros(0, dtype=np.uint64)
        err = np.ctypeslib.as_array(
            ct.cast(err_p, ct.POINTER(ct.c_double)), shape=(m,)
        ).copy() if m else np.zeros(0, dtype=np.float64)
    finally:
        lib.st_free(pos_p)
        lib.st_free(err_p)
    return pos, err


class NativeEngine:
    """SPECK entropy engine backed by the C++ library (byte-identical streams)."""

    name = "native"

    def __init__(self):
        self._lib = _load()

    def encode(self, ndim, mags, signs, dims, width, budget_bits) -> bytes:
        m = np.ascontiguousarray(mags, dtype=_DTYPES[width])
        s = np.ascontiguousarray(signs, dtype=np.uint8)
        nx, ny, nz = dims
        out = ct.c_void_p(None)
        rtn = self._lib.st_speck_encode(
            ndim, width, m.ctypes.data_as(ct.c_void_p), s.ctypes.data_as(ct.c_void_p),
            nx, ny, nz, budget_bits, ct.byref(out),
        )
        if rtn < 0:
            raise RuntimeError(f"native speck encode failed: {rtn}")
        buf = ct.string_at(out, rtn)
        self._lib.st_free(out)
        return buf

    def decode(self, ndim, stream, dims, width) -> Tuple[np.ndarray, np.ndarray]:
        nx, ny, nz = dims
        n = nx * ny * nz
        mags = np.empty(n, dtype=_DTYPES[width])
        signs = np.empty(n, dtype=np.uint8)
        buf = bytes(stream)
        rtn = self._lib.st_speck_decode(
            ndim, width, buf, len(buf), nx, ny, nz,
            mags.ctypes.data_as(ct.c_void_p), signs.ctypes.data_as(ct.c_void_p),
        )
        if rtn < 0:
            raise RuntimeError(f"native speck decode failed: {rtn}")
        return mags.astype(np.uint64), signs.astype(bool)

    def encode_1d(self, mags, signs, total_len, width) -> bytes:
        return self.encode(1, mags, signs, (total_len, 1, 1), width, 0)

    def decode_1d(self, stream, total_len, width):
        return self.decode(1, stream, (total_len, 1, 1), width)

    def decode3d_control(self, stream, dims, width):
        """Control-only 3D parse (the hybrid device-decode split): walks
        LIP/LIS control bits, SKIPS refinement segments, and returns what
        the device needs to reconstruct magnitudes —

          (spass u8[n]  — pass each pixel became significant, 255 never,
           signs bool[n],
           ref_off u64[num_bp]   — refinement bit offsets into the body,
           ref_avail u64[num_bp] — refinement bits actually present,
           num_bp, avail_bits)

        Reference decode hot loop being split: SPECK_INT.cpp:166-228 (the
        set walk stays host-serial; value reconstruction moves on device).
        """
        nx, ny, nz = dims
        n = nx * ny * nz
        spass = np.empty(n, dtype=np.uint8)
        signs = np.empty(n, dtype=np.uint8)
        ref_off = np.zeros(64, dtype=np.uint64)
        ref_avail = np.zeros(64, dtype=np.uint64)
        nbp = ct.c_uint8(0)
        avail = ct.c_uint64(0)
        buf = bytes(stream)
        rtn = self._lib.st_speck_decode3d_control(
            width, buf, len(buf), nx, ny, nz,
            spass.ctypes.data_as(ct.c_void_p),
            signs.ctypes.data_as(ct.c_void_p),
            ref_off.ctypes.data_as(ct.c_void_p),
            ref_avail.ctypes.data_as(ct.c_void_p),
            ct.byref(nbp), ct.byref(avail),
        )
        if rtn < 0:
            raise RuntimeError(f"native control decode failed: {rtn}")
        P = int(nbp.value)
        return (
            spass, signs.astype(bool), ref_off[:P], ref_avail[:P],
            P, int(avail.value),
        )


_MODE_CODES = {"rate": 1, "psnr": 2, "pwe": 3, "directq": 4}


class NativeChunkCodec:
    """Full per-chunk float pipeline in C++ (condition->DWT->quantize->SPECK).

    precision=64 (default): byte-identical streams to the exact host engine
    (and the reference binaries).  precision=32: fast mode — half the memory
    traffic; streams stay format-valid SPERR, quality bounded by f32
    roundoff (same contract as the TPU engine).
    """

    def __init__(self, precision: int = 64):
        assert precision in (32, 64)
        self._lib = _load()
        self.precision = precision

    def compress(self, data: np.ndarray, ndim: int, dims, mode: str, quality: float) -> bytes:
        arr = np.ascontiguousarray(data)
        is_float = 1 if arr.dtype == np.float32 else 0
        if not is_float:
            arr = np.ascontiguousarray(arr, dtype=np.float64)
        nx, ny, nz = dims
        out = ct.c_void_p(None)
        rtn = self._lib.st_compress_chunk2(
            ndim, arr.ctypes.data_as(ct.c_void_p), is_float,
            nx, ny, nz, _MODE_CODES[mode], quality, self.precision, ct.byref(out),
        )
        if rtn < 0:
            raise RuntimeError(f"native chunk compress failed: {rtn}")
        buf = ct.string_at(out, rtn)
        self._lib.st_free(out)
        return buf

    def decompress(self, stream: bytes, ndim: int, dims) -> np.ndarray:
        nx, ny, nz = dims
        n = nx * ny * nz
        dtype = np.float64 if self.precision == 64 else np.float32
        out = np.empty(n, dtype=dtype)
        buf = bytes(stream)
        rtn = self._lib.st_decompress_chunk2(
            ndim, buf, len(buf), nx, ny, nz, self.precision,
            out.ctypes.data_as(ct.c_void_p),
        )
        if rtn < 0:
            raise RuntimeError(f"native chunk decompress failed: {rtn}")
        return out

    # ---- whole-volume strided variants (3D): the chunk block is gathered/
    # scattered by the native code directly, skipping a Python-side copy.
    def compress_strided(
        self, vol: np.ndarray, chunk, mode: str, quality: float
    ) -> bytes:
        """`vol`: C-contiguous (nz, ny, nx) f32 or f64; `chunk`:
        (x0, lx, y0, ly, z0, lz)."""
        if not vol.flags.c_contiguous or vol.dtype not in (np.float32, np.float64):
            raise ValueError("vol must be C-contiguous float32/float64")
        is_float = 1 if vol.dtype == np.float32 else 0
        vnz, vny, vnx = vol.shape
        x0, lx, y0, ly, z0, lz = chunk
        out = ct.c_void_p(None)
        rtn = self._lib.st_compress_chunk_strided(
            vol.ctypes.data_as(ct.c_void_p), is_float, vnx, vny,
            x0, y0, z0, lx, ly, lz,
            _MODE_CODES[mode], quality, self.precision, ct.byref(out),
        )
        if rtn < 0:
            raise RuntimeError(f"native strided compress failed: {rtn}")
        buf = ct.string_at(out, rtn)
        self._lib.st_free(out)
        return buf

    def decompress_strided(self, stream: bytes, vol: np.ndarray, chunk) -> None:
        """Decompress one chunk stream directly into `vol` (dtype must match
        this codec's precision)."""
        want = np.float64 if self.precision == 64 else np.float32
        if not vol.flags.c_contiguous or vol.dtype != want:
            raise ValueError(f"vol must be C-contiguous {want}")
        vnz, vny, vnx = vol.shape
        x0, lx, y0, ly, z0, lz = chunk
        buf = bytes(stream)
        rtn = self._lib.st_decompress_chunk_strided(
            buf, len(buf), vnx, vny, x0, y0, z0, lx, ly, lz,
            self.precision, vol.ctypes.data_as(ct.c_void_p),
        )
        if rtn < 0:
            raise RuntimeError(f"native strided decompress failed: {rtn}")
