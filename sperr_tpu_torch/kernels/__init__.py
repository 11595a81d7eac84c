"""Hand-written CUDA kernels for Hopper (sm_90a): build, load and wrappers.

The ``.cu`` sources beside this file are compiled with ``nvcc`` at first use
into ``_build/`` and loaded with ``ctypes`` (a plain C interface: pointers
from ``tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``).  The library is rebuilt when a
source is newer than it; builds go to a per-pid temp file that is renamed
into place, so concurrent builders never see a partial library.

There is no fallback.  A missing ``nvcc``, a failed build or load, a device
that is not compute capability 9.0, or a refused launch raises.  The plain
PyTorch versions live beside the callers (``ops/quantize.py``,
``ops/cdf97.py``, ``ops/packemit.py``, ``ops/wave_unpack.py``,
``ops/speck_virtual.py``, ``ops/speck.py``, ``ops/speck_lis.py``,
``ops/speck_lis2.py``, ``ops/wave_pack.py``) and run only
for tensors on the CPU.

Each wrapper adds one to ``launches[name]`` for each kernel it launches,
under a lock: a batch split over devices launches from one host thread per
device.  ``load`` checks each device a wrapper launches on.
"""

from __future__ import annotations

import contextlib
import ctypes as ct
import functools
import os
import subprocess
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.dims import calc_approx_detail_len, num_of_xforms

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = tuple(
    os.path.join(_DIR, f)
    for f in ("quantize.cu", "cdf97_lift.cu", "cdf97_2d.cu", "bits.cu", "unpack.cu",
              "schedule.cu", "walk.cu", "emit.cu", "walk_table.cu")
)
# headers the sources include: an edited header rebuilds the library too
HEADERS = tuple(os.path.join(_DIR, f) for f in ("bits.cuh", "rank.cuh"))
_LIB_NAME = "libsperr_torch_kernels.so"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
NVCC_LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")
# Shared memory a tile of lifting lines may use (opt-in): one line must fit.
LIFT_MAX_SHARED_BYTES = 96 * 1024

launches = {
    "quantize": 0, "cdf97_lift": 0, "dwt2d_full": 0, "idwt2d_full": 0,
    "transpose_bits32": 0, "masked_pack": 0, "compact_flags_rows": 0, "reconstruct_mags": 0,
    "sched_boxmax": 0, "sched_virtual": 0, "sched_table": 0, "sched_pyramid": 0,
    "walk_vtab": 0, "anchor_ranks": 0, "walk_rows": 0, "radix_sort": 0,
    "emit_stage": 0, "emit_planes": 0,
    "table_anchors": 0, "table_walk": 0, "node_passes": 0,
}
# nvcc's output of the last build (register and shared-memory use per kernel)
build_log = ""
# the plan of the last call of each 2D transform kernel (plane_plan)
last_plan = {}

_lock = threading.Lock()
_lib: Optional[ct.CDLL] = None
_capable = set()  # indices of the CUDA devices checked by load()
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _find_nvcc() -> str:
    # torch's own search: $CUDA_HOME or $CUDA_PATH, nvcc on PATH, then the
    # toolkit's default install location
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    if not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, CUDA_PATH, PATH): the sperr_tpu_torch "
            "CUDA kernels cannot be built"
        )
    return nvcc


def build(out_dir: str = BUILD_DIR) -> str:
    """Compile the kernel sources into ``out_dir`` if the library is missing
    or older than a source or a header; return the library's path."""
    global build_log
    lib = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib) and all(
        os.path.getmtime(lib) >= os.path.getmtime(s) for s in SOURCES + HEADERS
    ):
        return lib
    nvcc = _find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    # one nvcc per source, all at once, then one link
    objs = [f"{os.path.join(out_dir, os.path.basename(s))}.{os.getpid()}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
        for c, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{log}")
        cmd = [nvcc, *NVCC_LINK_FLAGS, *objs, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    build_log = "".join(logs) + proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def load(device=None) -> ct.CDLL:
    """Build (if needed) and load the kernel library; check that ``device``
    (default: the current CUDA device) is compute capability 9.0.  Each
    device is checked once."""
    global _lib
    idx = None if device is None else torch.device(device).index
    if _lib is not None and idx in _capable:
        return _lib
    with _lock:
        if _lib is None:
            lib = ct.CDLL(build())
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: the kernels need an sm_90 GPU")
            lib.sperr_quantize.restype = ct.c_int
            lib.sperr_quantize.argtypes = [
                ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
                ct.c_longlong, ct.c_longlong, ct.c_void_p,
            ]
            lib.sperr_cdf97_lift.restype = ct.c_int
            lib.sperr_cdf97_lift.argtypes = [
                ct.c_void_p, ct.c_longlong, ct.c_int, ct.c_int, ct.c_int,
                ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_int,
                ct.POINTER(ct.c_float), ct.c_void_p,
            ]
            lib.sperr_cdf97_2d.restype = ct.c_int
            lib.sperr_cdf97_2d.argtypes = [
                ct.c_int, ct.c_int, ct.POINTER(ct.c_longlong), ct.c_void_p, ct.c_void_p,
                ct.c_void_p, ct.c_longlong, ct.POINTER(ct.c_float), ct.c_void_p,
            ]
            vp, ll = ct.c_void_p, ct.c_longlong
            for name, args in (
                ("sperr_transpose_bits32", [vp, vp, vp, ll, ll, ct.c_int, vp]),
                ("sperr_masked_pack", [
                    ct.c_int, ct.POINTER(vp), ct.POINTER(vp), ct.POINTER(ll), ct.POINTER(ll),
                    ct.c_int, ll, ll, vp, vp, vp, vp, vp,
                ]),
                ("sperr_flag_compact_rows", [vp, vp, vp, vp, ll, ll, ll, vp]),
                ("sperr_reconstruct_mags", [vp, vp, ll, vp, vp, vp, vp, vp, vp, vp, ll, ll, ll, vp]),
                ("sperr_sched_boxmax", [vp, vp, vp, vp, ct.c_int, vp]),
                ("sperr_sched_virtual", [vp, vp, vp, vp, ct.c_int, vp, vp, vp, ct.c_int, ll, vp]),
                ("sperr_sched_table", [ct.POINTER(SchedTable), vp]),
                ("sperr_sched_pyramid", [
                    vp, ll, vp, ct.c_int, ct.c_int, ct.c_int, ct.c_int, vp, vp, vp, ll, vp, vp,
                    vp, vp, vp,
                ]),
                ("sperr_walk_vtab", [vp, vp, vp, vp, vp, ct.c_int, ll, vp, vp]),
                ("sperr_anchor_ranks", [
                    vp, vp, ll, vp, vp, ct.c_int, ct.c_int, vp, vp, vp, vp, vp, vp, vp, vp, ll, vp,
                ]),
                ("sperr_radix_sort", [
                    vp, ct.c_int, vp, ll, ct.POINTER(ct.c_int), ct.c_int, vp, vp, vp, vp, vp, ll, vp,
                ]),
                ("sperr_gather", [vp, ct.c_int, vp, vp, ll, vp]),
                ("sperr_walk_rows", [vp, ct.c_int, vp, vp, vp, ll, vp, vp, vp]),
                ("sperr_walk_born", [
                    vp, ct.c_int, vp, ll, vp, vp, vp, vp, ll, ct.c_int, ct.c_int, ct.c_int, vp, vp,
                    vp, vp, vp,
                ]),
                ("sperr_walk_entries", [
                    vp, vp, vp, ct.c_int, vp, ll, vp, vp, vp, vp, ll, ct.c_int, ct.c_int, ct.c_int,
                    vp, vp, vp, vp, vp,
                ]),
                ("sperr_walk_rowkeys", [vp, ct.c_int, ll, vp, vp, vp, ct.c_int, ct.c_int, vp, vp, vp]),
                ("sperr_emit_cube", [
                    vp, vp, vp, vp, ct.c_int, ll, ll, ll, ll, vp, ll, ll, ct.c_int, vp, vp, vp, vp, vp,
                    vp, vp, vp,
                ]),
                ("sperr_emit_fields", [vp, vp, vp, ct.c_int, vp, ll, ll, vp, ll, ll, vp, ct.c_int, vp, vp]),
                ("sperr_emit_planes", [ct.c_int, vp, vp, vp, ct.c_int, ll, ll, vp, ct.c_int, vp, vp, vp]),
                ("sperr_table_anchors", [vp, vp, vp, ct.c_int, vp]),
                ("sperr_table_rows", [vp, vp]),
                ("sperr_table_born", [vp, vp]),
                ("sperr_table_entries", [vp, vp]),
                ("sperr_table_rowkeys", [vp, vp]),
                ("sperr_rank_keys", [vp, ll, vp, vp, vp, vp, vp]),
                ("sperr_rank_sorted", [vp, ll, vp, vp, vp, ll, vp, vp]),
                ("sperr_node_passes", [vp, vp, ll, vp, vp]),
            ):
                fn = getattr(lib, name)
                fn.restype = ct.c_int
                fn.argtypes = args
            lib.sperr_rank_scratch_words.restype = ll
            lib.sperr_rank_scratch_words.argtypes = [ll]
            lib.sperr_emit_status_words.restype = ll
            lib.sperr_emit_status_words.argtypes = [ct.c_int]
            lib.sperr_reconstruct_status_words.restype = ll
            lib.sperr_reconstruct_status_words.argtypes = [ll, ll]
            lib.sperr_cuda_error_string.restype = ct.c_char_p
            lib.sperr_cuda_error_string.argtypes = [ct.c_int]
            _lib = lib
        if idx is None:
            idx = torch.cuda.current_device()
        if idx not in _capable:
            cap = torch.cuda.get_device_capability(idx)
            if cap != (9, 0):
                raise RuntimeError(
                    f"the kernels are built for compute capability 9.0 (sm_90a); "
                    f"{torch.cuda.get_device_name(idx)} (cuda:{idx}) has {cap[0]}.{cap[1]}"
                )
            _capable.add(idx)
        return _lib


def _count(name: str, k: int = 1) -> None:
    """Add k to ``launches[name]`` (the wrappers run on several host threads
    when a batch is split over devices)."""
    with _count_lock:
        launches[name] += k


def _check(lib: ct.CDLL, err: int, name: str) -> None:
    if err != 0:
        msg = lib.sperr_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err}: {msg}")


def _require_cuda_f32(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous float32 CUDA tensor; got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_device(t: torch.Tensor):
    """Make t's device current for a launch (no switch when it already is:
    the switch costs more host time than a small kernel runs)."""
    return _on_index(t.device)


def _on_index(dev: torch.device):
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


# Buffers that the kernels leave zeroed for their next call (the look-back
# status words and tickets of K9's and K13's scans): one per host thread,
# device and stream, so that calls issued by two threads into one stream
# never share one.
_zeroed_local = threading.local()


@contextlib.contextmanager
def _zeroed(dev: torch.device, words: int):
    """A zeroed int64 buffer of at least ``words`` words on ``dev`` for
    launches that leave it zeroed again.  It goes back to the cache only
    when the block ends without an exception: after a refused launch it may
    not be zero, and is dropped."""
    cache = getattr(_zeroed_local, "bufs", None)
    if cache is None:
        cache = _zeroed_local.bufs = {}
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = cache.pop(key, None)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(int(words), 1024), dtype=torch.int64, device=dev)
    yield buf
    cache[key] = buf


_consts_arrays = {}


def _consts(consts: np.ndarray):
    """The lifting constants as a C float array, built once per value."""
    key = np.ascontiguousarray(consts, dtype=np.float32).tobytes()
    arr = _consts_arrays.get(key)
    if arr is None:
        vals = np.frombuffer(key, dtype=np.float32)
        arr = _consts_arrays[key] = (ct.c_float * len(vals))(*vals)
    return arr


def quantize(coeffs: torch.Tensor, inv_q: torch.Tensor):
    """K1: coeffs (B, n) f32, inv_q (B,) f32 on one CUDA device ->
    (mags i32 (B, n), signs bool (B, n), maxmag i32 (B,))."""
    _require_cuda_f32(coeffs, "coeffs")
    _require_cuda_f32(inv_q, "inv_q")
    if coeffs.dim() != 2 or inv_q.shape != (coeffs.shape[0],):
        raise ValueError(
            f"coeffs must be (B, n) and inv_q (B,); got {tuple(coeffs.shape)} "
            f"and {tuple(inv_q.shape)}"
        )
    if inv_q.device != coeffs.device:
        raise ValueError("coeffs and inv_q are on different devices")
    B, n = coeffs.shape
    if B > 65535:
        raise ValueError(f"at most 65535 rows per launch; got {B}")
    lib = load(coeffs.device)
    mags = torch.empty((B, n), dtype=torch.int32, device=coeffs.device)
    signs = torch.empty((B, n), dtype=torch.bool, device=coeffs.device)
    maxmag = torch.zeros((B,), dtype=torch.int32, device=coeffs.device)
    with _on_device(coeffs):
        err = lib.sperr_quantize(
            coeffs.data_ptr(), inv_q.data_ptr(), mags.data_ptr(),
            signs.data_ptr(), maxmag.data_ptr(), B, n, _stream(coeffs),
        )
    _check(lib, err, "quantize")
    _count("quantize")
    return mags, signs, maxmag


def cdf97_lift(
    x: torch.Tensor,
    axis: int,
    box: Tuple[int, int, int],
    inverse: bool,
    consts: np.ndarray,
) -> None:
    """One lifting level along ``axis`` (-1 x, -2 y, -3 z) of the sub-box
    ``box`` = (lz, ly, lx) at the origin of x (B, nz, ny, nx), in place.
    ``consts``: f32 {alpha, beta, gamma, delta, epsilon, inv_epsilon}."""
    _require_cuda_f32(x, "x")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, nz, ny, nx); got {tuple(x.shape)}")
    B, nz, ny, nx = x.shape
    lz, ly, lx = (int(v) for v in box)
    if not (1 <= lz <= nz and 1 <= ly <= ny and 1 <= lx <= nx):
        raise ValueError(f"box {box} does not fit in {(nz, ny, nx)}")
    if axis not in (-1, -2, -3):
        raise ValueError(f"axis must be -1, -2 or -3; got {axis}")
    L = {-1: lx, -2: ly, -3: lz}[axis]
    if L < 2:
        raise ValueError(f"a lifting line needs at least 2 samples; got {L}")
    if 4 * L > LIFT_MAX_SHARED_BYTES:
        raise ValueError(
            f"a line of {L} samples needs {4 * L} bytes of shared memory; "
            f"the lifting kernel holds at most {LIFT_MAX_SHARED_BYTES}"
        )
    lib = load(x.device)
    with _on_device(x):
        err = lib.sperr_cdf97_lift(
            x.data_ptr(), B, nz, ny, nx, lz, ly, lx, axis, int(bool(inverse)),
            _consts(consts), _stream(x),
        )
    _check(lib, err, "cdf97_lift")
    _count("cdf97_lift")


# ---------------------------------------------------------------------------
# K2/K3: the 2D transforms (kernels/cdf97_2d.cu), one launch per level, out
# of place.  One block per tile of PLANE_TILE x PLANE_TILE output pairs,
# which it loads with a halo of two pairs on each side into shared memory.
# ---------------------------------------------------------------------------
PLANE_TILE = 28
PLANE_SHARED_BYTES = 2 * 32 * 81 * 4  # a tile of 64 rows, pitch 81 floats
PLANE_MAX_GRID = 2**31 - 1


class PlaneLaunch(NamedTuple):
    level: int         # forward: the level done; inverse: the level undone
    ly: int            # the level's corner (ly, lx)
    lx: int
    grid: int          # blocks: one per tile
    shared_bytes: int  # per block


class PlaneScratch(NamedTuple):
    """An approximation passed from one launch to the next: B planes of
    (ly, pitch) floats at ``offset`` in the scratch, lx of each row used."""
    ly: int
    lx: int
    pitch: int
    offset: int


class PlanePlan(NamedTuple):
    launches: Tuple[PlaneLaunch, ...]
    scratch: Tuple[PlaneScratch, ...]  # between launch k and k + 1
    scratch_floats: int


@functools.lru_cache(maxsize=256)
def plane_plan(B: int, ny: int, nx: int, inverse: bool, lev_hi: int, lev_lo: int = 0,
               keep: bool = False) -> PlanePlan:
    """The launches of one K2 (forward levels 0 .. lev_hi-1) or K3 (undo
    levels lev_hi .. lev_lo+1) call on (B, ny, nx) planes, and the scratch
    that carries each approximation to the next launch: two regions used in
    turn, or with ``keep`` one per approximation (the multi-resolution
    decode reads them all).  Rows of the scratch are padded to 16 bytes.
    Raises ValueError for what the kernels cannot take: lines shorter than 2
    samples, or a level with more tiles than a launch's grid holds."""
    B, ny, nx, lev_hi, lev_lo = (int(v) for v in (B, ny, nx, lev_hi, lev_lo))
    if B < 0 or ny < 1 or nx < 1:
        raise ValueError(f"planes must be (B >= 0, ny >= 1, nx >= 1); got {(B, ny, nx)}")
    if not 0 <= lev_lo < lev_hi:
        raise ValueError(f"levels must satisfy 0 <= lev_lo < lev_hi; got {lev_lo}, {lev_hi}")
    if not inverse and lev_lo:
        raise ValueError(f"the forward transform starts at level 0; got lev_lo {lev_lo}")

    def corner(lev):
        return calc_approx_detail_len(ny, lev)[0], calc_approx_detail_len(nx, lev)[0]

    if min(corner(lev_hi - 1)) < 2:
        raise ValueError(f"{lev_hi} levels leave lines shorter than 2 samples in {(ny, nx)}")
    levels = range(lev_hi, lev_lo, -1) if inverse else range(lev_lo, lev_hi)
    # the inverse's tiles start at x pair -2 (aligned loads, cdf97_2d.cu)
    shift = 2 if inverse else 0
    runs = []
    for lev in levels:
        ly, lx = corner(lev - 1 if inverse else lev)
        grid = B * -(-(ly - ly // 2) // PLANE_TILE) * -(-(lx - lx // 2 + shift) // PLANE_TILE)
        if grid > PLANE_MAX_GRID:
            raise ValueError(
                f"level {lev} of {(B, ny, nx)} needs {grid} blocks; a launch takes at most "
                f"{PLANE_MAX_GRID}"
            )
        runs.append(PlaneLaunch(lev, ly, lx, grid, PLANE_SHARED_BYTES))
    mids = [corner(lev - 1 if inverse else lev + 1) for lev in levels][:-1]
    sizes = [B * ly * (-(-lx // 4) * 4) for ly, lx in mids]
    if keep:
        offsets = [sum(sizes[:m]) for m in range(len(sizes))]
        total = sum(sizes)
    else:
        region = [max(sizes[0::2], default=0), max(sizes[1::2], default=0)]
        offsets = [region[0] * (m % 2) for m in range(len(sizes))]
        total = sum(region)
    scratch = tuple(
        PlaneScratch(ly, lx, -(-lx // 4) * 4, off) for (ly, lx), off in zip(mids, offsets)
    )
    return PlanePlan(tuple(runs), scratch, total)


@functools.lru_cache(maxsize=256)
def _plane_desc(plan: PlanePlan, ny: int, nx: int, oy: int, ox: int, inverse: bool):
    """The launch descriptors of a plan as kernels/cdf97_2d.cu
    sperr_cdf97_2d takes them (a ctypes array, built once per plan)."""
    # the approximations in launch order: the input (0), the scratch (1),
    # the output (2), each as (base, byte offset, pitch, plane stride)
    chain = (
        [(0, 0, nx, ny * nx)]
        + [(1, 4 * s.offset, s.pitch, s.ly * s.pitch) for s in plan.scratch]
        + [(2, 0, ox, oy * ox)]
    )
    det = 0 if inverse else 2
    words = []
    for k, run in enumerate(plan.launches):
        (ks, *src), (kd, *dst) = chain[k], chain[k + 1]
        words += [*src, *dst, 0, nx, ny * nx, run.ly, run.lx, run.grid, ks, kd, det]
    return (ct.c_longlong * len(words))(*words)


def _plane(x: torch.Tensor, inverse: bool, lev_hi: int, lev_lo: int, consts: np.ndarray,
           keep: bool):
    """K2 (forward) or K3 (inverse) of x (B, ny, nx) -> (out, the scratch's
    approximations as (B, ly, lx) views).  out is (B, ny, nx) for the
    forward, the (B, ly, lx) corner of level lev_lo for the inverse.  One
    ctypes call issues every launch."""
    name = "idwt2d_full" if inverse else "dwt2d_full"
    _require_cuda_f32(x, "x")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, ny, nx); got {tuple(x.shape)}")
    B, ny, nx = x.shape
    plan = plane_plan(B, ny, nx, bool(inverse), int(lev_hi), int(lev_lo), bool(keep))
    oy, ox = (
        (calc_approx_detail_len(ny, lev_lo)[0], calc_approx_detail_len(nx, lev_lo)[0])
        if inverse else (ny, nx)
    )
    out = torch.empty((B, oy, ox), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=x.device)
    lls = [
        scratch[s.offset : s.offset + B * s.ly * s.pitch].view(B, s.ly, s.pitch)[:, :, : s.lx]
        for s in plan.scratch
    ] if keep else []
    if B == 0:
        return out, lls
    lib = load(x.device)
    with _on_device(x):
        err = lib.sperr_cdf97_2d(
            int(inverse), len(plan.launches), _plane_desc(plan, ny, nx, oy, ox, bool(inverse)),
            x.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, _consts(consts), _stream(x),
        )
    _check(lib, err, name)
    _count(name, len(plan.launches))
    last_plan[name] = plan
    return out, lls


def _all_levels(x: torch.Tensor) -> int:
    return num_of_xforms(min(x.shape[-1], x.shape[-2]))


def dwt2d_full(x: torch.Tensor, consts: np.ndarray, levels: Optional[int] = None) -> torch.Tensor:
    """K2: the first ``levels`` (default: all ``num_of_xforms(min(nx, ny))``)
    levels of the 2D transform of x (B, ny, nx), rows then columns of each
    level's approximation corner, into a new (B, ny, nx) tensor; x is left
    alone.  One launch per level.  ``consts`` as for ``cdf97_lift``."""
    levels = _all_levels(x) if levels is None else levels
    return _plane(x, False, int(levels), 0, consts, False)[0]


def idwt2d_full(
    x: torch.Tensor, consts: np.ndarray, lev_hi: Optional[int] = None, lev_lo: int = 0,
    hierarchy: bool = False,
):
    """K3: undo levels ``lev_hi .. lev_lo+1`` (default: all) of the 2D
    transform of x (B, ny, nx), columns then rows, one launch per level; x
    is left alone.  Returns the (B, ly, lx) approximation corner of level
    ``lev_lo`` (the whole plane for ``lev_lo = 0``); with ``hierarchy``
    also the approximations of levels lev_hi-1 .. lev_lo+1, coarsest first,
    as (B, ly, lx) views of the launches' own outputs."""
    lev_hi = _all_levels(x) if lev_hi is None else lev_hi
    out, lls = _plane(x, True, int(lev_hi), int(lev_lo), consts, hierarchy)
    return (out, lls) if hierarchy else out


# ---------------------------------------------------------------------------
# K10-K12: the bit machinery of the device SPECK encoder (kernels/bits.cu).
# Words are 32-bit patterns carried in int32 tensors.
# ---------------------------------------------------------------------------
def _require_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous {dtype} CUDA tensor; got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _transpose(name: str, a: torch.Tensor, b: Optional[torch.Tensor], per_word: int,
               out: torch.Tensor, row0: int, take: int) -> torch.Tensor:
    _require_cuda(out, torch.int32, "out")
    if out.device != a.device:
        raise ValueError(f"out is on {out.device}, the items on {a.device}")
    W = a.numel() // per_word
    row0, take = int(row0), int(take)
    if out.dim() != 2 or out.shape[1] != W or not (1 <= take <= 32 and 0 <= row0 <= out.shape[0] - take):
        raise ValueError(
            f"out must be (R, {W}) with rows row0 .. row0 + take - 1 inside it and "
            f"1 <= take <= 32; got {tuple(out.shape)}, row0 {row0}, take {take}"
        )
    lib = load(a.device)
    with _on_device(a):
        err = lib.sperr_transpose_bits32(
            a.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), W, row0, take,
            _stream(a),
        )
    _check(lib, err, name)
    _count("transpose_bits32")
    return out


def transpose_bits32(x: torch.Tensor, out: torch.Tensor, row0: int, take: int) -> torch.Tensor:
    """K10: x (M,) int32 words, M % 32 == 0; planes 0 .. take-1 of the
    transpose (plane p, word w: bit l = x[32 w + l] bit p) into rows
    row0 .. row0+take-1 of out (R, M // 32) int32.  Returns out."""
    _require_cuda(x, torch.int32, "x")
    if x.dim() != 1 or x.numel() % 32 or x.numel() == 0:
        raise ValueError(f"x must be (M,) with M a positive multiple of 32; got {tuple(x.shape)}")
    return _transpose("transpose_bits32", x, None, 32, out, row0, take)


def transpose_bits32_pair(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, row0: int,
                          take: int) -> torch.Tensor:
    """K10, pair form: a, b (M,) int32, M % 16 == 0; planes 0 .. take-1 of
    the transpose of the cell stream a_0 b_0 a_1 b_1 ... into rows
    row0 .. row0+take-1 of out (R, M // 16) int32.  Returns out."""
    _require_cuda(a, torch.int32, "a")
    _require_cuda(b, torch.int32, "b")
    if a.dim() != 1 or a.shape != b.shape or a.numel() % 16 or a.numel() == 0:
        raise ValueError(
            f"a and b must be (M,) with M a positive multiple of 16; got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.device != b.device:
        raise ValueError("a and b are on different devices")
    return _transpose("transpose_bits32_pair", a, b, 16, out, row0, take)


PACK_TILE = 2048  # words per tile of K11 (kPackTile in bits.cu)
PACK_MAX_PARTS = 4


def masked_pack(parts, evb_cap: int, out_cap_bytes: int, piece_words: int = 8):
    """K11: parts, 1 to 4 pairs (valid, bits) of (rows, W) int32 word arrays
    on one CUDA device, W a multiple of piece_words -> (out_words
    (out_cap_bytes // 4,) int32, counts (all rows,) int32, total_bytes ()
    int64, overflow () bool, n_nz () int64), as ops/packemit.masked_pack
    defines them.  Three launches (count, which also zeroes out_words, scan
    and pack; no pack when there is no word), no host synchronisation."""
    if not 1 <= len(parts) <= PACK_MAX_PARTS:
        raise ValueError(f"1 to {PACK_MAX_PARTS} parts; got {len(parts)}")
    evb_cap, out_cap_bytes, piece_words = int(evb_cap), int(out_cap_bytes), int(piece_words)
    if piece_words not in (2, 4, 8, 16) or out_cap_bytes < 0 or out_cap_bytes % 4:
        raise ValueError(
            f"piece_words must be 2, 4, 8 or 16 and out_cap_bytes a multiple of 4; got "
            f"{piece_words}, {out_cap_bytes}"
        )
    dev = parts[0][0].device
    shapes = []
    for k, (v, b) in enumerate(parts):
        for t, what in ((v, f"valid[{k}]"), (b, f"bits[{k}]")):
            _require_cuda(t, torch.int32, what)
            if t.device != dev:
                raise ValueError(f"{what} is on {t.device}, valid[0] on {dev}")
        if v.dim() != 2 or b.shape != v.shape or v.shape[1] % piece_words:
            raise ValueError(
                f"valid[{k}] and bits[{k}] must be (rows, W) with W a multiple of "
                f"{piece_words}; got {tuple(v.shape)}, {tuple(b.shape)}"
            )
        shapes.append(tuple(v.shape))
    nrows = sum(r for r, _ in shapes)
    tiles = sum(r * -(-w // PACK_TILE) for r, w in shapes)
    take = min(evb_cap, sum(r * w for r, w in shapes) // piece_words)
    out_words = out_cap_bytes // 4
    # out and counts in one int32 buffer; the totals and the scratch (two
    # words per tile, one per row) in one int64 buffer
    i32 = torch.empty(out_words + nrows, dtype=torch.int32, device=dev)
    i64 = torch.empty(2 + 2 * tiles + nrows, dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    n = len(parts)
    lib = load(parts[0][0].device)
    with _on_device(parts[0][0]):
        err = lib.sperr_masked_pack(
            n, (ct.c_void_p * n)(*(v.data_ptr() for v, _ in parts)),
            (ct.c_void_p * n)(*(b.data_ptr() for _, b in parts)),
            (ct.c_longlong * n)(*(r for r, _ in shapes)),
            (ct.c_longlong * n)(*(w for _, w in shapes)),
            piece_words, take, out_cap_bytes, i32.data_ptr(), i32[out_words:].data_ptr(),
            i64.data_ptr(), overflow.data_ptr(), _stream(parts[0][0]),
        )
    _check(lib, err, "masked_pack")
    _count("masked_pack", 3 if tiles else 2)
    return i32[:out_words], i32[out_words : out_words + nrows], i64[0], overflow, i64[1]


FLAG_TILE = 16384  # flags per block of K12 (kFlagTile in bits.cu)


def compact_flags_rows(flags: torch.Tensor, take: int, out=None):
    """K12: flags (B, n) bool -> (idx (B, take) int32, the ascending indices
    of the set flags with the sentinel n in unused slots; count (B,) int32).
    One pass with a decoupled look-back over status words zeroed for the
    call, then a small launch that writes the sentinels.  ``out`` (idx,
    count, B ceil(n / 16384) int64 status words), where given, is written in
    place of new tensors."""
    _require_cuda(flags, torch.bool, "flags")
    if flags.dim() != 2 or flags.shape[1] == 0 or not 0 < flags.shape[0] <= 65535:
        raise ValueError(f"flags must be (B, n), 0 < B <= 65535, n > 0; got {tuple(flags.shape)}")
    take = int(take)
    if take <= 0:
        raise ValueError(f"take must be positive; got {take}")
    B, n = flags.shape
    if out is None:
        out = (torch.empty((B, take), dtype=torch.int32, device=flags.device),
               torch.empty((B,), dtype=torch.int32, device=flags.device),
               torch.empty(B * -(-n // FLAG_TILE), dtype=torch.int64, device=flags.device))  # zeroed by the call
    idx, count, status = out
    if (idx.shape != (B, take) or count.shape != (B,) or status.numel() < B * -(-n // FLAG_TILE)
            or any(t.device != flags.device or not t.is_contiguous() for t in out)):
        raise ValueError(f"out must hold ({B}, {take}) and ({B},) int32 and the status words on {flags.device}")
    lib = load(flags.device)
    with _on_device(flags):
        err = lib.sperr_flag_compact_rows(
            flags.data_ptr(), idx.data_ptr(), count.data_ptr(), status.data_ptr(),
            B, n, take, _stream(flags),
        )
    _check(lib, err, "compact_flags_rows")
    _count("compact_flags_rows", 2)
    return idx, count


# ---------------------------------------------------------------------------
# K13: the device half of the hybrid decode (kernels/unpack.cu)
# ---------------------------------------------------------------------------
_SEG_PIXELS = 1024  # pixels per warp segment (kSegPixels in unpack.cu)


def reconstruct_mags(spass: torch.Tensor, words: torch.Tensor, ref_off: torch.Tensor,
                     ref_avail: torch.Tensor, num_bp: torch.Tensor, p_cap: int, evw_cap: int):
    """K13: spass (B, n) uint8 with n < 2^30, words (B, W) int32, ref_off and
    ref_avail (B, 32) int32, num_bp (B,) int32 with num_bp <= p_cap <= 32 ->
    (mags int32 (B, n), overflow bool (B,)): more than ``evw_cap`` active
    (pass, word) slots in a chunk set its overflow, as ops/wave_unpack.py
    defines it.  Two launches (count, reconstruct), no host synchronisation."""
    _require_cuda(spass, torch.uint8, "spass")
    for t, what in ((words, "words"), (ref_off, "ref_off"), (ref_avail, "ref_avail"),
                    (num_bp, "num_bp")):
        _require_cuda(t, torch.int32, what)
        if t.device != spass.device:
            raise ValueError(f"{what} is on {t.device}, spass on {spass.device}")
    p_cap, evw_cap = int(p_cap), int(evw_cap)
    if spass.dim() != 2 or not 0 < spass.shape[1] < 2**30 or not 0 < spass.shape[0] <= 65535:
        raise ValueError(f"spass must be (B, n), 0 < B <= 65535, 0 < n < 2^30 (the look-back's "
                         f"counts); got {tuple(spass.shape)}")
    B, n = spass.shape
    if (words.dim() != 2 or words.shape[0] != B or words.shape[1] == 0
            or ref_off.shape != (B, 32) or ref_avail.shape != (B, 32) or num_bp.shape != (B,)):
        raise ValueError(
            f"words must be (B, W > 0), ref_off and ref_avail (B, 32), num_bp (B,) for B = {B}; "
            f"got {tuple(words.shape)}, {tuple(ref_off.shape)}, {tuple(ref_avail.shape)}, "
            f"{tuple(num_bp.shape)}"
        )
    if not 0 < p_cap <= 32 or evw_cap < 0:
        raise ValueError(f"p_cap must be in [1, 32] and evw_cap >= 0; got {p_cap}, {evw_cap}")
    nseg = -(-n // _SEG_PIXELS)
    take = min(evw_cap, p_cap * (-(-n // 128) * 4))  # the reference's P * Wn slots
    mags = torch.empty((B, n), dtype=torch.int32, device=spass.device)
    overflow = torch.empty((B,), dtype=torch.bool, device=spass.device)
    scratch = torch.empty(B * (32 * nseg + 33), dtype=torch.int32, device=spass.device)
    lib = load(spass.device)
    status_words = -(-lib.sperr_reconstruct_status_words(B, n) // 2)
    with _on_device(spass), _zeroed(spass.device, status_words) as status:
        err = lib.sperr_reconstruct_mags(
            spass.data_ptr(), words.data_ptr(), words.shape[1], ref_off.data_ptr(),
            ref_avail.data_ptr(), num_bp.data_ptr(), scratch.data_ptr(), status.data_ptr(),
            mags.data_ptr(), overflow.data_ptr(), B, n, take, _stream(spass),
        )
        _check(lib, err, "reconstruct_mags")
    _count("reconstruct_mags", 2)
    return mags, overflow


# ---------------------------------------------------------------------------
# K5, K6 and the schedule of K14/K15 (kernels/schedule.cu): integer results,
# num_bp stays on the device
# ---------------------------------------------------------------------------
SCHED_MAX_SEGS = 256  # segments of the cube schedule's nm table (kMaxSegs)


def pyramid_cells(K: int) -> int:
    """Cells of the cube schedule's morton pyramid, grids 0 .. K-1: grid g
    (8^g cells) starts at (8^g - 1) / 7."""
    return ((1 << (3 * int(K))) - 1) // 7


def sched_boxmax(mags: torch.Tensor, K: int):
    """Launch 1 of the power-of-two cube schedule: mags ((2^K)^3,) int32,
    8-byte aligned -> (pm8 (n,) uint8, each pixel's msb+1; M
    (pyramid_cells(K),) uint8, the morton max pyramid of the 2x2x2 box
    maxima with grids K-1 .. max(K-4, 0) written; num_bp () int32)."""
    _require_cuda(mags, torch.int32, "mags")
    K = int(K)
    if not 1 <= K <= 10 or mags.dim() != 1 or mags.numel() != 1 << (3 * K):
        raise ValueError(f"mags must be ((2^K)^3,) for 1 <= K <= 10; got {tuple(mags.shape)}, K {K}")
    if mags.data_ptr() % 8:
        raise ValueError("mags must be 8-byte aligned (the kernel loads pixel pairs)")
    dev = mags.device
    pm8 = torch.empty(mags.numel(), dtype=torch.uint8, device=dev)
    M = torch.empty(pyramid_cells(K), dtype=torch.uint8, device=dev)
    num_bp = torch.zeros((), dtype=torch.int32, device=dev)
    lib = load(dev)
    with _on_device(mags):
        err = lib.sperr_sched_boxmax(mags.data_ptr(), pm8.data_ptr(), M.data_ptr(), num_bp.data_ptr(),
                                     K, _stream(mags))
    _check(lib, err, "sched_boxmax")
    _count("sched_boxmax")
    return pm8, M, num_bp


def sched_virtual(pm8: torch.Tensor, M: torch.Tensor, num_bp: torch.Tensor, segs: torch.Tensor,
                  K: int, nn: int):
    """Launch 2: (s, e (n,) int32, nm (nn,) int32) from ``sched_boxmax``'s
    pm8 and M (whose small grids it completes) and num_bp (a 1-element
    int32 tensor); nm through ``segs`` (nseg, 4) int32 rows (grid, lo, hi,
    output offset) in output order."""
    K, nn = int(K), int(nn)
    n = 1 << (3 * K)
    for t, dtype, what in ((pm8, torch.uint8, "pm8"), (M, torch.uint8, "M"),
                           (num_bp, torch.int32, "num_bp"), (segs, torch.int32, "segs")):
        _require_cuda(t, dtype, what)
        if t.device != pm8.device:
            raise ValueError(f"{what} is on {t.device}, pm8 on {pm8.device}")
    if (not 1 <= K <= 10 or pm8.shape != (n,) or M.shape != (pyramid_cells(K),)
            or num_bp.numel() != 1 or segs.dim() != 2 or segs.shape[1] != 4
            or not 1 <= segs.shape[0] <= SCHED_MAX_SEGS or nn < 1):
        raise ValueError(
            f"pm8 ({n},), M ({pyramid_cells(K)},), one num_bp, segs (1 .. {SCHED_MAX_SEGS}, 4) "
            f"and nn >= 1 for K {K}; got {tuple(pm8.shape)}, {tuple(M.shape)}, "
            f"{tuple(num_bp.shape)}, {tuple(segs.shape)}, {nn}"
        )
    dev = pm8.device
    s = torch.empty(n, dtype=torch.int32, device=dev)
    e = torch.empty(n, dtype=torch.int32, device=dev)
    nm = torch.empty(nn, dtype=torch.int32, device=dev)
    lib = load(dev)
    with _on_device(pm8):
        err = lib.sperr_sched_virtual(pm8.data_ptr(), M.data_ptr(), num_bp.data_ptr(), segs.data_ptr(),
                                      segs.shape[0], s.data_ptr(), e.data_ptr(), nm.data_ptr(), K, nn,
                                      _stream(pm8))
    _check(lib, err, "sched_virtual")
    _count("sched_virtual")
    return s, e, nm


SCHED_MAX_DEPTH = 32  # depths of a child-table schedule's tree (kMaxDepth)
SCHED_MAX_CHILDREN = 8  # child rows of one of its nodes (kMaxChildren)
SCHED_MAX_GROUPS = 32  # upper groups one block of its deep cut reaches (kMaxGroups)
SCHED_NODE_MARK = 64  # a staged row at or past it is a node child (kNodeMark)
SCHED_PIX_TILE = 1024  # pixels a block of its pixel pass takes from one row (kPixTile)
SCHED_ZERO_WORDS = 19  # zeroed int32 words it takes before the groups' counters (kZeroWords)
ISET_MAX_LEVELS = 16  # I levels of a 2D field (kMaxIset)


class SchedTable(ct.Structure):
    """kernels/schedule.cu's SchedTable, field for field."""

    _fields_ = [(f, ct.c_void_p) for f in ("mags", "ch_src", "ch_bounds", "px_parent")] + [
        ("sub", ct.c_void_p * 2)] + [(f, ct.c_void_p) for f in ("links", "leaf", "nm", "num_bp", "s", "e", "iset_s",
                                                                "zw")] + [
        ("n", ct.c_longlong), ("levels", ct.c_int)] + [(f, ct.c_int * 2) for f in ("cut", "nblk", "nsub")] + [
        (f, ct.c_int) for f in ("smem", "nroots", "ny", "nx", "xf", "depth", "row", "plane", "leaf64")] + [
        ("depth_lo", ct.c_int * (SCHED_MAX_DEPTH + 1)), ("ax", ct.c_int * (ISET_MAX_LEVELS + 1)),
        ("ay", ct.c_int * (ISET_MAX_LEVELS + 1))]


class SubtreePlan(NamedTuple):
    """The static plan of a child-table schedule (ops/speck.py
    ``subtree_plan``): ``cuts``, its cut depths (one, or two with the
    second shallower: its groups' subtrees end where the first cut's
    begin); ``depth_lo``, the first node id of each depth and nn;
    ``nroots``; ``smem``, a block's dynamic shared bytes; ``sub``, per cut
    a (2, nsub, nblk + 1) int32 tensor on the device: at depth cut + j, the
    first node and the first child row of each block's (or group's) run of
    the cut's nodes, the ends last; ``links`` (two cuts), int32 on the
    device: each block's first and last group, then each group's blocks;
    ``leaf``, on the device, each node of the deepest depth (a box of at
    most 2 x 2 x 2 pixels): its first pixel's linear index << 3 | its sides
    - 1 (x, y << 1, z << 2), int32, or int64 where a box starts at or past
    pixel 2^28; ``strides``, a pixel's y and z strides."""

    cuts: Tuple[int, ...]
    depth_lo: Tuple[int, ...]
    nroots: int
    smem: int
    sub: Tuple[torch.Tensor, ...]
    links: Optional[torch.Tensor]
    leaf: torch.Tensor
    strides: Tuple[int, int]


def _aligned(words: int) -> int:
    return -(-int(words) // 32) * 32


def sched_table(mags: torch.Tensor, ch_src: torch.Tensor, ch_bounds: torch.Tensor, px_parent: torch.Tensor,
                plan: SubtreePlan, grid: Optional[Tuple[int, int]] = None, regions=None):
    """The child-table schedule: mags (n,) int32; ch_src (rows,) int32,
    each child row's pixel (its linear index) or node (-(id + 1));
    ch_bounds (nn + 1,) int32, node k's rows ch_bounds[k] ..
    ch_bounds[k+1]-1; px_parent (n,) int32; the plan; grid (ny, nx), the
    pixels' rows (default (1, n)); ``regions`` [(ax_k, ay_k) for k = 0 ..
    xf], a 2D field's I levels (level k's region: every pixel with y >= ay_k
    or x >= ax_k) -> (num_bp () int32, s, e (n,) int32, nm (nn,) int32),
    and iset_s (xf + 1,) int32 after them with ``regions``: NEVER at 0 and
    for a region with no significant pixel, else num_bp - its maximum.  Two
    launches (the subtrees, the pixel pass); no fill, and no pm."""
    L = len(plan.cuts)
    for t, what in ((mags, "mags"), (ch_src, "ch_src"), (ch_bounds, "ch_bounds"), (px_parent, "px_parent"),
                    (plan.leaf, "plan.leaf"), *((sub, "plan.sub") for sub in plan.sub),
                    *(((plan.links, "plan.links"),) if L == 2 else ())):
        _require_cuda(t, torch.int64 if t is plan.leaf and t.dtype == torch.int64 else torch.int32, what)
        if t.device != mags.device:
            raise ValueError(f"{what} is on {t.device}, mags on {mags.device}")
    n, nn = mags.numel(), ch_bounds.numel() - 1
    ny, nx = (1, n) if grid is None else (int(grid[0]), int(grid[1]))
    if mags.dim() != 1 or n == 0 or px_parent.shape != (n,) or nn < 1 or ny * nx != n:
        raise ValueError(f"mags and px_parent must be (n > 0,) = grid, ch_bounds (nn + 1 > 1,); got "
                         f"{tuple(mags.shape)}, {tuple(px_parent.shape)}, {tuple(ch_bounds.shape)}, grid {grid}")
    if (not 1 <= L <= 2 or len(plan.sub) != L
            or any(sub.dim() != 3 or sub.shape[0] != 2 or sub.shape[2] < 2 for sub in plan.sub)
            or not 2 <= len(plan.depth_lo) <= SCHED_MAX_DEPTH + 1 or plan.depth_lo[-1] != nn
            or plan.leaf.shape != (nn - plan.depth_lo[-2],)
            or (L == 2 and plan.links.shape != (2 * (plan.sub[0].shape[2] - 1) + plan.sub[1].shape[2] - 1,))):
        raise ValueError(f"a plan of one or two cuts over at most {SCHED_MAX_DEPTH} depths of the {nn} nodes; "
                         f"got cuts {plan.cuts}, depth starts {plan.depth_lo}")
    xf = -1 if regions is None else len(regions) - 1
    if regions is not None and not 0 <= xf <= ISET_MAX_LEVELS:
        raise ValueError(f"0 to {ISET_MAX_LEVELS} I levels; got {xf}")
    dev = mags.device
    # one allocation: s, e, nm, num_bp, then iset_s where asked (each 128-byte aligned)
    sizes = [n, n, nn, 1] + ([xf + 1] if regions is not None else [])
    offs = np.cumsum([0] + [_aligned(w) for w in sizes])
    buf = torch.empty(int(offs[-1]), dtype=torch.int32, device=dev)
    parts = [buf[int(o):int(o) + w] for o, w in zip(offs, sizes)]
    s, e, nm, num_bp = parts[:4]
    iset_s = parts[-1] if regions is not None else None
    a = SchedTable(
        mags=mags.data_ptr(), ch_src=ch_src.data_ptr(), ch_bounds=ch_bounds.data_ptr(),
        px_parent=px_parent.data_ptr(), links=plan.links.data_ptr() if L == 2 else None, nm=nm.data_ptr(),
        num_bp=num_bp.data_ptr(), s=s.data_ptr(), e=e.data_ptr(),
        iset_s=None if iset_s is None else iset_s.data_ptr(), n=n, levels=L, smem=plan.smem, nroots=plan.nroots,
        ny=ny, nx=nx, xf=max(xf, 0), leaf=plan.leaf.data_ptr(), depth=len(plan.depth_lo) - 1,
        row=plan.strides[0], plane=plan.strides[1], leaf64=int(plan.leaf.dtype == torch.int64))
    for v, (cut, sub) in enumerate(zip(plan.cuts, plan.sub)):
        a.sub[v] = sub.data_ptr()
        a.cut[v], a.nsub[v], a.nblk[v] = cut, sub.shape[1], sub.shape[2] - 1
    a.depth_lo[:len(plan.depth_lo)] = plan.depth_lo
    for k in range(1, xf + 1):
        a.ax[k], a.ay[k] = int(regions[k][0]), int(regions[k][1])
    words = SCHED_ZERO_WORDS + (a.nblk[1] if L == 2 else 0)
    lib = load(dev)
    with _on_device(mags), _zeroed(dev, -(-words // 2)) as zw:
        a.zw = zw.data_ptr()
        err = lib.sperr_sched_table(ct.byref(a), _stream(mags))
        _check(lib, err, "sched_table")
    _count("sched_table", 2)
    out = (num_bp.reshape(()), s, e, nm)
    return out if regions is None else out + (iset_s,)


def sched_pyramid(mags: torch.Tensor, deep_idx: torch.Tensor, levels: int,
                  ax_depth: Tuple[int, int, int], e_src: torch.Tensor, nm_src: torch.Tensor):
    """The pyramid schedule: mags (n,) int32, deep_idx (n,) int32 (each
    pixel's cell of the deepest level), levels L, ax_depth (az, ay, ax):
    level d is 2^min(d, az) x 2^min(d, ay) x 2^min(d, ax), the levels
    concatenated depth 0 first; e_src (n,), nm_src (nn,) int32 cells of that
    concatenation -> (num_bp () int32, s, e (n,) int32, nm (nn,) int32).
    2 + L launches."""
    for t, what in ((mags, "mags"), (deep_idx, "deep_idx"), (e_src, "e_src"), (nm_src, "nm_src")):
        _require_cuda(t, torch.int32, what)
        if t.device != mags.device:
            raise ValueError(f"{what} is on {t.device}, mags on {mags.device}")
    n, nn, L = mags.numel(), nm_src.numel(), int(levels)
    az, ay, ax = (int(v) for v in ax_depth)
    if (mags.dim() != 1 or n == 0 or deep_idx.shape != (n,) or e_src.shape != (n,) or nn == 0
            or not 0 <= L <= 30 or max(az, ay, ax) > L):
        raise ValueError(f"mags, deep_idx, e_src (n > 0,), nm_src (nn > 0,), 0 <= depths <= L <= 30; got "
                         f"{tuple(mags.shape)}, {tuple(deep_idx.shape)}, {tuple(e_src.shape)}, "
                         f"{tuple(nm_src.shape)}, L {L}, {ax_depth}")
    dev = mags.device
    cells = sum(1 << (min(d, az) + min(d, ay) + min(d, ax)) for d in range(L + 1))
    flat = torch.empty(cells, dtype=torch.uint8, device=dev)
    num_bp = torch.zeros((), dtype=torch.int32, device=dev)
    s = torch.empty(n, dtype=torch.int32, device=dev)
    e = torch.empty(n, dtype=torch.int32, device=dev)
    nm = torch.empty(nn, dtype=torch.int32, device=dev)
    lib = load(dev)
    with _on_device(mags):
        err = lib.sperr_sched_pyramid(
            mags.data_ptr(), n, deep_idx.data_ptr(), L, az, ay, ax, flat.data_ptr(), e_src.data_ptr(),
            nm_src.data_ptr(), nn, num_bp.data_ptr(), s.data_ptr(), e.data_ptr(), nm.data_ptr(),
            _stream(mags),
        )
    _check(lib, err, "sched_pyramid")
    _count("sched_pyramid", 2 + L)
    return num_bp, s, e, nm


# ---------------------------------------------------------------------------
# K7, K8: the 3D set walk, and the stable radix sort (kernels/walk.cu).  The
# forest descriptor and the rank plan are int32 arrays that
# ops/speck_virtual.py lays out (walk_forest, rank_plan).
# ---------------------------------------------------------------------------
SORT_THREADS = 256  # threads per tile of the radix sort (kSortThreads in walk.cu)
SORT_ITEMS = 16  # keys per thread (kSortItems)
SORT_TILE = SORT_THREADS * SORT_ITEMS  # keys per tile (kTile)
SORT_PASSES = 8  # digit passes a sort may take (kSortPasses)
RANK_SPANS = 16  # id spans per level of the rank plan (kMaxSpans)
RANK_LEVEL_INTS = 3 + 2 * RANK_SPANS  # words per level (kLevelInts)
RANK_SMALL_MAX = 4096  # nodes of a level ranked in one block (kSmallMax)
RANK_SMALL_BITS = 21  # key bits of a level ranked in one block (kSmallBits)
RANK_SCAN_GROUPS = 256 * 4  # 8-word groups per block of a larger level's scan (kScanGroups)
RANK_BITMAP_BITS = 32  # widest keys a level ranks by its presence bitmap; wider ones sort (kBitmapBits)
FOREST_DEPTHS = 14  # entries of the forest's per-depth tables (kMaxDepth)
FOREST_ROOTS = 64  # roots the forest descriptor holds (kMaxRoots)


def radix_shifts(bits: int):
    """The digit passes (shifts of 8-bit digits) that sort keys of ``bits``
    significant bits: digits above them are equal for every key."""
    bits = int(bits)
    return [8 * p for p in range(-(-bits // 8))]


def sort_scratch_words(n: int) -> int:
    """8-byte words of the radix sort's zeroed scratch for n keys
    (sort_scratch_words in walk.cu): 256 status words per tile, the digit
    counts of every pass, the counters."""
    return -(-int(n) // SORT_TILE) * 256 + SORT_PASSES * 256 // 2 + SORT_PASSES


def radix_sort(keys: torch.Tensor, bits: Optional[int] = None, vals: Optional[torch.Tensor] = None,
               out=None, scratch=None):
    """The stable LSD radix sort: keys (n,) int32 or int64, read as signed,
    with vals (n,) int32 (None: 0 .. n-1) -> (sorted keys, the values in the
    same order).  ``bits``: every key's bits above this many are equal
    (nonnegative keys below 2^bits), so only the digits below are sorted;
    None sorts every digit.  One histogram launch, then one launch per
    8-bit digit.  ``out`` (sorted keys, values) and ``scratch`` (n keys, n
    int32, ``sort_scratch_words(n)`` int64), where given, are written in
    place of new tensors (a caller that keeps its buffers)."""
    if not keys.is_cuda or keys.dtype not in (torch.int32, torch.int64) or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous int32 or int64 CUDA tensor; got {keys.dtype} "
                         f"on {keys.device}")
    if keys.dim() != 1 or keys.numel() == 0 or keys.numel() >= 2**31:
        raise ValueError(f"keys must be (n,) with 0 < n < 2^31; got {tuple(keys.shape)}")
    n = keys.numel()
    if vals is not None:
        _require_cuda(vals, torch.int32, "vals")
        if vals.shape != keys.shape or vals.device != keys.device:
            raise ValueError(f"vals must be (n,) on {keys.device}; got {tuple(vals.shape)} on {vals.device}")
    width = 8 * keys.element_size()
    bits = width if bits is None else int(bits)
    if not 1 <= bits <= width:
        raise ValueError(f"bits must be in [1, {width}]; got {bits}")
    shifts = radix_shifts(bits)
    dev = keys.device
    if scratch is None:
        scratch = (torch.empty_like(keys), torch.empty(n, dtype=torch.int32, device=dev),
                   torch.empty(sort_scratch_words(n), dtype=torch.int64, device=dev))
    if out is None:
        out = (torch.empty_like(keys), torch.empty(n, dtype=torch.int32, device=dev))
    kbuf, vbuf, zbuf = scratch
    kout, vout = out
    for t, dtype, m, what in ((kbuf, keys.dtype, n, "scratch keys"), (vbuf, torch.int32, n, "scratch values"),
                              (zbuf, torch.int64, sort_scratch_words(n), "scratch words"),
                              (kout, keys.dtype, n, "out keys"), (vout, torch.int32, n, "out values")):
        if t.dtype != dtype or t.device != dev or t.numel() < m or not t.is_contiguous():
            raise ValueError(f"{what} must be {m} contiguous {dtype} on {dev}; got {t.numel()} {t.dtype} "
                             f"on {t.device}")
    lib = load(dev)
    with _on_device(keys):
        err = lib.sperr_radix_sort(
            keys.data_ptr(), keys.element_size(), None if vals is None else vals.data_ptr(), n,
            (ct.c_int * len(shifts))(*shifts), len(shifts), kbuf.data_ptr(), vbuf.data_ptr(),
            kout.data_ptr(), vout.data_ptr(), zbuf.data_ptr(), zbuf.numel(), _stream(keys),
        )
    _check(lib, err, "radix_sort")
    _count("radix_sort", 1 + len(shifts))
    return kout, vout


def gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] for src (n,) int32 or int64 and idx (m,) int32 on one CUDA
    device (one launch, counted with the radix sort it serves)."""
    if not src.is_cuda or src.dtype not in (torch.int32, torch.int64) or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous int32 or int64 CUDA tensor; got {src.dtype} "
                         f"on {src.device}")
    _require_cuda(idx, torch.int32, "idx")
    if idx.device != src.device or src.dim() != 1 or idx.dim() != 1 or idx.numel() == 0:
        raise ValueError(f"src and idx must be non-empty (n,) tensors on one device; got "
                         f"{tuple(src.shape)} on {src.device}, {tuple(idx.shape)} on {idx.device}")
    out = torch.empty(idx.numel(), dtype=src.dtype, device=src.device)
    lib = load(src.device)
    with _on_device(src):
        err = lib.sperr_gather(src.data_ptr(), src.element_size(), idx.data_ptr(), out.data_ptr(),
                               idx.numel(), _stream(src))
    _check(lib, err, "gather")
    _count("radix_sort")
    return out


def radix_lexsort(keys, bits=None) -> torch.Tensor:
    """Permutation (int32) that sorts stably by keys[0], then keys[1], ...:
    LSD over the keys, the last first (``bits``: each key's width, as
    ``radix_sort``); between keys one gather carries the next key into the
    order so far."""
    keys = list(keys)
    bits = [None] * len(keys) if bits is None else list(bits)
    if not keys or len(bits) != len(keys):
        raise ValueError(f"one width per key; got {len(keys)} keys, {len(bits)} widths")
    if keys[0].numel() == 0:
        return torch.empty(0, dtype=torch.int32, device=keys[0].device)
    perm = None
    for k, b in zip(reversed(keys), reversed(bits)):
        k = k.contiguous() if perm is None else gather(k.contiguous(), perm)
        perm = radix_sort(k, b, perm)[1]
    return perm


def _forest_check(forest: torch.Tensor, dev) -> None:
    _require_cuda(forest, torch.int32, "forest")
    if forest.device != dev:
        raise ValueError(f"the forest descriptor is on {forest.device}, the tensors on {dev}")


def walk_vtab(s: torch.Tensor, signs: torch.Tensor, mags: Optional[torch.Tensor],
              node_s: torch.Tensor, forest: torch.Tensor, N: int, nt: int) -> torch.Tensor:
    """The walk's 8-aligned child value table of an N^3 cube (nt int32): the
    pixels' clip(s, 0, 127) | sign << 7 [| min(mag, 2^23 - 1) << 8] in
    2x2x2-box-major order, then each depth's node_s, padded with NEVER to a
    multiple of 8.  One launch."""
    for t, dtype, what in ((s, torch.int32, "s"), (signs, torch.bool, "signs"),
                           (node_s, torch.int32, "node_s")) + (
                               () if mags is None else ((mags, torch.int32, "mags"),)):
        _require_cuda(t, dtype, what)
        if t.device != s.device:
            raise ValueError(f"{what} is on {t.device}, s on {s.device}")
    N, nt = int(N), int(nt)
    n = N ** 3
    if N < 2 or N & (N - 1) or s.shape != (n,) or signs.shape != (n,) or (
            mags is not None and mags.shape != (n,)) or nt < n:
        raise ValueError(f"s, signs and mags must be ({n},) for N = {N}, nt >= n; got {tuple(s.shape)}, "
                         f"{tuple(signs.shape)}, nt {nt}")
    if any(t.data_ptr() % 8 for t in (s, signs) + (() if mags is None else (mags,))):
        raise ValueError("s, signs and mags must be 8-byte aligned (the kernel loads pixel pairs)")
    _forest_check(forest, s.device)
    vtab = torch.empty(nt, dtype=torch.int32, device=s.device)
    lib = load(s.device)
    with _on_device(s):
        err = lib.sperr_walk_vtab(s.data_ptr(), signs.data_ptr(), None if mags is None else mags.data_ptr(),
                                  node_s.data_ptr(), forest.data_ptr(), N, nt, vtab.data_ptr(), _stream(s))
    _check(lib, err, "walk_vtab")
    _count("walk_vtab")
    return vtab


class AnchorRanks(NamedTuple):
    J: torch.Tensor     # (nn,) int32: each node's same-pass chain top
    R: torch.Tensor     # (nn,) int32: its string rank in its level (0 on leaf levels)
    sigf: Optional[torch.Tensor]  # (nn,) uint8: node_s < NEVER (the walk's flags)
    wbuf: Optional[torch.Tensor]  # (nn + 1,) int32, BIG: the walk's rank table


class RankLayout(NamedTuple):
    """K7's scratch for a rank plan (as sperr_anchor_ranks lays it out):
    its first ``nbitmap`` levels ranked by their presence bitmaps, the rest
    by sorting their keys."""

    bits: Tuple[int, ...]        # key bits of each level, 12 + wk
    nbitmap: int                 # leading levels ranked by bitmaps (keys within bitmap_bits)
    nsmall: int                  # of them, the leading ones ranked in one block
    words: Tuple[int, ...]       # 4-byte words of each bitmap level's bitmap, 2^(bits - 5)
    scan_blocks: Tuple[int, ...]  # blocks of each larger bitmap level's group scan (0: one block)
    zwords: int                  # 4-byte words zeroed per call: the bitmaps, then per larger
                                 # level its groups' counts, scan blocks' sums and a counter
    keys: int                    # keys of the largest larger bitmap level


def rank_layout(plan_host: np.ndarray, nsmall: int, bitmap_bits: int = RANK_BITMAP_BITS) -> RankLayout:
    """The bitmaps and scan blocks of a rank plan: the levels before the
    first whose keys are wider than ``bitmap_bits`` (at most 32) take the
    bitmaps, that level and the rest sort their keys (``_rank_sorted``);
    the one-block levels are the first min(nsmall, nbitmap).  Raises where
    a level ranked in one block has more than RANK_SMALL_MAX nodes or
    RANK_SMALL_BITS key bits."""
    if not 12 <= bitmap_bits <= RANK_BITMAP_BITS:
        raise ValueError(f"bitmap_bits must be in [12, {RANK_BITMAP_BITS}]; got {bitmap_bits}")
    levels = np.asarray(plan_host, dtype=np.int64).reshape(-1, RANK_LEVEL_INTS)
    bits = tuple(12 + int(w) for w in levels[:, 1])
    if any(not 12 <= b <= 43 for b in bits):  # u < 2^12 above a rank + 1 < 2^31
        raise ValueError(f"rank keys of {bits} bits")
    nbm = next((k for k, b in enumerate(bits) if b > bitmap_bits), len(bits))
    nsmall = min(nsmall, nbm)
    if (levels[:nsmall, 0] > RANK_SMALL_MAX).any() or any(b > RANK_SMALL_BITS for b in bits[:nsmall]):
        raise ValueError(f"a level ranked in one block has more than {RANK_SMALL_MAX} nodes or "
                         f"keys wider than {RANK_SMALL_BITS} bits")
    words = tuple(1 << (b - 5) for b in bits[:nbm])
    blocks = tuple(0 if k < nsmall else -(-(w // 8) // RANK_SCAN_GROUPS) for k, w in enumerate(words))
    big = range(nsmall, nbm)
    # per larger level: its groups' counts, then its blocks' sums and their
    # counter padded to 16 bytes
    return RankLayout(bits, nbm, nsmall, words, blocks,
                      sum(words) + sum(words[k] // 8 + -(-(blocks[k] + 1) // 4) * 4 for k in big),
                      max((int(levels[k, 0]) for k in big), default=1))


def _rank_sorted(lib, plan: torch.Tensor, plan_host: np.ndarray, first: int, u: int, jp: int,
                 R: int, dev) -> int:
    """The plan's levels from ``first`` on, coarse first, ranked by
    sorting their keys (u, jp, R: the (nn,) int32 buffers' addresses on
    dev): per level its keys packed in 64 bits, the radix sort over their
    12 + wk bits carrying their positions, then the heads and their ranks
    (rank.cuh).  Returns the launches besides the sort's."""
    levels = plan_host.reshape(-1, RANK_LEVEL_INTS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for l in range(first, levels.shape[0]):
        cnt, wk = int(levels[l, 0]), int(levels[l, 1])
        L = plan.data_ptr() + 4 * RANK_LEVEL_INTS * l
        keys = torch.empty(cnt, dtype=torch.int64, device=dev)
        err = lib.sperr_rank_keys(L, cnt, u, jp, R, keys.data_ptr(), stream)
        _check(lib, err, "rank_keys")
        sk, sv = radix_sort(keys, 12 + wk, None)  # the values: each key's position in the level
        scratch = torch.empty(lib.sperr_rank_scratch_words(cnt), dtype=torch.int32, device=dev)
        err = lib.sperr_rank_sorted(L, cnt, sk.data_ptr(), sv.data_ptr(), scratch.data_ptr(), scratch.numel(), R,
                                    stream)
        _check(lib, err, "rank_sorted")
    return 4 * (levels.shape[0] - first)


def anchor_ranks(node_s: torch.Tensor, forest: torch.Tensor, plan: torch.Tensor,
                 plan_host: np.ndarray, nsmall: int, walk: bool = False,
                 bitmap_bits: int = RANK_BITMAP_BITS) -> AnchorRanks:
    """K7: the chain tops J and string ranks R of every node from node_s
    (nn,) int32.  ``plan``: the ranked levels (RANK_LEVEL_INTS words each,
    ascending), the first ``nsmall`` of them ranked in one block, each other
    by a presence bitmap of its keys in three launches, or where its keys
    are wider than ``bitmap_bits`` by sorting them (``rank_layout``).
    With ``walk``, also the walk's significance flags and its rank table
    (set to BIG)."""
    _require_cuda(node_s, torch.int32, "node_s")
    dev = node_s.device
    _forest_check(forest, dev)
    _require_cuda(plan, torch.int32, "plan")
    nn = node_s.numel()
    plan_host = np.ascontiguousarray(plan_host, dtype=np.int32)
    nlev = plan_host.size // RANK_LEVEL_INTS
    if (node_s.dim() != 1 or nn == 0 or plan.numel() != plan_host.size
            or plan_host.size % RANK_LEVEL_INTS or not 0 <= nsmall <= nlev):
        raise ValueError(f"node_s (nn > 0,) and a plan of {RANK_LEVEL_INTS}-word levels; got "
                         f"{tuple(node_s.shape)}, {plan.numel()} words, nsmall {nsmall}")
    lay = rank_layout(plan_host, nsmall, bitmap_bits)
    J = torch.empty(nn, dtype=torch.int32, device=dev)
    R = torch.empty(nn, dtype=torch.int32, device=dev)
    u = torch.empty(nn, dtype=torch.int32, device=dev)
    jp = torch.empty(nn, dtype=torch.int32, device=dev)
    sigf = torch.empty(nn, dtype=torch.uint8, device=dev) if walk else None
    wbuf = torch.empty(nn + 1, dtype=torch.int32, device=dev) if walk else None
    keys = torch.empty(lay.keys, dtype=torch.int32, device=dev)
    zbuf = torch.empty(max(1, lay.zwords), dtype=torch.int32, device=dev)
    lib = load(dev)
    with _on_device(node_s):
        err = lib.sperr_anchor_ranks(
            node_s.data_ptr(), forest.data_ptr(), nn, plan.data_ptr(),
            plan_host.ctypes.data_as(ct.c_void_p), lay.nsmall, lay.nbitmap, J.data_ptr(), R.data_ptr(),
            u.data_ptr(), jp.data_ptr(), None if sigf is None else sigf.data_ptr(),
            None if wbuf is None else wbuf.data_ptr(), keys.data_ptr(), zbuf.data_ptr(), zbuf.numel(),
            _stream(node_s),
        )
        _check(lib, err, "anchor_ranks")
        sorted_launches = _rank_sorted(lib, plan, plan_host, lay.nbitmap, u.data_ptr(), jp.data_ptr(), R.data_ptr(),
                                       dev)
    _count("anchor_ranks", 1 + (1 if lay.nsmall else 0) + 3 * (lay.nbitmap - lay.nsmall) + sorted_launches)
    return AnchorRanks(J, R, sigf, wbuf)


def _walk_args(sid: torch.Tensor, idxE: Optional[torch.Tensor], tensors, forest: torch.Tensor):
    dev = sid.device
    _require_cuda(sid, torch.int32, "sid")
    if idxE is not None:
        _require_cuda(idxE, torch.int32, "idxE")
    for t, what in tensors:
        _require_cuda(t, torch.int32, what)
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, sid on {dev}")
    _forest_check(forest, dev)


def walk_rows(sid: torch.Tensor, node_s: torch.Tensor, vtab: torch.Tensor, forest: torch.Tensor,
              C: int, pay: torch.Tensor) -> torch.Tensor:
    """The child rows of the compacted parents sid (take,) int32 (ascending,
    the sentinel nn past the significant sets; slots take .. C-1 are none):
    their payload words into pay (8 C,) int32, a view of the walk's item
    words; returns each parent's eligibility (node children) (C,) uint8.
    One launch."""
    _walk_args(sid, None, ((node_s, "node_s"), (vtab, "vtab"), (pay, "pay")), forest)
    C = int(C)
    if C < 1 or pay.shape != (8 * C,) or vtab.data_ptr() % 32:
        raise ValueError(f"pay must be ({8 * C},) and vtab 32-byte aligned; got {tuple(pay.shape)}")
    elig = torch.empty(C, dtype=torch.uint8, device=sid.device)
    lib = load(sid.device)
    with _on_device(sid):
        err = lib.sperr_walk_rows(sid.data_ptr(), sid.numel(), node_s.data_ptr(), vtab.data_ptr(),
                                  forest.data_ptr(), C, pay.data_ptr(), elig.data_ptr(), _stream(sid))
    _check(lib, err, "walk_rows")
    _count("walk_rows")
    return elig


def walk_born(sid: torch.Tensor, idxE: Optional[torch.Tensor], C: int, node_s: torch.Tensor,
              J: torch.Tensor, R: torch.Tensor, forest: torch.Tensor, CB: int, nlev: int,
              wa: int, pw: int, path_words: int):
    """The born entries (CB, 8 per eligible parent: idxE (CB // 8,) int32,
    the compacted eligible parents with the sentinel C, or None when every
    parent slot has its own) -> (their insertion keys: [int64 key] when
    ``pw`` > 0 (path packed below the rank), else [int64 key, path word 0
    (, path word 1)], the valid entries per level (nlev + 1,) int32).  One
    launch."""
    _walk_args(sid, idxE, ((node_s, "node_s"), (J, "J"), (R, "R")), forest)
    dev = sid.device
    CB = int(CB)
    key0 = torch.empty(CB, dtype=torch.int64, device=dev)
    kp = [torch.empty(CB, dtype=torch.int32, device=dev) for _ in range(0 if pw else path_words)]
    counts = torch.empty(nlev + 1, dtype=torch.int32, device=dev)
    lib = load(dev)
    with _on_device(sid):
        err = lib.sperr_walk_born(
            sid.data_ptr(), sid.numel(), None if idxE is None else idxE.data_ptr(), int(C),
            node_s.data_ptr(), J.data_ptr(), R.data_ptr(), forest.data_ptr(), CB, int(nlev), int(wa),
            int(pw), key0.data_ptr(), kp[0].data_ptr() if kp else None,
            kp[1].data_ptr() if len(kp) > 1 else None, counts.data_ptr(), _stream(sid),
        )
    _check(lib, err, "walk_born")
    _count("walk_rows", 1 if CB else 0)
    return [key0] + kp, counts


def walk_entries(perm: torch.Tensor, counts: torch.Tensor, sid: torch.Tensor,
                 idxE: Optional[torch.Tensor], C: int, node_s: torch.Tensor, J: torch.Tensor,
                 R: torch.Tensor, forest: torch.Tensor, CB: int, nroots: int, tcap: int, pw0: int,
                 wbuf: torch.Tensor, pay: torch.Tensor, key0: torch.Tensor,
                 key1: Optional[torch.Tensor]) -> None:
    """After the insertion sort (perm (CB,) int32): each list entry's walk
    rank into wbuf, its payload word into pay[: CB + nroots], its walk-sort
    key into key0 (and key1).  One launch."""
    _walk_args(sid, idxE, ((perm, "perm"), (counts, "counts"), (node_s, "node_s"), (J, "J"),
                           (R, "R"), (wbuf, "wbuf"), (pay, "pay")), forest)
    if (key0.dtype != torch.int64 or not key0.is_contiguous()
            or (key1 is not None and key1.dtype != torch.int32)):
        raise ValueError("key0 must be contiguous int64, key1 int32")
    lib = load(sid.device)
    with _on_device(sid):
        err = lib.sperr_walk_entries(
            perm.data_ptr(), counts.data_ptr(), sid.data_ptr(), sid.numel(),
            None if idxE is None else idxE.data_ptr(), int(C), node_s.data_ptr(), J.data_ptr(),
            R.data_ptr(), forest.data_ptr(), int(CB), int(nroots), int(tcap), int(pw0),
            wbuf.data_ptr(), pay.data_ptr(), key0.data_ptr(), None if key1 is None else key1.data_ptr(),
            _stream(sid),
        )
    _check(lib, err, "walk_entries")
    _count("walk_rows")


def walk_rowkeys(sid: torch.Tensor, C: int, J: torch.Tensor, wbuf: torch.Tensor,
                 forest: torch.Tensor, tcap: int, pw0: int, key0: torch.Tensor,
                 key1: Optional[torch.Tensor]) -> None:
    """The child rows' walk-sort keys into key0 (8 C,) int64 (and key1):
    their chain top's walk rank and the child path.  One launch."""
    _walk_args(sid, None, ((J, "J"), (wbuf, "wbuf")), forest)
    C = int(C)
    if key0.dtype != torch.int64 or key0.shape != (8 * C,) or (key1 is not None and key1.shape != (8 * C,)):
        raise ValueError(f"key0 must be ({8 * C},) int64; got {key0.dtype} {tuple(key0.shape)}")
    lib = load(sid.device)
    with _on_device(sid):
        err = lib.sperr_walk_rowkeys(sid.data_ptr(), sid.numel(), C, J.data_ptr(), wbuf.data_ptr(),
                                     forest.data_ptr(), int(tcap), int(pw0), key0.data_ptr(),
                                     None if key1 is None else key1.data_ptr(), _stream(sid))
    _check(lib, err, "walk_rowkeys")
    _count("walk_rows")


# ---------------------------------------------------------------------------
# K9: the emission's pixel stage (kernels/emit.cu)
# ---------------------------------------------------------------------------
def _num_bp_word(num_bp: torch.Tensor, dev) -> torch.Tensor:
    _require_cuda(num_bp, torch.int32, "num_bp")
    if num_bp.numel() != 1 or num_bp.device != dev:
        raise ValueError(f"num_bp must be one int32 on {dev}; got {tuple(num_bp.shape)} on {num_bp.device}")
    return num_bp


class CubeStage(NamedTuple):
    exp_idx: torch.Tensor  # (min(8 take_b, wexp_cap),) int32 ascending pixel indices, sentinel n
    exp_ll: torch.Tensor   # (wexp_cap,) int32 signed magnitudes, 0 past the kept pixels
    n_exp: torch.Tensor    # () int32, 8 x the exposed boxes
    overflow: torch.Tensor  # () bool, more exposed boxes than take_b
    parts: list            # [(valid, bits)] of LIP, LIS and REF: (P, W) int32 planes each


STAGE_ITEMS = 1024  # LIP/REF items per pixel block of the planes launch (kStageItems)
STAGE_LIS_WORDS = 64  # LIS words per LIS block (kStageLis)


def _stage_parts(dev, P: int, widths):
    """The (valid, bits) (P, W) planes of LIP, LIS and REF, one after the
    other in one int32 buffer (the order the kernel writes them)."""
    buf = torch.empty(2 * P * sum(widths), dtype=torch.int32, device=dev)
    parts, o = [], 0
    for W in widths:
        pl = buf[o:o + 2 * P * W].view(2, P, W)
        parts.append((pl[0], pl[1]))
        o += 2 * P * W
    return buf, parts


def _stage_common(pay: torch.Tensor, num_bp: torch.Tensor, P: int, dev):
    """The payload's word count and LIS width (the payloads padded to 128),
    after the checks the two forms share."""
    _require_cuda(pay, torch.int32, "pay")
    if pay.dim() != 1 or pay.device != dev:
        raise ValueError(f"pay must be 1-D on {dev}; got {tuple(pay.shape)} on {pay.device}")
    if P < 1:
        raise ValueError(f"P must be >= 1; got {P}")
    _num_bp_word(num_bp, dev)
    n_pay = pay.numel()
    return n_pay, -(-n_pay // 128) * 128 // 16


def emit_cube(pv_bm: torch.Tensor, mags: Optional[torch.Tensor], s: torch.Tensor,
              num_bp: torch.Tensor, N: int, wexp_cap: int, pay: torch.Tensor, P: int) -> CubeStage:
    """K9 on an N^3 cube: the exposed-pixel compaction from its box-major
    pixel table pv_bm (n,) int32 (clip(s, 0, 127) | sign << 7, with
    min(mag, 2^23 - 1) << 8 when ``mags`` is None; else mags (n,) int32 in
    linear order), the linear schedule s (n,) (read only when num_bp is
    outside [1, 127]) and num_bp (one int32), keeping the first
    max(1, wexp_cap // 8) exposed boxes, then the LIP and refinement planes
    of the kept pixels (padded to a multiple of 256) and the LIS planes of
    the walk's payload words ``pay`` (padded to a multiple of 128), P
    passes: as ``ops/wave_pack.emit_cube_ref`` defines them.  Two launches
    (rows, planes), no host synchronisation; no pixel field is stored."""
    N, wexp_cap, P = int(N), int(wexp_cap), int(P)
    n = N ** 3
    dev = pv_bm.device
    for t, what in ((pv_bm, "pv_bm"), (s, "s")) + (() if mags is None else ((mags, "mags"),)):
        _require_cuda(t, torch.int32, what)
        if t.shape != (n,) or t.device != dev:
            raise ValueError(f"{what} must be ({n},) on {dev}; got {tuple(t.shape)} on {t.device}")
    if not 2 <= N <= 1024 or N & (N - 1) or not 0 < wexp_cap < n:
        raise ValueError(f"N must be a power of two in [2, 1024] and 0 < wexp_cap < N^3; got {N}, {wexp_cap}")
    if pv_bm.data_ptr() % 16:
        raise ValueError("pv_bm must be 16-byte aligned (the kernel loads boxes of 32 bytes)")
    n_pay, W_lis = _stage_common(pay, num_bp, P, dev)
    take_b = max(1, wexp_cap // 8)
    Lv = min(8 * take_b, wexp_cap)
    npad = -(-wexp_cap // 256) * 256
    Nh = N // 2
    NR = Nh * Nh
    # the indices, the signed values and n_exp in one int32 buffer; the row
    # flags and bases in another
    out = torch.empty(Lv + wexp_cap + 1, dtype=torch.int32, device=dev)
    scratch = torch.empty(NR * -(-Nh // 32) + NR + 1, dtype=torch.int32, device=dev)
    over = torch.empty((), dtype=torch.bool, device=dev)
    exp_idx, exp_ll, n_exp = out[:Lv], out[Lv:Lv + wexp_cap], out[-1]
    planes, parts = _stage_parts(dev, P, (npad // 16, W_lis, npad // 32))
    lib = load(dev)
    with _on_device(pv_bm), _zeroed(dev, lib.sperr_emit_status_words(N)) as status:
        err = lib.sperr_emit_cube(
            pv_bm.data_ptr(), None if mags is None else mags.data_ptr(), s.data_ptr(),
            num_bp.data_ptr(), N, take_b, Lv, wexp_cap, npad, pay.data_ptr(), n_pay, W_lis, P,
            scratch.data_ptr(), status.data_ptr(), exp_idx.data_ptr(), exp_ll.data_ptr(),
            n_exp.data_ptr(), over.data_ptr(), planes.data_ptr(), _stream(pv_bm),
        )
        _check(lib, err, "emit_stage")
    _count("emit_stage", 2)
    return CubeStage(exp_idx, exp_ll, n_exp, over, parts)


def emit_fields(pixels, pay: torch.Tensor, num_bp: torch.Tensor, P: int):
    """K9's planes launch for the 3D forms that hand their pixel fields:
    pixels = (s, e, sign, magnitude) of the LIP/REF items (int32; the sign
    int32 or bool), padded to a multiple of 256 items with (NEVER, NEVER,
    0, 0), and the walk's payload words ``pay`` -> [(valid, bits)] of LIP,
    LIS and REF, as ``ops/wave_pack.emit_fields_ref`` defines them.  One
    launch."""
    P = int(P)
    dev = pixels[0].device
    n_real = pixels[0].numel()
    for k, t in enumerate(pixels):
        dtype = torch.bool if (k == 2 and t.dtype == torch.bool) else torch.int32
        _require_cuda(t, dtype, f"pixel field {k}")
        if t.dim() != 1 or t.numel() != n_real or t.device != dev:
            raise ValueError(f"the pixel fields must be 1-D, of one length, on {dev}")
    n_pay, W_lis = _stage_common(pay, num_bp, P, dev)
    items = -(-n_real // 256) * 256
    planes, parts = _stage_parts(dev, P, (items // 16, W_lis, items // 32))
    if items + W_lis == 0:
        return parts
    g = pixels[2]
    lib = load(dev)
    with _on_device(pixels[0]):
        err = lib.sperr_emit_fields(
            pixels[0].data_ptr(), pixels[1].data_ptr(), g.data_ptr(), 1 if g.dtype == torch.bool else 4,
            pixels[3].data_ptr(), n_real, items, pay.data_ptr(), n_pay, W_lis, num_bp.data_ptr(), P,
            planes.data_ptr(), _stream(pixels[0]),
        )
    _check(lib, err, "emit_stage")
    _count("emit_stage")
    return parts


EMIT_CLASSES = {"lip": (0, 16, 3), "lis": (1, 16, 1), "ref": (2, 32, 2)}  # id, items per word, fields


def emit_planes(kind: str, fields, num_bp: torch.Tensor, P: int, items: int):
    """K9b: the (P, items // per_word) int32 valid and bit planes of one
    emission class, as ``ops/wave_pack.emit_planes_ref`` defines them:
    kind "lip" (fields s, e, sign: the sign int32 or bool; 16 items per
    word), "lis" (the payload words; 16) or "ref" (s, magnitudes; 32).
    The fields may be shorter than ``items``: the items past them take the
    padding.  One launch."""
    if kind not in EMIT_CLASSES:
        raise ValueError(f"kind must be one of {sorted(EMIT_CLASSES)}; got {kind!r}")
    cls, per_word, nf = EMIT_CLASSES[kind]
    if len(fields) != nf:
        raise ValueError(f"{kind} takes {nf} fields; got {len(fields)}")
    dev = fields[0].device
    n_real = fields[0].numel()
    for k, t in enumerate(fields):
        dtype = torch.bool if (kind == "lip" and k == 2 and t.dtype == torch.bool) else torch.int32
        _require_cuda(t, dtype, f"{kind} field {k}")
        if t.dim() != 1 or t.numel() != n_real or t.device != dev:
            raise ValueError(f"the {kind} fields must be 1-D, of one length, on {dev}")
    P, items = int(P), int(items)
    if P < 1 or items % per_word or items < n_real:
        raise ValueError(f"P >= 1 and {n_real} <= items, a multiple of {per_word}; got {P}, {items}")
    nb = _num_bp_word(num_bp, dev)
    W = items // per_word
    planes = torch.empty((2, P, W), dtype=torch.int32, device=dev)
    if W == 0:
        return planes[0], planes[1]
    f = list(fields) + [None] * (3 - nf)
    g_bytes = 1 if f[2] is not None and f[2].dtype == torch.bool else 4
    lib = load(dev)
    with _on_device(fields[0]):
        err = lib.sperr_emit_planes(
            cls, f[0].data_ptr(), None if f[1] is None else f[1].data_ptr(),
            None if f[2] is None else f[2].data_ptr(), g_bytes, n_real, W, nb.data_ptr(), P,
            planes[0].data_ptr(), planes[1].data_ptr(), _stream(fields[0]),
        )
    _check(lib, err, "emit_planes")
    _count("emit_planes")
    return planes[0], planes[1]


# ---------------------------------------------------------------------------
# K15 and K14: the table and 2D walks (kernels/walk_table.cu).  The walk's
# tables, buffers and sizes travel in one structure (TableArgs in the
# source: every field a pointer or a long long), which ops/speck_lis.py
# fills; the rank plan is K7's (RANK_LEVEL_INTS words per level).
# ---------------------------------------------------------------------------
TABLE_MAX_LEVELS = 30  # tree levels the walk takes (kMaxLevels - 2: the 2D class codes)
TABLE_MAX_CHILDREN = 8  # child slots of a node (kMaxChildren)
RANK_U_WORDS = 128  # words of a level's hop-word bitmap (kUWords in rank.cuh)
RANK_ULAY = 8  # int32 words per level of a u-rank layout (kULay)
RANK_STATE = 8  # int32 state words per level (kStInts)
RANK_CAP_BITS = 27  # widest region a larger level's keys mark (2^27 bits, 16 MB); wider keys overflow to the
                    # level's sorted route, gated on the device

TABLE_POINTERS = (
    "parent", "level", "pidx", "ptab", "ch_start", "ch_count", "ctab", "O0", "off0", "root_ids", "root_levels",
    "is_group", "k_of", "irank_of", "block_rank_of", "group_ids", "group_k", "gbit_rank", "lev_plan", "plan",
    "ulay", "node_s", "s_lin", "signs", "iset_s", "num_bp", "J", "R", "u", "jp", "sigf", "wbuf", "ubm", "uw",
    "upre", "rst", "sbm", "rbm", "rgc", "rbs", "rkeys", "gkeys", "gkbuf", "gvbuf", "gvout", "gzbuf", "gscr", "sid",
    "sid_count", "bflag", "born_idx", "born_count", "counts", "n_sig_out", "ikey", "perm", "pay", "wkey",
)
TABLE_SIZES = (
    "form", "nn", "n", "nrows", "MC", "nlev", "xf", "G", "nroots", "C", "take", "CB", "NE", "E", "rows", "tcap",
    "wbase", "wa", "pb", "nsmall", "dlow0", "gzwords", "gswords",
)


class TableArgs(ct.Structure):
    """kernels/walk_table.cu's struct TableArgs, field for field."""

    _fields_ = [(k, ct.c_void_p) for k in TABLE_POINTERS] + [(k, ct.c_longlong) for k in TABLE_SIZES]


class TableRankLayout(NamedTuple):
    """The table and 2D walks' rank levels (walk_table.cu, rank.cuh's u-rank
    route): every level of the plan ranked on a bitmap after its hop words
    are ranked (the first ``nsmall`` in one block, the others in three
    launches over a region of 2^min(12 + wk, cap) bits, two regions used in
    turn; a cap below RANK_SMALL_BITS also ranks the levels past it apart).
    ``gated``: the larger levels whose 12 + wk bits pass the cap, whose keys
    may overflow their region and then take their sorted route (its
    launches issued every call, run only on overflow).  Sizes in 4-byte
    words unless named."""

    nsmall: int
    lay: np.ndarray              # int32 [levels, RANK_ULAY] (rank.cuh kLay*)
    cap_bits: Tuple[int, ...]    # per larger bitmap level, log2 of its region's bits
    gated: Tuple[int, ...]       # plan indices of the gated levels
    region_words: int            # bitmap words of the two regions
    region_groups: int           # their group counts
    bsum_words: int              # every larger level's scan block sums
    keys: int                    # nodes of the largest larger level
    gated_keys: int              # nodes of the largest gated level
    launches: int                # per call, the anchors launch included


def table_rank_layout(plan_host: np.ndarray, nsmall: int, cap_bits: int = RANK_CAP_BITS) -> TableRankLayout:
    """The ``TableRankLayout`` of a table or 2D walk's rank plan; a
    ``cap_bits`` below RANK_CAP_BITS (the walks' own) drives the gated
    sorted route at small sizes."""
    levels = np.asarray(plan_host, dtype=np.int64).reshape(-1, RANK_LEVEL_INTS)
    bits = [12 + int(w) for w in levels[:, 1]]
    if not 8 <= cap_bits <= 31:  # 8: regions of one group, which every larger level's keys pass
        raise ValueError(f"cap_bits must be in [8, 31]; got {cap_bits}")
    # a cap below the one block's bits takes the levels past it out of the block too
    nsmall = min(int(nsmall), next((k for k, b in enumerate(bits) if b > cap_bits), len(bits)))
    if (levels[:nsmall, 0] > RANK_SMALL_MAX).any() or any(b > RANK_SMALL_BITS for b in bits[:nsmall]):
        raise ValueError(f"a level ranked in one block has more than {RANK_SMALL_MAX} nodes or "
                         f"keys wider than {RANK_SMALL_BITS} bits")
    lay = np.zeros((len(bits), RANK_ULAY), dtype=np.int32)
    caps = tuple(min(b, cap_bits) for b in bits[nsmall:])
    gw = max([4] + [(1 << c) // 256 for c in caps])  # a region's groups, at least 4 (16-byte stores)
    bs = 0
    for k, c in enumerate(caps):
        l = nsmall + k
        groups = (1 << c) // 256
        scan = -(-groups // RANK_SCAN_GROUPS)
        lay[l] = (groups, (k % 2) * 8 * gw, (k % 2) * gw, bs, scan, int(bits[l] > cap_bits), 0, 0)
        bs += scan
    gated = tuple(nsmall + k for k, b in enumerate(bits[nsmall:]) if b > cap_bits)
    nshift = [len(radix_shifts(bits[l])) for l in gated]
    launches = (1 + (1 if len(bits) else 0) + (1 if nsmall else 0) + 3 * (len(bits) - nsmall)
                + sum(5 + n for n in nshift))
    nreg = min(len(caps), 2)  # two regions, used in turn
    return TableRankLayout(nsmall, lay, caps, gated, nreg * 8 * gw, nreg * gw, bs,
                           max((int(levels[l, 0]) for l in range(nsmall, len(bits))), default=0),
                           max((int(levels[l, 0]) for l in gated), default=0), launches)


def rank_scratch_words(cnt: int) -> int:
    """4-byte words of a sorted rank level's scratch (rank.cuh sorted_words):
    the heads' bitmap over 8-word groups padded to a multiple of 4 groups,
    their counts, the scan blocks' sums and their counter."""
    groups = ((-(-int(cnt) // 256)) + 3) & ~3
    return groups * 9 + ((-(-groups // RANK_SCAN_GROUPS) + 1 + 3) & ~3)


def table_anchors(args: TableArgs, dev, plan: torch.Tensor, plan_host: np.ndarray, lay: TableRankLayout) -> None:
    """The table or 2D walk's anchors and string ranks: J, R, u, jp, the
    significance flags and the walk rank table of ``args`` from its node
    passes, the hop words ranked per level, then the levels of the rank
    plan (``lay``).  ``args`` points at the plan, its layout and the
    scratch ``lay`` sizes.  ``lay.launches`` launches."""
    _require_cuda(plan, torch.int32, "plan")
    plan_host = np.ascontiguousarray(plan_host, dtype=np.int32)
    nlev = plan_host.size // RANK_LEVEL_INTS
    if plan.numel() != plan_host.size or plan_host.size % RANK_LEVEL_INTS or lay.lay.shape[0] != nlev:
        raise ValueError(f"a plan of {RANK_LEVEL_INTS}-word levels and its layout; got {plan.numel()} words, "
                         f"{lay.lay.shape[0]} layout rows")
    lay_host = np.ascontiguousarray(lay.lay, dtype=np.int32)
    lib = load(dev)
    with _on_device(plan):
        err = lib.sperr_table_anchors(ct.byref(args), plan_host.ctypes.data_as(ct.c_void_p),
                                      lay_host.ctypes.data_as(ct.c_void_p), nlev, _stream(plan))
    _check(lib, err, "table_anchors")
    _count("table_anchors", lay.launches)


def table_stage(stage: str, args: TableArgs, dev) -> None:
    """One launch of the table walk: ``stage`` "rows" (the child rows'
    payloads and born flags), "born" (the entries' insertion keys, the
    per-level counts and n_sig), "entries" (after the insertion sort: the
    walk ranks, the entries' payloads and walk keys) or "rowkeys" (the rows'
    walk keys, and the 2D walk's I items)."""
    if stage not in ("rows", "born", "entries", "rowkeys"):
        raise ValueError(f"no table walk stage {stage!r}")
    dev = torch.device(dev)
    lib = load(dev)
    with _on_index(dev):
        err = getattr(lib, f"sperr_table_{stage}")(ct.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, f"table_{stage}")
    _count("table_walk")


def node_passes(nm: torch.Tensor, num_bp: torch.Tensor) -> torch.Tensor:
    """The node passes of a schedule: nm (nn,) int32 node maxima and num_bp
    (one int32) -> node_s (nn,) int32, num_bp - nm where nm > 0, else
    NEVER.  One launch."""
    _require_cuda(nm, torch.int32, "nm")
    if nm.dim() != 1 or nm.numel() == 0:
        raise ValueError(f"nm must be (nn > 0,); got {tuple(nm.shape)}")
    nb = _num_bp_word(num_bp, nm.device)
    node_s = torch.empty_like(nm)
    lib = load(nm.device)
    with _on_device(nm):
        err = lib.sperr_node_passes(nm.data_ptr(), nb.data_ptr(), nm.numel(), node_s.data_ptr(), _stream(nm))
    _check(lib, err, "node_passes")
    _count("node_passes")
    return node_s
