#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sperr_tpu_torch) once on an NVIDIA H100 and check it.

Run from the root of a checkout, with one GPU visible:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:
  1. device: name, compute capability, nvidia-smi's name and power limit;
  2. build: compile and load the CUDA kernels from the sources in the checkout;
  3. each kernel against its plain PyTorch version on the card (K1 quantize
     bit for bit; the CDF 9/7 lifting kernel through dwt3d/idwt3d; the
     per-level 2D kernels K2/K3 bit for bit against dwt2d_ref/idwt2d_ref and
     the per-axis lifting path, level by level and partial inverses against
     the full one, timed per call and per launch at (16, 1024^2) and
     (1, 1800, 3600);
     the bit transpose K10 (on the masks of every window of each class, as
     the plain planes launch builds them), the masked pack K11 and the flag compaction
     K12 bit for bit on the inputs that one 256^3 chunk's schedule and walk
     give them, at the first tier and at the widest, and K12 at the sparse
     transfer's shape (that chunk's nonzero flags, take n/2, beside
     torch.nonzero); the hybrid decode's K13 (two launches: count,
     reconstruct) bit for bit on the control parse of one 256^3 chunk's stream, that stream
     truncated, an all-zero chunk, and a stream past a small active-word
     cap; the schedule kernels of kernels/schedule.cu bit for bit: the cube
     form (sched_boxmax, sched_virtual: K5 and K6) on chunk 0 of phase 4's
     quantized field, an all-zero and a 2^31 - 1 256^3 chunk, 16^3 and 2^3
     cubes, the child-table form (sched_table, and with the 2D I-set
     passes; at most 3 launches a call) on a Hurricane packet chunk (100,
     256, 256), its edge chunk (100, 244, 244), a 1024^2 and a 1800x3600
     field, with the int64 leaf table and on a 70000 x 16 field (one cut,
     rows past the grid's 65535), the pyramid form (sched_pyramid, two
     launches, no memset) on the dyadic (97, 128, 118) chunk, a 244^3
     chunk and a (65, 17, 17) chunk of unequal axis depths, each also
     against the child-table form, each timed; the PSNR search K16
     (psnr_q) on the inputs the PSNR fronts give it at PSNR 80 (phase 5's
     chunk, the headline volume's 8 chunks in one call, phase 7's 16
     fields, phase 8's field), with second rounds forced and a target f32
     cannot reach raising on both sides, each call's two launches a round
     (a lean launch of 3 candidates, a full one of 8 queued behind it) and
     each input's shrink counts; the
     walk kernels of kernels/walk.cu bit for bit: the child value table
     (walk_vtab), K7 (anchor_ranks), the whole 3D walk (walk_rows and the
     key kernels, payload words padding included) and every radix sort it
     ran (against torch.sort(stable=True)) on headline chunk 0 at tiers 0,
     1 and the widest, an all-zero, a one-pixel and a 2^31 - 1 256^3 chunk,
     16^3 and 2^3 cubes, and lexsort (the radix sort) against the chained
     torch.sort on the plain table walk's and 2D walk's keys; the one-sweep sort
     against torch.sort(stable=True) at 1 key, a tile's worth - 1, + 0 and
     + 1, 3 tiles + 1, on int32 and int64 keys of both signs, of full and
     reduced widths and all equal, and one walk's two sorts repeated 20
     times (a race check on the look-back); the table, K7 (beside
     torch.unique on its largest level's keys), the walk at tiers 0 and 1
     and the tier-1 walk sort timed, the sort beside torch.sort, and the
     launches per walk call (at most 40, no radix pass in K7) checked; the
     emission kernels of kernels/emit.cu bit for bit, every output, on
     each call the emission makes (K9, emit_stage: a cube's exposure and
     the three classes' planes in two launches, emit_cube; the other 3D
     forms' planes in one, emit_fields; the 2D program's emission in two,
     emit_fields with no payload, then with no pixel field): headline
     chunk 0 at tiers 0, 1, the
     widest (P = 34, every pixel), P = 34 compacted (magnitudes apart) and
     an exposure forced to overflow; an all-zero, a one-pixel, a 2^31 - 1
     and an all-2^31 - 1 256^3 chunk; 16^3 and 2^3 cubes and a 16^3 cube
     capped below one box; a Hurricane packet chunk (K12's compaction) and
     a 1024^2 field (K14: its pixel half and its walk's LIS half); the
     stage timed at tiers 0 and 1 (and per launch) beside its plain version
     and its bound (inputs read once, outputs written once), the 1024^2
     field's two halves each timed beside its plain version and bound, and
     the launches between the walk and K11 counted (K9's two only); the
     tier-1 stage repeated 50 times, every
     output of every call against the plain version's (a race check on the
     look-back); the
     table and 2D walks' kernels of kernels/walk_table.cu bit for bit,
     every output: node_passes, table_anchors (J, R, u, jp, alone and in
     the walk), the whole walk (payload words, padding included, and n_sig)
     with every radix sort it ran, and the 2D LIS segments
     through K9's planes launch and K11 against the plain event form at
     three caps, on a
     Hurricane packet chunk at tiers 0, 1 and a node cap of nn / 20, its
     all-zero, one-pixel and 2^31 - 1 forms, the dyadic chunk, a 1024^2,
     the 1800x3600 and a 3600x7200 field (its finest rank level too wide
     for a bitmap: the sorted route), 33x57 random and edge fields, the
     anchors also with every level past 16 key bits sorted (as K7 on the
     cube chunks), and node_passes also on headline chunk 0's schedule;
     each timed
     beside its plain version and bound, with its launches, its peak
     memory, and no torch or CUB sort, scan or cummax among its kernels);
  4. the 3D path: a 512^3 f32 field, 8 chunks of 256^3, PWE 1e-2, through
     TorchCompressor3D and TorchDecompressor3D (the hybrid decode: control
     parse on the host, K13 on the card), checked against the host f64
     decoder, with the kernels' launch counters set to 0 after a warm-up and
     read after the timed encode and decode; then the full-parse decode
     (hybrid=False), timed after its own warm-up and alternating twice with
     the hybrid one, must equal it element for element; each route's time
     by stage; and K13 held against its plain version on the decode's own
     input, once and in 50 repeated calls (every output of each);
  5. PSNR 80 and rate 2.0 bpp on one 256^3 chunk, the counts read around
     each encode (K16 launched at PSNR 80 only), each stream's sha256;
  6. the device entropy path (entropy="wave"): phase 4's volume, whose
     container must equal phase 4's byte for byte (1,012,155 bytes) with
     every chunk on the device and K1, the lifting kernel, K9 (emit_stage,
     two launches per emission), K11, K12, the schedule's
     sched_boxmax and sched_virtual and the walk's walk_vtab, anchor_ranks,
     walk_rows and radix sort launched, K10 not at all; the volume as one
     512^3 chunk, its wave container equal to its host one with the walk on
     two path words, its K9 calls repeated 50 times against the plain
     version (the rows' look-back over four windows); phase 5's PSNR and rate streams; one noisy 256^3 chunk
     that drives the tier ladder into its dense tiers;
  7. the 2D path: 16 Turbulence1024-like 1024^2 fields, PWE 1e-2, through
     TorchCompressor2D and TorchDecompressor2D, checked against the host f64
     decoder, with the launch counters read around the timed encode and
     decode, as in phase 4;
  8. one 1800x3600 field (the CESM-ATM 2D shape) at PSNR 80 and rate 2.0
     (the counts read around each encode, each stream's sha256),
     its multi-resolution decode, and the 3D multi-resolution decode of
     phase 5's stream (through the hybrid decode), each against the host f64
     decoder;
  9. chunks that are not power-of-two cubes on the device entropy path:
     SDRBench Hurricane ISABEL's shape (100 x 500 x 500, cut from phase 4's
     field) in 256^3 chunks, four wavelet-packet chunks (child-table
     schedule and table walk, K15), whose wave container must equal the
     host one byte for byte (87,959 bytes) with K1, the lifting kernel,
     emit_stage (one launch per emission), K11, K12, sched_table, the
     radix sort, node_passes,
     table_anchors and table_walk launched (K10 not), decoded on both
     routes; one dyadic
     chunk, whose wave container must equal the host one, with
     sched_pyramid launched; the first chunk's schedule and walk (K15) at
     tiers 0 and 1 with its launches by name and no torch or CUB sort,
     scan or cummax;
 10. the 2D device entropy path (entropy="wave"): phase 7's fields, whose
     streams must equal phase 7's (167,627 bytes) with every field on the
     device and K1, K2, K3, emit_stage (two launches a field program), K11,
     K12, sched_table (with the I-set passes), the radix sort, node_passes,
     table_anchors and table_walk launched (K10 not), decoded within the
     bound, the encode timed on both routes; one field's device program
     (device-busy and host-issued time, host waits, its two planes launches,
     K11 and K12 calls bit for bit, K10 on the planes' masks, its launches
     by name, and every device operation from its
     schedule's first kernel to K11's last one of the repo's kernels or a
     memset); phase 8's
     field at PWE, PSNR and rate, a 3600x7200 field at PWE (its finest
     rank level sorted) and a noisy field that climbs the tier ladder, each
     wave stream equal to its host one;
 11. the command-line tools (--exec cuda), as new processes: sperr3d on
     phase 4's volume (container and decode equal to phase 4's),
     sperr3d_trunc, sperr2d on field 0 of phase 7 (stream equal to the
     in-process compress); in process, with their kernel launches, the same
     3D and 2D calls, and sperr2d on phase 8's field with its
     multi-resolution files; then each function of
     sperr_tpu_torch.runtime.device_bench once (every stage must read more
     than 0, the hybrid route must be timed, every tier must fit);
 12. more than one device: in one process, the 512^3 volume through
     TorchCompressor3D(devices=...) with host and wave entropy (containers
     equal to phase 4's byte for byte), TorchDecompressor3D(devices=...)
     (decode equal to phase 4's) and phase 7's fields through the 2D
     classes (streams and decodes equal to phase 7's), ``devices`` every
     card, or the one card named twice; then two ranks as new processes
     over a gloo group (``--rank``, below), each loading only its own
     chunks: rank 0's container over both transports equal to phase 4's,
     the distributed decode equal to phase 4's, K1's launches over both
     ranks equal to phase 6's; each rank prints one JSON line;
 13. the sparse transfer (transfer="sparse", the default; phases 4-12 pass
     transfer="dense"): phase 4's volume with host and wave entropy, each
     container equal to phase 4's byte for byte and each decode phase 4's,
     K1, the lifting kernel and K12 launched (the wave route also K9,
     K11, sched_boxmax, sched_virtual and the walk kernels), the bound
     under the port's
     decoder and the host f64 decoder;
     warm encodes of both transfers alternating on each route with their
     device to host bytes; every chunk through the dense re-run (container
     equal to phase 4's); pwe_strict="device" (bound under both decoders).
The line before the last is a JSON object with each kernel's launches on its
path, error, time on the device (``ms``, the calls queued behind a sleep
kernel) and as the host issues the calls (``host_ms``), plain version's time
and how it was timed (``plain_timed``), bound and library time; the last line is {"ok": true, "device": {...}}.
The K12 entry also holds its time at the sparse transfer's shape and its
launches on that path (``sparse``); psnr_q's (K16) row is phase 5's chunk at
PSNR 80, its launches phase 5's PSNR encode's (phase 8's in
``launches_2d``), every checked input's q, chosen j, launches and host
waits in ``cases``; sched_pyramid's the dyadic chunk, the 244^3 and
(65, 17, 17) chunks in ``s3d_244`` and ``uneven_65x17x17``; sched_virtual's the two cube launches
together (``fused``: the K5 + K6 function), sched_table's its times on the
edge chunk and 2D fields (``edge``, ``2d``), its plan, launches per call
and per-launch times and its launches in phase 10 (``launches_2d``); each walk
kernel's its launches per call (``launches_per_call``), walk_rows's (the
whole walk) its tier-1 time (``tier1``), the radix sort's its launches in
phases 9 and 10 (``launches_table``, ``launches_2d``) and its LSD floor
(``lsd_floor_ms``: its passes' bytes over the memory rate); emit_stage's
row is the K9 stage at tier 1, also at tier 0 (``tier0``), per launch
(``per_launch``), with its launches in phase 9 (``launches_table``), the
stage at tiers 0 and 1 with its launches between the walk and K11
(``k9_stage``), the 512^3 chunk's bytes, walls, peaks and tiers
(``chunk512``) and the repeated calls at tier 1 and on the 512^3 chunk
(``repeats``: calls, each launch's least, median and largest device time);
reconstruct_mags's row is the decode's (8, 256^3) call, per launch
(``per_launch``), on one chunk (``one_chunk``) and repeated (``repeats``);
with its launches in phase 10's first timed 2D encode (``launches_2d``) and
a 1024^2 field's two planes launches, each timed (``2d_field``);
K10's row says that its transpose runs inside K9 on the wave paths
(``merged_into``: its launches there are 0).
``python3 chip_smoke.py --kernels-only`` stops after phase 3 and prints no
result line; ``--rank R --port P --gather-port G --vol F --out D`` is one
rank of phase 12, which the script starts itself.  Times come from sperr_tpu_torch.runtime.device_bench's timer.
Without a CUDA device, or without the repository beside it, the script
prints no result and exits non-zero.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _launch_ms(fn, name: str, n: int, reps: int):
    """Device milliseconds of each of the n launches of the kernel ``name``
    that one call of fn makes, averaged over reps calls after a warm-up, from
    the kernels' own events in a torch.profiler trace; None when the trace
    does not hold n x reps of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name),
                 key=lambda e: e.time_range.start)
    if len(evs) != n * reps:
        return None
    return [sum(evs[r * n + i].time_range.elapsed_us() for r in range(reps)) / reps / 1e3
            for i in range(n)]


def _kernel_means(fn, name: str, reps: int):
    """{kernel: (device ms per launch, launches seen)} of the kernels whose
    name holds ``name``, over reps calls of fn after a warm-up, from each
    launch's own event in a torch.profiler trace (a trace that drops events
    still gives each kernel's mean)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    acc = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and name in e.name:
            key = e.name.split("(", 2)[1].split(")::")[-1] if e.name.startswith("(") else e.name
            tot, cnt = acc.get(key, (0.0, 0))
            acc[key] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    return {k: (tot / cnt, cnt) for k, (tot, cnt) in acc.items()}


def _stage_times(cls, names):
    """Time every call of cls.<name> for each name, the device synchronized
    after each call (a context manager yielding {name: seconds summed})."""
    import contextlib

    import torch

    spent = {name: 0.0 for name in names}

    @contextlib.contextmanager
    def ctx():
        orig = {name: getattr(cls, name) for name in names}

        def wrap(name):
            def timed(*args, **kw):
                t0 = time.perf_counter()
                out = orig[name](*args, **kw)
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                return out
            return timed

        for name in names:
            setattr(cls, name, wrap(name))
        try:
            yield spent
        finally:
            for name in names:
                setattr(cls, name, orig[name])

    return ctx()


def _top(per_name, k: int) -> str:
    """The k kernels with the most device time, as 'name ms'."""
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:k]
    return ", ".join(f"{name[:60]} {ms:.4f}" for name, ms in top)


def _capture(module, names, clone=False):
    """Record the arguments of every call of module.<name> for each name
    (a context manager); the calls still run.  ``clone``: record copies of
    the tensor arguments, for calls that write over their inputs."""
    import contextlib

    calls = {name: [] for name in names}

    @contextlib.contextmanager
    def ctx():
        orig = {name: getattr(module, name) for name in names}

        def wrap(name):
            def rec(*args, **kw):  # the positional arguments recorded
                calls[name].append(tuple(a.clone() if clone and hasattr(a, "clone") else a for a in args))
                return orig[name](*args, **kw)
            return rec

        for name in names:
            setattr(module, name, wrap(name))
        try:
            yield calls
        finally:
            for name in names:
                setattr(module, name, orig[name])

    return ctx()


# HBM rate of one H100 SXM (NVIDIA's data sheet); a kernel's bound is the
# bytes it must move (each input read once, each output written once) over it
_HBM_BYTES_PER_S = 3.35e12


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name without its namespace, template
    arguments and parameters ("Memset" for a memset)."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0].split("<")[0].split("::")[-1].strip()


def _bound_ms(nbytes: float) -> float:
    return nbytes / _HBM_BYTES_PER_S * 1e3


def _lift_per_launch(kernels, cdf97, x, levels: int, smi: str):
    """Time every launch of the 3D lifting kernel that dwt3d and idwt3d make
    on x (1, n, n, n), level by level and axis by axis, on a scratch copy;
    print each beside its bound (the box read and written once).  Returns
    {(direction, level, axis): (ms, bound_ms)}."""
    from sperr_tpu_torch.runtime.device_bench import time_ms
    from sperr_tpu_torch.utils.dims import calc_approx_detail_len

    n = x.shape[-1]
    out = {}
    boxes = [(L, L, L) for L in (calc_approx_detail_len(n, lev)[0] for lev in range(levels))]
    for inverse, name in ((False, "dwt3d"), (True, "idwt3d")):
        y = x.clone()
        for lev, box in enumerate(boxes):
            for axis, aname in ((-1, "x"), (-2, "y"), (-3, "z")):
                ms = time_ms(lambda: kernels.cdf97_lift(y, axis, box, inverse, cdf97.LIFT_CONSTS), 20,
                             "device")[0]
                out[(name, lev, aname)] = (ms, _bound_ms(2 * 4 * box[0] ** 3))
        del y
    for name in ("dwt3d", "idwt3d"):
        rows = [(k, v) for k, v in out.items() if k[0] == name]
        print(f"[kernels] K4 per launch, {name} {n}^3 (level, axis: ms / bound ms): "
              + ", ".join(f"{k[1]}{k[2]} {v[0]:.4f}/{v[1]:.4f}" for k, v in rows)
              + f"; sum {sum(v[0] for _, v in rows):.4f} / {sum(v[1] for _, v in rows):.4f} ms"
              f" -- {smi}")
    return out


def _chunk512(kernels, smi: str, vol) -> dict:
    """Phase 6's 512^3 chunk: phase 4's volume as one chunk
    (``TorchCompressor3D((512,) * 3, (512,) * 3)``, the default transfer),
    first on the wave route, then on the host route: the containers must
    be equal byte for byte, the chunk on the device, the walk's layout two
    path words (the two-word walk: a forest deeper than base-9 paths of one
    word hold), K9 and the walk launched; each K9 call of the wave route
    repeated 50 times against the plain version (``_repeats``: the rows'
    look-back over four windows of 256 tiles, where a 256^3 cube has one).
    Returns the walls, peaks, launches and repeats."""
    import torch

    from sperr_tpu_torch.ops import speck_lis, wave_pack
    from sperr_tpu_torch.parallel.batched import TorchCompressor3D

    dims = (512, 512, 512)
    layouts = []
    orig = speck_lis.walk_layout

    def record(vf, node_cap):
        lay = orig(vf, node_cap)
        layouts.append((tuple(vf.dims), lay))
        return lay

    res = {"wall_s": {}, "peak": {}, "tiers": {}, "repeats": {}}
    streams = {}
    speck_lis.walk_layout = record
    try:
        for entropy in ("wave", "host"):
            comp = TorchCompressor3D(dims, dims, device="cuda", entropy=entropy)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with _capture(wave_pack, ["emit_cube"]) as calls:
                streams[entropy] = comp.compress(vol, "pwe", 1e-2)
            torch.cuda.synchronize()
            res["wall_s"][entropy] = time.perf_counter() - t0
            res["peak"][entropy] = torch.cuda.max_memory_allocated()
            _check(comp.last_uncertified_chunks == 0, f"512^3 chunk, {entropy}: uncertified")
            if entropy == "wave":
                res["launches"] = {k: v for k, v in kernels.launches.items() if v}
                res["tiers"] = comp.last_wave_tiers
                _check(comp.last_wave_chunks == 1, "the 512^3 chunk took host entropy on the wave route")
                _check(len(calls["emit_cube"]) > 0, "the 512^3 chunk's emission made no emit_cube call")
                for k, a in enumerate(calls["emit_cube"]):
                    res["repeats"][f"call {k}"] = _repeats(
                        kernels, lambda a=a: wave_pack.emit_cube(*a), wave_pack.emit_cube_ref(*a),
                        f"K9 on the 512^3 chunk, call {k} (P {a[8]}, wexp_cap {a[5]})", smi)
            del calls
    finally:
        speck_lis.walk_layout = orig
    for name in ("emit_stage", "walk_rows", "radix_sort", "sched_virtual"):
        _check(res["launches"].get(name, 0) > 0, f"{name} was not launched on the 512^3 chunk")
    words = sorted({lay.path_words for d, lay in layouts if d == dims})
    _check(words == [2], f"the 512^3 walk took path words {words}, not 2")
    _check(streams["wave"] == streams["host"], "the 512^3 chunk's wave container differs from the host one")
    res["bytes"] = len(streams["wave"])
    print(f"[wave] one 512^3 chunk: wave container = host container byte for byte ({res['bytes']} bytes), "
          f"tiers {res['tiers']}, the walk on two path words ({len(layouts)} walk calls, key widths "
          f"{sorted({lay.walk_bits for d, lay in layouts if d == dims})}); encode {res['wall_s']['wave']:.3f} s "
          f"wave, {res['wall_s']['host']:.3f} s host (first calls: the 512^3 index built); peak device memory "
          f"{res['peak']['wave']} bytes ({res['peak']['wave'] / 2**30:.3f} GiB) wave, {res['peak']['host']} "
          f"host; launches on the wave route {res['launches']} -- {smi}")
    return res


def _k10_calls(wave_pack, planes_calls):
    """K10's calls on the masks of the classes of captured planes launches
    (``emit_planes_ref`` arguments, ``stage_plane_args``): each class's
    per-item masks for every 32-pass window, as the plain version builds
    them, each pair or single form into a (P, W) buffer at rows base ..
    base + take - 1 (the arguments the emission gave K10 before K9).
    Returns {"transpose_bits32_pair": [...],
    "transpose_bits32": [...]}."""
    import torch

    out = {"transpose_bits32_pair": [], "transpose_bits32": []}
    for kind, fields, num_bp, P, items in planes_calls:
        if not items:  # the empty half of a 2D emission's launch
            continue
        masks_fn, pair = wave_pack.plane_masks(kind, fields, num_bp, items)
        dst = torch.empty((P, items // (16 if pair else 32)), dtype=torch.int32, device=fields[0].device)
        for base in range(0, P, 32):
            take = min(32, P - base)
            m = masks_fn(base)
            if pair:
                out["transpose_bits32_pair"] += [(m[0], m[2], dst, base, take), (m[1], m[3], dst, base, take)]
            else:
                out["transpose_bits32"] += [(m[0], dst, base, take), (m[1], dst, base, take)]
    return out


def _bits_equal(kernels, packemit, calls, label: str):
    """Hold every captured call of K10-K12 against its plain version bit for
    bit; returns the largest difference of each (0)."""
    import torch

    err = {"transpose_bits32": 0, "masked_pack": 0, "compact_flags_rows": 0}
    # K10 writes planes 0 .. take-1 into rows row0 .. of the caller's buffer:
    # both versions start from the same filler, so a row written out of
    # place shows too
    for args in calls["transpose_bits32"] + calls["transpose_bits32_pair"]:
        *xs, dst, row0, take = args
        a, b = torch.full_like(dst, -7), torch.full_like(dst, -7)
        if len(xs) == 1:
            kernels.transpose_bits32(xs[0].contiguous(), a, row0, take)
            packemit.transpose_bits32_ref(xs[0], b, row0, take)
        else:
            kernels.transpose_bits32_pair(xs[0].contiguous(), xs[1].contiguous(), a, row0, take)
            packemit.transpose_bits32_pair_ref(xs[0], xs[1], b, row0, take)
        err["transpose_bits32"] = max(err["transpose_bits32"], _int_err(a, b))
        _check(torch.equal(a, b), f"K10 ({len(xs)} inputs) differs from its plain version at "
               f"{tuple(xs[0].shape)}, rows {row0} + {take} of {tuple(dst.shape)} ({label})")
    for parts, evb_cap, out_cap_bytes in calls["masked_pack"]:
        err["masked_pack"] = max(err["masked_pack"],
                                 _k11_equal(packemit, parts, evb_cap, out_cap_bytes, 8, label))
    for flags, take in calls["compact_flags_rows"]:
        a, b = kernels.compact_flags_rows(flags.contiguous(), take), packemit.compact_flags_rows_ref(flags, take)
        for x, y in zip(a, b):
            err["compact_flags_rows"] = max(err["compact_flags_rows"], _int_err(x, y))
            _check(torch.equal(x, y), f"K12 differs at {tuple(flags.shape)}, take {take} ({label})")
    return err


def _bits_case(kernels, packemit, calls, smi: str, label: str):
    """Hold every captured call of K10-K12 against its plain version bit for
    bit, then time the largest call of each beside its bound and, for K12,
    beside torch.nonzero on the same flags.  Returns {kernel: stats}."""
    import torch

    from sperr_tpu_torch.runtime.device_bench import busy_ms, time_ms

    out = {}
    errs = _bits_equal(kernels, packemit, calls, label)
    # the three shapes of one emission's masks: the first 32-plane window of
    # the LIP pair, the LIS pair and the refinement single form (each twice,
    # for the valid and the bit masks)
    pairs, singles = calls["transpose_bits32_pair"], calls["transpose_bits32"]
    lis_args = pairs[len(pairs) // 2]
    k10 = {}
    for shape, fn, args, per_word in (
            ("LIP pair", kernels.transpose_bits32_pair, pairs[0], 16),
            ("LIS pair", kernels.transpose_bits32_pair, lis_args, 16),
            ("REF single", kernels.transpose_bits32, singles[0], 32)):
        items, take = args[0].numel(), args[-1]
        inputs = 4 * items * (2 if per_word == 16 else 1)
        k10[shape] = dict(items=items, take=take, ms=time_ms(lambda: fn(*args), 20, "device")[0],
                          host_ms=time_ms(lambda: fn(*args), 20, "host-issued")[0],
                          bound_ms=_bound_ms(inputs + 4 * take * items // per_word),
                          bound32_ms=_bound_ms(inputs + 4 * 32 * items // per_word))
    print(f"[kernels] {label} K10 per shape (items, planes kept: device ms / host-issued ms / "
          f"bound ms / bound of all 32 planes ms): "
          + ", ".join(f"{k} ({v['items']}, {v['take']}) {v['ms']:.4f}/{v['host_ms']:.4f}/"
                      f"{v['bound_ms']:.4f}/{v['bound32_ms']:.4f}" for k, v in k10.items())
          + f"; on one emission's masks ({len(pairs)} pair and {len(singles)} single calls; K9's "
          f"planes launch transposes them in registers on the main path) "
          f"{sum(v['ms'] for v in k10.values()) * len(singles):.4f} ms device -- {smi}")
    lis = k10["LIS pair"]
    plain = time_ms(lambda: packemit.transpose_bits32_pair_ref(*lis_args), 5)
    out["transpose_bits32"] = dict(
        max_abs_err=errs["transpose_bits32"], shape=f"LIS pair {lis['items']} items, {lis['take']} planes",
        ms=lis["ms"], host_ms=lis["host_ms"], plain_ms=plain[0], plain_timed=plain[1],
        bound_ms=lis["bound_ms"], library_ms=None, per_shape=k10,
    )
    (parts, evb_cap, out_cap_bytes), = calls["masked_pack"]
    per_name = busy_ms(lambda: packemit.masked_pack(parts, evb_cap, out_cap_bytes), 10)[1]
    print(f"[kernels] {label} K11 by launch, ms per call: {_top(per_name, 4)} -- {smi}")
    b = packemit.masked_pack_ref(parts, evb_cap, out_cap_bytes)
    words = sum(v.numel() for v, _ in parts)
    rows = sum(v.shape[0] for v, _ in parts)
    plain = time_ms(lambda: packemit.masked_pack_ref(parts, evb_cap, out_cap_bytes), 3)
    out["masked_pack"] = dict(
        max_abs_err=errs["masked_pack"], shape=f"{words} words per array, {rows} rows, {int(b.total_bytes)} bytes "
        f"out, overflow {bool(b.overflow)}",
        ms=time_ms(lambda: packemit.masked_pack(parts, evb_cap, out_cap_bytes), 10, "device")[0],
        host_ms=time_ms(lambda: packemit.masked_pack(parts, evb_cap, out_cap_bytes), 10, "host-issued")[0],
        plain_ms=plain[0], plain_timed=plain[1],
        bound_ms=_bound_ms(8 * words + int(b.total_bytes) + 4 * rows),
        library_ms=None,
    )
    for k, (flags, take) in enumerate(calls["compact_flags_rows"]):
        B, n = flags.shape
        key = "compact_flags_rows" if k == 0 else f"compact_flags_rows {k}"
        plain = time_ms(lambda: packemit.compact_flags_rows_ref(flags, take), 5)
        out[key] = dict(
            max_abs_err=errs["compact_flags_rows"], shape=f"({B}, {n}) take {take}",
            ms=time_ms(lambda: kernels.compact_flags_rows(flags, take), 20, "device")[0],
            host_ms=time_ms(lambda: kernels.compact_flags_rows(flags, take), 20, "host-issued")[0],
            plain_ms=plain[0], plain_timed=plain[1],
            bound_ms=_bound_ms(B * n + 4 * B * take + 4 * B),
            library_ms=time_ms(lambda: torch.nonzero(flags[0]), 20, "host-issued")[0],
        )
    for name, st in out.items():
        lib = (f", torch.nonzero {st['library_ms']:.4f} ms (it synchronizes: as the host issues it)"
               if st["library_ms"] is not None else "")
        print(f"[kernels] {label} {name} at {st['shape']}: kernel {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms ({st['plain_timed']}), bound {st['bound_ms']:.4f} ms (share "
              f"{st['bound_ms'] / st['ms']:.3f}), {st['host_ms']:.4f} ms as the host issues it"
              f"{lib}; equal to the plain version bit for bit -- {smi}")
    return out


def _k11_equal(packemit, parts, evb_cap: int, out_cap_bytes: int, piece_words: int,
               label: str) -> int:
    """K11 against its plain version on every PackResult field, bit for bit;
    returns the largest difference (0)."""
    import torch

    a = packemit.masked_pack(parts, evb_cap, out_cap_bytes, piece_words)
    b = packemit.masked_pack_ref(parts, evb_cap, out_cap_bytes, piece_words)
    err = 0
    for name, x, y in zip(a._fields, a, b):
        err = max(err, _int_err(x, y))
        _check(x.dtype == y.dtype and torch.equal(x, y),
               f"K11 {name} differs from its plain version ({label})")
    return err


def _k11_synthetic(packemit, dev) -> None:
    """K11 on shapes the main path does not give it: rows shorter than a
    tile (2048 words) and rows that end inside one, odd bit counts, empty
    rows and parts, all-ones words, 4-word pieces, and overflow by the piece
    cap and by the byte cap."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)

    def words(rows, W, k):
        # each bit set with probability 2^-k (k = 0: all ones; None: none)
        w = np.full((rows, W), 0 if k is None else 0xFFFFFFFF, np.uint32)
        for _ in range(k or 0):
            w &= rng.integers(0, 2**32, (rows, W), dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(dev)

    def part(rows, W, k):
        return words(rows, W, k), words(rows, W, 1)

    ragged = [part(3, 520, 3), part(2, 2 * 2048 + 776, 5), part(4, 8, 1)]
    empty = [part(3, 4096, None), part(0, 64, 2), part(2, 2056, 0), part(1, 16, 2)]
    empty[0][0][1, 5:9] = -1  # one row of the empty part is not empty
    quarter = [part(5, 1028, 2), part(3, 3004, 4)]
    pairs = [part(3, 1030, 2), part(2, 6, 0)]  # rows not on 16-byte boundaries
    cases = []
    for name, parts, pw in (("ragged rows", ragged, 8), ("empty rows and parts, all-ones "
                            "words", empty, 8), ("4-word pieces", quarter, 4),
                           ("2-word pieces", pairs, 2)):
        words_n = sum(v.numel() for v, _ in parts)
        out_cap = ((4 * words_n + sum(v.shape[0] for v, _ in parts) + 7) // 4 + 1) * 4
        cases.append((name, parts, pw, words_n // pw + 1, out_cap))
    cases += [("overflow by the piece cap", ragged, 8, 3, cases[0][4]),
              ("overflow by the byte cap", ragged, 8, cases[0][3], 64)]
    for name, parts, pw, evb_cap, out_cap in cases:
        _k11_equal(packemit, parts, evb_cap, out_cap, pw, name)
        res = packemit.masked_pack_ref(parts, evb_cap, out_cap, pw)
        _check(bool(res.overflow) == name.startswith("overflow"), f"K11 overflow flag ({name})")
        print(f"[kernels] K11 {name}: {int(res.total_bytes)} bytes, counts "
              f"{res.counts.tolist()[:6]}..., {int(res.n_nz)} pieces, overflow "
              f"{bool(res.overflow)}: equal to the plain version bit for bit")


def _k13_bound_ms(args) -> float:
    """K13's bound on its inputs: spass and the body words its refinement
    bits lie in (each read once), the int32 magnitudes and the flags
    written once."""
    spass, _, rof, rav, nbps = args
    ends = (rof.long() + rav.long()).amax(dim=1)  # bits of each body read
    words = int(((ends + 31) // 32).sum())
    return _bound_ms(5 * spass.numel() + 4 * words + 8 * rof.numel() + 5 * nbps.numel())


def _k13_check(wup, args, p_cap: int, evw_cap: int, label: str, want=None, overflow=None) -> int:
    """K13 against its plain version on the card, bit for bit: the overflow
    flags, and the magnitudes of every chunk the plain version does not
    flag (a flagged chunk's are not defined: the decoder parses it in full).
    The kernel has no cap, so all its magnitudes must equal ``want`` (the
    host's full parse) where given; ``overflow``, where given, is the flag
    every chunk must carry.  Returns the largest difference (0)."""
    import torch

    a = wup.reconstruct_mags_batched(*args, p_cap, evw_cap)
    b = wup.reconstruct_mags_batched_ref(*args, p_cap, evw_cap)
    torch.cuda.synchronize()
    _check(torch.equal(a[1], b[1]), f"K13 overflow differs from its plain version ({label})")
    if overflow is not None:
        _check(bool((b[1] == overflow).all()), f"K13 overflow {b[1].tolist()}, expected {overflow} ({label})")
    ok = ~b[1]
    err = _int_err(a[0][ok], b[0][ok])
    _check(torch.equal(a[0][ok], b[0][ok]), f"K13 magnitudes differ from their plain version ({label})")
    if want is not None:
        _check(torch.equal(a[0].cpu(), want), f"K13 magnitudes differ from the host's full parse ({label})")
    print(f"[kernels] K13 {label}: {tuple(args[0].shape)}, num_bp {args[4].tolist()}, overflow "
          f"{a[1].tolist()}: equal to the plain version bit for bit"
          + ("" if want is None else "; all magnitudes equal to the host's full parse"))
    return err


def _int_err(a, b) -> int:
    """max |a - b| over integer tensors (int64 arithmetic)."""
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def _turbulence_like(ny: int, nx: int, seed: int):
    """A Turbulence1024-like 2D field: 24 random separable sine modes plus
    0.001 noise (the recipe of sperr_tpu/runtime/device_bench.py wave2d_stage,
    one generator per field)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, max(nx, ny), dtype=np.float32)
    f = np.zeros((ny, nx), np.float32)
    for _ in range(24):
        fx, fy = rng.uniform(0.5, 8.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        a = np.float32(rng.normal(scale=0.4))
        f += a * (
            np.sin(2 * np.pi * fy * t[:ny] + py)[:, None]
            * np.sin(2 * np.pi * fx * t[:nx] + px)[None, :]
        )
    f += rng.normal(scale=0.001, size=f.shape).astype(np.float32)
    return f


def _tensor_bytes(obj) -> int:
    """Bytes of every tensor an index object holds (its static tables)."""
    import torch

    total = 0
    stack = [getattr(obj, name) for name in obj.__slots__ if hasattr(obj, name) and not name.startswith("_")]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    return total


def _table_phase(kernels, smi: str, dev, vol, pvol, chunk=(256, 256, 256)) -> dict:
    """Phase 9: chunks that are not power-of-two cubes on the device entropy
    path.  ``vol`` (z, y, x) in ``chunk`` chunks, in the smoke run SDRBench
    Hurricane ISABEL's shape (100 x 500 x 500, cropped from phase 4's field):
    four wavelet-packet chunks of four shapes; the index builds per shape,
    the wave container against the host one (after a warm-up each), the
    kernels launched, both decode routes; the first chunk's schedule and
    walk (K15) and its emission at tiers 0 and 1, timed.  Then ``pvol``, one
    dyadic chunk (cut from phase 5's field): its wave container against the
    host one (phase 3 holds its pyramid-form schedule against the
    child-table one).  The schedule kernels must launch on both paths (sched_table on the
    packet chunks, sched_pyramid on the dyadic one); returns their
    launches."""
    import numpy as np
    import torch

    from sperr_tpu_torch.ops import cdf97
    from sperr_tpu_torch.ops import speck as spk
    from sperr_tpu_torch.ops import speck_lis
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.parallel.chunked3d import Sperr3DDecompressor
    from sperr_tpu_torch.runtime.device_bench import busy_ms, host_waits, time_ms
    from sperr_tpu_torch.utils.dims import chunk_volume

    t_phase = time.perf_counter()
    tol = 1e-2
    nz, ny, nx = vol.shape
    dims = (nx, ny, nz)
    chunks = chunk_volume(dims, chunk)
    shapes = list(dict.fromkeys(c[1::2] for c in chunks))
    builds = {}
    for s3 in shapes:
        t0 = time.perf_counter()
        li, si = tb._wave_index(s3, dev)
        builds[s3] = (time.perf_counter() - t0, type(si).__name__, li.nn, li.nrows)
    print(f"[table] {nz}x{ny}x{nx} (Hurricane ISABEL's shape) in {chunk} chunks: {len(chunks)} chunks; "
          "index builds on the host (chunk shape: form, nodes, child rows, s): "
          + ", ".join(f"{s3}: {f}, {nn}, {nr}, {t:.3f}" for s3, (t, f, nn, nr) in builds.items()))
    _check(len(chunks) == 4 and len(shapes) == 4, f"chunk shapes {shapes}")
    _check(all(f == "TreeIndex" for _, f, _, _ in builds.values()), "a chunk left the child-table form")

    runs = {}
    for entropy in ("host", "wave"):
        comp = tb.TorchCompressor3D(dims, chunk, device=dev, entropy=entropy, transfer="dense")
        comp.compress(vol, "pwe", tol)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = comp.compress(vol, "pwe", tol)
        torch.cuda.synchronize()
        runs[entropy] = dict(wall=time.perf_counter() - t0, stream=s, launches=dict(kernels.launches),
                             peak=torch.cuda.max_memory_allocated(), d2h=comp.last_d2h_bytes, comp=comp)
        _check(comp.last_uncertified_chunks == 0, f"{entropy}: uncertified chunks {comp.last_uncertified_ids}")
    w, h = runs["wave"], runs["host"]
    print(f"[table] launches during the timed wave encode: {w['launches']}")
    for name in ("quantize", "cdf97_lift", "emit_stage", "masked_pack", "compact_flags_rows",
                 "sched_table", "radix_sort", "node_passes", "table_anchors", "table_walk"):
        _check(w["launches"][name] > 0, f"kernel {name} was not launched on the table-form wave path")
    _check(w["launches"]["transpose_bits32"] == 0, "K10 was launched on the table-form wave path")
    # each emission of a chunk that is not a power-of-two cube: K9's planes
    # launch once (the pixel fields from K12's compaction), K11's three
    _check(3 * w["launches"]["emit_stage"] == w["launches"]["masked_pack"],
           f"K9 launched {w['launches']['emit_stage']} times for {w['launches']['masked_pack'] // 3} emissions")
    _check(w["stream"] == h["stream"], "the table-form wave container differs from the host one")
    _check(len(w["stream"]) == 87959, f"the table-form container is {len(w['stream'])} bytes, not 87,959")
    sched_launches = {k: w["launches"][k] for k in ("sched_table", "radix_sort", "emit_stage", "node_passes",
                                                    "table_anchors", "table_walk")}
    _check(w["comp"].last_wave_chunks == 4, f"{w['comp'].last_wave_chunks} of 4 chunks on the device")
    print(f"[table] PWE {tol}: container {len(w['stream'])} bytes "
          f"({8.0 * len(w['stream']) / vol.size:.5f} bpp), wave = host byte for byte, "
          f"{w['comp'].last_wave_chunks} of 4 chunks on the device at tiers {w['comp'].last_wave_tiers}")
    print(f"[table] encode (after one warm-up each) {w['wall']:.4f} s wave, {h['wall']:.4f} s host; "
          f"device to host {w['d2h']} bytes wave, {h['d2h']} host; peak device memory {w['peak']} bytes "
          f"({w['peak'] / 2**30:.3f} GiB) wave, {h['peak']} host -- {smi}")

    dec = tb.TorchDecompressor3D(device=dev, hybrid=True)
    dec_full = tb.TorchDecompressor3D(device=dev, hybrid=False)
    out, out_dims = dec.decompress(w["stream"])
    out_full, _ = dec_full.decompress(w["stream"])
    host_out, _ = Sperr3DDecompressor().decompress(w["stream"])
    _check(out_dims == dims and out.shape == vol.shape and np.isfinite(out).all(), "decode shape")
    _check(np.array_equal(out, out_full), "the hybrid decode differs from the full host parse")
    err_port = float(np.abs(out.astype(np.float64) - vol).max())
    err_host = float(np.abs(host_out.reshape(vol.shape) - vol).max())
    print(f"[table] decode: hybrid route ({dec.last_hybrid_chunks} chunks rebuilt on the card, parsed "
          f"in full: {dec.last_full_parse_chunks or 'none'}) = hybrid=False element for element; "
          f"max|err| port {err_port:.6e}, host f64 {err_host:.6e} (bound {tol})")
    _check(err_port <= tol and err_host <= tol, f"table-form stream misses the bound: {err_port}, {err_host}")
    del out, out_full, host_out, runs, w, h

    # the first chunk's schedule and walk (K15) and its whole emission, at
    # tiers 0 and 1: device time (behind a sleep), as the host issues it,
    # device-busy time and host waits (profiler, sync debug mode)
    c = chunks[0]
    s3 = c[1::2]
    n = s3[0] * s3[1] * s3[2]
    x = torch.from_numpy(np.ascontiguousarray(vol[c[4]:c[4] + c[5], c[2]:c[2] + c[3], c[0]:c[0] + c[1]])[None])
    front = tb._dense_encode_rows(x.to(dev), "pwe", tol, "dual", cdf97.dwt3d, cdf97.idwt3d_,
                                  out_cap=max(1024, n // 1024))
    mags, signs = front["mags"][0], front["signs"][0]
    li, si = tb._wave_index(s3, dev)
    tiers = tb.wave_tiers_for(n)
    for t in (0, 1):
        caps = tb._wave_caps(li, s3, tiers[t], 34)

        def k15():
            num_bp, s, e, nm = tb._schedule(mags, si)
            return speck_lis.lis_segments_device(spk.node_passes(nm, num_bp), s, signs, num_bp, li, caps["P"],
                                                 caps["node_cap"], return_events="items")

        def emit():
            return tb._wave_emit_chunk(mags, signs, li, caps, si)

        em, fits = emit()
        T = speck_lis.lis_item_count(li, caps["node_cap"])
        # K15's bound: each input read once (the magnitudes, signs and both
        # indices' static tables), each output written once (s, e, node
        # maxima, node passes, the T payload words)
        k15_bytes = (_tensor_bytes(si) + _tensor_bytes(li) + 4 * n + n + 3 * 4 * n + 2 * 4 * li.nn
                     + 4 * T)
        for label, fn in (("K15 schedule and table walk", k15), ("_wave_emit_chunk", emit)):
            before = dict(kernels.launches)
            fn()
            torch.cuda.synchronize()
            per_call = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
            ms, how = time_ms(fn, 3)
            host_ms = time_ms(fn, 3, "host-issued")[0]
            syncs = host_waits(fn)
            busy, per_name = busy_ms(fn, 3)
            bound = f", bound {_bound_ms(k15_bytes):.4f} ms ({k15_bytes} bytes)" if fn is k15 else ""
            bad = _sorts_and_scans(kernels, per_name)
            if fn is k15:
                _check(not bad, f"the table walk ran {bad}")
                _check(per_call.get("table_walk", 0) == 4 and per_call.get("table_anchors", 0) > 0,
                       f"the table walk's launches {per_call}")
            print(f"[table] {s3} tier {t} {label}: {ms:.4f} ms ({how}), {host_ms:.4f} ms as the host issues "
                  f"it, device busy {busy:.4f} ms, {syncs} host "
                  f"waits per call{bound}; launches per call {per_call}; torch or CUB sorts, scans or cummax: "
                  f"{bad or 'none'}; the most device time, ms per call: {_top(per_name, 8)} -- {smi}")
        print(f"[table] {s3} tier {t}: caps {caps}, n_sig {int(em.n_sig)}, fits {bool(fits)}, "
              f"{T} walk items")
        del em, fits
    del front, mags, signs, x

    # the pyramid form on the card: one dyadic chunk
    pz, py, px = pvol.shape
    pyr_dims = (px, py, pz)
    t0 = time.perf_counter()
    li_p, pi = tb._wave_index(pyr_dims, dev)
    t_pyr = time.perf_counter() - t0
    _check(isinstance(pi, spk.PyramidIndex), f"{pyr_dims} did not take the pyramid form")
    s_host = tb.TorchCompressor3D(pyr_dims, pyr_dims, device=dev, transfer="dense").compress(pvol, "pwe", tol)
    wave = tb.TorchCompressor3D(pyr_dims, pyr_dims, device=dev, entropy="wave", transfer="dense")
    wave.compress(pvol, "pwe", tol)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    s_wave = wave.compress(pvol, "pwe", tol)
    torch.cuda.synchronize()
    sched_launches["sched_pyramid"] = kernels.launches["sched_pyramid"]
    _check(sched_launches["sched_pyramid"] > 0, "sched_pyramid was not launched on the pyramid-form wave path")
    _check(s_wave == s_host, "the pyramid-form wave stream differs from the host one")
    _check(wave.last_wave_chunks == 1, "the pyramid-form chunk took host entropy")
    print(f"[table] pyramid form {pyr_dims}: index builds {t_pyr:.3f} s (pyramid with the table walk's); "
          f"wave stream = host stream ({len(s_wave)} bytes, tier {wave.last_wave_tiers}); schedule launches "
          f"{sched_launches} -- {smi}")
    print(f"[table] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return sched_launches


def _wave2d_phase(kernels, smi: str, dev, fields, streams7, f7, streams8) -> int:
    """Phase 10: the 2D device entropy path (TorchCompressor2D(entropy=
    "wave"), K14).  Phase 7's 16 fields at PWE 1e-2: the wave streams must
    equal phase 7's byte for byte with every field on the device, K1, K2,
    K3, K9's planes launch (emit_stage, two a field program: its pixel
    half, then its LIS half), K11 and K12 launched in the first timed wave
    encode (K10 not), and decode
    within the bound under the port's decoder and the host f64 codec; the
    encode timed on both routes, alternating, three times each.  One field's
    device program at tier 0, with its two planes launches, K11 and K12
    calls (and K10 on the planes' masks) held against their
    plain versions: device-busy time, host-issued time, host waits, the ops
    with the most device time and its bound.  Phase 8's 1800 x 3600 field
    at PWE 1e-2, PSNR 80 and rate 2.0, and a noisy 256 x 256 field that
    climbs the tier ladder: every wave stream equal to its host one.
    Returns sched_table's and the radix sort's launches in the first timed
    wave encode."""
    import numpy as np
    import torch

    from sperr_tpu_torch.codec.speck_flt import SpeckFloatCodec
    from sperr_tpu_torch.ops import cdf97, packemit, speck_lis, wave_pack
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.parallel import batched2d as tb2
    from sperr_tpu_torch.runtime.device_bench import busy_ms, host_waits, time_ms

    t_phase = time.perf_counter()
    tol = 1e-2
    B, ny, nx = fields.shape
    n = nx * ny
    t0 = time.perf_counter()
    index = tb2._wave_index2((nx, ny), dev)
    li2 = index[1]
    print(f"[wave2d] {ny}x{nx} index build on the host {time.perf_counter() - t0:.3f} s: {li2.nn} nodes, "
          f"{li2.nrows} child rows, depth {li2.depth_max}, {li2.xf} I levels, {li2.G} groups")
    comps = {route: tb2.TorchCompressor2D((nx, ny), device=dev, entropy=route) for route in ("host", "wave")}
    for route, comp in comps.items():  # warm-up
        _check(comp.compress_batch(fields, "pwe", tol) == streams7, f"{route}: streams differ from phase 7's")
    walls = {"host": [], "wave": []}
    peak, d2h = {}, {}
    launches = None
    for route in ("wave", "host", "wave", "host", "wave", "host"):
        comp = comps[route]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first = route == "wave" and launches is None
        if first:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = comp.compress_batch(fields, "pwe", tol)
        torch.cuda.synchronize()
        walls[route].append(time.perf_counter() - t0)
        if first:
            launches = dict(kernels.launches)
        peak[route] = max(peak.get(route, 0), torch.cuda.max_memory_allocated())
        d2h[route] = comp.last_d2h_bytes
        _check(s == streams7, f"{route}: a timed encode differs from phase 7's streams")
        _check(comp.last_uncertified_chunks == 0, f"{route}: {comp.last_uncertified_chunks} uncertified fields")
    wave = comps["wave"]
    print(f"[wave2d] launches during the first timed 2D wave encode: {launches}")
    for name in ("quantize", "dwt2d_full", "idwt2d_full", "emit_stage", "masked_pack",
                 "compact_flags_rows", "sched_table", "radix_sort", "node_passes", "table_anchors", "table_walk"):
        _check(launches[name] > 0, f"kernel {name} was not launched on the 2D wave path")
    _check("iset_max" not in launches, "the 2D wave batch counts I-set launches apart from its schedule's")
    _check(launches["transpose_bits32"] == 0, "K10 was launched on the 2D wave path")
    _check(launches["cdf97_lift"] == 0, "the 2D wave path launched the per-axis lifting kernel")
    # a field program: the planes launch and K11's three for each half
    _check(3 * launches["emit_stage"] == launches["masked_pack"] and launches["emit_stage"] % 2 == 0,
           f"the 2D wave batch made {launches['emit_stage']} planes launches and {launches['masked_pack']} K11 "
           "launches, not one and three for each half of each field program")
    _check(wave.last_wave_chunks == B, f"{wave.last_wave_chunks} of {B} fields on the device")
    dec = tb2.TorchDecompressor2D((nx, ny), device=dev)
    host = SpeckFloatCodec(2, (nx, ny, 1))
    err_port = err_host = 0.0
    for f, out, st in zip(fields, dec.decompress_batch(s), s):
        _check(out.shape == (ny, nx) and np.isfinite(out).all(), "2D wave decode shape or finiteness")
        err_port = max(err_port, float(np.abs(out.astype(np.float64) - f).max()))
        h, _ = host.decompress(bytes(st))
        err_host = max(err_host, float(np.abs(h.reshape(ny, nx) - f).max()))
    _check(err_port <= tol and err_host <= tol, f"2D wave streams miss the bound: {err_port}, {err_host}")
    nbytes = sum(len(x) for x in s)
    _check(nbytes == 167627, f"the 2D wave streams hold {nbytes} bytes, not 167,627")
    print(f"[wave2d] {B} x {ny}x{nx} PWE {tol}: {nbytes} bytes, equal to phase 7's byte for byte, "
          f"{wave.last_wave_chunks} of {B} fields on the device at tiers {wave.last_wave_tiers}; max|err| "
          f"port decoder {err_port:.6e}, host f64 decoder {err_host:.6e} (bound {tol})")
    print(f"[wave2d] encode walls, s (after one warm-up each, alternating wave, host, ...): wave "
          + ", ".join(f"{t:.4f}" for t in walls["wave"]) + "; host " + ", ".join(f"{t:.4f}" for t in walls["host"])
          + f"; device to host {d2h['wave']} bytes wave, {d2h['host']} host; peak device memory "
          f"{peak['wave']} bytes wave, {peak['host']} host -- {smi}")

    # one field's device program at tier 0, as the wave encode runs it
    front = tb._dense_encode_rows(torch.from_numpy(fields[:1]).to(dev), "pwe", tol, "dual", cdf97.dwt2d,
                                  cdf97.idwt2d, out_cap=n)
    mags, signs = front["mags"][0], front["signs"][0]
    caps = tb2._wave_caps2(n, wave.num_bp_cap, li2.nn, max(4096, int(wave.wave_event_tiers[0] * n)))

    def prog():
        return tb2._wave_emit_field(mags, signs, index, caps, wave.num_bp_cap)

    with _capture(packemit, ["masked_pack", "compact_flags_rows"]) as calls, \
            _capture(wave_pack, ["emit_fields"]) as k9:
        w = wave._fetch_wave(prog(), caps, n)
    _check(wave._wave_fits(w, 0, n), "field 0 does not fit tier 0")
    _check(len(k9["emit_fields"]) == 2, f"field 0's program made {len(k9['emit_fields'])} planes launches, not 2")
    for args in k9["emit_fields"]:
        _check(all(torch.equal(a, b) for a, b in zip(_flat(wave_pack.emit_fields(*args)),
                                                      _flat(wave_pack.emit_fields_ref(*args)))),
               f"K9's planes launch ({args[0][0].numel()} pixels, {args[1].numel()} payloads) differs from "
               "its plain version on 2D field 0")
    calls.update(_k10_calls(wave_pack, [a for f in k9["emit_fields"] for a in wave_pack.stage_plane_args(*f)]))
    _bits_equal(kernels, packemit, calls, "2D field 0, tier 0")
    ncalls = dict({k: len(v) for k, v in calls.items()}, emit_fields=len(k9["emit_fields"]))
    before = dict(kernels.launches)
    prog()
    torch.cuda.synchronize()
    per_call = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
    # every device operation from the schedule's first kernel to K11's last is
    # one of the repo's kernels or a memset
    ours = _our_kernels(kernels)
    names = _device_names(prog, 2, ("table_subtrees", "pack_tile_kernel"))
    _check("table_subtrees" in names and "pack_tile_kernel" in names, f"the program's trace: {names}")
    starts = [i for i, nm in enumerate(names) if nm == "table_subtrees"]
    i0 = starts[len(starts) // 2]  # the second call's schedule
    i1 = max(i for i, nm in enumerate(names) if nm.startswith("pack_"))
    window = names[i0:i1 + 1]
    _check(per_call.get("sched_table", 0) <= 3 and window[:2] == ["table_subtrees", "table_pixels"],
           f"the 2D program's schedule: {per_call.get('sched_table')} launches, {window[:8]}")
    for nm in ("table_pixels", "node_passes_kernel", "table_anchors", "table_rows", "emit_stage_planes"):
        _check(nm in window, f"{nm} is missing from the second call's trace: {window}")
    foreign = sorted({nm for nm in window if nm not in ours})
    _check(not foreign, f"the 2D program ran torch ops between its schedule and K11: {foreign}")
    sorts = _sorts_and_scans(kernels, names)
    _check(not sorts, f"the 2D program ran {sorts}")
    print(f"[wave2d] field 0 program: launches per call {per_call}; {len(window)} device operations from the "
          f"schedule's first kernel to K11's last, every one the repo's kernels or a memset "
          f"({sum(nm == 'Memset' for nm in window)} memsets); torch or CUB sorts, scans or cummax: none")
    ms, how = time_ms(prog, 3)
    host_ms = time_ms(prog, 3, "host-issued")[0]
    syncs = host_waits(prog)
    busy, per_name = busy_ms(prog, 3)
    # bound: the magnitudes (int32), the signs and the index's static tables
    # (schedule and walk) read once, the segments written once
    stream = int(w["px_total"][0]) + int(w["lis_total"][0])
    ti2 = index[0]
    tables = [ti2.ch_src, ti2.ch_bounds, ti2.px_parent32] + list(speck_lis.table_static(li2).tables.values())
    prog_bytes = 5 * n + sum(t.numel() * t.element_size() for t in tables) + stream
    bound = _bound_ms(prog_bytes)
    print(f"[wave2d] field 0, tier 0 ({caps}): num_bp {int(w['num_bp'][0])}, n_sig {int(w['n_sig'][0])}, "
          f"{stream} segment bytes; K9, K11 and K12 calls (K10 on the planes' masks) {ncalls}, equal to their "
          "plain versions bit for bit")
    print(f"[wave2d] field 0 device program: {ms:.4f} ms ({how}), {host_ms:.4f} ms as the host issues it, device "
          f"busy {busy:.4f} ms, {syncs} host waits per call; bound "
          f"{bound:.4f} ms ({prog_bytes} bytes), share {bound / (busy or ms):.4f} of the busy time; the most "
          f"device time, ms per call: {_top(per_name, 5)} -- {smi}")
    del front, mags, signs, w, calls, k9

    # the CESM-ATM shape at PWE, PSNR and rate, and a noisy field
    ny7, nx7 = f7.shape
    t0 = time.perf_counter()
    tb2._wave_index2((nx7, ny7), dev)
    build7 = time.perf_counter() - t0
    host7 = tb2.TorchCompressor2D((nx7, ny7), device=dev)
    wave7 = tb2.TorchCompressor2D((nx7, ny7), device=dev, entropy="wave")
    routes = []
    for mode, quality in (("pwe", tol), ("psnr", 80.0), ("rate", 2.0)):
        want = streams8.get(mode) or host7.compress(f7, mode, quality)
        t0 = time.perf_counter()
        got = wave7.compress(f7, mode, quality)
        wall = time.perf_counter() - t0
        _check(got == want, f"{ny7}x{nx7} {mode}: the wave stream differs from the host one")
        tier = wave7.last_wave_tiers[0]
        routes.append(f"{mode} {quality}: {len(got)} bytes, {wave7.last_wave_chunks} of 1 field on the device ("
                      + ("host engine" if tier is None else f"tier {tier}") + f"), wave {wall:.3f} s")
    _check(wave7.last_wave_tiers[0] is None, "rate 2.0 fit the device (more than 18 bitplanes expected)")
    print(f"[wave2d] {ny7}x{nx7} (index build {build7:.3f} s): " + "; ".join(routes)
          + "; every wave stream equal to its host one")
    # a field past the rank bitmaps' 32 key bits: its finest rank level sorted
    ny8, nx8 = 3600, 7200
    f8 = _turbulence_like(ny8, nx8, 17)
    t0 = time.perf_counter()
    li8 = tb2._wave_index2((nx8, ny8), dev)[1]
    build8 = time.perf_counter() - t0
    st8 = speck_lis.table_static(li8)
    rl8 = kernels.table_rank_layout(st8.plan.host, st8.plan.nsmall)
    bits8 = tuple(12 + w for w in st8.plan.wks)
    _check(rl8.gated and max(bits8) > 32, f"{ny8}x{nx8}: rank levels of {bits8} static key bits, gated {rl8.gated}")
    want = tb2.TorchCompressor2D((nx8, ny8), device=dev).compress(f8, "pwe", tol)
    w8 = tb2.TorchCompressor2D((nx8, ny8), device=dev, entropy="wave")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = w8.compress(f8, "pwe", tol)
    wall = time.perf_counter() - t0
    l8 = {k: v for k, v in kernels.launches.items() if v}
    _check(got == want, f"{ny8}x{nx8} pwe: the wave stream differs from the host one")
    _check(w8.last_wave_chunks == 1, f"{ny8}x{nx8}: the field did not stay on the device")
    for name in ("sched_table", "node_passes", "table_anchors", "table_walk", "radix_sort",
                 "emit_stage", "masked_pack"):
        _check(l8.get(name, 0) > 0, f"{ny8}x{nx8}: {name} was not launched")
    rs8 = [_rank_state(kernels, speck_lis, li8, c.views) for k, (_, c) in st8.calls.items()
           if k[1] == kernels.RANK_CAP_BITS]  # the walk's own calls (not phase 3's forced routes)
    _check(rs8 and all(not r["overflowed"] and r["widest_used_bits"] <= 2**26 and r["left_zero"] for r in rs8),
           f"{ny8}x{nx8}: rank levels {rs8}")
    print(f"[wave2d] {ny8}x{nx8} PWE {tol} (index build {build8:.3f} s; rank levels of {bits8} static key bits, "
          f"none sorted, gated {rl8.gated}, their keys spanning {rs8[0]['used_bits']} bits, none overflowed): "
          f"{len(got)} bytes, equal to the host stream, tier "
          f"{w8.last_wave_tiers[0]}, wave {wall:.3f} s (first call at this shape); launches {l8}; peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes")
    del f8, w8, li8, st8
    noisy = np.random.default_rng(3).normal(size=(256, 256)).astype(np.float32)
    want = tb2.TorchCompressor2D((256, 256), device=dev).compress(noisy, "pwe", tol)
    wn = tb2.TorchCompressor2D((256, 256), device=dev, entropy="wave")
    _check(wn.compress(noisy, "pwe", tol) == want, "noisy 256x256: the wave stream differs from the host one")
    tier = wn.last_wave_tiers[0]
    _check(tier is None or tier >= 1, f"the noisy field did not climb the ladder: tier {tier}")
    print(f"[wave2d] noisy 256x256 PWE {tol}: {len(want)} bytes, equal to the host stream, "
          + ("host engine past the last tier" if tier is None else f"device at tier {tier}")
          + f" ({wn.last_wave_chunks} field on the device)")
    print(f"[wave2d] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return {k: launches[k] for k in ("sched_table", "radix_sort", "emit_stage", "node_passes", "table_anchors",
                                     "table_walk")}


def _cli(tool: str, *args: str) -> str:
    """Run ``python -m sperr_tpu_torch.cli.<tool> args`` from the checkout's
    root; print its wall time and output; return its output."""
    cmd = [sys.executable, "-m", f"sperr_tpu_torch.cli.{tool}", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    _check(proc.returncode == 0, f"{tool} {' '.join(args)} exited {proc.returncode}:\n{proc.stderr}")
    print(f"[cli] {tool} {' '.join(a if '/' not in a else os.path.basename(a) for a in args)}: "
          f"{wall:.3f} s wall (a new process: torch import, kernel and engine load)")
    for line in proc.stdout.splitlines():
        print(f"[cli]   {line}")
    return proc.stdout


def _launches_of(kernels, run, argv):
    """The kernel launches of one in-process run(argv) of a tool, and its wall."""
    import torch

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _check(run(argv) == 0, f"run({argv}) failed")
    torch.cuda.synchronize()
    return {k: v for k, v in kernels.launches.items() if v}, time.perf_counter() - t0


def _cli_phase(kernels, smi: str, tmp: str, vol_path: str, stream4: bytes, out4, field0,
               stream7_0: bytes, f7, stream8_psnr: bytes, k4_ms, k1_ms) -> None:
    """Phase 11: the command-line tools on the card, and the stage timer.

    The 3D tool on phase 4's 512^3 volume (its container and decode must
    equal phase 4's) and sperr3d_trunc on that container, each as a new
    process, then once in process with the kernel launches counted; the 2D
    tool on field 0 of phase 7 as a new process (its stream must equal the
    in-process compress of that field), then in process with the launches
    counted, and on phase 8's field with its multi-resolution files.  Then
    each device_bench function once; every stage must read more than 0."""
    import numpy as np
    import torch

    from sperr_tpu_torch.cli import sperr2d, sperr3d
    from sperr_tpu_torch.parallel.batched2d import TorchCompressor2D, TorchDecompressor2D
    from sperr_tpu_torch.runtime import device_bench as db
    from sperr_tpu_torch.stream import tools
    from sperr_tpu_torch.utils.dims import coarsened_resolutions

    t_phase = time.perf_counter()
    tol = 1e-2
    path = lambda name: os.path.join(tmp, name)  # noqa: E731

    # -- the 3D tool, 512^3 PWE 1e-2 ----------------------------------------
    comp_args = ["-c", vol_path, "--exec", "cuda", "--dims", "512", "512", "512", "--pwe", "1e-2"]
    _cli("sperr3d", *comp_args, "--bitstream", path("v.sperr"), "--print_stats")
    with open(path("v.sperr"), "rb") as f:
        s3 = f.read()
    _check(s3 == stream4, "the 3D tool's container differs from phase 4's")
    print(f"[cli] 512^3 container of the tool: {len(s3)} bytes, equal to phase 4's byte for byte "
          "(the tool calls TorchCompressor3D((512, 512, 512), (256, 256, 256), device='cuda') with the "
          "sparse transfer, the default; phase 4 passes transfer='dense')")
    _cli("sperr3d", "-d", path("v.sperr"), "--exec", "cuda", "--decomp_f", path("v.f32"))
    out = np.fromfile(path("v.f32"), dtype=np.float32).reshape(out4.shape)
    _check(np.array_equal(out, out4), "the 3D tool's decode differs from phase 4's TorchDecompressor3D")
    err = float(np.abs(out.astype(np.float64) - np.fromfile(vol_path, np.float32).reshape(out.shape)).max())
    print(f"[cli] 512^3 decode of the tool: equal to phase 4's element for element, max|err| "
          f"{err:.6e} (bound {tol})")
    _check(err <= tol, f"the 3D tool's decode misses the bound: {err}")
    _cli("sperr3d_trunc", path("v.sperr"), "--pct", "10", "--bitstream", path("t.sperr"),
         "--compare_f", vol_path)
    with open(path("t.sperr"), "rb") as f:
        _check(f.read() == tools.progressive_truncate(stream4, 10), "sperr3d_trunc's stream")
    lc, wc = _launches_of(kernels, sperr3d.run, comp_args + ["--bitstream", path("w.sperr")])
    ld, wd = _launches_of(kernels, sperr3d.run, ["-d", path("w.sperr"), "--exec", "cuda",
                                                 "--decomp_f", path("w.f32")])
    print(f"[cli] in process, 3D compress run(): {wc:.3f} s, launches {lc}; decompress run(): "
          f"{wd:.3f} s, launches {ld} -- {smi}")
    for name in ("quantize", "cdf97_lift"):
        _check(lc.get(name, 0) > 0, f"the 3D tool's compress did not launch {name}")
    for name in ("reconstruct_mags", "cdf97_lift"):
        _check(ld.get(name, 0) > 0, f"the 3D tool's decompress did not launch {name}")
    for name in ("v.f32", "w.f32"):
        os.remove(path(name))

    # -- the 2D tool: field 0 of phase 7, phase 8's field ----------------------
    field0.tofile(path("f0.f32"))
    comp2 = ["-c", path("f0.f32"), "--exec", "cuda", "--dims", "1024", "1024", "--pwe", "1e-2"]
    _cli("sperr2d", *comp2, "--bitstream", path("f0.sperr"), "--print_stats")
    with open(path("f0.sperr"), "rb") as f:
        s2 = f.read()
    want = TorchCompressor2D((1024, 1024), device="cuda").compress(field0, "pwe", tol)
    _check(s2[10:] == want, "the 2D tool's stream differs from TorchCompressor2D.compress of the field")
    print(f"[cli] 1024^2 field 0: {len(s2)} bytes, equal behind its header to the in-process "
          f"compress; equal to phase 7's batched stream of that field: {s2[10:] == stream7_0}")
    l2c, w2c = _launches_of(kernels, sperr2d.run, comp2 + ["--bitstream", path("g0.sperr")])
    with open(path("g0.sperr"), "rb") as f:
        _check(f.read() == s2, "the 2D tool's stream differs between a new process and run()")
    l2d, w2d = _launches_of(kernels, sperr2d.run, ["-d", path("f0.sperr"), "--exec", "cuda",
                                                   "--decomp_f", path("f0.out")])
    print(f"[cli] in process, 2D compress run(): {w2c:.3f} s, launches {l2c}; decompress run(): "
          f"{w2d:.3f} s, launches {l2d} -- {smi}")
    err2 = float(np.abs(np.fromfile(path("f0.out"), np.float32).astype(np.float64) - field0.ravel()).max())
    print(f"[cli] 1024^2 decode of the tool (-d --exec cuda): max|err| {err2:.6e} (bound {tol})")
    _check(err2 <= tol, f"the 2D tool's decode misses the bound: {err2}")
    for name in ("quantize", "dwt2d_full", "idwt2d_full"):
        _check(l2c.get(name, 0) > 0, f"the 2D tool's compress did not launch {name}")
    _check(l2d.get("idwt2d_full", 0) > 0, "the 2D tool's decompress did not launch idwt2d_full")
    ny7, nx7 = f7.shape
    f7.tofile(path("f7.f32"))
    _check(sperr2d.run(["-c", path("f7.f32"), "--exec", "cuda", "--dims", str(nx7), str(ny7),
                        "--psnr", "80", "--bitstream", path("f7.sperr")]) == 0, "sperr2d -c at PSNR 80")
    with open(path("f7.sperr"), "rb") as f:
        s7 = f.read()
    print(f"[cli] {ny7}x{nx7} PSNR 80, in process: {len(s7)} bytes, equal behind its header to "
          f"phase 8's stream: {s7[10:] == stream8_psnr}")
    _check(sperr2d.run(["-d", path("f7.sperr"), "--exec", "cuda", "--decomp_f", path("f7.out"),
                        "--decomp_lowres_f", path("lr")]) == 0, "sperr2d -d --decomp_lowres_f")
    dec7 = TorchDecompressor2D((nx7, ny7), device="cuda")
    full = dec7.decompress(s7[10:], multi_res=True)
    _check(np.array_equal(np.fromfile(path("f7.out"), np.float32).reshape(ny7, nx7), full),
           "the 2D tool's full-resolution decode differs from TorchDecompressor2D's")
    res = coarsened_resolutions((nx7, ny7, 1))
    for h, r in zip(dec7.hierarchy[0], res):
        got = np.fromfile(path(f"lr.{r[0]}x{r[1]}"), np.float32)
        _check(np.array_equal(got, h.ravel()), f"lowres file {r[0]}x{r[1]} differs from the decoder's level")
    print(f"[cli] {ny7}x{nx7} multi-resolution files of sperr2d -d, in process: "
          + ", ".join(f"lr.{r[0]}x{r[1]}" for r in res) + ", each equal to TorchDecompressor2D's level")

    # -- the stage timer ----------------------------------------------------------
    t_bench = time.perf_counter()
    results = {}
    for name, kw in (("pipeline_stages", dict(n=256)),
                     ("container_decode_stages", dict(n=256, chunks=8)),
                     ("wave_entropy_breakdown", dict(n=256)),
                     ("wave_entropy_breakdown", dict(n=256, dims=(256, 256, 100))),
                     ("wave2d_stage", dict(nx=1024, ny=1024, batch=16)),
                     ("wave_entropy_stage", dict(n=256, regime="smooth")),
                     ("wave_entropy_stage", dict(n=256, regime="dense"))):
        t0 = time.perf_counter()
        r = getattr(db, name)(**kw)
        print(f"[bench] {name}({', '.join(f'{k}={v}' for k, v in kw.items())}), "
              f"{time.perf_counter() - t0:.1f} s: {json.dumps(r)}")
        results[name + kw.get("regime", "") + ("_table" if "dims" in kw else "")] = r
        stages = {k: v for k, v in r.items() if k.endswith("_s")}
        stages.update({f"hybrid {k}": v for k, v in r.get("hybrid", {}).items() if k.endswith("_s")})
        bad = {k: v for k, v in stages.items() if not v > 0}
        _check(not bad, f"{name}: stages that read <= 0: {bad}")
        if name in ("container_decode_stages", "wave_entropy_stage"):
            # stages compared: one method for all
            _check(isinstance(r["timed"], str), f"{name}: stages timed by more than one method")
        if name == "wave_entropy_breakdown":
            # each delta subtracts two chains timed by the one method named for it
            _check(set(r["timed"]) == {"quantize", "schedule", "lis_items", "full_pack", "ref_words_abs"},
                   f"{name}: timed {r['timed']}")
            what = (f"{tuple(r['dims'])} (sched_table, node_passes)" if "dims" in kw
                    else "256^3 schedule (K5 + K6 kernels, node_passes)")
            print(f"[bench] wave_entropy_breakdown {what}: {r['schedule_s'] * 1e3:.4f} "
                  f"ms ({r['timed']['schedule']}); quantize {r['quantize_s'] * 1e3:.4f} ms "
                  f"({r['timed']['quantize']}), LIS items {r['lis_items_s'] * 1e3:.4f} ms "
                  f"({r['timed']['lis_items']}), the rest of the emission {r['full_pack_s'] * 1e3:.4f} ms "
                  f"({r['timed']['full_pack']}) -- {smi}")
        if name == "wave2d_stage":
            pg = r["program"]
            print(f"[bench] wave2d_stage one 1024^2 field's program, ms (deltas of chains, each pair one "
                  f"method: {pg['timed']}): schedule {pg['schedule_ms']:.4f}, pixel classes "
                  f"{pg['pixels_ms']:.4f}, walk (node passes, I-set, table walk) {pg['walk_ms']:.4f}, LIS planes "
                  f"and K11 {pg['lis_pack_ms']:.4f}; total {pg['total_ms']:.4f} -- {smi}")
        _check(r["device"].startswith(torch.cuda.get_device_name(0)) and "power limit" in r["device"],
               f"{name}: device {r['device']!r}")
    _check("reason" not in results["container_decode_stages"]["hybrid"],
           "the hybrid route was skipped on the 512^3 container")
    for regime in ("smooth", "dense"):
        _check(results["wave_entropy_stage" + regime]["fits"], f"wave_entropy_stage {regime}: no tier fits")
    ps = results["pipeline_stages"]
    for stage, phase3, kname in (("dwt3d", k4_ms, "K4"), ("quantize", k1_ms, "K1")):
        ms = ps[stage + "_s"] * 1e3
        print(f"[bench] pipeline_stages {stage} 256^3: {ms:.4f} ms ({ps['timed'][stage]}); phase 3's "
              f"{kname} at (1, 256^3): {phase3:.4f} ms, ratio {ms / phase3:.3f} -- {smi}")
    print(f"[cli] stage timer {time.perf_counter() - t_bench:.1f} s; phase 11 took "
          f"{time.perf_counter() - t_phase:.1f} s")


def _rank_main(argv) -> int:
    """One rank of phase 12 (b), started by the script as a new process:
    ``--rank R --port P --gather-port G --vol PATH --out DIR``.  It joins a
    gloo group of two, reads only its own chunks of the 512^3 volume through
    an np.memmap, compresses them twice on its card (the default transport,
    the torch.distributed all-gather, then the socket gather), decodes its
    chunks to rank 0 and on its card (to_host=False), and prints one JSON
    line: rank, card, chunks, walls, peak memory, gathered bytes and
    launches per kernel of each encode."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke rank: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sperr_tpu_torch import kernels
    from sperr_tpu_torch.parallel import distributed as td
    from sperr_tpu_torch.parallel.transport import AllgatherTransport, SocketGatherTransport
    from sperr_tpu_torch.utils.dims import chunk_volume

    opt = dict(zip(argv[0::2], argv[1::2]))
    rank = int(opt["--rank"])
    t_start = time.perf_counter()
    td.initialize(f"127.0.0.1:{opt['--port']}", 2, rank)
    card = td.own_device()
    torch.cuda.set_device(card)
    kernels.load(card)
    t_ready = time.perf_counter() - t_start
    dims, cd = (512, 512, 512), (256, 256, 256)
    mm = np.memmap(opt["--vol"], dtype=np.float32, mode="r", shape=dims)
    read = []

    def loader(c):
        read.append(c)
        return np.asarray(mm[c[4] : c[4] + c[5], c[2] : c[2] + c[3], c[0] : c[0] + c[1]])

    class Counted:
        """A transport that counts the bytes it ships and receives."""

        def __init__(self, inner):
            self.inner, self.sent, self.received = inner, 0, 0

        def gather_bytes(self, payload, pid, nprocs):
            self.sent += len(payload)
            out = self.inner.gather_bytes(payload, pid, nprocs)
            self.received += 0 if out is None else sum(len(b) for b in out)
            return out

    mine = td.local_chunk_ids(len(chunk_volume(dims, cd)), rank, 2)
    factory = td.device_compressor_factory(cd, entropy="wave", transfer="dense")
    torch.cuda.reset_peak_memory_stats(card)
    rec = {"rank": rank, "card": str(card), "card_name": torch.cuda.get_device_name(card),
           "chunks": mine, "ready_s": t_ready, "encode_s": {}, "gathered_bytes": {}, "launches": {}}
    streams = {}
    for name, inner in (("allgather", AllgatherTransport()),
                        ("socket", SocketGatherTransport(f"127.0.0.1:{opt['--gather-port']}", timeout=240.0))):
        tr = Counted(inner)
        read.clear()
        torch.cuda.synchronize(card)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = td.compress_distributed(loader, dims, cd, "pwe", 1e-2, compressor_factory=factory, transport=tr)
        torch.cuda.synchronize(card)
        rec["encode_s"][name] = time.perf_counter() - t0
        rec["launches"][name] = {k: v for k, v in kernels.launches.items() if v}
        rec["gathered_bytes"][name] = {"sent": tr.sent, "received": tr.received}
        _check((s is None) == (rank != 0), f"rank {rank}: compress_distributed returned {type(s)}")
        _check(set(read) == {chunk_volume(dims, cd)[i] for i in mine},
               f"rank {rank} loaded chunks it does not own, or not all of its own")
        streams[name] = s
    out_dir = opt["--out"]
    if rank == 0:
        for name, s in streams.items():
            with open(os.path.join(out_dir, f"{name}.sperr"), "wb") as f:
                f.write(s)
    torch.distributed.barrier()
    with open(os.path.join(out_dir, "allgather.sperr"), "rb") as f:
        stream = f.read()
    torch.cuda.synchronize(card)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = td.decompress_distributed(stream)
    torch.cuda.synchronize(card)
    rec["decode_s"] = time.perf_counter() - t0
    rec["decode_launches"] = {k: v for k, v in kernels.launches.items() if v}
    _check((got is None) == (rank != 0), f"rank {rank}: decompress_distributed returned {type(got)}")
    if rank == 0:
        np.save(os.path.join(out_dir, "decode.npy"), got[0])
    blocks, _ = td.decompress_distributed(stream, to_host=False)
    chunks = chunk_volume(dims, cd)
    _check(set(blocks) == {td._key(chunks[i]) for i in mine}, f"rank {rank}: to_host=False blocks")
    _check(all(isinstance(b, torch.Tensor) and b.device == card for b in blocks.values()),
           f"rank {rank}: to_host=False blocks are not on {card}")
    rec["device_blocks"] = len(blocks)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(card)
    del blocks
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps(rec))
    return 0


def _multi_phase(kernels, smi: str, tmp: str, vol_path: str, stream4: bytes, out4, fields,
                 streams7, outs7, k1_phase6: int, walls: dict) -> None:
    """Phase 12: more than one device.

    (a) In one process: the 512^3 volume through TorchCompressor3D(devices=)
    with host and wave entropy (each container must equal phase 4's byte for
    byte), TorchDecompressor3D(devices=) on the hybrid route (its decode must
    equal phase 4's element for element), and phase 7's 16 fields through
    TorchCompressor2D(devices=) and TorchDecompressor2D(devices=) (streams
    and decodes equal to phase 7's).  ``devs`` is every card where there
    are two or more, else the one card named twice.
    (b) Two ranks as new processes over a gloo group (``_rank_main``): rank
    0's container over both transports must equal phase 4's, its
    distributed decode phase 4's decode, and K1's launches over both ranks
    phase 6's."""
    import numpy as np
    import socket

    import torch

    from sperr_tpu_torch.parallel.batched import TorchCompressor3D, TorchDecompressor3D
    from sperr_tpu_torch.parallel.batched2d import TorchCompressor2D, TorchDecompressor2D

    t_phase = time.perf_counter()
    tol = 1e-2
    n = torch.cuda.device_count()
    devs = [f"cuda:{i}" for i in range(n)] if n >= 2 else ["cuda:0", "cuda:0"]

    def run(fn, label, need):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in kernels.launches.items() if v}
        for name in need:
            _check(launched.get(name, 0) > 0, f"phase 12 {label}: {name} was not launched")
        print(f"[multi] {label} on {devs}: {wall:.3f} s, launches {launched} -- {smi}")
        return out, wall

    # -- (a) in one process -------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    for entropy, need in (("host", ("quantize", "cdf97_lift")),
                          ("wave", ("quantize", "cdf97_lift", "emit_stage", "masked_pack",
                                    "compact_flags_rows"))):
        comp = TorchCompressor3D((512, 512, 512), (256, 256, 256), devices=devs, entropy=entropy,
                                 transfer="dense")
        vol = np.fromfile(vol_path, dtype=np.float32).reshape(512, 512, 512)
        s, wall = run(lambda: comp.compress(vol, "pwe", tol), f"3D encode, entropy={entropy}", need)
        _check(s == stream4, f"the {entropy} container over {devs} differs from phase 4's")
        _check(comp.last_uncertified_chunks == 0, f"uncertified chunks {comp.last_uncertified_ids}")
        if entropy == "wave":
            _check(comp.last_wave_chunks == 8, f"{comp.last_wave_chunks} of 8 chunks on the wave path")
        print(f"[multi] 512^3 {entropy} container over {devs}: {len(s)} bytes, equal to phase 4's byte "
              f"for byte; {wall:.3f} s against {walls[entropy]:.3f} s on one device; device to host "
              f"{comp.last_d2h_bytes} bytes -- {smi}")
        del vol
    dec = TorchDecompressor3D(devices=devs)
    (out, _), wall = run(lambda: dec.decompress(stream4), "3D decode (hybrid)", ("reconstruct_mags", "cdf97_lift"))
    _check(np.array_equal(out, out4), f"the decode over {devs} differs from phase 4's")
    _check(dec.last_hybrid_chunks > 0, "no chunk took the hybrid decode")
    print(f"[multi] 512^3 decode over {devs}: equal to phase 4's element for element, {wall:.3f} s "
          f"against {walls['decode']:.3f} s; {dec.last_hybrid_chunks} of 8 chunks rebuilt on the "
          f"cards; host to device {dec.last_h2d_bytes} bytes -- {smi}")
    del out
    ny2, nx2 = fields.shape[1:]
    comp2 = TorchCompressor2D((nx2, ny2), devices=devs)
    s2, wall_e = run(lambda: comp2.compress_batch(fields, "pwe", tol), "2D encode",
                     ("quantize", "dwt2d_full", "idwt2d_full"))
    _check(s2 == streams7, f"the 2D streams over {devs} differ from phase 7's")
    dec2 = TorchDecompressor2D((nx2, ny2), devices=devs)
    o2, wall_d = run(lambda: dec2.decompress_batch(s2), "2D decode", ("idwt2d_full",))
    _check(all(np.array_equal(a, b) for a, b in zip(o2, outs7)) and len(o2) == len(outs7),
           f"the 2D decodes over {devs} differ from phase 7's")
    print(f"[multi] 16 x {ny2}x{nx2} over {devs}: streams and decodes equal to phase 7's; encode "
          f"{wall_e:.3f} s, decode {wall_d:.3f} s (phase 7: {walls['enc2']:.3f}, {walls['dec2']:.3f}); "
          f"peak device memory {torch.cuda.max_memory_allocated()} bytes -- {smi}")

    # -- (b) two ranks ---------------------------------------------------------
    def free_port():
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    out_dir = tempfile.mkdtemp(prefix="ranks_", dir=tmp)
    port, gport = free_port(), free_port()
    t0 = time.perf_counter()
    procs = []
    for r in range(2):
        env = dict(os.environ, LOCAL_RANK=str(r))
        env.pop("SPERR_TPU_GATHER_ADDR", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port", str(port),
             "--gather-port", str(gport), "--vol", vol_path, "--out", out_dir],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    logs = []
    try:
        deadline = time.monotonic() + 300
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                raise AssertionError("a rank passed its 300 s timeout") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    recs = []
    for r, (p, (out_s, err_s)) in enumerate(zip(procs, logs)):
        _check(p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out_s}\n{err_s[-4000:]}")
        lines = [ln for ln in out_s.splitlines() if ln.startswith('{"rank"')]
        _check(len(lines) == 1, f"rank {r} printed {len(lines)} result lines:\n{out_s}")
        print(lines[0])
        recs.append(json.loads(lines[0]))
    for name in ("allgather", "socket"):
        with open(os.path.join(out_dir, f"{name}.sperr"), "rb") as f:
            _check(f.read() == stream4, f"rank 0's container over the {name} transport differs from phase 4's")
        k1 = sum(rec["launches"][name].get("quantize", 0) for rec in recs)
        _check(k1 == k1_phase6, f"K1 launched {k1} times over both ranks ({name}), phase 6 {k1_phase6}")
        for rec in recs:
            for kname in ("quantize", "cdf97_lift", "emit_stage", "masked_pack", "compact_flags_rows"):
                _check(rec["launches"][name].get(kname, 0) > 0, f"rank {rec['rank']} did not launch {kname}")
    got = np.load(os.path.join(out_dir, "decode.npy"), mmap_mode="r")
    _check(np.array_equal(got, out4), "the distributed decode differs from phase 4's")
    for rec in recs:
        _check(rec["decode_launches"].get("reconstruct_mags", 0) > 0, f"rank {rec['rank']}: no K13 in the decode")
    print(f"[multi] two ranks over gloo, {wall:.1f} s from start to exit: rank 0's container over both "
          f"transports equal to phase 4's byte for byte, the distributed decode equal to phase 4's "
          f"element for element, K1 {k1_phase6} launches over both ranks as in phase 6; encode walls "
          + "; ".join(f"rank {rec['rank']} {rec['card']} " + ", ".join(f"{k} {v:.3f} s" for k, v in rec["encode_s"].items())
                      + f", decode {rec['decode_s']:.3f} s, peak {rec['peak_bytes']} bytes" for rec in recs)
          + f" -- {smi}")
    print(f"[multi] phase 12 took {time.perf_counter() - t_phase:.1f} s -- {smi}")


def _sparse_phase(kernels, smi: str, vol_path: str, stream4: bytes, out4, dense: dict, d2h: dict) -> dict:
    """13. The sparse transfer (``transfer="sparse"``, the default) on phase
    4's 512^3 volume at PWE 1e-2, host and wave entropy.  Each route's
    containers must equal phase 4's byte for byte and their decodes phase
    4's decode, with K1, the lifting kernel and K12 (the wave route also
    K9, K11 and the schedule's sched_boxmax and sched_virtual) launched
    between the counts set to 0 and read; the bound is
    checked under the port's decoder and the host f64 decoder.  Warm
    encodes of both transfers alternate on each route (``dense``: phases 4
    and 6's warm compressors), two timed runs each, with the device to host
    bytes beside phases 4 and 6's (``d2h``).  Then a sparse_cap_frac that
    sends every chunk through the dense re-run (container equal to phase
    4's), and pwe_strict="device" (bound under both decoders).  Returns the
    host route's launches."""
    import numpy as np
    import torch

    from sperr_tpu_torch.parallel.batched import TorchCompressor3D, TorchDecompressor3D
    from sperr_tpu_torch.parallel.chunked3d import Sperr3DDecompressor

    t_phase = time.perf_counter()
    tol = 1e-2
    vol = np.fromfile(vol_path, dtype=np.float32).reshape(512, 512, 512)
    v64 = vol.astype(np.float64)
    dec = TorchDecompressor3D(device="cuda")

    def bound(stream, label):
        ours, _ = dec.decompress(stream)
        host, _ = Sperr3DDecompressor().decompress(stream)
        e_port = float(np.abs(ours.astype(np.float64) - v64).max())
        e_host = float(np.abs(host.reshape(vol.shape) - v64).max())
        print(f"[sparse] {label}: max|err| / tol port decoder {e_port / tol:.6f}, host f64 decoder "
              f"{e_host / tol:.6f}")
        _check(e_port <= tol and e_host <= tol, f"{label}: the PWE bound does not hold")
        return ours

    want = {"host": ("quantize", "cdf97_lift", "compact_flags_rows"),
            "wave": ("quantize", "cdf97_lift", "compact_flags_rows", "emit_stage", "masked_pack",
                     "sched_boxmax", "sched_virtual", "walk_vtab", "anchor_ranks", "walk_rows", "radix_sort")}
    launches = {}
    walls = {}
    for entropy, phase in (("host", 4), ("wave", 6)):
        sp = TorchCompressor3D((512, 512, 512), (256, 256, 256), device="cuda", entropy=entropy)
        _check(sp.transfer == "sparse", "the sparse transfer is not the default")
        sp.compress(vol, "pwe", tol)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        s = sp.compress(vol, "pwe", tol)
        torch.cuda.synchronize()
        launches[entropy] = dict(kernels.launches)
        for name in want[entropy]:
            _check(launches[entropy][name] > 0, f"{name} was not launched on the sparse {entropy} route")
        _check(s == stream4, f"the sparse {entropy} container differs from phase 4's")
        _check(sp.last_uncertified_chunks == 0, f"uncertified chunks {sp.last_uncertified_ids}")
        out = bound(s, f"sparse {entropy} entropy, equal to phase 4's container")
        _check(np.array_equal(out, out4), f"the sparse {entropy} decode differs from phase 4's")
        print(f"[sparse] {entropy} entropy: container equal to phase 4's byte for byte ({len(s)} bytes), "
              f"decode equal to phase 4's element for element; launches {launches[entropy]}; device to "
              f"host {sp.last_d2h_bytes} bytes sparse, {d2h[entropy]} dense (phase {phase}) -- {smi}")
        walls[entropy] = {"dense": [], "sparse": []}
        d2h_seen = {}
        for transfer in ("dense", "sparse", "sparse", "dense"):
            c = dense[entropy] if transfer == "dense" else sp
            t0 = time.perf_counter()
            s = c.compress(vol, "pwe", tol)
            torch.cuda.synchronize()
            walls[entropy][transfer].append(time.perf_counter() - t0)
            d2h_seen[transfer] = c.last_d2h_bytes
            _check(s == stream4, f"a timed {transfer} {entropy} encode differs from phase 4's container")
        _check(d2h_seen["sparse"] < d2h_seen["dense"], f"{entropy}: the sparse transfer copied no fewer bytes")
        print(f"[sparse] {entropy} entropy, warm encode walls, s (in the order run: dense, sparse, sparse, "
              f"dense): " + "; ".join(f"{t} {', '.join(f'{w:.4f}' for w in ws)} (spread {max(ws) - min(ws):.4f})"
                                      for t, ws in walls[entropy].items())
              + f"; device to host {d2h_seen['sparse']} bytes sparse, {d2h_seen['dense']} dense -- {smi}")
        del sp
    # every chunk past the nonzero cap: the dense re-run on the card
    rerun = TorchCompressor3D((512, 512, 512), (256, 256, 256), device="cuda")
    rerun.sparse_cap_frac = 0.0  # cap = 1024 nonzeros
    s = rerun.compress(vol, "pwe", tol)
    _check(s == stream4, "the dense re-run's container differs from phase 4's")
    print(f"[sparse] sparse_cap_frac 0 (cap 1024, every chunk re-run through the dense front): container "
          f"equal to phase 4's byte for byte; device to host {rerun.last_d2h_bytes} bytes -- {smi}")
    # pwe_strict="device": the device scans at tol - eta, the host only where eta > tol/4
    for entropy in ("host", "wave"):
        margin = TorchCompressor3D((512, 512, 512), (256, 256, 256), device="cuda", entropy=entropy,
                                   pwe_strict="device")
        t0 = time.perf_counter()
        s = margin.compress(vol, "pwe", tol)
        wall = time.perf_counter() - t0
        bound(s, f"pwe_strict='device' {entropy} entropy, {len(s)} bytes, encode {wall:.4f} s (first "
                 f"call), device to host {margin.last_d2h_bytes} bytes")
    print(f"[sparse] phase 13 took {time.perf_counter() - t_phase:.1f} s -- {smi}")
    return launches["host"]


def _morton_pyramid_ref(pm, K: int):
    """The plain morton max pyramid of a cube's 2x2x2 box maxima (pm: msb+1
    per pixel), grids 0 .. K-1 concatenated, grid 0 first, as bytes: what
    sched_boxmax and sched_virtual write."""
    import torch

    from sperr_tpu_torch.ops import speck_virtual as sv

    N = 1 << K
    grids = [sv._morton_flatten(sv.box_reduce_max(pm.reshape(N, N, N)), K - 1)]
    for _ in range(K - 1):
        grids.append(grids[-1].reshape(-1, 8).amax(dim=1))
    return torch.cat(grids[::-1]).to(torch.uint8)


def _psnr_kernel(kernels, smi: str, dev, vol512, vol11) -> dict:
    """Phase 3's K16 (kernels.psnr_q, kernels/quantize.cu) bit for bit
    against its plain version on the inputs the PSNR front gives it at PSNR
    80 (each captured from ``_dense_encode_rows``): phase 5's 256^3 chunk,
    the headline volume's 8 chunks in one call, phase 7's 16 x 1024^2 batch
    and phase 8's 1800 x 3600 field, each row's shrink count (its chosen
    candidate j: the counts that set the lean launch's PSNR_LEAN
    candidates) printed; later rounds forced (rounds of one and one, and of
    two and two candidates) on phase 5's chunk and on four normal(scale
    100) rows of 2^20 at PSNR 105 and 110 (5 and 7 evaluations); the same
    rows at PSNR 120, which f32 cannot meet, raising on both sides with one
    message.  Each call makes two launches a round (the lean launch, then
    the full one queued behind it) and at most one host wait a round.  Each
    call's q and chosen j per row, its launches and host waits; timed: the
    kernel's device ms a call and per launch (torch.profiler), host-issued
    ms per call, the plain version; bound: one read of a row by each launch
    that has it open (the lean launch reads every row).  Returns the
    kernel's row of the result line."""
    import numpy as np
    import torch

    from sperr_tpu_torch.ops import cdf97, quantize
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.runtime.device_bench import host_waits, time_ms

    t_phase = time.perf_counter()
    shrink = np.float32(kernels.PSNR_SHRINK)

    def chosen(q0, q):
        # each row's candidate index: q = q0 shrunk j times in f32
        out = []
        for a, b in zip(q0.tolist(), q.tolist()):
            v, j = np.float32(a), 0
            while v != np.float32(b) and j < 4096:
                v, j = np.float32(v * shrink), j + 1
            out.append(j)
        return out

    def reads(j, rnd):
        # the launches that a row met at candidate j takes part in (each reads the row once)
        whole, left = divmod(j, sum(rnd))
        return 2 * whole + (1 if left < rnd[0] else 2)

    def front(x, fwd, inv):
        with _capture(kernels, ["psnr_q"]) as k16:
            tb._dense_encode_rows(x, "psnr", 80.0, "none", fwd, inv)
        (args,) = k16["psnr_q"]
        return args

    err = 0.0
    cases = {}

    def held(label, args, rnd=kernels.PSNR_ROUND, timed=False):
        nonlocal err
        before = kernels.launches["psnr_q"]
        got = kernels.psnr_q(*args, rnd)
        launches = kernels.launches["psnr_q"] - before
        want = quantize.psnr_q_ref(*args)
        err = max(err, float((got - want).abs().max()))
        _check(got.dtype == want.dtype and torch.equal(got, want), f"K16 differs from its plain version on {label}")
        j = chosen(args[1], got)
        rounds = -(-(max(j) + 1) // sum(rnd))
        _check(launches == 2 * rounds, f"K16 made {launches} launches on {label} ({rounds} rounds of two expected)")
        waits = host_waits(lambda: kernels.psnr_q(*args, rnd))
        _check(waits <= rounds, f"K16 waited {waits} times for the card on {label} ({rounds} rounds)")
        B, n = args[0].shape
        shrinks = {k: j.count(k) for k in sorted(set(j))}
        r = cases[label] = {"q": got.tolist(), "j": j, "shrinks": shrinks, "round": list(rnd), "rounds": rounds,
                            "met_in_first_launch": sum(x < rnd[0] for x in j), "launches_per_call": launches,
                            "host_waits": waits,
                            "bound_ms": _bound_ms(4 * n * sum(reads(x, rnd) for x in j) + 12 * B)}
        if timed:
            per = _kernel_means(lambda: kernels.psnr_q(*args, rnd), "psnr_q", 10)
            r["per_launch"] = {("lean" if f"<{kernels.PSNR_LEAN}>" in k else "full"): m for k, (m, _) in per.items()}
            # the call's launches: each kernel's mean launch times its launches a call (a trace may drop events)
            lean = sum(j <= kernels.PSNR_LEAN for j in rnd)
            r["ms"] = rounds * (lean * r["per_launch"].get("lean", 0.0) + (2 - lean) * r["per_launch"].get("full", 0.0))
            r["lean_bound_ms"] = _bound_ms(4 * B * n + 12 * B)  # the lean launch reads every row
            r["host_ms"] = time_ms(lambda: kernels.psnr_q(*args, rnd), 10, "host-issued")[0]
            r["plain_ms"], r["plain_timed"] = time_ms(lambda: quantize.psnr_q_ref(*args), 5)
        print(f"[kernels] K16 psnr_q, {label} ({B} x {n}, rounds of {rnd[0]} + {rnd[1]} candidates): equal to the "
              f"plain version bit for bit; q {[f'{v:.9g}' for v in r['q'][:16]]}, j {j[:16]}; shrinks per row "
              f"(count: rows) {shrinks}, {r['met_in_first_launch']} of {B} rows met in the first launch; "
              f"{launches} launches, {waits} host waits a call"
              + (f"; kernel {r['ms']:.4f} ms a call on the device (profiler; per launch "
                 + ", ".join(f"{k} {m:.4f}" for k, m in r["per_launch"].items())
                 + f"), {r['host_ms']:.4f} as the host issues it, plain {r['plain_ms']:.4f} ({r['plain_timed']}), "
                 f"bound {r['bound_ms']:.4f} ms, share {r['bound_ms'] / r['ms']:.3f}; the lean launch's bound "
                 f"{r['lean_bound_ms']:.4f} ms, share "
                 f"{r['lean_bound_ms'] / r['per_launch'].get('lean', float('inf')):.3f}" if timed else "")
              + f" -- {smi}")
        return got

    c256 = front(torch.from_numpy(np.ascontiguousarray(vol11)[None]).to(dev), cdf97.dwt3d, cdf97.idwt3d_)
    held("phase 5's 256^3 chunk, PSNR 80", c256, timed=True)
    held("phase 5's 256^3 chunk, PSNR 80, rounds of one and one", c256, (1, 1))
    del c256
    x8 = torch.from_numpy(np.stack([vol512[z:z + 256, y:y + 256, x:x + 256]
                                    for z in (0, 256) for y in (0, 256) for x in (0, 256)])).to(dev)
    held("the headline volume's 8 chunks, PSNR 80", front(x8, cdf97.dwt3d, cdf97.idwt3d_), timed=True)
    del x8
    f16 = torch.from_numpy(np.stack([_turbulence_like(1024, 1024, seed) for seed in range(16)])).to(dev)
    held("phase 7's 16 x 1024^2 fields, PSNR 80", front(f16, cdf97.dwt2d, cdf97.idwt2d), timed=True)
    del f16
    f8 = torch.from_numpy(_turbulence_like(1800, 3600, 16)[None]).to(dev)
    held("phase 8's 1800 x 3600 field, PSNR 80", front(f8, cdf97.dwt2d, cdf97.idwt2d), timed=True)
    del f8
    # the shrink counts of the inputs the PSNR fronts give K16: the lean launch's candidates cover them
    real = [x for c in cases.values() if c["round"] == list(kernels.PSNR_ROUND) for x in c["j"]]
    counts = {k: real.count(k) for k in sorted(set(real))}
    print(f"[kernels] K16: the PSNR 80 inputs' shrink counts (count: rows) {counts}, the most {max(real)}; the "
          f"lean launch tests {kernels.PSNR_LEAN} candidates (shrinks 0 to {kernels.PSNR_LEAN - 1}) and met "
          f"{sum(x < kernels.PSNR_LEAN for x in real)} of {len(real)} rows")
    rows = torch.from_numpy(np.random.default_rng(0).normal(scale=100.0, size=(4, 1 << 20)).astype(np.float32)).to(dev)
    ones = torch.ones(4, device=dev)
    for psnr in (105.0, 110.0):
        t_mse, q0 = quantize.psnr_start(ones, psnr)
        for rnd in (kernels.PSNR_ROUND, (2, 2), (1, 1)):
            held(f"4 normal rows, PSNR {psnr:g}, rounds of {rnd[0]} + {rnd[1]}", (rows, q0, t_mse), rnd)
    t_mse, q0 = quantize.psnr_start(ones, 120.0)
    said = []
    for fn in (lambda: kernels.psnr_q(rows, q0, t_mse), lambda: quantize.psnr_q_ref(rows, q0, t_mse)):
        try:
            fn()
        except ValueError as e:
            said.append(str(e))
    _check(len(said) == 2 and said[0] == said[1], f"PSNR 120 on the normal rows: {said}")
    print(f"[kernels] K16 psnr_q, 4 normal rows, PSNR 120: both versions raise ValueError: {said[0]}")
    del rows
    one = cases["phase 5's 256^3 chunk, PSNR 80"]
    print(f"[kernels] K16 took {time.perf_counter() - t_phase:.1f} s")
    return {"ms": one["ms"], "host_ms": one["host_ms"], "plain_ms": one["plain_ms"],
            "plain_timed": one["plain_timed"], "bound_ms": one["bound_ms"], "max_abs_err": err, "cases": cases,
            "per_launch": one["per_launch"], "lean_bound_ms": one["lean_bound_ms"]}


def _sched_kernels(kernels, smi: str, dev, vol512, vol11) -> dict:
    """Phase 3's schedule kernels (kernels/schedule.cu) bit for bit against
    their plain versions on the card: the cube form (sched_boxmax, then
    sched_virtual) on chunk 0 of phase 4's quantized 256^3 field, an
    all-zero 256^3 chunk, a 256^3 chunk with a 2^31 - 1 magnitude, 16^3 and
    2^3 cubes; each launch alone (the pyramid levels it writes), the fused
    entry point and a given num_bp; the child-table form (sched_table) on a
    Hurricane ISABEL packet chunk (100, 256, 256) and edge chunk (100, 244,
    244), a 1024^2 and a 1800 x 3600 field, alone and (2D) with the I-set
    passes against iset_significance_ref, its launches per call (at most
    3), each shape again with its leaf table widened to int64, and a
    70000 x 16 random field (a plan of one cut; more rows than a grid's
    65535, so the pixel pass's blocks take several); the pyramid form
    (sched_pyramid: two launches, no memset, by the profiler's names) on the
    dyadic (97, 128, 118) chunk, SDRBench S3D 500^3's (244, 244, 244) edge
    chunk and a (65, 17, 17) random chunk of axis depths 5, 5, 7, each also
    against the child-table form, with its host index builds.  Each kernel timed
    on the device and as the host issues it (sched_table in its routes'
    form: no pm, the I-set passes on a 2D field; per launch by the
    profiler), beside its plain version and its bound.  Returns each
    kernel's row of the result line."""
    import numpy as np
    import torch

    from sperr_tpu_torch.codec.speck_wave import build_tree2
    from sperr_tpu_torch.ops import cdf97
    from sperr_tpu_torch.ops import speck as spk
    from sperr_tpu_torch.ops import speck_lis2 as sl2
    from sperr_tpu_torch.ops import speck_virtual as sv
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.runtime.device_bench import busy_ms, time_ms

    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    i32 = torch.int32
    err = {k: 0 for k in ("sched_boxmax", "sched_virtual", "sched_table", "sched_pyramid")}

    def equal(name, got, want, what):
        for k, (a, b) in enumerate(zip(got, want)):
            err[name] = max(err[name], _int_err(a.reshape(-1), b.reshape(-1)))
            _check(a.dtype == b.dtype and torch.equal(a.reshape(-1), b.reshape(-1)),
                   f"{name}: output {k} differs from the plain version on {what}")

    def front(field, two_d=False):
        x = torch.from_numpy(np.ascontiguousarray(field)[None]).to(dev)
        fwd, inv = (cdf97.dwt2d, cdf97.idwt2d) if two_d else (cdf97.dwt3d, cdf97.idwt3d_)
        return tb._dense_encode_rows(x, "pwe", 1e-2, "dual", fwd, inv)["mags"][0].reshape(-1).contiguous()

    def plain_virtual(m, vf, nb=None):
        nb = sv.msbp1_device(m).max() if nb is None else nb
        return (nb,) + sv.pixel_schedule_virtual_ref(m, vf, nb)

    # -- the cube form -------------------------------------------------------------
    chunk0 = front(vol512[:256, :256, :256])
    big = chunk0.clone()
    big[big.numel() // 2] = 2**31 - 1
    cubes = [("headline chunk 0, 256^3", chunk0), ("all zero 256^3", torch.zeros_like(chunk0)),
             ("256^3 with 2^31 - 1", big)]
    for N in (16, 2):
        m = rng.integers(0, 1 << 20, N**3) * (rng.random(N**3) < 0.4)
        cubes.append((f"{N}^3", torch.from_numpy(m.astype(np.int32)).to(dev)))
    for label, m in cubes:
        N = round(m.numel() ** (1 / 3))
        vf = sv.virtual_lis_index((N, N, N), dev)
        K = vf.K
        want = plain_virtual(m, vf)
        pm_ref = sv.msbp1_device(m)
        pyr = _morton_pyramid_ref(pm_ref, K)
        lo = kernels.pyramid_cells(max(K - 4, 0))
        pm8, M, nb = kernels.sched_boxmax(m, K)
        equal("sched_boxmax", (pm8, nb, M[lo:]), (pm_ref.to(torch.uint8), want[0], pyr[lo:]), label)
        got = kernels.sched_virtual(pm8, M, nb.reshape(1), vf.nm_segs, K, vf.nn)
        equal("sched_virtual", got + (M,), want[1:] + (pyr,), label)
        equal("sched_virtual", sv.schedule_virtual(m, vf), want, f"{label} (fused)")
        nb2 = want[0] + 2
        equal("sched_virtual", sv.pixel_schedule_virtual(m, vf, nb2),
              sv.pixel_schedule_virtual_ref(m, vf, nb2), f"{label}, num_bp + 2")
        print(f"[kernels] schedule, cube form, {label}: num_bp {int(want[0])}; sched_boxmax (pm, num_bp, "
              f"grids {max(K - 4, 0)} .. {K - 1}) and sched_virtual (s, e, nm, grids below) equal to the "
              "plain version bit for bit, alone, fused and with num_bp + 2")
    vf = sv.virtual_lis_index((256, 256, 256), dev)
    n, nn, K = vf.n, vf.nn, vf.K
    pm8, M, nb = kernels.sched_boxmax(chunk0, K)
    nb1 = nb.reshape(1)
    segs = vf.nm_segs
    big_cells = kernels.pyramid_cells(K) - kernels.pyramid_cells(K - 4)
    rows = {}
    for name, fn, plain, nbytes in (
            ("sched_boxmax", lambda: kernels.sched_boxmax(chunk0, K),
             lambda: (lambda pm: (pm.to(torch.uint8), _morton_pyramid_ref(pm, K), pm.max()))(
                 sv.msbp1_device(chunk0)),
             # mags read; pm bytes, the grids it writes and num_bp written
             4 * n + n + big_cells + 4),
            ("sched_virtual", lambda: kernels.sched_virtual(pm8, M, nb1, segs, K, nn),
             lambda: sv.pixel_schedule_virtual_ref(chunk0, vf, nb),
             # pm bytes, the large grids, the table and num_bp read; s, e, nm and the small grids written
             n + big_cells + segs.numel() * 4 + 4 + 8 * n + 4 * nn + kernels.pyramid_cells(K - 4))):
        r = rows[name] = {
            "ms": time_ms(fn, 20, "device")[0], "host_ms": time_ms(fn, 20, "host-issued")[0],
            "bound_ms": _bound_ms(nbytes),
        }
        r["plain_ms"], r["plain_timed"] = time_ms(plain, 5)
        print(f"[kernels] {name} 256^3 (headline chunk 0): kernel {r['ms']:.4f} ms ({r['host_ms']:.4f} as the "
              f"host issues it), plain {r['plain_ms']:.4f} ms ({r['plain_timed']}), bound {r['bound_ms']:.4f} ms "
              f"({nbytes} bytes), share {r['bound_ms'] / r['ms']:.3f} -- {smi}")
    fused = (time_ms(lambda: sv.schedule_virtual(chunk0, vf), 20, "device")[0],
             time_ms(lambda: sv.schedule_virtual(chunk0, vf), 20, "host-issued")[0])
    fused_plain = time_ms(lambda: plain_virtual(chunk0, vf), 5)
    # the function K5 + K6 computes: mags read once; s, e, nm and num_bp written once
    fused_bytes = 4 * n + 8 * n + 4 * nn + 4
    print(f"[kernels] schedule_virtual 256^3 (K5 + K6, both launches): {fused[0]:.4f} ms ({fused[1]:.4f} as the "
          f"host issues it), plain {fused_plain[0]:.4f} ms ({fused_plain[1]}); bound {_bound_ms(fused_bytes):.4f} "
          f"ms ({fused_bytes} bytes), share {_bound_ms(fused_bytes) / fused[0]:.3f} -- {smi}")
    rows["sched_virtual"]["fused"] = {"ms": fused[0], "host_ms": fused[1], "plain_ms": fused_plain[0],
                                      "plain_timed": fused_plain[1], "bound_ms": _bound_ms(fused_bytes)}
    del cubes, big, pm8, M

    # -- the child-table form: the Hurricane packet and edge chunks, a 1024^2 and a 1800 x 3600 field ----
    def tab_bytes(ti, n_, xf=None):
        # what this design must move: mags, the parents and the child rows and row starts of every node
        # but the leaves read, each leaf's box from the leaf table (not its rows); num_bp, s, e, nm
        # written, and iset_s on a 2D field (the routes take no pm)
        lo = ti.plan.depth_lo[-2]
        inner_rows = int(ti.ch_bounds[lo])
        return (4 * n_ + 4 * n_ + 4 * inner_rows + 4 * (lo + 1) + ti.plan.leaf.element_size() * (ti.nn - lo)
                + 4 + 8 * n_ + 4 * ti.nn + (0 if xf is None else 4 * (xf + 1)))

    def wide(ti, m, regions):
        # the same call with the leaf table widened to int64 (a field with boxes past pixel 2^28)
        return kernels.sched_table(m, ti.ch_src, ti.ch_bounds, ti.px_parent32,
                                   ti.plan._replace(leaf=ti.plan.leaf.to(torch.int64)), ti.grid, regions)

    tall = rng.integers(0, 1 << 20, 16 * 70000) * (rng.random(16 * 70000) < 0.3)
    tables = [("Hurricane packet chunk (100, 256, 256)", (256, 256, 100), front(vol512[:100, :256, :256])),
              ("Hurricane edge chunk (100, 244, 244)", (244, 244, 100), front(vol512[:100, :244, :244])),
              ("1024^2 field", (1024, 1024), front(_turbulence_like(1024, 1024, 0), True)),
              ("1800x3600 field", (3600, 1800), front(_turbulence_like(1800, 3600, 16), True)),
              ("70000x16 random field", (16, 70000), torch.from_numpy(tall.astype(np.int32)).to(dev))]
    table_times = {}
    for label, dims, m in tables:
        t0 = time.perf_counter()
        ti = spk.tree_index(dims, dev)
        build = time.perf_counter() - t0
        pm = sv.msbp1_device(m)
        nbm = pm.max()
        want = (nbm,) + spk.pixel_schedule_ref(m, ti, nbm)
        regions = None
        if len(dims) == 2:
            tree = build_tree2(dims)
            regions = tree.iset_regions[: tree.xf + 1]
            want = want + (sl2.iset_significance_ref(pm.reshape(dims[1], dims[0]), tree, nbm),)
        per_call = []
        for form, kw in (("alone", {}), ("with the I-set passes", dict(iset_regions=regions))):
            if regions is None and kw:
                continue
            before = kernels.launches["sched_table"]
            got = spk.schedule_table(m, ti, **kw)
            per_call.append(kernels.launches["sched_table"] - before)
            equal("sched_table", got, want[:len(got)], f"{label}, {form}")
            _check(len(got) == 4 + len(kw), f"sched_table {form} returned {len(got)} outputs on {label}")
        equal("sched_table", wide(ti, m, regions), want, f"{label}, int64 leaf table")
        _check(max(per_call) <= 3 and min(per_call) == 2,
               f"sched_table made {per_call} launches per call on {label} (two expected, at most 3)")
        if label.startswith("70000"):
            _check(len(ti.plan.cuts) == 1 and dims[1] > 65535,
                   f"the 70000 x 16 field's plan is {ti.plan.cuts} (one cut expected)")
            print(f"[kernels] sched_table, {label} (cuts {ti.plan.cuts}, {ti.grid[0]} rows): equal to the plain "
                  "version bit for bit (num_bp, s, e, nm, iset_s), alone, with the I-set passes and with the int64 "
                  "leaf table")
            continue
        # the route's own form: on a 2D field the I-set passes with the schedule
        kw = {} if regions is None else dict(iset_regions=regions)
        nbytes = tab_bytes(ti, m.numel(), None if regions is None else len(regions) - 1)
        r = table_times[label] = {
            "ms": time_ms(lambda: spk.schedule_table(m, ti, **kw), 10, "device")[0],
            "host_ms": time_ms(lambda: spk.schedule_table(m, ti, **kw), 10, "host-issued")[0],
            "bound_ms": _bound_ms(nbytes), "bytes": nbytes, "launches_per_call": per_call[-1],
            "cuts": list(ti.plan.cuts), "blocks": [int(t.shape[2]) - 1 for t in ti.plan.sub],
            "smem": ti.plan.smem,
        }
        if regions is None:
            r["plain_ms"], r["plain_timed"] = time_ms(lambda: spk.pixel_schedule_ref(m, ti, nbm), 3)
        else:
            r["plain_ms"], r["plain_timed"] = time_ms(lambda: (
                spk.pixel_schedule_ref(m, ti, nbm), sl2.iset_significance_ref(pm.reshape(dims[1], dims[0]), tree,
                                                                               nbm)), 3)
        _, per_name = busy_ms(lambda: spk.schedule_table(m, ti, **kw), 5)
        r["per_launch"] = {_kernel_name(k): v for k, v in per_name.items()}
        print(f"[kernels] sched_table, {label} {dims} (index {build:.3f} s, {ti.nn} nodes, {len(ti.plan.depth_lo) - 1} "
              f"depths; cuts {ti.plan.cuts}, {r['blocks']} blocks and groups, {ti.plan.smem} shared bytes; launches "
              f"per call {per_call} alone, with the I-set passes): equal to the plain version bit for bit (num_bp "
              f"{int(nbm)}, s, e, nm" + (", iset_s" if regions is not None else "")
              + f"; also with the int64 leaf table); the route's form {r['ms']:.4f} ms ({r['host_ms']:.4f} as the "
              f"host issues it; per launch " + ", ".join(f"{k} {v:.4f}" for k, v in r["per_launch"].items())
              + f"), plain {r['plain_ms']:.4f} ms ({r['plain_timed']}), bound {r['bound_ms']:.4f} ms ({nbytes} "
              "bytes: the leaves' boxes, not their rows" + (", iset_s" if regions is not None else "")
              + f"), share {r['bound_ms'] / r['ms']:.3f} -- {smi}")
    rows["sched_table"] = dict(table_times[tables[0][0]], **{"edge": table_times[tables[1][0]],
                                                             "2d": {k: v for k, v in table_times.items()
                                                                    if k not in (tables[0][0], tables[1][0])}})
    del tables

    # -- the pyramid form: the dyadic chunk, SDRBench S3D's 244^3 chunk, axes of unequal depths ----
    def pyr_bytes(plan, n_, nn_):
        # what this design must move: mags read; s, e, nm, num_bp written; nm_src and the axes' tables
        # read; each level a node or a pixel's parent lies on written once and read once
        cells = plan.off[plan.lmax + 1]
        return 4 * n_ + 8 * n_ + 4 * nn_ + 4 + 4 * nn_ + plan.axes.numel() * 4 + 2 * cells

    uneven = rng.integers(0, 1 << 20, 65 * 17 * 17) * (rng.random(65 * 17 * 17) < 0.3)
    pyr_times = {}
    for label, dims, m in (("dyadic chunk", (97, 128, 118), front(vol11[:118, :128, :97])),
                           ("S3D 500^3's edge chunk", (244, 244, 244), front(vol512[:244, :244, :244])),
                           ("axes of depths 5, 5, 7 (z, y, x)", (65, 17, 17),
                            torch.from_numpy(uneven.astype(np.int32)).to(dev))):
        t0 = time.perf_counter()
        pi = spk.pyramid_index(dims, dev)
        build = time.perf_counter() - t0
        nbm = sv.msbp1_device(m).max()
        want = (nbm,) + spk.pixel_schedule_pyramid_ref(m, pi, nbm)
        before = kernels.launches["sched_pyramid"]
        equal("sched_pyramid", spk.schedule_pyramid(m, pi), want, f"{label} {dims}")
        per_call = kernels.launches["sched_pyramid"] - before
        _check(per_call == 2, f"sched_pyramid made {per_call} launches a call on {dims} (two expected)")
        t0 = time.perf_counter()
        ti = spk.tree_index(dims, dev)
        t_build = time.perf_counter() - t0
        equal("sched_pyramid", spk.schedule_pyramid(m, pi), (nbm,) + spk.pixel_schedule_ref(m, ti, nbm),
              f"{label} {dims} against the child-table form")
        del ti
        names = _device_names(lambda: spk.schedule_pyramid(m, pi), 2, need=("pyramid_tiles", "pyramid_finish"))
        _check(names[-2:] == ["pyramid_tiles", "pyramid_finish"] and set(names) == {"pyramid_tiles", "pyramid_finish"},
               f"sched_pyramid's device operations on {dims}: {names} (its two kernels, no memset, expected)")
        npx, p = m.numel(), pi.plan
        nbytes = pyr_bytes(p, npx, pi.nn)
        r = pyr_times[dims] = {
            "ms": time_ms(lambda: spk.schedule_pyramid(m, pi), 10, "device")[0],
            "host_ms": time_ms(lambda: spk.schedule_pyramid(m, pi), 10, "host-issued")[0],
            "bound_ms": _bound_ms(nbytes), "bytes": nbytes, "launches_per_call": per_call, "index_s": build,
            "levels": p.levels, "top": p.top, "lmax": p.lmax, "nodes": pi.nn,
        }
        r["plain_ms"], r["plain_timed"] = time_ms(lambda: spk.pixel_schedule_pyramid_ref(m, pi, nbm), 5)
        r["per_launch"] = {_kernel_name(k): v[0]
                           for k, v in _kernel_means(lambda: spk.schedule_pyramid(m, pi), "pyramid_", 10).items()}
        print(f"[kernels] sched_pyramid, {label} {dims} (pyramid index {build:.3f} s on the host, the child "
              f"table's {t_build:.3f} s; {pi.nn} nodes, {p.levels} levels, tiles at level {p.top}, levels "
              f"0 .. {p.lmax} written; {per_call} launches a call, no memset): equal to the plain version and "
              f"to the child-table form bit for bit; kernel {r['ms']:.4f} ms ({r['host_ms']:.4f} as the host "
              f"issues it; per launch " + ", ".join(f"{k} {v:.4f}" for k, v in r["per_launch"].items())
              + f"), plain {r['plain_ms']:.4f} ms ({r['plain_timed']}), bound {r['bound_ms']:.4f} ms ({nbytes} "
              f"bytes), share {r['bound_ms'] / r['ms']:.3f} -- {smi}")
        del pi, m, want
    rows["sched_pyramid"] = dict(pyr_times[(97, 128, 118)], **{
        "s3d_244": pyr_times[(244, 244, 244)], "uneven_65x17x17": pyr_times[(65, 17, 17)]})
    for name in rows:
        rows[name]["max_abs_err"] = err[name]
    print(f"[kernels] schedule kernels took {time.perf_counter() - t_phase:.1f} s")
    return rows


def _walk_kernels(kernels, smi: str, dev, vol512) -> dict:
    """Phase 3's walk kernels (kernels/walk.cu) bit for bit against their
    plain versions on the card: the child value table (``walk_vtab``), K7
    (``anchor_ranks``: ``dense_anchor_ranks`` against
    ``dense_anchor_ranks_ref``), the whole walk (``_lis_items_virtual``
    against ``_lis_items_virtual_ref``, padding items included) and every
    radix sort the walk ran (against ``torch.sort(stable=True)`` on the same
    keys), on headline chunk 0 at tiers 0, 1 and the widest, an all-zero, a
    one-pixel and a 2^31 - 1 256^3 chunk, 16^3 and 2^3 cubes; then
    ``lexsort`` (the radix sort) against its plain version on the keys of the
    plain table walk (64, 64, 25) and the plain 2D walk (256^2); the sort at
    the tile's edges and on all-equal keys, and one walk's two sorts 20
    times over.  The table, K7, the walk at tiers 0 and 1 and the tier-1
    walk sort timed on the device and as the host issues them, beside their
    plain versions, their bounds (the sort also beside its LSD floor: its
    passes' bytes) and one PyTorch call (torch.sort; torch.unique for K7's
    largest level), with the earlier design's times (three launches a
    digit, K7's levels sorted) printed beside them; the launches
    per call checked.  Returns each kernel's row of the result line."""
    import numpy as np
    import torch

    from sperr_tpu_torch.codec import speck_wave as sw
    from sperr_tpu_torch.ops import cdf97
    from sperr_tpu_torch.ops import speck as spk
    from sperr_tpu_torch.ops import speck_lis as sl
    from sperr_tpu_torch.ops import speck_lis2 as sl2
    from sperr_tpu_torch.ops import speck_virtual as sv
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.runtime.device_bench import busy_ms, time_ms

    t_phase = time.perf_counter()
    rng = np.random.default_rng(14)
    names = ("walk_vtab", "anchor_ranks", "walk_rows", "radix_sort")
    err = {k: 0 for k in names}

    def equal(name, got, want, what):
        for k, (a, b) in enumerate(zip(got, want)):
            a, b = a.reshape(-1), b.reshape(-1)
            same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            err[name] = max(err[name], _int_err(a, b) if a.shape == b.shape else 2**31)
            _check(same, f"{name}: output {k} differs from the plain version on {what}")

    def sort_ref(keys, vals):
        idx = torch.sort(keys, stable=True).indices
        return keys[idx], (idx.to(torch.int32) if vals is None else vals[idx])

    x = torch.from_numpy(np.ascontiguousarray(vol512[:256, :256, :256])[None]).to(dev)
    front = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", cdf97.dwt3d, cdf97.idwt3d_)
    mags0 = front["mags"][0].reshape(-1).contiguous()
    signs0 = front["signs"][0].reshape(-1).contiguous()
    del x, front
    n = mags0.numel()
    vf256 = sv.virtual_lis_index((256, 256, 256), dev)
    tiers = tb.wave_tiers_for(n)
    cap = {t: tb._wave_caps(vf256, (256, 256, 256), tiers[t], 34)["node_cap"] for t in (0, 1, len(tiers) - 1)}
    one = torch.zeros_like(mags0)
    one[n // 3] = 5
    big = mags0.clone()
    big[n // 2] = 2**31 - 1
    cases = [("headline chunk 0", mags0, signs0, [(f"tier {t}", c) for t, c in cap.items()]),
             ("all zero 256^3", torch.zeros_like(mags0), torch.zeros_like(signs0), [("tier 0", cap[0])]),
             ("one pixel 256^3", one, signs0, [("tier 0", cap[0])]),
             ("256^3 with 2^31 - 1", big, signs0, [("tier 0", cap[0]), ("tier 1", cap[1])])]
    for N in (16, 2):
        m = rng.integers(0, 1 << 20, N**3) * (rng.random(N**3) < 0.4)
        vfN = sv.virtual_lis_index((N, N, N), dev)
        cases.append((f"{N}^3", torch.from_numpy(m.astype(np.int32)).to(dev),
                      torch.from_numpy(rng.random(N**3) < 0.5).to(dev),
                      [("nn", vfN.nn), ("nn / 20", max(1, vfN.nn // 20))]))
    rows = {}
    keep = {}
    for label, mags, signs, caps in cases:
        N = round(mags.numel() ** (1 / 3))
        vf = sv.virtual_lis_index((N, N, N), dev)
        nb, s, _, nm = sv.schedule_virtual(mags, vf)
        node_s = torch.where(nm > 0, nb - nm, 0x7FFF).to(torch.int32)
        for mg in (None, mags):
            equal("walk_vtab", (sv.child_value_table(vf, s, signs, node_s, mg),),
                  (sv.child_value_table_ref(vf, s, signs, node_s, mg),),
                  f"{label}, mags {'packed' if mg is not None else 'apart'}")
        want_k7 = sv.dense_anchor_ranks_ref(node_s, vf)
        equal("anchor_ranks", sv.dense_anchor_ranks(node_s, vf), want_k7, label)
        equal("anchor_ranks", sv.dense_anchor_ranks(node_s, vf, bitmap_bits=16), want_k7,
              f"{label}, the levels past 16 key bits sorted")
        vtab = sv.child_value_table(vf, s, signs, node_s)
        nsorts = 0
        for clabel, c in caps:
            with _capture(kernels, ["radix_sort"]) as rc:
                got = sl._lis_items_virtual(node_s, s, signs, nb, vf, c, vtab)
            with _capture(sl, ["lexsort"]) as lc:
                want = sl._lis_items_virtual_ref(node_s, s, signs, nb, vf, c, vtab)
            equal("walk_rows", got, want, f"{label}, {clabel} (node cap {c})")
            for keys, bits, vals in rc["radix_sort"]:
                equal("radix_sort", kernels.radix_sort(keys, bits, vals), sort_ref(keys, vals),
                      f"{label}, {clabel}: a sort of {keys.numel()} keys")
                nsorts += 1
            for (keys,) in lc["lexsort"]:
                equal("radix_sort", (kernels.radix_lexsort(keys).long(),), (sl.lexsort(keys),),
                      f"{label}, {clabel}: the plain walk's lexsort of {keys[0].numel()} keys")
                nsorts += 1
            if label == "headline chunk 0" and clabel in ("tier 0", "tier 1"):
                keep[clabel] = (node_s, s, signs, nb, vf, c, vtab, rc["radix_sort"], lc["lexsort"])
        print(f"[kernels] walk, {label}: num_bp {int(nb)}, {int((node_s < 0x7FFF).sum())} significant sets; "
              f"walk_vtab (mags packed and apart), anchor_ranks (J, R; bitmaps and sorted levels) and the walk's "
              f"payload words at "
              f"{', '.join(f'{cl} ({c})' for cl, c in caps)} equal to the plain versions bit for bit, and "
              f"{nsorts} sorts equal to torch.sort(stable=True)")
        del vtab, got, want
    del cases, one, big

    # lexsort (the radix sort) on the table walk's and the 2D walk's keys
    dims_t = (64, 64, 25)
    nt_ = dims_t[0] * dims_t[1] * dims_t[2]
    ti, li_t = spk.tree_index(dims_t, dev), sl.lis_index(dims_t, dev)
    mt = torch.from_numpy((rng.integers(0, 1 << 16, nt_) * (rng.random(nt_) < 0.3)).astype(np.int32)).to(dev)
    nbt, st, _, nmt = spk.schedule_table(mt, ti)
    node_st = torch.where(nmt > 0, nbt - nmt, 0x7FFF).to(torch.int32)
    # the plain walks' lexsorts (the walks themselves run walk_table.cu's kernels
    # and sort their packed keys, held in _table_walk_kernels)
    with _capture(sl, ["lexsort"]) as lt:
        sl._lis_items_table_ref(node_st, st, torch.from_numpy(rng.random(nt_) < 0.5).to(dev), nbt, li_t, li_t.nn)
    field = _turbulence_like(256, 256, 3)
    fr2 = tb._dense_encode_rows(torch.from_numpy(field[None]).to(dev), "pwe", 1e-2, "dual", cdf97.dwt2d,
                                cdf97.idwt2d)
    ti2, li2 = spk.tree_index((256, 256), dev), sl2.lis2_index((256, 256), dev)
    tree2 = sw.build_tree2((256, 256))
    nb2, s2, _, nm2, iset2 = spk.schedule_table(fr2["mags"][0].reshape(-1).contiguous(), ti2,
                                                iset_regions=tree2.iset_regions[: tree2.xf + 1])
    with _capture(sl, ["lexsort"]) as l2a, _capture(sl2, ["lexsort"]) as l2b:
        sl2._lis2_items_ref(spk.node_passes(nm2, nb2), s2, fr2["signs"][0].reshape(-1).contiguous(), nb2, iset2,
                            li2, li2.nn)
    for what, calls in (("plain table walk (64, 64, 25)", lt["lexsort"]),
                        ("plain 2D walk 256^2", l2a["lexsort"] + l2b["lexsort"])):
        _check(len(calls) > 0, f"the {what} called no lexsort")
        for (keys,) in calls:
            got = kernels.radix_lexsort(keys).long()
            equal("radix_sort", (got,), (sl.lexsort(keys),), f"the {what}'s lexsort")
        print(f"[kernels] lexsort on the {what}'s keys ({len(calls)} calls, "
              f"{', '.join(str(len(k)) for (k,) in calls)} keys each): the radix sort equal to the chained "
              "torch.sort bit for bit")

    # the one-sweep sort at a tile's edges, on int32 and int64 keys of both
    # signs, full and reduced widths, and all-equal keys
    T = kernels.SORT_TILE
    nedge = 0
    for ne in (1, T - 1, T, T + 1, 3 * T + 1):
        for dt, width in ((torch.int32, 32), (torch.int64, 64)):
            lo, hi = (-(2**31), 2**31 - 1) if width == 32 else (-(2**62), 2**62)
            full = rng.integers(lo, hi, ne)
            full[rng.random(ne) < 0.3] = full[0]
            for knp, bits in ((full, None), (rng.integers(0, 2**13, ne), 13), (np.full(ne, -5), None),
                              (np.full(ne, 7), 3)):
                keys = torch.from_numpy(knp).to(dt).to(dev)
                for vals in (None, torch.from_numpy(rng.integers(0, 2**31 - 1, ne)).to(torch.int32).to(dev)):
                    equal("radix_sort", kernels.radix_sort(keys, bits, vals), sort_ref(keys, vals),
                          f"{ne} {dt} keys (bits {bits}, {'with' if vals is not None else 'no'} values)")
                    nedge += 1
    print(f"[kernels] radix sort at 1, tile - 1, tile, tile + 1 and 3 tiles + 1 keys (tile {T}), int32 and "
          f"int64, both signs, full and reduced widths, all-equal keys: {nedge} sorts equal to "
          "torch.sort(stable=True)")

    # timings at the main path's shapes: headline chunk 0
    node_s, s, signs, nb, vf, c1, vtab, sorts1, plain_sorts1 = keep["tier 1"]
    nn, nt = vf.nn, vf.nt
    # vtab: s, signs, mags read; the table written.  K7: node_s read; J, R
    # written.  The walk: node_s and the table read; the payload words and
    # n_sig written.  The sort: keys and values read, both written.
    rows["walk_vtab"] = {"fn": lambda: sv.child_value_table(vf, s, signs, node_s, mags0),
                         "plain": lambda: sv.child_value_table_ref(vf, s, signs, node_s, mags0),
                         "bytes": 4 * n + n + 4 * n + 4 * nn + 4 * nt}
    with _capture(sv, ["_level_ranks"]) as lr:
        sv.dense_anchor_ranks_ref(node_s, vf)
    lkey = max((a[0] for a in lr["_level_ranks"]), key=lambda k: k.numel())
    rows["anchor_ranks"] = {"fn": lambda: sv.dense_anchor_ranks(node_s, vf),
                            "plain": lambda: sv.dense_anchor_ranks_ref(node_s, vf), "bytes": 12 * nn,
                            "library": lambda: torch.unique(lkey, sorted=True, return_inverse=True),
                            "library_what": f"torch.unique(sorted=True, return_inverse=True) on the "
                                            f"{lkey.numel()}-node level's keys", "earlier": "0.2728-0.2781"}
    # the look-back's race check: the tier-1 walk's two sorts, 20 times each
    for keys, bits, vals in sorts1:
        first = kernels.radix_sort(keys, bits, vals)
        for _ in range(20):
            again = kernels.radix_sort(keys, bits, vals)
            _check(torch.equal(again[0], first[0]) and torch.equal(again[1], first[1]),
                   f"a repeated sort of {keys.numel()} keys gave another order")
    print(f"[kernels] the tier-1 walk's {len(sorts1)} sorts ({', '.join(str(k.numel()) for k, _, _ in sorts1)} "
          "keys) repeated 20 times each: every output identical")
    walk_sort = max(sorts1, key=lambda a: a[0].numel())
    wk, wb, wv = walk_sort
    plain_keys = max(plain_sorts1, key=lambda a: a[0][0].numel())[0]
    rows["radix_sort"] = {"fn": lambda: kernels.radix_sort(wk, wb, wv),
                          "plain": lambda: sl.lexsort(plain_keys),
                          "library": lambda: torch.sort(wk, stable=True), "library_how": "device",
                          "library_what": "torch.sort(stable=True)",
                          "bytes": 2 * (wk.element_size() + 4) * wk.numel(), "earlier": "0.7958-0.7985",
                          "lsd_bytes": len(kernels.radix_shifts(wb)) * 2 * (wk.element_size() + 4) * wk.numel()
                          + wk.element_size() * wk.numel()}
    for t in ("tier 0", "tier 1"):
        node_s_, s_, signs_, nb_, vf_, c_, vtab_, _, _ = keep[t]
        T = sl.lis_item_count(vf_, c_)
        rows[f"walk_rows {t}"] = {
            "fn": (lambda a=(node_s_, s_, signs_, nb_, vf_, c_, vtab_): sl._lis_items_virtual(*a)),
            "plain": (lambda a=(node_s_, s_, signs_, nb_, vf_, c_, vtab_): sl._lis_items_virtual_ref(*a)),
            "bytes": 4 * nn + 4 * nt + 4 * T + 4, "T": T,
            "earlier": {"tier 0": "0.8094-0.8190", "tier 1": "1.6134-1.6246"}[t]}
    for name, r in rows.items():
        before = dict(kernels.launches)
        r["fn"]()
        torch.cuda.synchronize()
        per_call = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
        r["ms"] = time_ms(r["fn"], 10, "device")[0]
        r["host_ms"] = time_ms(r["fn"], 10, "host-issued")[0]
        r["plain_ms"], r["plain_timed"] = time_ms(r["plain"], 3)
        r["library_ms"], lib_timed = (time_ms(r["library"], 10, r.get("library_how")) if "library" in r
                                      else (None, None))
        r["bound_ms"] = _bound_ms(r["bytes"])
        r["launches_per_call"] = per_call
        if "lsd_bytes" in r:
            r["lsd_floor_ms"] = _bound_ms(r["lsd_bytes"])
        print(f"[kernels] {name} 256^3 (headline chunk 0" + (f", {r['T']} items" if "T" in r else "")
              + f"; launches per call {per_call}): kernels {r['ms']:.4f} ms ({r['host_ms']:.4f} as the host "
              f"issues them)"
              + (f" (the earlier design on an H100 80GB HBM3 at 700 W: {r['earlier']} ms)" if "earlier" in r else "")
              + f", plain {r['plain_ms']:.4f} ms ({r['plain_timed']})"
              + (f", {r['library_what']} {r['library_ms']:.4f} ms ({lib_timed}), kernels / library "
                 f"{r['ms'] / r['library_ms']:.3f}" if r["library_ms"] is not None else "")
              + f", bound {r['bound_ms']:.4f} ms ({r['bytes']} bytes), share {r['bound_ms'] / r['ms']:.3f}"
              + (f", LSD floor {r['lsd_floor_ms']:.4f} ms ({r['lsd_bytes']} bytes: its passes' reads and "
                 f"writes and the histogram's read), share {r['lsd_floor_ms'] / r['ms']:.3f}"
                 if "lsd_bytes" in r else "") + f" -- {smi}")
    # where the device time goes: each kernel's busy time per call (profiler)
    for name in ("anchor_ranks", "radix_sort", "walk_rows tier 0", "walk_rows tier 1"):
        tot, per = busy_ms(rows[name]["fn"], 10)
        print(f"[kernels] {name}: device busy {tot:.4f} ms per call; by kernel: "
              + ", ".join(f"{_kernel_name(k)} {v:.4f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1]))
              + f" -- {smi}")
    for t in ("tier 0", "tier 1"):
        per_call = rows[f"walk_rows {t}"]["launches_per_call"]
        _check(sum(per_call.values()) <= 40, f"the walk at {t} issued {per_call} launches (at most 40)")
    _check("radix_sort" not in rows["anchor_ranks"]["launches_per_call"], "K7 launched a radix pass")
    out = {}
    for name in names:
        src = rows["walk_rows tier 0"] if name == "walk_rows" else rows[name]
        out[name] = {k: src[k] for k in ("ms", "host_ms", "plain_ms", "plain_timed", "bound_ms", "library_ms",
                                          "launches_per_call", "lsd_floor_ms") if k in src}
        out[name]["max_abs_err"] = err[name]
    out["walk_rows"]["tier1"] = {k: rows["walk_rows tier 1"][k]
                                 for k in ("ms", "host_ms", "plain_ms", "bound_ms", "launches_per_call")}
    print(f"[kernels] walk kernels took {time.perf_counter() - t_phase:.1f} s")
    return out


def _our_kernels(kernels) -> set:
    """The names of the repo's kernels, as torch.profiler shows them
    (``_kernel_name``), read from the sources; and "Memset"."""
    import re

    names = {"Memset"}
    for path in kernels.SOURCES + kernels.HEADERS:
        with open(path) as f:
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                    f.read()))
    return names


def _device_names(fn, calls: int = 1, need=()) -> list:
    """The device operations of ``calls`` calls of fn, in order, by
    torch.profiler after a warm-up: their kernel names (``_kernel_name``).
    A trace can miss its first operations (seen on an H100): read the last
    call's.  It can also lose some or all of them (seen on an H100, as
    busy_ms notes): a trace with no device operation, or without one of
    the kernel names ``need``, is taken again, twice at most, and the last
    one returned (the caller checks it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        names = [_kernel_name(e.name) for e in evs]
        if names and all(k in names for k in need):
            break
    return names


def _sorts_and_scans(kernels, names) -> list:
    """The operations among ``names`` (profiler keys or kernel names) that
    are not the repo's kernels and sort, scan or take a running maximum:
    torch's and CUB's sorts, scans and cummax."""
    ours = _our_kernels(kernels)
    short = {_kernel_name(n) for n in names} - ours
    return sorted(n for n in short if any(w in n.lower() for w in ("sort", "cub", "cummax", "scan")))


def _rank_state(kernels, sl, li, views) -> dict:
    """The rank levels of a table or 2D walk call, read from its buffer
    (``keep`` or a cached call's views): per level its route and the bits
    its keys spanned (groups of 256; the small levels' exact span), the
    plan's widest region, the levels that overflowed to their gated sorted
    route, and whether the hop-word bitmaps and the scans' counters were
    left zero."""
    st = sl.table_static(li)
    rl = kernels.table_rank_layout(st.plan.host, st.plan.nsmall)
    nlv = len(st.plan.counts)
    rst = views["rst"][: nlv * kernels.RANK_STATE].reshape(nlv, kernels.RANK_STATE).cpu().numpy()
    used = []
    D = st.dlow0
    for l in range(nlv):
        nu, d, groups, over, nd = (int(x) for x in rst[l, :5])
        if l < rl.nsmall:
            used.append(nu * D)  # the one block's span: nu D bits
            D = max(D, nd + 1)
        else:
            used.append(None if over else 256 * groups)
    return {"used_bits": used, "widest_used_bits": max((u for u in used if u is not None), default=0),
            "widest_region_bits": max([1 << c for c in rl.cap_bits] + [1 << kernels.RANK_SMALL_BITS] * bool(rl.nsmall)),
            "overflowed": [l for l, u in enumerate(used) if u is None], "gated": list(rl.gated),
            "left_zero": not views["ubm"].any().item() and not views["rst"].reshape(-1, kernels.RANK_STATE)[:, 5].any().item()}


def _static_build(sl, li, index_s: float) -> dict:
    """Host seconds of a walk index: its build (``index_s``, measured by the
    caller; about 0 where it was cached), its ``table_static`` (None where
    an earlier phase made it) and ``path_ranks`` alone (a fresh call)."""
    fresh = li._walk_static is None
    t0 = time.perf_counter()
    sl.table_static(li)
    static_s = round(time.perf_counter() - t0, 4) if fresh else None
    t0 = time.perf_counter()
    sl.path_ranks(li)
    return {"index_s": index_s, "table_static_s": static_s, "path_ranks_s": time.perf_counter() - t0}


def _table_walk_kernels(kernels, smi: str, dev, vol512, vol11) -> dict:
    """Phase 3's table and 2D walk kernels (kernels/walk_table.cu) bit for
    bit against their plain versions on the card, every output of each:
    ``node_passes`` (node_s), ``table_anchors`` (J, R, u, jp against
    ``table_anchors_ref``, alone and inside the walk), the whole walk
    (``_table_items_cuda`` against ``_lis_items_table_ref`` or
    ``_lis2_items_ref``: payload words, padding included, and n_sig) and
    every radix sort it ran (against torch.sort(stable=True)); the 2D walk's
    LIS planes through K9's planes launch and K11 against the plain event
    form (buffer, counts, total and n_sig; at the tier-0 caps, an event cap
    of 700 and a byte cap of 100).  Inputs: a Hurricane ISABEL packet
    chunk (100, 256, 256) at tiers 0 and 1 and at a node cap of nn / 20,
    its all-zero, one-pixel and
    2^31 - 1 forms, the dyadic chunk (118, 128, 97); a 1024^2, the
    1800 x 3600 and a 3600 x 7200 field (its finest rank level past the
    bitmaps' 32 bits: sorted), 33 x 57 random, an all-zero and a 2^31 - 1
    1024^2, a one-pixel 33 x 57; the anchors also with every level past 16
    key bits sorted; node_passes also on headline chunk 0's schedule (the
    256^3 cube path's).  Each kernel timed at the main path's shapes on
    the device and as the host issues it, beside its plain version, its
    bound and, for the anchors, torch.unique on the largest ranked level's
    keys.  Returns each kernel's row of the result line."""
    import numpy as np
    import torch

    from sperr_tpu_torch.codec.speck_wave import build_tree2
    from sperr_tpu_torch.ops import cdf97
    from sperr_tpu_torch.ops import speck as spk
    from sperr_tpu_torch.ops import speck_lis as sl
    from sperr_tpu_torch.ops import speck_lis2 as sl2
    from sperr_tpu_torch.ops import wave_pack as wp
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.parallel import batched2d as tb2
    from sperr_tpu_torch.runtime.device_bench import busy_ms, time_ms

    t_phase = time.perf_counter()
    names = ("node_passes", "table_anchors", "table_walk")
    err = {k: 0 for k in names}
    nsorts = 0
    big = 2**31 - 1

    def equal(name, got, want, what):
        for k, (a, b) in enumerate(zip(got, want)):
            a, b = a.reshape(-1), b.reshape(-1)
            same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            err[name] = max(err[name], _int_err(a, b) if a.shape == b.shape else 2**31)
            _check(same, f"{name}: output {k} differs from the plain version on {what}")

    def front(field, two_d=False):
        x = torch.from_numpy(np.ascontiguousarray(field)[None]).to(dev)
        fwd, inv = (cdf97.dwt2d, cdf97.idwt2d) if two_d else (cdf97.dwt3d, cdf97.idwt3d_)
        fr = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", fwd, inv)
        return fr["mags"][0].reshape(-1).contiguous(), fr["signs"][0].reshape(-1).contiguous()

    def sorts_equal(calls, what):
        for keys, bits, vals in calls:
            idx = torch.sort(keys, stable=True).indices
            want = (keys[idx], idx.to(torch.int32) if vals is None else vals[idx])
            equal("table_walk", kernels.radix_sort(keys, bits, vals), want, f"{what}: a sort of {keys.numel()} keys")
        return len(calls)

    def edge(m, kind):
        out = torch.zeros_like(m) if kind != "big" else m.clone()
        if kind == "one":
            out[m.numel() // 3] = 5
        if kind == "big":
            out[m.numel() // 2] = big
        return out

    timing, ranks, builds = {}, {}, {}
    # -- 3D chunks on the table walk ---------------------------------------------
    dims_h = (256, 256, 100)
    hur = front(vol512[:100, :256, :256])
    li_h, _ = tb._wave_index(dims_h, dev)
    tiers = tb.wave_tiers_for(256 * 256 * 100)
    cap_h = {t: tb._wave_caps(li_h, dims_h, tiers[t], 34)["node_cap"] for t in (0, 1)}
    cases3 = [("Hurricane packet chunk (100, 256, 256)", dims_h, hur,
               [("tier 0", cap_h[0]), ("tier 1", cap_h[1]), ("node cap nn / 20", li_h.nn // 20)]),
              ("all zero (100, 256, 256)", dims_h, (edge(hur[0], "zero"), hur[1]), [("tier 0", cap_h[0])]),
              ("one pixel (100, 256, 256)", dims_h, (edge(hur[0], "one"), hur[1]), [("tier 0", cap_h[0])]),
              ("(100, 256, 256) with 2^31 - 1", dims_h, (edge(hur[0], "big"), hur[1]),
               [("tier 0", cap_h[0]), ("tier 1", cap_h[1])]),
              ("dyadic chunk (118, 128, 97)", (97, 128, 118), front(vol11[:118, :128, :97]), [("node cap nn", None)])]
    for label, dims, (m, sg), caps in cases3:
        t0 = time.perf_counter()
        li, si = tb._wave_index(dims, dev)
        if label.startswith("Hurricane"):
            builds[label] = _static_build(sl, li, time.perf_counter() - t0)
        nb, s, _, nm = tb._schedule(m, si)
        ns = spk.node_passes(nm, nb)
        equal("node_passes", (ns,), (spk.node_passes_ref(nm, nb),), label)
        want_anc = sl.table_anchors_ref(ns, li)
        equal("table_anchors", sl.table_anchors(ns, li), want_anc, label)
        equal("table_anchors", sl.table_anchors(ns, li, cap_bits=16), want_anc, f"{label}, levels past 16 bits gated")
        equal("table_anchors", sl.table_anchors(ns, li, cap_bits=8), want_anc, f"{label}, levels gated to sorting")
        for clabel, c in caps:
            c = li.nn if c is None else c
            keep = {}
            with _capture(kernels, ["radix_sort"], clone=True) as rc:  # the walk's sorts write over their keys
                got = sl._table_items_cuda(ns, s, sg, li, c, keep=keep)
            want_w = sl._lis_items_table_ref(ns, s, sg, nb, li, c)
            equal("table_walk", got, want_w, f"{label}, {clabel} (node cap {c})")
            equal("table_anchors", [keep[k] for k in ("J", "R", "u", "jp")], want_anc, f"{label}, {clabel} (in the walk)")
            ranks[f"{label}, {clabel}"] = rs = _rank_state(kernels, sl, li, keep)
            _check(not rs["overflowed"] and rs["widest_used_bits"] <= 2**26 and rs["left_zero"],
                   f"{label}, {clabel}: rank levels {rs}")
            nsorts += sorts_equal(rc["radix_sort"], f"{label}, {clabel}")
            if clabel == caps[0][0]:
                equal("table_walk", sl._table_items_cuda(ns, s, sg, li, c, cap_bits=8), want_w,
                      f"{label}, {clabel}, every larger rank level gated to sorting")
            if label.startswith("Hurricane") and clabel.startswith("tier"):
                timing[f"K15 {clabel}"] = dict(fn=(lambda a=(ns, s, sg, li, c): sl._table_items_cuda(*a)),
                                               plain=(lambda a=(ns, s, sg, nb, li, c): sl._lis_items_table_ref(*a)),
                                               li=li, n=m.numel(), T=got[0].numel(), cap=c)
        if label.startswith("Hurricane"):
            timing["node_passes"] = dict(fn=lambda a=(nm, nb): spk.node_passes(*a),
                                         plain=lambda a=(nm, nb): spk.node_passes_ref(*a),
                                         bytes=8 * li.nn + 4)
            timing["anchors K15"] = dict(fn=lambda a=(ns, li): sl.table_anchors(*a),
                                         plain=lambda a=(ns, li): sl.table_anchors_ref(*a), li=li, ns=ns)
        st = sl.table_static(li)
        rs = ranks[f"{label}, {caps[0][0]}"]
        print(f"[kernels] table walk, {label}: num_bp {int(nb)}, {int((ns < 0x7FFF).sum())} significant sets; "
              f"node_passes, table_anchors (J, R, u, jp, alone, in the walk, with the levels past 16 bits gated "
              f"and with every larger level gated to sorting) and the walk's payload words and "
              f"n_sig at {', '.join(f'{cl} ({li.nn if c is None else c})' for cl, c in caps)} equal to the plain "
              f"versions bit for bit; rank levels' key spans {rs['used_bits']} bits (widest "
              f"{rs['widest_used_bits']}; the plan's widest region {rs['widest_region_bits']} bits; gated "
              f"{rs['gated']}, none overflowed); path ranks {st.path_values} values ({st.pb} bits), static "
              f"tables {st.path_bytes} bytes (8 nn + 4 n = {8 * li.nn + 4 * li.n})")

    # node_passes on the 256^3 cube path's node maxima (headline chunk 0)
    m0, _ = front(vol512[:256, :256, :256])
    nb0, _, _, nm0 = tb._schedule(m0, tb._wave_index((256, 256, 256), dev)[1])
    equal("node_passes", (spk.node_passes(nm0, nb0),), (spk.node_passes_ref(nm0, nb0),),
          f"headline chunk 0 (256^3 cube, {nm0.numel()} nodes)")
    print(f"[kernels] node_passes on headline chunk 0's {nm0.numel()} cube nodes equal to the plain version")
    del m0, nm0

    # -- 2D fields on the 2D walk ----------------------------------------------------
    rng = np.random.default_rng(19)
    f1024 = front(_turbulence_like(1024, 1024, 0), True)
    n57 = 33 * 57
    r57 = (torch.from_numpy((rng.integers(0, 1 << 14, n57) * (rng.random(n57) < 0.4)).astype(np.int32)).to(dev),
           torch.from_numpy(rng.random(n57) < 0.5).to(dev))
    cases2 = [("1024^2 field", (1024, 1024), f1024),
              ("1800x3600 field", (3600, 1800), front(_turbulence_like(1800, 3600, 16), True)),
              ("3600x7200 field", (7200, 3600), front(_turbulence_like(3600, 7200, 17), True)),
              ("33x57 random", (33, 57), r57),
              ("all zero 1024^2", (1024, 1024), (edge(f1024[0], "zero"), f1024[1])),
              ("1024^2 with 2^31 - 1", (1024, 1024), (edge(f1024[0], "big"), f1024[1])),
              ("one pixel 33x57", (33, 57), (edge(r57[0], "one"), r57[1]))]
    for label, (nx, ny), (m, sg) in cases2:
        n = nx * ny
        t0 = time.perf_counter()
        ti, li = spk.tree_index((nx, ny), dev), sl2.lis2_index((nx, ny), dev)
        if label in ("1024^2 field", "1800x3600 field"):
            builds[label] = _static_build(sl, li, time.perf_counter() - t0)
        tree = build_tree2((nx, ny))
        # the I-set passes come with the schedule (phase 3's _sched_kernels holds them)
        nb, s, _, nm, iset = spk.schedule_table(m, ti, iset_regions=tree.iset_regions[: tree.xf + 1])
        ns = spk.node_passes(nm, nb)
        equal("node_passes", (ns,), (spk.node_passes_ref(nm, nb),), label)
        want_anc = sl.table_anchors_ref(ns, li, iset)
        equal("table_anchors", sl.table_anchors(ns, li, iset), want_anc, label)
        equal("table_anchors", sl.table_anchors(ns, li, iset, cap_bits=16), want_anc,
              f"{label}, levels past 16 bits gated")
        equal("table_anchors", sl.table_anchors(ns, li, iset, cap_bits=8), want_anc,
              f"{label}, levels gated to sorting")
        st = sl.table_static(li)
        bits = tuple(12 + w for w in st.plan.wks)
        keep = {}
        with _capture(kernels, ["radix_sort"], clone=True) as rc:
            got = sl._table_items_cuda(ns, s, sg, li, li.nn, iset, nb, keep=keep)
        want = sl2._lis2_items_ref(ns, s, sg, nb, iset, li, li.nn)
        equal("table_walk", got, want, label)
        equal("table_anchors", [keep[k] for k in ("J", "R", "u", "jp")], want_anc, f"{label} (in the walk)")
        ranks[label] = rs = _rank_state(kernels, sl, li, keep)
        _check(not rs["overflowed"] and rs["widest_used_bits"] <= 2**26 and rs["left_zero"],
               f"{label}: rank levels {rs}")
        equal("table_walk", sl._table_items_cuda(ns, s, sg, li, li.nn, iset, nb, cap_bits=8), want,
              f"{label}, every larger rank level gated to sorting")
        nsorts += sorts_equal(rc["radix_sort"], label)
        caps = tb2._wave_caps2(n, 34, li.nn, max(4096, int(1.25 * n)))
        fits = []
        for ev_cap, cap_total, what in ((caps["ev_cap"], caps["cap_total"], "tier 0"),
                                        (700, caps["cap_total"], "event cap 700"),
                                        (caps["ev_cap"], 100, "byte cap 100")):
            a = wp.wave_emit_2d_lis(got[0], got[1], nb, 34, ev_cap, cap_total)
            b = sl._event_tail(want[0], want[1], nb, 34, ev_cap, cap_total)
            _check(int(a[3]) == int(b[3]), f"{label}, {what}: n_sig {int(a[3])} after K9 and K11, {int(b[3])} in "
                                           f"the event form")
            if int(a[1].sum()) <= ev_cap and int(a[2]) <= cap_total:
                equal("table_walk", (a[0], a[1], a[2].to(torch.int32)), b[:3], f"{label}, {what}: the LIS segments")
                fits.append(what)
        if label == "1024^2 field":
            timing["K14 1024^2"] = dict(fn=lambda a=(ns, s, sg, li, li.nn, iset, nb): sl._table_items_cuda(*a),
                                        plain=lambda a=(ns, s, sg, nb, iset, li, li.nn): sl2._lis2_items_ref(*a),
                                        li=li, n=n, T=got[0].numel(), cap=li.nn)
            timing["anchors K14 1024^2"] = dict(fn=lambda a=(ns, li, iset): sl.table_anchors(*a),
                                                plain=lambda a=(ns, li, iset): sl.table_anchors_ref(*a),
                                                li=li, ns=ns, iset=iset)
        if label == "1800x3600 field":
            timing["K14 1800x3600"] = dict(fn=lambda a=(ns, s, sg, li, li.nn, iset, nb): sl._table_items_cuda(*a),
                                           plain=lambda a=(ns, s, sg, nb, iset, li, li.nn): sl2._lis2_items_ref(*a),
                                           li=li, n=n, T=got[0].numel(), cap=li.nn)
        if label == "3600x7200 field":
            timing["anchors K14 3600x7200"] = dict(fn=lambda a=(ns, li, iset): sl.table_anchors(*a),
                                                   plain=lambda a=(ns, li, iset): sl.table_anchors_ref(*a),
                                                   li=li, ns=ns, iset=iset)
        print(f"[kernels] 2D walk, {label}: num_bp {int(nb)}, n_sig {int(got[1])}, rank levels of {bits} static "
              f"key bits, none sorted, their keys spanning {rs['used_bits']} bits (widest "
              f"{rs['widest_used_bits']}; the plan's widest region {rs['widest_region_bits']} bits; gated "
              f"{rs['gated']}, none overflowed); path ranks {st.path_values} values ({st.pb} bits), static tables "
              f"{st.path_bytes} bytes (8 nn + 4 n = {8 * li.nn + 4 * li.n}); node_passes, "
              f"table_anchors (also with the levels past 16 bits gated, and every larger level gated to "
              f"sorting) and the walk's payload words (also gated) equal to the plain versions bit for bit; the LIS "
              f"segments through K9's planes launch and K11 equal to the event form at "
              f"{', '.join(fits) or 'no cap'}, n_sig equal at every cap")
    print(f"[kernels] the table and 2D walks ran {nsorts} radix sorts, each equal to torch.sort(stable=True)")

    # -- times at the main path's shapes ------------------------------------------------
    def table_bytes(li):
        st = sl.table_static(li)
        return sum(t.numel() * t.element_size() for t in st.tables.values())

    rows = {}
    for key, r in timing.items():
        if "bytes" not in r and "T" in r:
            # inputs read once (node_s, s, signs, the index's tables), the payload words and n_sig written
            r["bytes"] = 4 * r["li"].nn + 5 * r["n"] + table_bytes(r["li"]) + 4 * r["T"] + 4
        elif "bytes" not in r:
            # node_s and the anchor tables read once, J and R written
            st = sl.table_static(r["li"])
            tabs = ("parent", "level", "O0") if st.form == 0 else ("parent", "level", "is_group", "k_of", "irank_of")
            r["bytes"] = 4 * r["li"].nn + sum(st.tables[k].numel() * st.tables[k].element_size() for k in tabs) \
                + 8 * r["li"].nn
            # torch.unique on the largest ranked level's keys
            Jr, Rr, u, jp = sl.table_anchors_ref(r["ns"], r["li"], r.get("iset"))
            row = max(st.plan.host.reshape(-1, kernels.RANK_LEVEL_INTS), key=lambda x: int(x[0]))
            ids = torch.cat([torch.arange(int(row[3 + k]), int(row[3 + kernels.RANK_SPANS + k]), device=dev)
                             for k in range(int(row[2]))])
            j = jp[ids]
            lkey = (u[ids].to(torch.int64) << int(row[1])) | torch.where(
                j < 0, -1 - j, Rr[torch.clamp(j, min=0).long()] + 1).to(torch.int64)
            r["library"] = lambda k=lkey: torch.unique(k, sorted=True, return_inverse=True)
            r["library_what"] = f"torch.unique(sorted=True, return_inverse=True) on the {lkey.numel()}-node level's keys"
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r["fn"]()
        torch.cuda.synchronize()
        r["peak_bytes"] = torch.cuda.max_memory_allocated() - base  # the call's own working set
        if "li" in r:  # and the walk's cached buffer at this cap (the anchors alone: cap 1)
            r["buffer_bytes"] = sum(c.buf.numel() for k, (_, c) in sl.table_static(r["li"]).calls.items()
                                    if k[:2] == (r.get("cap", 1), kernels.RANK_CAP_BITS))
        per_call = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
        r["ms"], r["timed"] = time_ms(r["fn"], 10)
        r["host_ms"] = time_ms(r["fn"], 10, "host-issued")[0]
        r["plain_ms"], r["plain_timed"] = time_ms(r["plain"], 3)
        r["library_ms"], lib_how = time_ms(r["library"], 10) if "library" in r else (None, None)
        r["bound_ms"] = _bound_ms(r["bytes"])
        r["launches_per_call"] = per_call
        # a profile of the calls that launch more than one kernel: where the
        # device time goes, and no torch or CUB sort, scan or cummax among them
        # (a single launch's wrapper runs its kernel alone)
        busy, per_name = busy_ms(r["fn"], 5) if sum(per_call.values()) > 1 else (None, {})
        r["busy_ms"] = busy
        bad = _sorts_and_scans(kernels, per_name)
        _check(not bad, f"{key}: the card ran {bad}")
        print(f"[kernels] {key}: {r['ms']:.4f} ms ({r['timed']}), {r['host_ms']:.4f} ms as the host issues it, "
              + (f"device busy {busy:.4f} ms" if busy is not None else "one launch")
              + f"; plain {r['plain_ms']:.4f} ms ({r['plain_timed']})"
              + (f", {r['library_what']} {r['library_ms']:.4f} ms ({lib_how})" if "library" in r else "")
              + f"; bound {r['bound_ms']:.4f} ms ({r['bytes']} bytes), share {r['bound_ms'] / r['ms']:.4f}; "
              f"launches per call {per_call}; peak device memory of one call {r['peak_bytes']} bytes"
              + (f" besides the walk's cached buffer ({r['buffer_bytes']} bytes)" if "li" in r else "")
              + (f"; no torch or CUB sort, scan or cummax; the most device time, ms per call: {_top(per_name, 6)}"
                 if per_name else "") + f" -- {smi}")
        rows[key] = r
    for key in ("K15 tier 0", "K15 tier 1", "K14 1024^2", "K14 1800x3600"):
        lp = rows[key]["launches_per_call"]
        _check(sum(lp.values()) <= 80, f"the walk {key} issued {lp} launches (at most 80)")
        # one int64 key per sort, no gather: a histogram and the digit passes of each
        lay = sl.table_layout(rows[key]["li"], rows[key]["cap"])
        radix = 2 + len(kernels.radix_shifts(lay.ins_bits)) + len(kernels.radix_shifts(lay.walk_bits))
        _check(lp.get("radix_sort", 0) == radix and radix <= (15 if key.startswith("K15") else 16)
               and (key != "K14 1024^2" or radix <= 14),
               f"the walk {key} ran {lp.get('radix_sort', 0)} radix launches ({radix} expected)")
        print(f"[kernels] {key}: {radix} radix launches per call (insertion key {lay.ins_bits} bits, walk key "
              f"{lay.walk_bits} bits, no gather), {lp.get('table_anchors', 0)} anchor and rank launches")
    # the walk's cached buffer (its rank levels' bitmaps and counters left zero
    # for the next call) over 50 calls back to back
    for key in ("K15 tier 1", "K14 1024^2"):
        r = rows[key]
        r["repeats"] = _repeats(kernels, r["fn"], r["plain"](), f"{key} walk", smi)
        for _, call in sl.table_static(r["li"]).calls.values():
            _check(not call.views["ubm"].any().item()
                   and not call.views["rst"].reshape(-1, kernels.RANK_STATE)[:, 5].any().item(),
                   f"{key}: the walk's cached bitmaps or counters are not zero after the repeats")
    keys = ("ms", "timed", "host_ms", "plain_ms", "plain_timed", "bound_ms", "library_ms", "launches_per_call",
            "busy_ms", "peak_bytes", "buffer_bytes", "repeats")
    pick = lambda r: {k: r.get(k) for k in keys}  # noqa: E731
    out = {
        "node_passes": pick(rows["node_passes"]),
        "table_anchors": dict(pick(rows["anchors K15"]), **{"2d": pick(rows["anchors K14 1024^2"]),
                                                             "2d_3600x7200": pick(rows["anchors K14 3600x7200"])},
                              rank_levels={k: {x: v[x] for x in ("widest_used_bits", "widest_region_bits", "gated",
                                                                 "overflowed")} for k, v in ranks.items()}),
        "table_walk": dict(pick(rows["K15 tier 0"]), **{"tier1": pick(rows["K15 tier 1"]),
                                                         "2d": pick(rows["K14 1024^2"]),
                                                         "2d_1800x3600": pick(rows["K14 1800x3600"])}),
    }
    out["table_walk"]["host_builds"] = builds
    for name in names:
        out[name]["max_abs_err"] = err[name]
    print("[kernels] walk indexes on the host, s (the index, ~0 where an earlier phase built it; its "
          "table_static, path_ranks included; path_ranks alone): "
          + "; ".join(f"{k}: {v['index_s']:.3f}, {v['table_static_s']}, {v['path_ranks_s']:.3f}"
                      for k, v in builds.items()))
    print(f"[kernels] table and 2D walk kernels took {time.perf_counter() - t_phase:.1f} s")
    return out


# the kernels of K9 (kernels/emit.cu), as torch.profiler names them
_K9_KERNELS = ("exposed_rows", "emit_stage_planes")
_K9_VIEW = ("exp_idx", "exp_ll", "n_exp", "overflow")


def _tail_launches(fn):
    """The device operations between the set walk's last kernel (a radix
    sort pass or the payload gather) and K11's first (its count) in one
    call of fn, after a warm-up, by torch.profiler (``_device_names``):
    (their names, the walk's last kernel)."""
    names = _device_names(fn, 1, ("pack_count_kernel",))
    _check("pack_count_kernel" in names, "no K11 count kernel in the emission's trace")
    i1 = names.index("pack_count_kernel")
    walk = [i for i in range(i1) if names[i].startswith(("radix_", "gather_kernel"))]
    _check(bool(walk), "no walk kernel before K11 in the emission's trace")
    return names[walk[-1] + 1:i1], names[walk[-1]]


def _k9_bytes(args, out) -> int:
    """The bound bytes of K9 on a cube, the stage's inputs read once and its
    outputs written once: the box-major table, the magnitudes of the kept
    pixels (when they are apart) and the walk's payloads read; the exposure
    view (indices, signed values, n_exp, the flag) and the three classes'
    (P, W) valid and bit planes written.  No pixel field: none leaves the
    stage."""
    pv_bm, _, _, _, N, wexp_cap, pack_mag, pay, P = args
    take_b = max(1, wexp_cap // 8)
    Lv = min(8 * take_b, wexp_cap)
    npad = -(-wexp_cap // 256) * 256
    kept = min(8 * min(int(out[2]) // 8, take_b), Lv)
    W_lis = -(-pay.numel() // 128) * 128 // 16
    return (4 * N**3 + (0 if pack_mag else 4 * kept) + 4 * pay.numel() + 4 * Lv + 4 * wexp_cap + 5
            + 8 * P * (npad // 16 + W_lis + npad // 32))


def _fields_bytes(args) -> int:
    """The bound bytes of K9's planes launch on handed fields (an
    ``emit_fields`` call): each pixel field and payload word read once, the
    three classes' (P, W) valid and bit planes written once."""
    pixels, pay, _, P = args
    items = -(-pixels[0].numel() // 256) * 256
    W_lis = -(-pay.numel() // 128) * 128 // 16
    return (sum(f.numel() * f.element_size() for f in pixels) + pay.numel() * pay.element_size()
            + 8 * P * (items // 16 + W_lis + items // 32))


def _flat(out):
    """The tensors of an emit_cube or emit_fields result, in order."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _flat(x)]


def _repeats(kernels, fn, want, label: str, smi: str, calls: int = 50) -> dict:
    """fn() called ``calls`` times back to back, each call's outputs
    compared on the device with ``want`` (the plain version's, computed
    once) and the unequal elements counted without a host wait; every count
    must be 0, and the look-backs' zeroed buffer zero after the calls.  A
    race in a decoupled look-back shows only now and then, so one equal call
    proves little.  The calls run in a torch.profiler trace: each kernel of
    the repo's least, median and largest device time over its launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    want = _flat(want)
    ours = _our_kernels(kernels)
    bad = torch.zeros(calls, dtype=torch.int64, device=want[0].device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            got = _flat(fn())
            _check(len(got) == len(want), f"{label}: {len(got)} outputs, the plain version {len(want)}")
            bad[i] = sum((a != b).sum() for a, b in zip(got, want))
        torch.cuda.synchronize()
    counts = bad.tolist()
    _check(not any(counts), f"{label}: unequal elements in the repeated calls {counts}")
    left = [int(b.count_nonzero()) for b in getattr(kernels._zeroed_local, "bufs", {}).values()]
    _check(not any(left), f"{label}: the look-backs' zeroed buffer holds {left} nonzero words after the calls")
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and _kernel_name(e.name) in ours - {"Memset"}:
            per.setdefault(_kernel_name(e.name), []).append(e.time_range.elapsed_us() / 1e3)
    spread = {k: {"launches": len(v), "min": min(v), "median": sorted(v)[len(v) // 2], "max": max(v)}
              for k, v in sorted(per.items())}
    print(f"[kernels] {label}: {calls} calls back to back, every output of each equal to the plain "
          f"version's, the zeroed buffer zero after; device ms per launch (least / median / largest, "
          f"launches in the trace) " + ", ".join(
              f"{k} {r['min']:.4f} / {r['median']:.4f} / {r['max']:.4f} ({r['launches']})"
              for k, r in spread.items()) + f" -- {smi}")
    return {"calls": calls, "per_launch": spread}


def _emit_kernels(kernels, smi: str, dev, vol512) -> dict:
    """Phase 3's emission kernels (kernels/emit.cu, K9) bit for bit against
    their plain versions on the card, every output: each call of K9 on a
    cube (``emit_cube``: the exposure and the three classes' planes, two
    launches) and on the forms that hand their fields (``emit_fields``: one
    launch; the other 3D forms, and each half of the 2D program's emission)
    that the emissions make on
    headline chunk 0 at tiers 0 and 1, at the widest tier (P = 34, two
    windows, every pixel) and at P = 34 with the compaction (magnitudes
    apart from the box-major table), with the exposure forced to overflow;
    on an all-zero, a one-pixel, a 2^31 - 1 and an all-2^31 - 1 256^3
    chunk; on 16^3 and 2^3 cubes (every pixel) and a 16^3 cube with a cap
    below one box; on a Hurricane packet chunk (100, 256, 256: the table
    walk's K12 compaction) and on a 1024^2 field (K14: two launches, the
    pixel half with no payload, then the LIS half with no pixel field).  At
    tiers 0 and 1 the stage is timed on the device and as the host issues
    it, per launch, beside its plain version and its bound, and the
    launches between the walk's return and K11 are counted in a
    torch.profiler trace (K9's two only); the 1024^2 field's two launches
    likewise, each beside its bound (``_fields_bytes``).  The tier-1 stage
    is repeated 50 times against the plain version (``_repeats``).  Returns
    the kernel's row of the result line."""
    import numpy as np
    import torch

    from sperr_tpu_torch.ops import cdf97, wave_pack
    from sperr_tpu_torch.ops import speck_virtual as sv
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.parallel import batched2d as tb2
    from sperr_tpu_torch.runtime.device_bench import time_ms

    t_phase = time.perf_counter()
    rng = np.random.default_rng(16)
    err = {"emit_stage": 0}

    def same(name, got, want, what):
        got, want = _flat(got), _flat(want)
        _check(len(got) == len(want), f"{name} gave {len(got)} tensors, its plain version {len(want)} ({what})")
        for k, (a, b) in enumerate(zip(got, want)):
            ok = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            err[name] = max(err[name], _int_err(a, b) if a.shape == b.shape else 2**31)
            field = _K9_VIEW[k] if k < 4 and name == "emit_stage" and len(got) == 10 else f"output {k}"
            _check(ok, f"{name} {field} differs from its plain version on {what}")

    def held(calls, what):
        for args in calls.get("emit_cube", []):
            same("emit_stage", wave_pack.emit_cube(*args), wave_pack.emit_cube_ref(*args), f"{what} (cube)")
        for args in calls.get("emit_fields", []):
            same("emit_stage", wave_pack.emit_fields(*args), wave_pack.emit_fields_ref(*args),
                 f"{what} (fields, {args[0][0].numel()} items)")

    def front3(field):
        x = torch.from_numpy(np.ascontiguousarray(field)[None]).to(dev)
        f = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", cdf97.dwt3d, cdf97.idwt3d_,
                                  out_cap=max(1024, x.numel() // 1024))
        return f["mags"][0].reshape(-1).contiguous(), f["signs"][0].reshape(-1).contiguous()

    d256 = (256, 256, 256)
    n = 256**3
    mags0, signs0 = front3(vol512[:256, :256, :256])
    li = sv.virtual_lis_index(d256, dev)
    tiers = tb.wave_tiers_for(n)
    caps = {f"tier {t}": tb._wave_caps(li, d256, tiers[t], 34) for t in (0, 1)}
    caps["widest"] = tb._wave_caps(li, d256, tiers[-1], 34)
    caps["P 34, compacted"] = tb._wave_caps(li, d256, (1.0, 1.0, 1.0, 34, 0.25), 34)
    caps["overflow"] = dict(caps["tier 0"], wexp_cap=8192)
    one = torch.zeros_like(mags0)
    one[n // 3] = 5
    big = mags0.clone()
    big[n // 2] = 2**31 - 1
    t01 = ("tier 0", "tier 1")
    cases = [("headline chunk 0", mags0, signs0, li, None, caps, list(caps)),
             ("all zero 256^3", torch.zeros_like(mags0), torch.zeros_like(signs0), li, None, caps, t01),
             ("one pixel 256^3", one, signs0, li, None, caps, t01),
             ("256^3 with 2^31 - 1", big, signs0, li, None, caps, t01),
             ("256^3 all 2^31 - 1", torch.full_like(mags0, 2**31 - 1), signs0, li, None, caps, ("tier 1",))]
    for N in (16, 2):
        m = rng.integers(0, 1 << 20, N**3) * (rng.random(N**3) < 0.4)
        liN = sv.virtual_lis_index((N, N, N), dev)
        tN = tb.wave_tiers_for(N**3)
        capsN = {f"tier {t}": tb._wave_caps(liN, (N, N, N), tN[t], 34) for t in (0, 1)}
        use = t01
        if N == 16:
            capsN["cap below one box"] = dict(capsN["tier 0"], wexp_cap=5)
            use = t01 + ("cap below one box",)
        cases.append((f"{N}^3", torch.from_numpy(m.astype(np.int32)).to(dev),
                      torch.from_numpy(rng.random(N**3) < 0.5).to(dev), liN, None, capsN, use))
    s3 = (256, 256, 100)
    mh, sh = front3(vol512[:100, :256, :256])
    li_h, si_h = tb._wave_index(s3, dev)
    th = tb.wave_tiers_for(256 * 256 * 100)
    cases.append(("Hurricane packet chunk (100, 256, 256)", mh, sh, li_h, si_h,
                  {f"tier {t}": tb._wave_caps(li_h, s3, th[t], 34) for t in (0, 1)}, t01))
    stats = {}
    names = ["emit_cube", "emit_fields"]
    for label, mags, signs, li_c, si_c, caps_c, use in cases:
        seen = []
        for cl in use:
            c = caps_c[cl]
            with _capture(wave_pack, names) as calls:
                em, fits = tb._wave_emit_chunk(mags, signs, li_c, c, si_c)
            compact = bool(c["wexp_cap"]) and c["wexp_cap"] < mags.numel()
            cube = int(compact and isinstance(li_c, sv.VirtualLisIndex))
            got = {k: len(v) for k, v in calls.items()}
            _check(got == {"emit_cube": cube, "emit_fields": 1 - cube},
                   f"{label}, {cl}: the emission made the calls {got}")
            held(calls, f"{label}, {cl}")
            seen.append(f"{cl} (P {c['P']}, wexp_cap {c['wexp_cap']}: "
                        + (f"cube, n_exp {int(em.n_exp)}, " if cube else "fields, ")
                        + f"overflow {bool(em.overflow)}, fits {bool(fits)})")
            if label == "headline chunk 0" and cl in t01:
                stats[cl] = (calls["emit_cube"][0], lambda m=mags, s=signs, c=c: tb._wave_emit_chunk(m, s, li, c))
            if label == "headline chunk 0" and cl == "overflow":
                _check(bool(em.overflow) and int(em.n_exp) > 8192, "the forced exposure did not overflow")
        print(f"[kernels] K9, {label}: every call equal to its plain version bit for bit, every output, at "
              f"{'; '.join(seen)}")
    # K14's classes: a 1024^2 field's program (two planes launches)
    ny = nx = 1024
    x2 = torch.from_numpy(_turbulence_like(ny, nx, 0)[None]).to(dev)
    f2 = tb._dense_encode_rows(x2, "pwe", 1e-2, "dual", cdf97.dwt2d, cdf97.idwt2d, out_cap=nx * ny)
    comp2 = tb2.TorchCompressor2D((nx, ny), device=dev, entropy="wave")
    index2 = tb2._wave_index2((nx, ny), dev)
    caps2 = tb2._wave_caps2(nx * ny, comp2.num_bp_cap, index2[1].nn,
                            max(4096, int(comp2.wave_event_tiers[0] * nx * ny)))
    with _capture(wave_pack, names) as calls2:
        tb2._wave_emit_field(f2["mags"][0], f2["signs"][0], index2, caps2, comp2.num_bp_cap)
    # the pixel half (no payload), then the LIS half of the walk's items (no pixel field)
    halves = [(a[0][0].numel(), a[1].numel()) for a in calls2["emit_fields"]]
    _check(not calls2["emit_cube"] and len(halves) == 2 and halves[0][0] == nx * ny and halves[0][1] == 0
           and halves[1][0] == 0 and halves[1][1] > 0,
           f"the 2D field's program made the planes launches (pixels, payloads) {halves}")
    held(calls2, "a 1024^2 field (K14)")
    print(f"[kernels] K9, a 1024^2 field's emission (K14): two planes launches, (pixels, payloads) {halves}, "
          "each equal to its plain version bit for bit, every output")
    del cases, one, big, mh, sh, x2, f2

    # timed at tiers 0 and 1: the stage, its launches, the launches between
    # the walk's return and K11
    out = {}
    for cl, (a9, emit) in stats.items():
        got = wave_pack.emit_cube(*a9)
        nbytes = _k9_bytes(a9, got)
        plain, how = time_ms(lambda: wave_pack.emit_cube_ref(*a9), 3)
        fn = lambda: wave_pack.emit_cube(*a9)
        row = dict(ms=time_ms(fn, 20, "device")[0], host_ms=time_ms(fn, 20, "host-issued")[0],
                   plain_ms=plain, plain_timed=how, bound_ms=_bound_ms(nbytes), bytes=nbytes,
                   per_launch={_kernel_name(k): m for k, (m, _) in _kernel_means(fn, "", 10).items()})
        names_t, last = _tail_launches(emit)
        _check(len(names_t) == 2 and all(nm in _K9_KERNELS for nm in names_t),
               f"{cl}: the device ran {names_t} between the walk ({last}) and K11, not K9's two kernels")
        row["launches"] = len(names_t)
        print(f"[kernels] K9 at headline chunk 0 {cl}: the device ran {len(names_t)} launches between the "
              f"walk's last kernel ({last}) and K11: {', '.join(names_t)}")
        print(f"[kernels] K9 {cl} (P {a9[8]}, wexp_cap {a9[5]}, n_exp {int(got[2])}, {a9[7].numel()} payload "
              f"words): {row['ms']:.4f} ms ({row['host_ms']:.4f} as the host issues it), per launch "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["per_launch"].items())
              + f"; plain {row['plain_ms']:.4f} ms ({how}), bound {row['bound_ms']:.4f} ms ({nbytes} bytes, "
              f"share {row['bound_ms'] / row['ms']:.3f}) -- {smi}")
        out[cl] = row
        if cl == "tier 1":
            row["repeats"] = _repeats(kernels, lambda: wave_pack.emit_cube(*a9), wave_pack.emit_cube_ref(*a9),
                                      "K9 at headline chunk 0 tier 1", smi)
        del got
    # the 1024^2 field's two planes launches, each alone and both as the program issues them
    k2d = {}
    for half, a in zip(("pixels", "lis"), calls2["emit_fields"]):
        plain, how = time_ms(lambda a=a: wave_pack.emit_fields_ref(*a), 3)
        nbytes = _fields_bytes(a)
        k2d[half] = dict(ms=time_ms(lambda a=a: wave_pack.emit_fields(*a), 20, "device")[0],
                         host_ms=time_ms(lambda a=a: wave_pack.emit_fields(*a), 20, "host-issued")[0],
                         plain_ms=plain, plain_timed=how, bound_ms=_bound_ms(nbytes), bytes=nbytes,
                         P=a[3], items=a[0][0].numel(), payloads=a[1].numel())

    def both():
        return [wave_pack.emit_fields(*a) for a in calls2["emit_fields"]]

    k2d.update(ms=time_ms(both, 20, "device")[0], host_ms=time_ms(both, 20, "host-issued")[0],
               bound_ms=k2d["pixels"]["bound_ms"] + k2d["lis"]["bound_ms"], launches=2)
    print("[kernels] K9 on a 1024^2 field, per launch: " + ", ".join(
        f"{k} (P {r['P']}, {r['items']} pixels, {r['payloads']} payloads) {r['ms']:.4f} ms ({r['host_ms']:.4f} "
        f"host-issued, plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, {r['bytes']} bytes, share "
        f"{r['bound_ms'] / r['ms']:.3f})" for k, r in k2d.items() if isinstance(r, dict))
        + f"; both launches {k2d['ms']:.4f} ms ({k2d['host_ms']:.4f} host-issued), bound {k2d['bound_ms']:.4f}, "
        f"share {k2d['bound_ms'] / k2d['ms']:.3f} -- {smi}")
    print(f"[kernels] emission kernels took {time.perf_counter() - t_phase:.1f} s")
    t1 = out["tier 1"]
    return {
        "emit_stage": dict({k: t1[k] for k in ("ms", "host_ms", "plain_ms", "plain_timed", "bound_ms",
                                               "per_launch")},
                           max_abs_err=err["emit_stage"],
                           tier0={k: out["tier 0"][k] for k in ("ms", "host_ms", "plain_ms", "bound_ms", "per_launch")},
                           k9_stage={c: {f: out[c][f] for f in ("ms", "host_ms", "bound_ms", "launches")}
                                     for c in out},
                           repeats={"tier 1": t1["repeats"]},
                           **{"2d_field": {k: ({f: r[f] for f in ("ms", "host_ms", "plain_ms", "bound_ms", "P",
                                                                   "items", "payloads")}
                                               if isinstance(r, dict) else r) for k, r in k2d.items()}}),
    }


def main() -> int:
    if "--rank" in sys.argv[1:]:
        return _rank_main(sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from sperr_tpu_torch import kernels
    from sperr_tpu_torch.codec.speck_flt import SpeckFloatCodec
    from sperr_tpu_torch.ops import cdf97, packemit, quantize, speck_virtual, wave_pack, wave_unpack
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.parallel.batched import TorchCompressor3D, TorchDecompressor3D
    from sperr_tpu_torch.parallel.batched2d import TorchCompressor2D, TorchDecompressor2D
    from sperr_tpu_torch.parallel.chunked3d import Sperr3DDecompressor
    from sperr_tpu_torch.runtime import device_bench
    from sperr_tpu_torch.runtime.device_bench import busy_ms, host_waits, time_ms
    from sperr_tpu_torch.runtime.engine import default_engine
    from sperr_tpu_torch.stream import tools
    from sperr_tpu_torch.utils.dims import coarsened_resolutions, num_of_xforms
    from sperr_tpu_torch.utils.testdata import smooth_field_3d

    # -- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = _smi()
    print(f"[device] {kind}, compute capability {cap[0]}.{cap[1]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    dev = torch.device("cuda", 0)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    # ptxas -v: each kernel's name, then its registers, shared memory, spills
    for line in kernels.build_log.splitlines():
        if any(w in line for w in ("Compiling entry function", "registers", "spill")):
            print(f"[build] {line.strip()}")

    # -- 3. kernels against their plain versions ---------------------------
    # each kernel is timed on the device alone ("device": the sleep must
    # cover its calls); its plain version as the repo's timer finds it can be
    plain_timed = {}
    rng = np.random.default_rng(0)
    n = 256**3
    coeffs = np.empty((9, n), dtype=np.float32)
    coeffs[:8] = rng.normal(scale=50.0, size=(8, n))
    q = (np.abs(rng.normal(scale=0.5, size=9)) + 0.01).astype(np.float32)
    # one more row, at q = 0.5: c = k + 0.25 lands on the tie 2k + 0.5
    coeffs[8] = rng.integers(-4000, 4000, size=n).astype(np.float32) + np.float32(0.25)
    coeffs[8, :4] = [0.0, -0.0, -0.25, 0.25]
    q[8] = 0.5
    c_d = torch.from_numpy(coeffs).to(dev)
    inv_d = torch.ones(9, device=dev) / torch.from_numpy(q).to(dev)
    got = kernels.quantize(c_d, inv_d)
    ref = quantize.quantize_ref(c_d, inv_d)
    torch.cuda.synchronize()
    for name, a, b in zip(("mags", "signs", "maxmag"), got, ref):
        _check(torch.equal(a, b), f"K1 {name} differ from the plain version")
    q_err = int((got[0].to(torch.int64) - ref[0].to(torch.int64)).abs().max())
    print("[kernels] K1 quantize (8, 256^3) plus a row of ties: mags, signs, maxmag equal")
    one = c_d[:1].contiguous()
    inv1 = inv_d[:1].contiguous()
    q_ms = time_ms(lambda: kernels.quantize(one, inv1), 20, "device")[0]
    q_host_ms = time_ms(lambda: kernels.quantize(one, inv1), 20, "host-issued")[0]
    q_plain_ms, plain_timed["quantize"] = time_ms(lambda: quantize.quantize_ref(one, inv1), 20)
    print(f"[kernels] K1 at (1, 256^3): kernel {q_ms:.4f} ms ({q_host_ms:.4f} as the host issues "
          f"it), plain {q_plain_ms:.4f} ms ({plain_timed['quantize']})")
    q_bound = _bound_ms(4 * n + 4 + 4 * n + n + 4)  # coeffs, q in; mags, signs, maxmag out
    del c_d, got, ref

    lift_err = 0.0
    # 256^3: both designs of the kernel; odd lengths; a batch; x lines of 400
    # samples (eight pairs per lane)
    # and a wavelet-packet chunk of SDRBench Hurricane ISABEL (256 x 244 x 100)
    for shape in ((1, 256, 256, 256), (1, 19, 27, 33), (1, 12, 32, 32), (1, 31, 29, 30),
                  (3, 64, 64, 64), (1, 16, 16, 400), (1, 100, 256, 244)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        bound = 2e-5 * float(x.abs().max())
        fwd, fwd_ref = cdf97.dwt3d(x), cdf97.dwt3d_ref(x)
        inv, inv_ref = cdf97.idwt3d(fwd), cdf97.idwt3d_ref(fwd)
        torch.cuda.synchronize()
        d_fwd = float((fwd - fwd_ref).abs().max())
        d_inv = float((inv - inv_ref).abs().max())
        d_rt = float((inv - x).abs().max())
        print(f"[kernels] lifting {shape[1:]}: max|dwt3d - plain| {d_fwd:.3e}, "
              f"max|idwt3d - plain| {d_inv:.3e} (both must be 0), max|round trip - x| "
              f"{d_rt:.3e}, bound {bound:.3e}")
        _check(max(d_fwd, d_inv, d_rt) <= bound, f"lifting kernel off its plain version at {shape}")
        _check(torch.equal(fwd, fwd_ref) and torch.equal(inv, inv_ref),
               f"dwt3d/idwt3d differ from their plain versions at {shape}")
        lift_err = max(lift_err, d_fwd, d_inv)
        if shape[1] == 256:
            kernels.reset_launch_counts()
            cdf97.dwt3d(x)
            per_dwt = kernels.launches["cdf97_lift"]
            l_ms = time_ms(lambda: cdf97.dwt3d(x), 10, "device")[0]
            l_plain_ms, plain_timed["cdf97_lift"] = time_ms(lambda: cdf97.dwt3d_ref(x), 3)
            li_ms = time_ms(lambda: cdf97.idwt3d(fwd), 10, "device")[0]
            li_plain_ms, li_plain_how = time_ms(lambda: cdf97.idwt3d_ref(fwd), 3)
            l_host_ms = time_ms(lambda: cdf97.dwt3d(x), 10, "host-issued")[0]
            li_host_ms = time_ms(lambda: cdf97.idwt3d(fwd), 10, "host-issued")[0]
            l_bound = _bound_ms(2 * 4 * x.numel())
            print(f"[kernels] dwt3d 256^3 ({per_dwt} launches): kernel {l_ms:.4f} ms ({l_host_ms:.4f} "
                  f"as the host issues it), plain {l_plain_ms:.4f} ms ({plain_timed['cdf97_lift']}); idwt3d: "
                  f"kernel {li_ms:.4f} ms ({li_host_ms:.4f}), plain {li_plain_ms:.4f} ms ({li_plain_how}); bound of the whole transform "
                  f"{l_bound:.4f} ms -- {smi}")
            _lift_per_launch(kernels, cdf97, x, num_of_xforms(256), smi)
        del x, fwd, fwd_ref, inv, inv_ref
    # the 1D and 2D drivers, with lines too long for a 32-line tile in shared
    # memory: the kernel on the card against the plain version on the CPU
    for fn, shape in ((cdf97.dwt2d, (2, 1000, 40)), (cdf97.idwt2d, (2, 1000, 40)),
                      (cdf97.dwt1d, (3, 5000)), (cdf97.idwt1d, (3, 5000))):
        xh = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        d = float((fn(xh.to(dev)).cpu() - fn(xh)).abs().max())
        print(f"[kernels] {fn.__name__} {shape}: max|card - CPU plain| {d:.3e}")
        _check(d <= 2e-5 * float(xh.abs().max()), f"{fn.__name__} off its plain version at {shape}")

    # K2/K3: bit for bit against the plain version and the per-axis lifting
    # kernel's path; the level-by-level and a partial inverse against the full one
    plane_ms, plane_timed = {}, {}
    plane_err = {"K2": 0.0, "K3": 0.0}
    for shape in ((16, 1024, 1024), (1, 1800, 3600), (3, 127, 127), (2, 19, 27)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        x_in = x.clone()
        levels = num_of_xforms(min(shape[1:]))
        lo = levels // 2
        fwd = cdf97.dwt2d(x)
        fwd_in = fwd.clone()
        inv = cdf97.idwt2d(fwd)
        plans = {name: kernels.last_plan[name] for name in ("dwt2d_full", "idwt2d_full")}
        steps = fwd.clone()
        for lev in range(levels, 0, -1):
            cdf97.idwt2d_(steps, lev, lev - 1)
        part = cdf97.idwt2d(fwd, levels, lo)  # undo levels .. lo+1 only
        part_ref = fwd.clone()
        cdf97._idwt2d_levels(part_ref, levels, lo, cdf97.lift_axis_ref)
        part_in_place = fwd.clone()
        cdf97.idwt2d_(part_in_place, levels, lo)
        fwd_in_place = x.clone()
        cdf97.dwt2d_(fwd_in_place)
        torch.cuda.synchronize()
        for what, a, b in (
            ("K2 = dwt2d_ref", fwd, cdf97.dwt2d_ref(x)),
            ("K2 = lift driver", fwd, cdf97.dwt2d_ref(x, lift=cdf97.lift_axis)),
            ("K2 in place = K2", fwd_in_place, fwd),
            ("K2 leaves its input alone", x, x_in),
            ("K3 = idwt2d_ref", inv, cdf97.idwt2d_ref(fwd)),
            ("K3 = lift driver", inv, cdf97.idwt2d_ref(fwd, lift=cdf97.lift_axis)),
            ("K3 leaves its input alone", fwd, fwd_in),
            ("K3 level by level = K3", steps, inv),
            (f"K3 partial (levels {levels} .. {lo + 1}) = plain", part, part_ref),
            ("K3 partial in place = K3 partial", part_in_place, part),
            ("K3 partial, then the rest = K3", cdf97.idwt2d(part, lo), inv),
        ):
            plane_err[what[:2]] = max(plane_err[what[:2]], float((a - b).abs().max()))
            _check(torch.equal(a, b), f"{what} fails at {shape}")
        d_rt = float((inv - x).abs().max())
        print(f"[kernels] K2/K3 {shape}: equal to dwt2d_ref/idwt2d_ref and to the per-axis lift bit "
              f"for bit, in place = out of place, inputs untouched, level by level and partial "
              f"(to level {lo}) then the rest = full; max|round trip - x| {d_rt:.3e}")
        for name, plan in plans.items():
            print(f"[kernels]   {name} plan: (level, corner, blocks, shared bytes) "
                  + ", ".join(f"({r.level}, {r.ly}x{r.lx}, {r.grid}, {r.shared_bytes})"
                              for r in plan.launches)
                  + f"; scratch {4 * plan.scratch_floats} bytes")
        _check(d_rt <= 2e-5 * float(x.abs().max()), f"K2/K3 round trip at {shape}")
        if shape[1] >= 1024:
            t = plane_ms[shape] = {
                "K2": time_ms(lambda: cdf97.dwt2d(x), 20, "device")[0],
                "K2 host": time_ms(lambda: cdf97.dwt2d(x), 20, "host-issued")[0],
                "K3": time_ms(lambda: cdf97.idwt2d(fwd), 20, "device")[0],
                "K3 host": time_ms(lambda: cdf97.idwt2d(fwd), 20, "host-issued")[0],
            }
            # the plain versions and the lift driver, each timed as the
            # repo's timer finds it can be
            t_how = plane_timed[shape] = {}
            t["K2 plain"], t_how["K2 plain"] = time_ms(lambda: cdf97.dwt2d_ref(x), 3)
            t["K2 lift driver"], t_how["K2 lift driver"] = time_ms(
                lambda: cdf97.dwt2d_ref(x, lift=cdf97.lift_axis), 20)
            t["K3 plain"], t_how["K3 plain"] = time_ms(lambda: cdf97.idwt2d_ref(fwd), 3)
            t["K3 lift driver"], t_how["K3 lift driver"] = time_ms(
                lambda: cdf97.idwt2d_ref(fwd, lift=cdf97.lift_axis), 20)
            t["bound"] = _bound_ms(2 * 4 * x.numel())
            print(f"[kernels] {shape} ms: " + ", ".join(
                f"{k} {v:.4f}" + (f" ({t_how[k]})" if k in t_how else "") for k, v in t.items())
                  + f" -- {smi}")
            for name, kname, fn in (("K2", "dwt2d_level", lambda: cdf97.dwt2d(x)),
                                    ("K3", "idwt2d_level", lambda: cdf97.idwt2d(fwd))):
                runs = plans["idwt2d_full" if name == "K3" else "dwt2d_full"].launches
                per = _launch_ms(fn, kname, len(runs), 10)
                bounds = [_bound_ms(2 * 4 * shape[0] * r.ly * r.lx) for r in runs]
                # levels after the first are programmatic dependent launches:
                # each becomes resident while the previous level runs and
                # waits for it, so its span in the trace includes that wait
                print(f"[kernels] {name} {shape} per launch (level: device ms / bound ms; after "
                      f"the first, spans include the wait for the previous level): "
                      + ("not measured (the trace does not hold one event per launch)" if per is None
                         else ", ".join(f"{r.level} {m:.4f}/{b:.4f}" for r, m, b in zip(runs, per, bounds))
                         + f"; sum {sum(per):.4f}")
                      + f" -- {smi}")
        del x, x_in, fwd, fwd_in, inv, steps, part, part_ref, part_in_place, fwd_in_place
    k23 = plane_ms[(16, 1024, 1024)]
    plain_timed.update({"dwt2d_full": plane_timed[(16, 1024, 1024)]["K2 plain"],
                        "idwt2d_full": plane_timed[(16, 1024, 1024)]["K3 plain"]})

    # K10-K12: the inputs the wave path gives them (K10: the masks K9's
    # planes launch builds in registers, as its plain version builds
    # them).  The headline volume's first 256^3 chunk (smooth_field_3d(512,
    # seed=7), PWE 1e-2) at tiers 0 and 1, the two tiers its chunks run on
    # the main path; the outlier compaction of its front (K12); and the
    # widest tier of smooth_field_3d(256, seed=11), the largest emission of
    # this run
    dims256 = (256, 256, 256)
    li = speck_virtual.virtual_lis_index(dims256, dev)
    tiers = tb.wave_tiers_for(256**3)
    t0 = time.perf_counter()
    vol512 = smooth_field_3d(512, seed=7)
    vol11 = smooth_field_3d(256, seed=11)
    print(f"[kernels] smooth_field_3d(512, seed=7) and (256, seed=11) made in {time.perf_counter() - t0:.2f} s")
    bits = {}
    emit_ms = {}
    for label, field, tier in (("tier 0", vol512, 0), ("tier 1", vol512, 1),
                               ("widest", vol11, len(tiers) - 1)):
        chunk = torch.from_numpy(np.ascontiguousarray(field[:256, :256, :256])[None]).to(dev)
        with _capture(packemit, ["compact_flags_rows"]) as cap_front:
            front = tb._dense_encode_rows(chunk, "pwe", 1e-2, "dual", cdf97.dwt3d, cdf97.idwt3d_,
                                          out_cap=max(1024, 256**3 // 1024))
        caps = tb._wave_caps(li, dims256, tiers[tier], 34)
        with _capture(packemit, ["masked_pack", "compact_flags_rows"]) as calls, \
                _capture(wave_pack, ["emit_cube", "emit_fields"]) as k9:
            em, fits = tb._wave_emit_chunk(front["mags"][0], front["signs"][0], li, caps)
        # K10 on the masks of every window of each class, as the plain
        # versions build them (K9 transposes them in registers on the main
        # path): the classes' planes arguments, the cube's pixels from the
        # plain exposure
        planes_args = [a for f in k9["emit_fields"] for a in wave_pack.stage_plane_args(*f)]
        for a in k9["emit_cube"]:
            pixels = wave_pack.emit_exposed_ref(*a[:7])[4:]
            planes_args += wave_pack.stage_plane_args(pixels, a[7], a[3], a[8])
        calls.update(_k10_calls(wave_pack, planes_args))
        print(f"[kernels] wave inputs, {label}: caps {caps}, fits {bool(fits)}")
        if label == "widest":
            _check(bool(fits), "the widest tier does not hold the smooth 256^3 chunk")
        if label == "tier 0":
            calls["compact_flags_rows"] += cap_front["compact_flags_rows"]
        bits[label] = _bits_case(kernels, packemit, calls, smi, label)
        if label != "widest":
            # the whole emission stage of one chunk (schedule, walk, K9,
            # K11), as the main path runs it at this tier
            def emit():
                return tb._wave_emit_chunk(front["mags"][0], front["signs"][0], li, caps)
            host_ms = time_ms(emit, 3, "host-issued")[0]
            syncs = host_waits(emit)
            busy, per_name = busy_ms(emit, 3)
            emit_ms[label] = (busy, host_ms)
            print(f"[kernels] {label} _wave_emit_chunk: device busy "
                  f"{busy:.4f} ms (kernels and copies), "
                  f"{host_ms:.4f} ms as the host issues it, {syncs} host waits for the device per "
                  f"call; the most device time, ms per call: {_top(per_name, 8)} -- {smi}")
        del chunk, front, em, fits, calls, cap_front, k9, planes_args
    bit_err = {k: max(b[k]["max_abs_err"] for b in bits.values() if k in b)
               for k in ("transpose_bits32", "masked_pack", "compact_flags_rows")}
    k16 = _psnr_kernel(kernels, smi, dev, vol512, vol11)
    # K12 on ragged shapes: rows that are not whole tiles, several rows, a
    # short take, empty and full rows, and a view that is not 16-byte aligned
    flag_rng = np.random.default_rng(12)
    for shape, density, take in (((3, 100_003), 0.3, 1000), ((3, 100_003), 0.3, 60_000),
                                 ((2, 17), 0.5, 40), ((4, 40_000), 0.0, 10),
                                 ((1, 50_000), 1.0, 50_000), ((1, 5_000_001), 0.01, 60_000)):
        wide = (shape[0], shape[1] + 1)
        flags = torch.from_numpy(flag_rng.random(wide) < density).to(dev)[:, 1:]
        for f in (flags.contiguous(), flags.contiguous()[:, 3:]):
            a = kernels.compact_flags_rows(f.contiguous(), take)
            b = packemit.compact_flags_rows_ref(f, take)
            _check(all(torch.equal(x, y) for x, y in zip(a, b)),
                   f"K12 differs from its plain version at {tuple(f.shape)}, take {take}")
    print("[kernels] K12 on ragged rows, several rows, short takes, empty and full rows: "
          "equal to the plain version bit for bit")
    _k11_synthetic(packemit, dev)

    # K13, the hybrid decode's device half: the control parse of the headline
    # volume's first 256^3 chunk (its SPECK stream as the C++ engine writes
    # it from the dense front's magnitudes), that stream cut to half its
    # length, an all-zero chunk, and the first stream past a small cap
    engine = default_engine()
    chunk = torch.from_numpy(np.ascontiguousarray(vol512[:256, :256, :256])[None]).to(dev)
    d0 = tb._dense_encode(chunk, "pwe", 1e-2, "dual")
    width0 = tb._width_for(int(d0["maxmag"][0]))
    s0 = engine.encode(3, d0["mags"][0].cpu().numpy(), d0["signs"][0].cpu().numpy(), dims256, width0, 0)
    # K12 at the sparse transfer's shape: the same chunk's nonzero flags,
    # take n/2 (the sparse program's cap at sparse_cap_frac 0.5)
    nzf = (d0["mags"] != 0).contiguous()
    take_sp = n // 2
    got, ref = kernels.compact_flags_rows(nzf, take_sp), packemit.compact_flags_rows_ref(nzf, take_sp)
    k12s_err = max(_int_err(a, b) for a, b in zip(got, ref))
    _check(all(torch.equal(a, b) for a, b in zip(got, ref)),
           "K12 differs from its plain version at the sparse transfer's shape")
    k12s = {
        "shape": f"(1, {n}) take {take_sp}, {int(got[1][0])} nonzeros",
        "ms": time_ms(lambda: kernels.compact_flags_rows(nzf, take_sp), 20, "device")[0],
        "host_ms": time_ms(lambda: kernels.compact_flags_rows(nzf, take_sp), 20, "host-issued")[0],
        # flags read, indices and count written
        "bound_ms": _bound_ms(n + 4 * take_sp + 4),
        # torch.nonzero synchronizes: timed as the host issues it
        "library_ms": time_ms(lambda: torch.nonzero(nzf[0]), 20, "host-issued")[0],
        "max_abs_err": k12s_err,
    }
    k12s["plain_ms"], k12s["plain_timed"] = time_ms(
        lambda: packemit.compact_flags_rows_ref(nzf, take_sp), 5)
    print(f"[kernels] K12 at the sparse transfer's shape, headline chunk 0's nonzero flags "
          f"{k12s['shape']}: equal to the plain version bit for bit; kernel {k12s['ms']:.4f} ms "
          f"({k12s['host_ms']:.4f} as the host issues it), plain {k12s['plain_ms']:.4f} ms "
          f"({k12s['plain_timed']}), bound {k12s['bound_ms']:.4f} ms (share "
          f"{k12s['bound_ms'] / k12s['ms']:.3f}), torch.nonzero {k12s['library_ms']:.4f} ms (host-issued) "
          f"-- {smi}")
    del chunk, d0, nzf, got, ref
    s_half = s0[: len(s0) // 2]
    s_zero = engine.encode(3, np.zeros(n, np.uint32), np.ones(n, bool), dims256, 8, 0)
    full = torch.stack([torch.from_numpy(engine.decode(3, s, dims256, width0)[0].astype(np.int32))
                        for s in (s0, s_half)] + [torch.zeros(n, dtype=torch.int32)])
    evw = tb._evw_cap(n)
    args3, _, p3 = device_bench._control_inputs(engine, [s0, s_half, s_zero], dims256, dev)
    k13_err = _k13_check(wave_unpack, args3, p3, evw, "headline chunk 0, cut to half, all zero",
                         want=full, overflow=False)
    args1, _, p1 = device_bench._control_inputs(engine, [s0], dims256, dev)
    k13_err = max(k13_err, _k13_check(wave_unpack, args1, p1, evw, "headline chunk 0", want=full[:1],
                                      overflow=False))
    _k13_check(wave_unpack, args1, p1, 1000, "headline chunk 0, evw_cap 1000", want=full[:1],
               overflow=True)
    k13_one = {
        "ms": time_ms(lambda: wave_unpack.reconstruct_mags_batched(*args1, p1, evw), 20, "device")[0],
        "host_ms": time_ms(lambda: wave_unpack.reconstruct_mags_batched(*args1, p1, evw), 20, "host-issued")[0],
        "bound_ms": _k13_bound_ms(args1),
    }
    k13_one["plain_ms"], k13_one["plain_timed"] = time_ms(
        lambda: wave_unpack.reconstruct_mags_batched_ref(*args1, p1, evw), 3)
    per_k13 = _kernel_means(lambda: wave_unpack.reconstruct_mags_batched(*args1, p1, evw), "k13_", 10)
    print(f"[kernels] K13 (1, 256^3), headline chunk 0 ({len(s0)} stream bytes, num_bp "
          f"{int(args1[4][0])}): kernel {k13_one['ms']:.4f} ms ({k13_one['host_ms']:.4f} as the host "
          f"issues it), plain {k13_one['plain_ms']:.4f} ms ({k13_one['plain_timed']}), bound "
          f"{k13_one['bound_ms']:.4f} ms (share "
          f"{k13_one['bound_ms'] / k13_one['ms']:.3f}); per launch (device ms, launches in a trace of "
          f"10 calls): " + (", ".join(f"{k} {m:.4f} ({c})" for k, (m, c) in sorted(per_k13.items()))
                             or "not measured") + f" -- {smi}")
    del args3, args1, full
    sched = _sched_kernels(kernels, smi, dev, vol512, vol11)
    walk = _walk_kernels(kernels, smi, dev, vol512)
    emit = _emit_kernels(kernels, smi, dev, vol512)
    twalk = _table_walk_kernels(kernels, smi, dev, vol512, vol11)
    k23_bound = k23["bound"]
    for name, ms, host_ms, bound in (
            ("K1 quantize (1, 256^3)", q_ms, q_host_ms, q_bound),
            ("K16 psnr_q (1, 256^3), PSNR 80", k16["ms"], k16["host_ms"], k16["bound_ms"]),
            ("K4 dwt3d 256^3", l_ms, l_host_ms, l_bound), ("K4 idwt3d 256^3", li_ms, li_host_ms, l_bound),
            ("K13 reconstruct_mags (1, 256^3)", k13_one["ms"], k13_one["host_ms"], k13_one["bound_ms"]),
            *((f"{k} {shape}", t[k], t[f"{k} host"], t["bound"])
              for shape, t in plane_ms.items() for k in ("K2", "K3")),
            *((name, r["ms"], r["host_ms"], r["bound_ms"]) for name, r in sched.items()),
            *((name, r["ms"], r["host_ms"], r["bound_ms"]) for name, r in walk.items()),
            *((f"K9 {tier} (both launches)", r["ms"], r["host_ms"], r["bound_ms"])
              for tier, r in emit["emit_stage"]["k9_stage"].items()),
            *((name, r["ms"], r["host_ms"], r["bound_ms"]) for name, r in twalk.items())):
        print(f"[kernels] {name}: {ms:.4f} ms ({host_ms:.4f} as the host issues it), bound "
              f"{bound:.4f} ms, share {bound / ms:.3f} -- {smi}")
    if "--kernels-only" in sys.argv[1:]:
        print("[kernels] --kernels-only: phases 4-11 skipped, no result line")
        return 0

    # -- 4. the 3D path: 512^3, 8 chunks of 256^3, PWE 1e-2 ----------------
    print(f"[main] host engine: {type(engine).__name__}")
    _check(type(engine).__name__ == "NativeEngine", "the C++ host engine did not load")
    vol = vol512
    tol = 1e-2
    comp = TorchCompressor3D((512, 512, 512), (256, 256, 256), device="cuda", transfer="dense")
    dec = TorchDecompressor3D(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    stream = comp.compress(vol, "pwe", tol)  # warm-up
    dec.decompress(stream)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stream2 = comp.compress(vol, "pwe", tol)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    with _capture(wave_unpack, ["reconstruct_mags_batched"]) as k13_calls:
        t0 = time.perf_counter()
        out, dims = dec.decompress(stream2)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] launches during the timed 3D encode and decode: {launches}")
    for name in ("quantize", "cdf97_lift", "reconstruct_mags"):
        _check(launches[name] > 0, f"kernel {name} was not launched on the 3D path")
    _check(dec.last_hybrid_chunks > 0, "no chunk took the hybrid decode")
    print(f"[main] hybrid decode: {dec.last_hybrid_chunks} of 8 chunks rebuilt on the card (K13), "
          f"parsed in full on the host: {dec.last_full_parse_chunks or 'none'} (reasons: num_bp = 0 "
          f"or > 32 bitplanes, evw_cap = more active refinement words than {tb._evw_cap(256**3)})")
    _check(stream2 == stream, "two compressions of one volume differ")
    _check(dims == (512, 512, 512), f"decoded dims {dims}")
    _check(comp.last_uncertified_chunks == 0, f"uncertified chunks {comp.last_uncertified_ids}")
    _check(out.shape == vol.shape and np.isfinite(out).all(), "port decode shape or finiteness")
    err_port = float(np.abs(out.astype(np.float64) - vol).max())
    t0 = time.perf_counter()
    host, _ = Sperr3DDecompressor().decompress(stream2)
    host_s = time.perf_counter() - t0
    err_host = float(np.abs(host.reshape(vol.shape) - vol).max())
    bpp = 8.0 * len(stream2) / vol.size
    print(f"[main] container {len(stream2)} bytes, {bpp:.5f} bpp; max|err| port decoder "
          f"{err_port:.6e}, host f64 decoder {err_host:.6e} (bound {tol}); "
          f"uncertified chunks {comp.last_uncertified_chunks} -- {smi}")
    print(f"[main] encode {enc_s:.3f} s, decode {dec_s:.3f} s (after one warm-up), "
          f"host f64 decode {host_s:.3f} s, peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB) -- {smi}")
    _check(err_port <= tol, f"port decoder misses the PWE bound: {err_port}")
    _check(err_host <= tol, f"host f64 decoder misses the PWE bound: {err_host}")
    # the full host parse, after its own warm-up: the same volume, element
    # for element; then both routes again, alternating
    dec_full = TorchDecompressor3D(device="cuda", hybrid=False)
    dec_full.decompress(stream2)
    torch.cuda.synchronize()
    walls = {"hybrid": [dec_s], "full": []}
    for route, d in (("full", dec_full), ("hybrid", dec), ("full", dec_full), ("hybrid", dec)):
        t0 = time.perf_counter()
        o, _ = d.decompress(stream2)
        torch.cuda.synchronize()
        walls[route].append(time.perf_counter() - t0)
        _check(np.array_equal(o, out), f"the {route} decode differs from the first hybrid decode")
    out_full = o
    _check(dec_full.last_hybrid_chunks == 0, "hybrid=False rebuilt chunks on the card")
    print(f"[main] 512^3 decode walls, s (after one warm-up each; in the order run: hybrid, "
          f"full, hybrid, full, hybrid): hybrid {', '.join(f'{t:.4f}' for t in walls['hybrid'])}; "
          f"full host parse {', '.join(f'{t:.4f}' for t in walls['full'])}; the outputs equal "
          f"element for element; host to device {dec.last_h2d_bytes} bytes hybrid, "
          f"{dec_full.last_h2d_bytes} bytes full parse -- {smi}")
    # where each route's time goes: one more decode each, the device
    # synchronized after each stage
    for route, d in (("hybrid", dec), ("full", dec_full)):
        with _stage_times(tb._HostParse, ("parse_all", "reconstruct")) as st:
            t0 = time.perf_counter()
            d.decompress(stream2)
            wall = time.perf_counter() - t0
        print(f"[main] 512^3 {route} decode stages, s: host parse on the pool {st['parse_all']:.4f}, "
              f"uploads, magnitudes (K13 on the hybrid route) and reconstruction on the card "
              f"{st['reconstruct']:.4f}, the rest (copy to the host, outliers, assembly) "
              f"{wall - st['parse_all'] - st['reconstruct']:.4f}; wall {wall:.4f} -- {smi}")
    # K13 on the decode's own input: the 8 chunks' control parses
    (k13_main,) = k13_calls["reconstruct_mags_batched"]
    *k13_args, k13_p, k13_evw = k13_main
    k13_err = max(k13_err, _k13_check(wave_unpack, k13_args, k13_p, k13_evw, "the 512^3 decode's input"))
    k13 = {
        "ms": time_ms(lambda: wave_unpack.reconstruct_mags_batched(*k13_args, k13_p, k13_evw), 10, "device")[0],
        "host_ms": time_ms(lambda: wave_unpack.reconstruct_mags_batched(*k13_args, k13_p, k13_evw), 10,
                           "host-issued")[0],
        "bound_ms": _k13_bound_ms(k13_args),
    }
    k13["plain_ms"], plain_timed["reconstruct_mags"] = time_ms(
        lambda: wave_unpack.reconstruct_mags_batched_ref(*k13_args, k13_p, k13_evw), 2)
    k13["per_launch"] = {_kernel_name(k): m for k, (m, _) in _kernel_means(
        lambda: wave_unpack.reconstruct_mags_batched(*k13_args, k13_p, k13_evw), "k13_", 10).items()}
    # no chunk of the decode overflows: the plain version defines every output
    k13_want = wave_unpack.reconstruct_mags_batched_ref(*k13_args, k13_p, k13_evw)
    _check(not bool(k13_want[1].any()), "a chunk of the 512^3 decode's K13 input overflows")
    k13["repeats"] = _repeats(kernels, lambda: wave_unpack.reconstruct_mags_batched(*k13_args, k13_p, k13_evw),
                              k13_want, "K13 on the decode's input", smi)
    del k13_want
    print(f"[main] K13 on the decode's input {tuple(k13_args[0].shape)}: kernel {k13['ms']:.4f} ms "
          f"({k13['host_ms']:.4f} as the host issues it), plain {k13['plain_ms']:.4f} ms "
          f"({plain_timed['reconstruct_mags']}), bound "
          f"{k13['bound_ms']:.4f} ms (share {k13['bound_ms'] / k13['ms']:.3f}); per launch (device ms) "
          + ", ".join(f"{k} {m:.4f}" for k, m in sorted(k13["per_launch"].items())) + f" -- {smi}")
    d2h_host = comp.last_d2h_bytes
    vol512 = vol
    # phase 11 runs the command-line tools on this volume, container and decode
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    vol_path = os.path.join(tmp.name, "vol512.f32")
    vol.tofile(vol_path)
    stream4, out4 = stream2, out
    del out, host, out_full, k13_calls, k13_main, k13_args

    # -- 5. PSNR and rate modes, one 256^3 chunk ---------------------------
    vol = vol11
    vrange = float(vol.max() - vol.min())
    one_chunk = TorchCompressor3D((256, 256, 256), (256, 256, 256), device="cuda", transfer="dense")
    streams5, launches5 = {}, {}
    for mode, quality in (("psnr", 80.0), ("rate", 2.0)):
        kernels.reset_launch_counts()
        s = streams5[mode] = one_chunk.compress(vol, mode, quality)
        torch.cuda.synchronize()
        launches5[mode] = dict(kernels.launches)
        _check(launches5[mode]["quantize"] > 0, f"K1 was not launched in the {mode} encode")
        _check((launches5[mode]["psnr_q"] > 0) == (mode == "psnr") and launches5[mode]["psnr_q"] % 2 == 0,
               f"K16 launched {launches5[mode]['psnr_q']} times in the {mode} encode (two a round)")
        print(f"[modes] {mode} {quality}: launches {_nonzero(launches5[mode])}; stream sha256 "
              f"{hashlib.sha256(s).hexdigest()}")
        ours, _ = dec.decompress(s)
        host, _ = Sperr3DDecompressor().decompress(s)
        host = host.reshape(vol.shape)
        agree = float(np.abs(ours.astype(np.float64) - host).max())
        mse = float(np.mean((host - vol) ** 2))
        psnr = 10 * np.log10(vrange * vrange / mse)
        print(f"[modes] {mode} {quality}: {len(s)} bytes, PSNR {psnr:.3f} dB, "
              f"max|port - host f64| {agree:.3e} (bound {1e-4 * vrange:.3e})")
        _check(agree <= 1e-4 * vrange, f"{mode}: port and host decodes disagree")
        if mode == "rate":
            h = tools.parse_header(s)
            body = int(quality * vol.size) // 8
            _check(h.chunk_offsets[1] == 17 + 9 + body,
                   f"rate chunk is {h.chunk_offsets[1]} bytes, budget {17 + 9 + body}")
        else:
            _check(psnr >= quality - 0.5, f"PSNR {psnr} far below its target {quality}")


    # -- 6. the device entropy path (entropy="wave") ------------------------
    wave = TorchCompressor3D((512, 512, 512), (256, 256, 256), device="cuda", entropy="wave",
                             transfer="dense")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wave.compress(vol512, "pwe", tol)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stream_w = wave.compress(vol512, "pwe", tol)
    torch.cuda.synchronize()
    encw_s = time.perf_counter() - t0
    launches_w = dict(kernels.launches)
    peak_w = torch.cuda.max_memory_allocated()
    print(f"[wave] launches during the 512^3 wave encode: {launches_w}")
    for name in ("quantize", "cdf97_lift", "emit_stage", "masked_pack",
                 "compact_flags_rows", "sched_boxmax", "sched_virtual", "walk_vtab", "anchor_ranks",
                 "walk_rows", "radix_sort", "node_passes"):
        _check(launches_w[name] > 0, f"kernel {name} was not launched on the wave path")
    for name in ("table_anchors", "table_walk", "sched_table"):
        _check(launches_w[name] == 0, f"{name} was launched on the cube form's wave path")
    # each emission of a cube chunk: K9's two launches, K11's three; K10
    # only inside K9
    _check(3 * launches_w["emit_stage"] == 2 * launches_w["masked_pack"],
           f"K9 launched {launches_w['emit_stage']} times for {launches_w['masked_pack'] // 3} emissions, "
           f"not twice for each")
    _check(launches_w["transpose_bits32"] == 0, "K10 was launched on the wave path")
    _check(launches_w["sched_boxmax"] == launches_w["sched_virtual"],
           "the cube schedule's two launches do not pair up")
    _check(launches_w["masked_pack"] % 3 == 0, "K11 did not launch three kernels per call")
    _check(launches_w["radix_sort"] <= 400,
           f"{launches_w['radix_sort']} radix sort launches in one 512^3 wave encode (at most 400)")
    _check(stream_w == stream2, "the wave container differs from the host-entropy container")
    _check(len(stream_w) == 1012155, f"the 512^3 wave container is {len(stream_w)} bytes, not 1,012,155")
    _check(wave.last_wave_chunks == 8, f"{wave.last_wave_chunks} of 8 chunks on the device path")
    _check(wave.last_uncertified_chunks == 0, f"uncertified chunks {wave.last_uncertified_ids}")
    print(f"[wave] 512^3 PWE {tol}: container equal to phase 4's byte for byte "
          f"({len(stream_w)} bytes), {wave.last_wave_chunks} chunks on the device path at "
          f"tiers {wave.last_wave_tiers}")
    d2h_wave = wave.last_d2h_bytes
    print(f"[wave] encode {encw_s:.3f} s wave, {enc_s:.3f} s host (phase 4), after one warm-up; "
          f"device to host {wave.last_d2h_bytes} bytes wave, {d2h_host} bytes host; peak device "
          f"memory {peak_w} bytes ({peak_w / 2**30:.3f} GiB) wave, {peak} host -- {smi}")
    chunk512 = _chunk512(kernels, smi, vol512)
    # phase 9's volume: SDRBench Hurricane ISABEL's shape, 100 x 500 x 500
    hurricane = np.ascontiguousarray(vol512[:100, :500, :500])
    del vol512, vol
    one_w = TorchCompressor3D((256, 256, 256), (256, 256, 256), device="cuda", entropy="wave",
                              transfer="dense")
    for mode, quality in (("psnr", 80.0), ("rate", 2.0)):
        s = one_w.compress(vol11, mode, quality)
        tiers_used = ["host" if t is None else t for t in one_w.last_wave_tiers]
        print(f"[wave] 256^3 {mode} {quality}: stream equal to phase 5's: {s == streams5[mode]}, "
              f"tier {tiers_used}, device to host {one_w.last_d2h_bytes} bytes")
        _check(s == streams5[mode], f"{mode}: wave and host-entropy streams differ")
    noisy = np.random.default_rng(3).normal(size=(256, 256, 256)).astype(np.float32)
    t0 = time.perf_counter()
    s_host = one_chunk.compress(noisy, "pwe", tol)
    noisy_host_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s_wave = one_w.compress(noisy, "pwe", tol)
    noisy_wave_s = time.perf_counter() - t0
    tiers_used = ["host" if t is None else t for t in one_w.last_wave_tiers]
    print(f"[wave] noisy 256^3 PWE {tol}: {len(s_wave)} bytes, equal to host entropy: "
          f"{s_wave == s_host}, tier {tiers_used}, encode {noisy_wave_s:.3f} s wave, "
          f"{noisy_host_s:.3f} s host, peak device memory {torch.cuda.max_memory_allocated()} bytes")
    _check(s_wave == s_host, "noisy chunk: wave and host-entropy streams differ")
    # phase 9's dyadic chunk, (97, 128, 118)
    pyr_chunk = np.ascontiguousarray(vol11[:118, :128, :97])
    del noisy, vol11

    # -- 7. the 2D path: 16 x 1024^2, PWE 1e-2 -----------------------------
    nx2 = ny2 = 1024
    t0 = time.perf_counter()
    fields = np.stack([_turbulence_like(ny2, nx2, seed) for seed in range(16)])
    print(f"[2d] 16 Turbulence1024-like fields made in {time.perf_counter() - t0:.2f} s")
    comp2 = TorchCompressor2D((nx2, ny2), device="cuda")
    dec2 = TorchDecompressor2D((nx2, ny2), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    streams = comp2.compress_batch(fields, "pwe", tol)  # warm-up
    dec2.decompress_batch(streams)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    streams2 = comp2.compress_batch(fields, "pwe", tol)
    torch.cuda.synchronize()
    enc2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs2 = dec2.decompress_batch(streams2)
    torch.cuda.synchronize()
    dec2_s = time.perf_counter() - t0
    launches2 = dict(kernels.launches)
    peak2 = torch.cuda.max_memory_allocated()
    print(f"[2d] launches during the timed 2D encode and decode: {launches2}")
    for name in ("dwt2d_full", "idwt2d_full", "quantize"):
        _check(launches2[name] > 0, f"kernel {name} was not launched on the 2D path")
    _check(launches2["cdf97_lift"] == 0, "the 2D path launched the per-axis lifting kernel")
    _check(streams2 == streams, "two compressions of one batch differ")
    _check(comp2.last_uncertified_chunks == 0,
           f"{comp2.last_uncertified_chunks} uncertified fields")
    _check(comp2.compress(fields[0], "pwe", tol) == streams2[0],
           "field 0 compressed alone differs from its stream in the batch")
    host2 = SpeckFloatCodec(2, (nx2, ny2, 1))
    err2_port = err2_host = 0.0
    for f, out, s in zip(fields, outs2, streams2):
        _check(out.shape == (ny2, nx2) and np.isfinite(out).all(), "2D decode shape or finiteness")
        err2_port = max(err2_port, float(np.abs(out.astype(np.float64) - f).max()))
        h, _ = host2.decompress(bytes(s))
        err2_host = max(err2_host, float(np.abs(h.reshape(ny2, nx2) - f).max()))
    nbytes2 = sum(len(s) for s in streams2)
    gb2 = fields.nbytes / 1e9
    print(f"[2d] {nbytes2} bytes, {8.0 * nbytes2 / fields.size:.5f} bpp; max|err| port decoder "
          f"{err2_port:.6e}, host f64 decoder {err2_host:.6e} (bound {tol}); uncertified "
          f"fields {comp2.last_uncertified_chunks} -- {smi}")
    print(f"[2d] encode {enc2_s:.3f} s ({gb2 / enc2_s:.4f} GB/s), decode {dec2_s:.3f} s "
          f"({gb2 / dec2_s:.4f} GB/s) after one warm-up, peak device memory {peak2} bytes "
          f"({peak2 / 2**30:.3f} GiB) -- {smi}")
    _check(err2_port <= tol, f"2D port decoder misses the PWE bound: {err2_port}")
    _check(err2_host <= tol, f"2D host f64 decoder misses the PWE bound: {err2_host}")
    outs7 = outs2  # phase 10 takes the fields and streams, phase 12 these decodes
    del outs2

    # -- 8. 1800x3600 modes and multi-resolution decodes --------------------
    nx7, ny7 = 3600, 1800
    f7 = _turbulence_like(ny7, nx7, 16)
    r7 = float(f7.max() - f7.min())
    comp7 = TorchCompressor2D((nx7, ny7), device="cuda")
    dec7 = TorchDecompressor2D((nx7, ny7), device="cuda")
    host7 = SpeckFloatCodec(2, (nx7, ny7, 1))
    streams8, launches8 = {}, {}
    for mode, quality in (("psnr", 80.0), ("rate", 2.0)):
        kernels.reset_launch_counts()
        s = streams8[mode] = comp7.compress(f7, mode, quality)
        torch.cuda.synchronize()
        launches8[mode] = dict(kernels.launches)
        _check((launches8[mode]["psnr_q"] > 0) == (mode == "psnr") and launches8[mode]["psnr_q"] % 2 == 0,
               f"K16 launched {launches8[mode]['psnr_q']} times in the 2D {mode} encode (two a round)")
        print(f"[2d modes] {mode} {quality}: launches {_nonzero(launches8[mode])}; stream sha256 "
              f"{hashlib.sha256(bytes(s)).hexdigest()}")
        ours = dec7.decompress(s)
        h, _ = host7.decompress(bytes(s))
        h = h.reshape(ny7, nx7)
        agree = float(np.abs(ours.astype(np.float64) - h).max())
        psnr = 10 * np.log10(r7 * r7 / float(np.mean((h - f7) ** 2)))
        print(f"[2d modes] {ny7}x{nx7} {mode} {quality}: {len(s)} bytes, PSNR {psnr:.3f} dB, "
              f"max|port - host f64| {agree:.3e} (bound {1e-4 * r7:.3e})")
        _check(agree <= 1e-4 * r7, f"2D {mode}: port and host decodes disagree")
        if mode == "rate":
            _check(len(s) == 17 + 9 + int(quality * f7.size) // 8,
                   f"2D rate stream is {len(s)} bytes")
            continue
        _check(psnr >= quality - 0.5, f"2D PSNR {psnr} far below its target {quality}")
        full = dec7.decompress(s, multi_res=True)
        h_full, h_hier = host7.decompress(bytes(s), multi_res=True)
        res = coarsened_resolutions((nx7, ny7, 1))
        _check(np.array_equal(full, ours), "2D multi-res full output differs from the plain decode")
        _check(len(dec7.hierarchy[0]) == len(h_hier) == len(res) > 0, "2D hierarchy length")
        d_hier = 0.0
        for a, b, r in zip(dec7.hierarchy[0], h_hier, res):
            _check(a.shape == (r[1], r[0]), f"2D hierarchy shape {a.shape}, expected {(r[1], r[0])}")
            d_hier = max(d_hier, float(np.abs(a - b.reshape(a.shape)).max()))
        print(f"[multires] 2D {ny7}x{nx7}: {len(res)} levels {[a.shape for a in dec7.hierarchy[0]]}, "
              f"max|port - host f64| {d_hier:.3e} (bound {1e-4 * r7:.3e})")
        _check(d_hier <= 1e-4 * r7, "2D hierarchy disagrees with the host f64 decoder")
    s5 = streams5["psnr"]
    ours3, _ = dec.decompress(s5, multi_res=True)
    host3 = Sperr3DDecompressor()
    h3, _ = host3.decompress(s5, multi_res=True)
    _check(len(dec.hierarchy) == len(host3.hierarchy) > 0, "3D hierarchy length")
    d3 = float(np.abs(ours3.astype(np.float64) - h3.reshape(ours3.shape)).max())
    for a, b in zip(dec.hierarchy, host3.hierarchy):
        _check(a.shape == b.shape, f"3D hierarchy shapes {a.shape} and {b.shape}")
        d3 = max(d3, float(np.abs(a.astype(np.float64) - b).max()))
    _check(dec.last_hybrid_chunks + sum(dec.last_full_parse_chunks.values()) == 1
           and "hybrid off" not in dec.last_full_parse_chunks, "the 3D multi-res decode's route")
    print(f"[multires] 3D 256^3 (hybrid decode: {dec.last_hybrid_chunks} chunk rebuilt on the card, "
          f"parsed in full: {dec.last_full_parse_chunks or 'none'}): "
          f"{len(dec.hierarchy)} levels {[a.shape for a in dec.hierarchy]}, "
          f"max|port - host f64| {d3:.3e} (bound {1e-4 * vrange:.3e})")
    _check(d3 <= 1e-4 * vrange, "3D multi-res decode disagrees with the host f64 decoder")

    # -- 9. chunks that are not power-of-two cubes on the wave path ----------
    launches_tab = _table_phase(kernels, smi, dev, hurricane, pyr_chunk)

    # -- 10. the 2D device entropy path --------------------------------------
    launches_2d = _wave2d_phase(kernels, smi, dev, fields, streams2, f7, streams8)
    launches_tab["sched_table_2d"] = launches_2d["sched_table"]
    _check(launches_w["node_passes"] > 0, "node_passes was not launched on the cube form's wave path")

    # -- 11. the command-line tools and the stage timer ----------------------
    _cli_phase(kernels, smi, tmp.name, vol_path, stream4, out4, fields[0], streams2[0], f7,
               streams8["psnr"], l_ms, q_ms)

    # -- 12. more than one device ---------------------------------------------
    _multi_phase(kernels, smi, tmp.name, vol_path, stream4, out4, fields, streams2, outs7,
                 launches_w["quantize"],
                 {"host": enc_s, "wave": encw_s, "decode": dec_s, "enc2": enc2_s, "dec2": dec2_s})
    del fields, streams2, f7, outs7

    # -- 13. the sparse transfer ------------------------------------------------
    launches_sp = _sparse_phase(kernels, smi, vol_path, stream4, out4, {"host": comp, "wave": wave},
                                {"host": d2h_host, "wave": d2h_wave})
    tmp.cleanup()
    del out4

    _check("jax" not in sys.modules, "the port imported jax")
    t1 = bits["tier 1"]
    rows = [
        ("quantize", "quantize.cu", "sperr_tpu/ops/pallas_kernels.py:244", launches["quantize"],
         q_err, q_ms, q_host_ms, q_plain_ms, q_bound, None),
        ("psnr_q", "quantize.cu", "sperr_tpu/ops/quantize_jax.py:19", launches5["psnr"]["psnr_q"],
         k16["max_abs_err"], k16["ms"], k16["host_ms"], k16["plain_ms"], k16["bound_ms"], None),
        ("cdf97_lift", "cdf97_lift.cu", "sperr_tpu/ops/cdf97_jax.py:230", launches["cdf97_lift"],
         lift_err, l_ms, l_host_ms, l_plain_ms, l_bound, None),
        ("dwt2d_full", "cdf97_2d.cu", "sperr_tpu/ops/pallas_kernels.py:217", launches2["dwt2d_full"],
         plane_err["K2"], k23["K2"], k23["K2 host"], k23["K2 plain"], k23_bound, None),
        ("idwt2d_full", "cdf97_2d.cu", "sperr_tpu/ops/pallas_kernels.py:231", launches2["idwt2d_full"],
         plane_err["K3"], k23["K3"], k23["K3 host"], k23["K3 plain"], k23_bound, None),
        ("reconstruct_mags", "unpack.cu", "sperr_tpu/ops/wave_unpack.py:82", launches["reconstruct_mags"],
         k13_err, k13["ms"], k13["host_ms"], k13["plain_ms"], k13["bound_ms"], None),
    ] + [
        (name, "bits.cu", where, launches_w[name], bit_err[name], t1[name]["ms"], t1[name]["host_ms"],
         t1[name]["plain_ms"], t1[name]["bound_ms"], t1[name]["library_ms"])
        for name, where in (("transpose_bits32", "sperr_tpu/ops/packemit.py:102"),
                            ("masked_pack", "sperr_tpu/ops/packemit.py:420"),
                            ("compact_flags_rows", "sperr_tpu/ops/packemit.py:305"))
    ]
    plain_timed.update({name: t1[name]["plain_timed"]
                        for name in ("transpose_bits32", "masked_pack", "compact_flags_rows")})
    plain_timed["psnr_q"] = k16["plain_timed"]
    # K16 on the 3D PSNR path (phase 5's chunk) and the 2D one (phase 8's field); its checks' inputs
    k16_extra = {"launches_2d": launches8["psnr"]["psnr_q"], "cases": k16["cases"],
                 "per_launch": k16["per_launch"], "lean_bound_ms": k16["lean_bound_ms"],
                 "timed": "ms: the kernel's device time a call by torch.profiler (the call waits for its status)"}
    # the schedule kernels: launches on their paths (phase 6 for the cube form, phase 9 for the
    # child-table and pyramid forms; phase 10's 2D encode in "launches_2d")
    for name, where, nl in (
            ("sched_boxmax", "sperr_tpu/ops/speck_jax.py:86", launches_w["sched_boxmax"]),
            ("sched_virtual", "sperr_tpu/ops/speck_virtual.py:657", launches_w["sched_virtual"]),
            ("sched_table", "sperr_tpu/ops/speck_jax.py:111", launches_tab["sched_table"]),
            ("sched_pyramid", "sperr_tpu/ops/speck_jax.py:638", launches_tab["sched_pyramid"])):
        r = sched[name]
        rows.append((name, "schedule.cu", where, nl, r["max_abs_err"], r["ms"], r["host_ms"], r["plain_ms"],
                     r["bound_ms"], None))
        plain_timed[name] = r["plain_timed"]
    sched["sched_table"]["launches_2d"] = launches_tab["sched_table_2d"]
    # since the I-set passes are its pixel pass's, sched_table also replaces
    # the 2D iset_significance_device
    sched["sched_table"]["also_replaces"] = ["sperr_tpu/ops/speck_jax.py:98",
                                             "sperr_tpu/ops/speck_lis2_jax.py:134"]
    # the walk kernels: launches in phase 6's timed wave encode; the radix
    # sort's also in phase 9 (the table walk) and phase 10 (the 2D walk)
    for name in ("walk_vtab", "anchor_ranks", "walk_rows", "radix_sort"):
        r = walk[name]
        rows.append((name, "walk.cu", {"walk_vtab": "sperr_tpu/ops/speck_virtual.py:310",
                                       "anchor_ranks": "sperr_tpu/ops/speck_virtual.py:457",
                                       "walk_rows": "sperr_tpu/ops/speck_lis_jax.py:175",
                                       "radix_sort": "sperr_tpu/ops/speck_lis_jax.py:175"}[name],
                     launches_w[name], r["max_abs_err"], r["ms"], r["host_ms"], r["plain_ms"], r["bound_ms"],
                     r["library_ms"]))
        plain_timed[name] = r["plain_timed"]
    walk["radix_sort"]["launches_table"] = launches_tab["radix_sort"]
    walk["radix_sort"]["launches_2d"] = launches_2d["radix_sort"]
    # K9: emit_stage's launches in phase 6's timed wave encode (also phase
    # 9's in "launches_table" and phase 10's 2D encode in "launches_2d"),
    # its times the stage at tier 1 (tier 0 in "tier0", a 1024^2 field's two
    # launches in "2d_field")
    r = emit["emit_stage"]
    rows.append(("emit_stage", "emit.cu", "sperr_tpu/ops/wave_pack.py:102", launches_w["emit_stage"],
                 r["max_abs_err"], r["ms"], r["host_ms"], r["plain_ms"], r["bound_ms"], None))
    plain_timed["emit_stage"] = r["plain_timed"]
    r.update(launches_table=launches_tab["emit_stage"], launches_2d=launches_2d["emit_stage"],
             also_replaces=["sperr_tpu/ops/wave_pack.py:339"],
             chunk512={k: chunk512[k] for k in ("bytes", "wall_s", "peak", "tiers")})
    r["repeats"].update({f"512^3 chunk, {k}": v for k, v in chunk512["repeats"].items()})
    # the table and 2D walks' kernels: launches in phase 9's timed wave encode
    # (node_passes also runs on the cube form's path, phase 6), and in phase 10's
    # first timed 2D encode in "launches_2d"
    for name, where in (("node_passes", "sperr_tpu/parallel/batched.py:490"),
                        ("table_anchors", "sperr_tpu/ops/speck_lis_jax.py:375"),
                        ("table_walk", "sperr_tpu/ops/speck_lis_jax.py:375")):
        r = twalk[name]
        nl = launches_tab[name]
        rows.append((name, "walk_table.cu", where, nl, r["max_abs_err"], r["ms"], r["host_ms"], r["plain_ms"],
                     r["bound_ms"], r["library_ms"]))
        plain_timed[name] = r["plain_timed"]
        r["launches_2d"] = launches_2d[name]
        r["launches_cube_path"] = launches_w["node_passes"] if name == "node_passes" else 0
    # K12 at the sparse transfer's shape, with its launches on that path (phase 13, host entropy)
    sparse_k12 = dict(k12s, launches=launches_sp["compact_flags_rows"])
    # "ms" is the device's time alone, "host_ms" as the host issues the
    # calls; "plain_timed" says how "plain_ms" was timed
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"sperr_tpu_torch/kernels/{src}",
         "replaces": where, "launches": nl, "max_abs_err": err, "ms": ms, "host_ms": host_ms,
         "plain_ms": plain, "plain_timed": plain_timed[name], "bound_ms": bound, "bound_by": "bytes",
         "library_ms": lib, **({"sparse": sparse_k12} if name == "compact_flags_rows" else {}),
         **({"per_launch": k13["per_launch"], "one_chunk": k13_one, "repeats": k13["repeats"]}
            if name == "reconstruct_mags" else {}),
         **({k: v for k, v in sched[name].items() if k in ("fused", "2d", "edge", "launches_2d", "also_replaces",
                                                            "launches_per_call", "cuts", "blocks", "per_launch",
                                                            "s3d_244", "uneven_65x17x17", "bytes", "index_s")}
            if name in sched
            else {}),
         **({k: v for k, v in walk[name].items() if k in ("tier1", "launches_per_call", "launches_table",
                                                           "launches_2d", "lsd_floor_ms")} if name in walk else {}),
         **({k: v for k, v in emit[name].items() if k in ("tier0", "per_launch", "launches_table", "launches_2d",
                                                           "also_replaces", "k9_stage", "chunk512", "repeats",
                                                           "2d_field")}
            if name in emit else {}),
         **({k: v for k, v in twalk[name].items() if k in ("tier1", "2d", "2d_1800x3600", "2d_3600x7200", "1800x3600", "timed",
                                                            "busy_ms", "launches_per_call", "launches_2d",
                                                            "launches_cube_path")}
            if name in twalk else {}),
         # K10's transpose runs inside K9 on the wave paths
         **({"merged_into": "emit_stage"} if name == "transpose_bits32" else {}),
         **(k16_extra if name == "psnr_q" else {})}
        for name, src, where, nl, err, ms, host_ms, plain, bound, lib in rows
    ]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
