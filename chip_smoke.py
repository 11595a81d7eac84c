#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sperr_tpu_torch) once on an NVIDIA H100 and check it.

Run from the root of a checkout, with one GPU visible:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:
  1. device: name, compute capability, nvidia-smi's name and power limit;
  2. build: compile and load both CUDA kernels from the sources in the checkout;
  3. each kernel against its plain PyTorch version on the card (K1 quantize
     bit for bit; the CDF 9/7 lifting kernel through dwt3d/idwt3d);
  4. the main path: a 512^3 f32 field, 8 chunks of 256^3, PWE 1e-2, through
     TorchCompressor3D and TorchDecompressor3D, checked against the host f64
     decoder, with the kernels' launch counters read around the run;
  5. PSNR 80 and rate 2.0 bpp on one 256^3 chunk.
The line before the last is a JSON object with each kernel's launches, error
and time; the last line is {"ok": true, "device": {...}}.  Without a CUDA
device, or without the repository beside it, the script prints no result and
exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor
    from sperr_tpu.runtime.engine import default_engine
    from sperr_tpu.stream import tools
    from sperr_tpu.utils.testdata import smooth_field_3d
    from sperr_tpu_torch import kernels
    from sperr_tpu_torch.ops import cdf97, quantize
    from sperr_tpu_torch.parallel.batched import TorchCompressor3D, TorchDecompressor3D

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
    print(f"[build] both kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # -- 3. kernels against their plain versions ---------------------------
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
    q_ms = _time_ms(lambda: kernels.quantize(one, inv1), 20)
    q_plain_ms = _time_ms(lambda: quantize.quantize_ref(one, inv1), 20)
    print(f"[kernels] K1 at (1, 256^3): kernel {q_ms:.4f} ms, plain {q_plain_ms:.4f} ms")
    del c_d, got, ref

    lift_err = 0.0
    for shape in ((1, 256, 256, 256), (1, 19, 27, 33), (1, 12, 32, 32)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        bound = 2e-5 * float(x.abs().max())
        fwd, fwd_ref = cdf97.dwt3d(x), cdf97.dwt3d_ref(x)
        inv, inv_ref = cdf97.idwt3d(fwd), cdf97.idwt3d_ref(fwd)
        torch.cuda.synchronize()
        d_fwd = float((fwd - fwd_ref).abs().max())
        d_inv = float((inv - inv_ref).abs().max())
        d_rt = float((inv - x).abs().max())
        print(f"[kernels] lifting {shape[1:]}: max|dwt3d - plain| {d_fwd:.3e}, "
              f"max|idwt3d - plain| {d_inv:.3e}, max|round trip - x| {d_rt:.3e}, "
              f"bound {bound:.3e}")
        _check(max(d_fwd, d_inv, d_rt) <= bound, f"lifting kernel off its plain version at {shape}")
        lift_err = max(lift_err, d_fwd, d_inv)
        if shape[1] == 256:
            l_ms = _time_ms(lambda: cdf97.dwt3d(x), 10)
            l_plain_ms = _time_ms(lambda: cdf97.dwt3d_ref(x), 3)
            li_ms = _time_ms(lambda: cdf97.idwt3d(fwd), 10)
            li_plain_ms = _time_ms(lambda: cdf97.idwt3d_ref(fwd), 3)
            print(f"[kernels] dwt3d 256^3 (18 launches): kernel {l_ms:.4f} ms, plain "
                  f"{l_plain_ms:.4f} ms; idwt3d: kernel {li_ms:.4f} ms, plain {li_plain_ms:.4f} ms")
        del x, fwd, fwd_ref, inv, inv_ref
    # the 1D and 2D drivers, with lines too long for a 32-line tile in shared
    # memory: the kernel on the card against the plain version on the CPU
    for fn, shape in ((cdf97.dwt2d, (2, 1000, 40)), (cdf97.idwt2d, (2, 1000, 40)),
                      (cdf97.dwt1d, (3, 5000)), (cdf97.idwt1d, (3, 5000))):
        xh = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        d = float((fn(xh.to(dev)).cpu() - fn(xh)).abs().max())
        print(f"[kernels] {fn.__name__} {shape}: max|card - CPU plain| {d:.3e}")
        _check(d <= 2e-5 * float(xh.abs().max()), f"{fn.__name__} off its plain version at {shape}")

    # -- 4. the main path: 512^3, 8 chunks of 256^3, PWE 1e-2 --------------
    engine = default_engine()
    print(f"[main] host engine: {type(engine).__name__}")
    _check(type(engine).__name__ == "NativeEngine", "the C++ host engine did not load")
    t0 = time.perf_counter()
    vol = smooth_field_3d(512, seed=7)
    print(f"[main] smooth_field_3d(512, seed=7) made in {time.perf_counter() - t0:.2f} s")
    tol = 1e-2
    comp = TorchCompressor3D((512, 512, 512), (256, 256, 256), device="cuda")
    dec = TorchDecompressor3D(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    stream = comp.compress(vol, "pwe", tol)  # warm-up
    dec.decompress(stream)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream2 = comp.compress(vol, "pwe", tol)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, dims = dec.decompress(stream2)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] launches during the main path: {launches}")
    for name, cnt in launches.items():
        _check(cnt > 0, f"kernel {name} was not launched on the main path")
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
    del vol, out, host

    # -- 5. PSNR and rate modes, one 256^3 chunk ---------------------------
    vol = smooth_field_3d(256, seed=11)
    vrange = float(vol.max() - vol.min())
    one_chunk = TorchCompressor3D((256, 256, 256), (256, 256, 256), device="cuda")
    for mode, quality in (("psnr", 80.0), ("rate", 2.0)):
        s = one_chunk.compress(vol, mode, quality)
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

    _check("jax" not in sys.modules, "the port imported jax")
    print(json.dumps({"kernels": [
        {"name": "quantize", "route": "cuda", "source": "sperr_tpu_torch/kernels/quantize.cu",
         "replaces": "sperr_tpu/ops/pallas_kernels.py:244", "launches": launches["quantize"],
         "max_abs_err": q_err, "ms": q_ms, "plain_ms": q_plain_ms},
        {"name": "cdf97_lift", "route": "cuda", "source": "sperr_tpu_torch/kernels/cdf97_lift.cu",
         "replaces": "sperr_tpu/ops/cdf97_jax.py:230", "launches": launches["cdf97_lift"],
         "max_abs_err": lift_err, "ms": l_ms, "plain_ms": l_plain_ms},
    ]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
