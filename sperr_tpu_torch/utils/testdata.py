"""Test-data generation and raw-image conversion utilities.

TPU-native equivalent of the reference's data tooling
(NCAR/SPERR test_data/generate.cpp — the 1/r "ball" fields — and
NCAR/SPERR test_data/pgm2float.cpp — PGM grayscale to f32), plus
the synthetic smooth fields the benchmarks run on, so every benchmark
configuration is reproducible without external blobs.

CLI:  python -m sperr_tpu.utils.testdata ball3d 100 /tmp/ball100.bin
      python -m sperr_tpu.utils.testdata smooth3d 256 /tmp/smooth256.f32
      python -m sperr_tpu.utils.testdata pgm2float in.pgm out.float

The port's copy of sperr_tpu/utils/testdata.py; only its imports differ.
"""

from __future__ import annotations

import sys

import numpy as np


def ball_field_2d(n: int = 100) -> np.ndarray:
    """2D 1/r radial field (generate.cpp's 2D case): f32 (n, n), the
    singular center sample clamped to 1."""
    c = n // 2
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2)
    out = np.divide(1.0, d, out=np.zeros_like(d), where=d > 0).astype(
        np.float32
    )
    out[c, c] = 1.0
    return out


def ball_field_3d(n: int = 100) -> np.ndarray:
    """3D 1/r radial field (generate.cpp's 3D case): f32 (n, n, n)."""
    c = n // 2
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    out = np.divide(1.0, d, out=np.zeros_like(d), where=d > 0).astype(
        np.float32
    )
    out[c, c, c] = 1.0
    return out


def smooth_field_3d(n: int, seed: int = 7, modes: int = 24,
                    noise: float = 0.001) -> np.ndarray:
    """Superposed random low-frequency separable modes + sub-tolerance
    noise — the benchmark regime of error-bounded compression (identical
    to bench.make_volume / device_bench._smooth_field)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    vol = np.zeros((n, n, n), dtype=np.float32)
    for _ in range(modes):
        fx, fy, fz = rng.uniform(0.5, 6.0, 3)
        px, py, pz = rng.uniform(0, 2 * np.pi, 3)
        a = np.float32(rng.normal(scale=0.4))
        gx = np.sin(2 * np.pi * fx * t + px).astype(np.float32)
        gy = np.sin(2 * np.pi * fy * t + py).astype(np.float32)
        gz = np.sin(2 * np.pi * fz * t + pz).astype(np.float32)
        vol += a * (gz[:, None, None] * gy[None, :, None] * gx[None, None, :])
    if noise:
        vol += rng.normal(scale=noise, size=vol.shape).astype(np.float32)
    return vol


def pgm_to_float(pgm_path: str) -> np.ndarray:
    """Read a binary (P5) PGM and return its pixels as f32 (h, w) —
    pgm2float.cpp with the header actually parsed instead of hardcoded
    byte offsets."""
    with open(pgm_path, "rb") as f:
        data = f.read()

    # P5 header: magic, whitespace/comments, width, height, maxval
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P5":
        raise ValueError(f"not a binary PGM (P5): magic {tokens[0]!r}")
    w, h, maxval = (int(t) for t in tokens[1:4])
    i += 1  # single whitespace after maxval
    if maxval > 255:
        px = np.frombuffer(data, dtype=">u2", count=w * h, offset=i)
    else:
        px = np.frombuffer(data, dtype=np.uint8, count=w * h, offset=i)
    return px.reshape(h, w).astype(np.float32)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd = argv[0]
    if cmd == "ball2d":
        n, out = int(argv[1]), argv[2]
        ball_field_2d(n).tofile(out)
    elif cmd == "ball3d":
        n, out = int(argv[1]), argv[2]
        ball_field_3d(n).tofile(out)
    elif cmd == "smooth3d":
        n, out = int(argv[1]), argv[2]
        seed = int(argv[3]) if len(argv) > 3 else 7
        smooth_field_3d(n, seed=seed).tofile(out)
    elif cmd == "pgm2float":
        src, out = argv[1], argv[2]
        pgm_to_float(src).tofile(out)
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
