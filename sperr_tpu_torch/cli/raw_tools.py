"""Raw-volume utilities: the reference's utilities/raw_tools/* as one CLI.

Subcommands (reference counterparts in parentheses):
  compare   — quality stats between two raw float files (compare_raw.cpp)
  crop2d    — crop a rectangle out of a 2D raw file (crop_2d.c)
  crop3d    — crop a box out of a 3D raw file (crop_3d.cpp)
  putback3d — paste a cropped box back into a 3D raw file (put_back_3d.cpp)
  convert   — f32 <-> f64 raw conversion (double_prec.cpp precision probe)
  generate  — synthetic test fields (test_data/generate.cpp: the 1/r "ball")

Usage: python -m sperr_tpu_torch.cli.raw_tools <subcommand> ...

The port's copy of sperr_tpu/cli/raw_tools.py; only its imports differ.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.stats import calc_stats


def _dtype(ftype: int):
    return np.float32 if ftype == 32 else np.float64


def cmd_compare(args) -> int:
    a = np.fromfile(args.file1, dtype=_dtype(args.ftype))
    b = np.fromfile(args.file2, dtype=_dtype(args.ftype))
    if a.size != b.size:
        print(f"size mismatch: {a.size} vs {b.size}")
        return 1
    rmse, linfty, psnr, amin, amax = calc_stats(
        a.astype(np.float64), b.astype(np.float64)
    )
    print(f"file1 range = ({amin:.6e}, {amax:.6e})")
    print(f"RMSE = {rmse:.6e}, L-Infty = {linfty:.6e}, PSNR = {psnr:.4f}dB")
    return 0


def cmd_crop2d(args) -> int:
    nx, ny = args.dims
    a = np.fromfile(args.infile, dtype=_dtype(args.ftype)).reshape(ny, nx)
    out = a[args.y0 : args.y1, args.x0 : args.x1]
    out.tofile(args.outfile)
    print(f"wrote {out.shape[1]}x{out.shape[0]} to {args.outfile}")
    return 0


def cmd_crop3d(args) -> int:
    nx, ny, nz = args.dims
    a = np.fromfile(args.infile, dtype=_dtype(args.ftype)).reshape(nz, ny, nx)
    out = a[args.z0 : args.z1, args.y0 : args.y1, args.x0 : args.x1]
    out.tofile(args.outfile)
    print(
        f"wrote {out.shape[2]}x{out.shape[1]}x{out.shape[0]} to {args.outfile}"
    )
    return 0


def cmd_putback3d(args) -> int:
    nx, ny, nz = args.dims
    big = np.fromfile(args.bigfile, dtype=_dtype(args.ftype)).reshape(nz, ny, nx)
    sx, sy, sz = args.small_dims
    small = np.fromfile(args.smallfile, dtype=_dtype(args.ftype)).reshape(
        sz, sy, sx
    )
    big[args.z0 : args.z0 + sz, args.y0 : args.y0 + sy, args.x0 : args.x0 + sx] = small
    big.tofile(args.bigfile)
    print(f"pasted {sx}x{sy}x{sz} at ({args.x0},{args.y0},{args.z0})")
    return 0


def cmd_convert(args) -> int:
    src = np.fromfile(args.infile, dtype=_dtype(args.ftype))
    dst = src.astype(np.float64 if args.ftype == 32 else np.float32)
    dst.tofile(args.outfile)
    print(f"converted {src.size} values f{args.ftype} -> f{dst.dtype.itemsize*8}")
    return 0


def cmd_generate(args) -> int:
    n = args.n
    if args.kind == "ball":
        # 1/r radial field with the centre singularity patched to 1.0
        # (test_data/generate.cpp)
        c = n // 2
        z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
        dist = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
        with np.errstate(divide="ignore"):
            buf = (1.0 / dist).astype(np.float32)
        buf[c, c, c] = 1.0
    else:  # smooth superposition of low-frequency separable modes
        rng = np.random.default_rng(args.seed)
        t = np.linspace(0.0, 1.0, n, dtype=np.float32)
        buf = np.zeros((n, n, n), dtype=np.float32)
        for _ in range(24):
            fx, fy, fz = rng.uniform(0.5, 6.0, 3)
            px, py, pz = rng.uniform(0, 2 * np.pi, 3)
            a = np.float32(rng.normal(scale=0.4))
            gx = np.sin(2 * np.pi * fx * t + px).astype(np.float32)
            gy = np.sin(2 * np.pi * fy * t + py).astype(np.float32)
            gz = np.sin(2 * np.pi * fz * t + pz).astype(np.float32)
            buf += a * (gz[:, None, None] * gy[None, :, None] * gx[None, None, :])
    buf.tofile(args.outfile)
    print(f"wrote {n}^3 f32 '{args.kind}' field to {args.outfile}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raw_tools", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compare", help="stats between two raw files")
    c.add_argument("file1")
    c.add_argument("file2")
    c.add_argument("--ftype", type=int, default=32, choices=(32, 64))
    c.set_defaults(fn=cmd_compare)

    c = sub.add_parser("crop2d", help="crop [x0,x1)x[y0,y1) from a 2D file")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("--dims", type=int, nargs=2, required=True, metavar=("NX", "NY"))
    for f in ("x0", "x1", "y0", "y1"):
        c.add_argument(f"--{f}", type=int, required=True)
    c.add_argument("--ftype", type=int, default=32, choices=(32, 64))
    c.set_defaults(fn=cmd_crop2d)

    c = sub.add_parser("crop3d", help="crop a box from a 3D file")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("--dims", type=int, nargs=3, required=True, metavar=("NX", "NY", "NZ"))
    for f in ("x0", "x1", "y0", "y1", "z0", "z1"):
        c.add_argument(f"--{f}", type=int, required=True)
    c.add_argument("--ftype", type=int, default=32, choices=(32, 64))
    c.set_defaults(fn=cmd_crop3d)

    c = sub.add_parser("putback3d", help="paste a box back into a 3D file")
    c.add_argument("bigfile")
    c.add_argument("smallfile")
    c.add_argument("--dims", type=int, nargs=3, required=True, metavar=("NX", "NY", "NZ"))
    c.add_argument("--small_dims", type=int, nargs=3, required=True, metavar=("SX", "SY", "SZ"))
    for f in ("x0", "y0", "z0"):
        c.add_argument(f"--{f}", type=int, required=True)
    c.add_argument("--ftype", type=int, default=32, choices=(32, 64))
    c.set_defaults(fn=cmd_putback3d)

    c = sub.add_parser("convert", help="f32 <-> f64 conversion")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("--ftype", type=int, default=32, choices=(32, 64),
                   help="input float width; output is the other width")
    c.set_defaults(fn=cmd_convert)

    c = sub.add_parser("generate", help="synthetic test fields")
    c.add_argument("outfile")
    c.add_argument("--kind", default="ball", choices=("ball", "smooth"))
    c.add_argument("-n", type=int, default=100)
    c.add_argument("--seed", type=int, default=7)
    c.set_defaults(fn=cmd_generate)
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(run())
