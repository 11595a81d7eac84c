"""sperr3d_trunc: truncate a SPERR3D stream to a percentage, optionally decode
and report quality (parity with utilities/sperr3d_trunc.cpp).  The port's copy
of sperr_tpu/cli/sperr3d_trunc.py: the decode is the exact host engine."""

from __future__ import annotations

import argparse

import numpy as np

from ..stream import tools
from .common import print_stats, read_floats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sperr3d_trunc", description=__doc__)
    p.add_argument("filename", help="input SPERR3D bitstream")
    p.add_argument("--pct", type=int, required=True, help="percentage to keep")
    p.add_argument("--omp", type=int, default=0)
    p.add_argument("--bitstream", default="", help="output truncated stream")
    p.add_argument("--compare_f", default="", help="f32 original for stats")
    p.add_argument("--compare_d", default="", help="f64 original for stats")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trunc = tools.progressive_read(args.filename, args.pct)
    if args.bitstream:
        with open(args.bitstream, "wb") as f:
            f.write(trunc)
    if args.compare_f or args.compare_d:
        from ..parallel.chunked3d import Sperr3DDecompressor

        out, dims = Sperr3DDecompressor(num_threads=args.omp).decompress(trunc)
        if args.compare_f:
            orig = read_floats(args.compare_f, 32)
            print_stats(orig, out.reshape(-1).astype(np.float32), len(trunc))
        else:
            orig = read_floats(args.compare_d, 64)
            print_stats(orig, out.reshape(-1), len(trunc))
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
