"""sperr2d: compress / decompress a 2D slice (CLI parity with the reference).

Stream layout: 10-byte header {version u8, flags u8, dims 2 x u32} followed by
the SPECK_FLT chunk stream — identical to the reference's sperr2d output
(utilities/sperr2d.cpp:278-290).  ``--exec cuda`` (the default) runs
``TorchCompressor2D`` and ``TorchDecompressor2D`` on the card and raises
without a GPU; ``--exec cpu`` runs them on the CPU, with the kernels' plain
versions; ``--exec host`` is the exact f64 host codec.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..codec.speck_flt import SpeckFloatCodec
from ..stream import tools
from .common import die, print_stats, read_floats, write_array


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sperr2d", description=__doc__)
    p.add_argument("filename", help="input file (raw floats or bitstream)")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-c", action="store_true", help="compress")
    g.add_argument("-d", action="store_true", help="decompress")
    p.add_argument("--ftype", type=int, default=32, choices=(32, 64))
    p.add_argument("--dims", type=int, nargs=2, metavar=("NX", "NY"))
    p.add_argument("--bitstream", default="", help="output compressed stream")
    p.add_argument("--decomp_f", default="", help="output decompressed f32")
    p.add_argument("--decomp_d", default="", help="output decompressed f64")
    p.add_argument("--decomp_lowres_f", default="", help="multi-res f32 prefix")
    p.add_argument("--decomp_lowres_d", default="", help="multi-res f64 prefix")
    p.add_argument("--print_stats", action="store_true")
    q = p.add_mutually_exclusive_group()
    q.add_argument("--pwe", type=float, default=0.0)
    q.add_argument("--psnr", type=float, default=0.0)
    q.add_argument("--bpp", type=float, default=0.0)
    p.add_argument(
        "--exec", dest="exec_", default="cuda", choices=("cuda", "cpu", "host"),
        help="execution engine: the card (default, parallel/batched2d.py), the "
        "same pipeline on the CPU, or the exact f64 host codec",
    )
    return p


def _decode(chunk: bytes, dims, exec_: str, multi_res: bool = False):
    """(flat reconstruction, hierarchy coarsest first) of a headerless stream."""
    nx, ny = dims
    if exec_ == "host":
        return SpeckFloatCodec(2, (nx, ny, 1)).decompress(chunk, multi_res=multi_res)
    from ..parallel.batched2d import TorchDecompressor2D

    dec = TorchDecompressor2D((nx, ny), device=exec_)
    recon = dec.decompress(chunk, multi_res=multi_res).reshape(-1)
    return recon, dec.hierarchy[0]


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.c:
        if not args.dims:
            die("--dims required for compression")
        nx, ny = args.dims
        data = read_floats(args.filename, args.ftype)
        if data.size != nx * ny:
            die("Input file size wrong!")
        if args.pwe:
            mode, quality = "pwe", args.pwe
        elif args.psnr:
            mode, quality = "psnr", args.psnr
        elif args.bpp:
            mode, quality = "rate", args.bpp
        else:
            die("one of --pwe/--psnr/--bpp is required")
        if args.exec_ == "host":
            codec = SpeckFloatCodec(2, (nx, ny, 1))
            chunk = codec.compress(data.astype(np.float64), mode, quality)
        else:
            from ..parallel.batched2d import TorchCompressor2D

            chunk = TorchCompressor2D((nx, ny), device=args.exec_).compress(
                data.reshape(ny, nx), mode, quality
            )
        stream = tools.generate_2d_header((nx, ny), args.ftype == 32) + chunk
        if args.bitstream:
            with open(args.bitstream, "wb") as f:
                f.write(stream)
        if args.print_stats or args.decomp_f or args.decomp_d:
            recon, _ = _decode(chunk, (nx, ny), args.exec_)
            if args.decomp_f:
                write_array(args.decomp_f, recon, np.float32)
            if args.decomp_d:
                write_array(args.decomp_d, recon, np.float64)
            if args.print_stats:
                if args.ftype == 32:
                    print_stats(data, recon.astype(np.float32, copy=False), len(stream))
                else:
                    print_stats(data, recon, len(stream))
        return 0

    # Decompression
    with open(args.filename, "rb") as f:
        stream = f.read()
    (nx, ny), _is_float = tools.parse_2d_header(stream)
    multi_res = bool(args.decomp_lowres_f or args.decomp_lowres_d)
    recon, hierarchy = _decode(stream[10:], (nx, ny), args.exec_, multi_res)
    from ..utils.dims import coarsened_resolutions

    if multi_res:
        for h, res in zip(hierarchy, coarsened_resolutions((nx, ny, 1))):
            tag = f"{res[0]}x{res[1]}"
            if args.decomp_lowres_f:
                write_array(f"{args.decomp_lowres_f}.{tag}", h, np.float32)
            if args.decomp_lowres_d:
                write_array(f"{args.decomp_lowres_d}.{tag}", h, np.float64)
    if args.decomp_f:
        write_array(args.decomp_f, recon, np.float32)
    if args.decomp_d:
        write_array(args.decomp_d, recon, np.float64)
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
