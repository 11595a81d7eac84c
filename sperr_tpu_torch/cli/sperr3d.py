"""sperr3d: compress / decompress a 3D volume (CLI parity with the reference).

Produces/consumes the SPERR3D container stream (header + per-chunk streams;
utilities/sperr3d.cpp).  ``--exec cuda`` (the default) runs the dense stages
on the card (``TorchCompressor3D``, SPECK on the host) and decodes through
``TorchDecompressor3D`` (the hybrid split: control parse on the host, the
magnitudes rebuilt on the card); without a GPU it raises.  ``--exec cpu``
runs the same classes on the CPU, with the kernels' plain versions.
``--exec host`` is the exact f64 host engine, whose streams are
byte-identical to the reference; ``--dq`` and ``--precision 32`` need it.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..stream import tools
from .common import die, print_stats, read_floats, write_array


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sperr3d", description=__doc__)
    p.add_argument("filename")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-c", action="store_true", help="compress")
    g.add_argument("-d", action="store_true", help="decompress")
    p.add_argument("--ftype", type=int, default=32, choices=(32, 64))
    p.add_argument("--dims", type=int, nargs=3, metavar=("NX", "NY", "NZ"))
    p.add_argument("--chunks", type=int, nargs=3, default=(256, 256, 256))
    p.add_argument("--omp", type=int, default=0, help="host threads (0 = all)")
    p.add_argument(
        "--exec", dest="exec_mode", default="cuda", choices=("cuda", "cpu", "host"),
        help="execution engine: the card (default), the same pipeline on the "
        "CPU, or the exact f64 host engine",
    )
    p.add_argument(
        "--precision", type=int, default=64, choices=(32, 64),
        help="host pipeline precision (--exec host): 64 = reference-bit-exact, 32 = fast",
    )
    p.add_argument("--bitstream", default="")
    p.add_argument("--decomp_f", default="")
    p.add_argument("--decomp_d", default="")
    p.add_argument("--decomp_lowres_f", default="")
    p.add_argument("--decomp_lowres_d", default="")
    p.add_argument("--print_stats", action="store_true")
    q = p.add_mutually_exclusive_group()
    q.add_argument("--pwe", type=float, default=0.0)
    q.add_argument("--psnr", type=float, default=0.0)
    q.add_argument("--bpp", type=float, default=0.0)
    q.add_argument(
        "--dq", type=float, default=0.0,
        help="experimental, --exec host only: provide the quantization step q "
        "directly (reference's EXPERIMENTING --dq, utilities/sperr3d.cpp:196-203)",
    )
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.precision != 64 and args.exec_mode != "host":
        die("--precision 32 needs --exec host")

    if args.c:
        if not args.dims:
            die("--dims required for compression")
        nx, ny, nz = args.dims
        data = read_floats(args.filename, args.ftype)
        if data.size != nx * ny * nz:
            die("Input file size wrong!")
        if args.pwe:
            mode, quality = "pwe", args.pwe
        elif args.psnr:
            mode, quality = "psnr", args.psnr
        elif args.bpp:
            mode, quality = "rate", args.bpp
        elif args.dq:
            mode, quality = "directq", args.dq
        else:
            die("one of --pwe/--psnr/--bpp/--dq is required")

        vol = data.reshape(nz, ny, nx)
        if args.exec_mode == "host":
            from ..parallel.chunked3d import Sperr3DCompressor

            comp = Sperr3DCompressor(
                (nx, ny, nz), tuple(args.chunks), num_threads=args.omp,
                precision=args.precision,
            )
        else:
            if mode == "directq":
                die("--dq needs --exec host")
            from ..parallel.batched import TorchCompressor3D

            comp = TorchCompressor3D(
                (nx, ny, nz), tuple(args.chunks), device=args.exec_mode,
                num_threads=args.omp or None,
            )
        stream = comp.compress(vol, mode, quality)

        if args.bitstream:
            with open(args.bitstream, "wb") as f:
                f.write(stream)
        if args.print_stats and args.exec_mode != "host":
            # PWE certification surface (pwe_strict=True dual mode): chunks
            # listed here carry the f64-decoder bound only — the port's f32
            # device decoder is not certified for them (mirrors the
            # reference's per-chunk error surface, SPERR3D_OMP_C.cpp:132-135).
            wav = comp.last_wave_chunks
            unc = comp.last_uncertified_ids
            print(f"{args.exec_mode.upper()} engine: device-entropy chunks = {wav}")
            if mode == "pwe":
                if unc:
                    print(
                        f"PWE f32-decoder certification: {len(unc)} chunk(s) "
                        f"NOT certified (f64 bound still holds): ids {unc}"
                    )
                else:
                    print(
                        "PWE bound certified for both f64 and f32 device "
                        "decoders (all chunks)"
                    )
        if args.print_stats or args.decomp_f or args.decomp_d:
            recon = _decompressor(args).decompress(bytes(stream))[0].reshape(-1)
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

    with open(args.filename, "rb") as f:
        stream = f.read()
    dec = _decompressor(args)
    recon, _ = dec.decompress(stream, multi_res=bool(args.decomp_lowres_f or args.decomp_lowres_d))
    hierarchy = dec.hierarchy
    if args.decomp_f:
        write_array(args.decomp_f, recon, np.float32)
    if args.decomp_d:
        write_array(args.decomp_d, recon, np.float64)
    if hierarchy:
        from ..utils.dims import coarsened_resolutions_chunked

        h = tools.parse_header(stream)
        for arr, res in zip(
            hierarchy, coarsened_resolutions_chunked(h.vol_dims, h.chunk_dims)
        ):
            tag = f"{res[0]}x{res[1]}x{res[2]}"
            if args.decomp_lowres_f:
                write_array(f"{args.decomp_lowres_f}.{tag}", arr, np.float32)
            if args.decomp_lowres_d:
                write_array(f"{args.decomp_lowres_d}.{tag}", arr, np.float64)
    return 0


def _decompressor(args):
    if args.exec_mode == "host":
        from ..parallel.chunked3d import Sperr3DDecompressor

        return Sperr3DDecompressor(num_threads=args.omp, precision=args.precision)
    from ..parallel.batched import TorchDecompressor3D

    return TorchDecompressor3D(device=args.exec_mode, num_threads=args.omp or None)


if __name__ == "__main__":
    raise SystemExit(run())
