"""Multi-process compression: chunks dealt across processes.

Port of sperr_tpu/parallel/distributed.py on torch.distributed.  The
reference's only parallelism is shared-memory OpenMP over chunks
(SPERR3D_OMP_C.cpp:94).  Here the same chunk grid scales across processes,
one per card or several sharing one:

  * each process owns the chunks assigned to it round-robin and runs the
    device-batched pipeline on its card;
  * each process ships one blob, its chunks' u64 length table followed by
    their bytes, to process 0, which assembles the container in global
    chunk order, byte-identical to a one-process run.

Only compressed bytes and header metadata cross processes.  With one
process this degrades to the one-process path; ``initialize()`` starts a
torch.distributed process group (gloo by default) for a real run.  Rank and
world size come from that group when one is initialized, else 0 and 1.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..stream import tools
from ..utils.dims import chunk_volume

ChunkSpec = Tuple[int, int, int, int, int, int]
Loader = Callable[[ChunkSpec], np.ndarray]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "gloo") -> None:
    """Start a torch.distributed process group for a multi-process run:
    ``coordinator_address`` is rank 0's "host:port".  No-op for a
    one-process run (no address) or when a group already exists."""
    import torch.distributed as dist

    if coordinator_address is None or dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
    )


def _rank_and_size() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def own_device():
    """This process's card: ``cuda:{LOCAL_RANK, else the rank} % the device
    count``; raises without a GPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this process")
    rank = int(os.environ.get("LOCAL_RANK", _rank_and_size()[0]))
    return torch.device("cuda", rank % torch.cuda.device_count())


def local_chunk_ids(num_chunks: int, pid: int, nprocs: int) -> List[int]:
    """Round-robin chunk ownership: chunk i belongs to process i % nprocs."""
    return [i for i in range(num_chunks) if i % nprocs == pid]


def split_concat(streams_concat: bytes, lens: Sequence[int]) -> List[bytes]:
    out, off = [], 0
    for ln in lens:
        out.append(streams_concat[off : off + ln])
        off += ln
    return out


def compress_distributed(
    loader: Loader,
    vol_dims: Tuple[int, int, int],
    chunk_dims: Tuple[int, int, int],
    mode: str,
    quality: float,
    is_float: bool = True,
    compressor_factory=None,
    pid: Optional[int] = None,
    nprocs: Optional[int] = None,
    transport=None,
) -> Optional[bytes]:
    """Compress a volume whose chunks are loaded on demand per process.

    `loader(chunk)` returns the chunk's data shaped (lz, ly, lx); it is only
    called for chunks this process owns, so each process reads just its
    slice of the input.  Returns the full container stream on process 0,
    None elsewhere.

    `transport`: a parallel.transport gather implementation; by default an
    ordered TCP gather-to-0 when SPERR_TPU_GATHER_ADDR is set (the
    reference's serial gather point, SPERR3D_OMP_C.cpp:145-161, across
    processes), else the torch.distributed all-gather.  Each rank ships
    one blob = its owned chunks' u64 length table ++ payload bytes, so only
    actual bytes travel and only rank 0 receives.
    """
    rank, size = _rank_and_size()
    pid = rank if pid is None else pid
    nprocs = size if nprocs is None else nprocs
    chunks = chunk_volume(vol_dims, chunk_dims)
    mine = local_chunk_ids(len(chunks), pid, nprocs)
    if transport is None:
        from .transport import default_transport

        transport = default_transport(nprocs)

    if compressor_factory is None:
        from ..codec.speck_flt import SpeckFloatCodec

        def compress_chunk(c: ChunkSpec) -> bytes:
            codec = SpeckFloatCodec(3, (c[1], c[3], c[5]))
            return codec.compress(
                np.asarray(loader(c), dtype=np.float64).reshape(-1), mode, quality
            )

        local_streams = [compress_chunk(chunks[i]) for i in mine]
    else:
        comp = compressor_factory(mode, quality)
        if hasattr(comp, "compress_chunks"):
            # device-batched engine (TorchCompressor3D via
            # device_compressor_factory): the process's owned chunks run
            # as one batched pipeline on its card(s)
            local_streams = comp.compress_chunks(
                [chunks[i] for i in mine], loader, mode, quality
            )
        else:
            local_streams = [comp(chunks[i]) for i in mine]
    # blob = length table for my chunks (u64 each, in my-owned order) ++
    # payload bytes: the gather carries everything rank 0 needs, with no
    # separate metadata collective.
    lens_tab = np.asarray([len(s) for s in local_streams], dtype="<u8")
    blob = lens_tab.tobytes() + b"".join(local_streams)
    payloads = transport.gather_bytes(blob, pid, nprocs)

    if payloads is None:  # non-root
        return None

    ordered: List[bytes] = [b""] * len(chunks)
    for p in range(nprocs):
        owned = local_chunk_ids(len(chunks), p, nprocs)
        tab = np.frombuffer(payloads[p][: 8 * len(owned)], dtype="<u8")
        parts = split_concat(payloads[p][8 * len(owned):], [int(x) for x in tab])
        for k, i in enumerate(owned):
            ordered[i] = parts[k]

    header = tools.generate_header(
        vol_dims, chunk_dims, [len(s) for s in ordered], is_float
    )
    return header + b"".join(ordered)


def device_compressor_factory(chunk_dims: Tuple[int, int, int], devices=None, **opts):
    """A ``compressor_factory`` for compress_distributed that routes each
    process's owned chunks through the device-batched TorchCompressor3D
    pipeline on ``devices`` (default: the process's own card,
    ``own_device``; raises without a GPU).  ``opts`` pass through to
    TorchCompressor3D (entropy=, pwe_strict=, transfer=, ...)."""
    devs = [own_device()] if devices is None else list(devices)

    def make(mode, quality):
        from .batched import TorchCompressor3D

        cd = tuple(int(d) for d in chunk_dims)
        return TorchCompressor3D(cd, cd, devices=devs, **opts)

    return make


def decompress_distributed(
    stream: bytes,
    pid: Optional[int] = None,
    nprocs: Optional[int] = None,
    transport=None,
    decompressor_factory=None,
    to_host: bool = True,
):
    """Distributed decompression: each process decodes its round-robin
    chunks on its card; decoded blocks gather to process 0, which scatters
    them into the full volume — the reference's parallel chunk decode +
    scatter (SPERR3D_OMP_D.cpp:101-127) across processes.

    ``decompressor_factory()`` makes the decoder; by default a
    TorchDecompressor3D on the process's own card (``own_device``).

    to_host=True: returns (volume, vol_dims) on process 0, None elsewhere.
    to_host=False: every process returns (its device-resident blocks as
    {(z0,y0,x0,lz,ly,lx) -> torch.Tensor}, vol_dims) — no gather.
    """
    rank, size = _rank_and_size()
    pid = rank if pid is None else pid
    nprocs = size if nprocs is None else nprocs
    h = tools.parse_header(stream)
    chunks = chunk_volume(h.vol_dims, h.chunk_dims)
    mine = local_chunk_ids(len(chunks), pid, nprocs)

    if decompressor_factory is None:
        from .batched import TorchDecompressor3D

        dec = TorchDecompressor3D(device=own_device())
    else:
        dec = decompressor_factory()
    blocks, _ = dec.decompress(stream, to_host=False, only=mine)
    if not to_host:
        return blocks, h.vol_dims

    if transport is None:
        from .transport import default_transport

        transport = default_transport(nprocs)
    dt = np.dtype(np.float32)
    # blob = my blocks' raw bytes in my-owned chunk order (shapes are
    # implied by the chunk grid, so no per-block metadata is needed)
    blob = b"".join(
        np.ascontiguousarray(blocks[_key(chunks[i])].cpu().numpy()).tobytes() for i in mine
    )
    payloads = transport.gather_bytes(blob, pid, nprocs)
    if payloads is None:
        return None

    nx, ny, nz = h.vol_dims
    vol = np.empty((nz, ny, nx), dtype=dt)
    for p in range(nprocs):
        owned = local_chunk_ids(len(chunks), p, nprocs)
        off = 0
        for i in owned:
            c = chunks[i]
            nbytes = c[1] * c[3] * c[5] * dt.itemsize
            block = np.frombuffer(
                payloads[p][off : off + nbytes], dtype=dt
            ).reshape(c[5], c[3], c[1])
            vol[
                c[4] : c[4] + c[5], c[2] : c[2] + c[3], c[0] : c[0] + c[1]
            ] = block
            off += nbytes
    return vol, h.vol_dims


def _key(c: ChunkSpec):
    """Chunk spec -> the block key TorchDecompressor3D uses (z0,y0,x0,lz,ly,lx)."""
    return (c[4], c[2], c[0], c[5], c[3], c[1])
