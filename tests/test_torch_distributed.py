"""The port's multi-process layer (sperr_tpu_torch/parallel/{distributed,
transport}.py) against sperr_tpu's, on the CPU.

The copied helpers and transports are held against their originals; a
container assembled from several ranks (simulated in one process, on
threads over TCP, or as real processes over a gloo group) equals the
one-process container byte for byte; the distributed decode equals the
one-process decode element for element."""

import inspect
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from sperr_tpu.parallel import distributed as jd
from sperr_tpu.parallel import transport as jt
from sperr_tpu.parallel.chunked3d import Sperr3DCompressor
from sperr_tpu_torch.parallel import batched as tb
from sperr_tpu_torch.parallel import distributed as td
from sperr_tpu_torch.parallel import transport as tt
from sperr_tpu_torch.utils.dims import chunk_volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS, CHUNK = (64, 64, 64), (32, 32, 32)
TOL = 1e-3
_EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: several pytest workers otherwise fight over the
    cores for the wave path's many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vol(nx, ny, nz, seed=31):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    return (np.sin(x * 0.2) * np.cos(y * 0.11) * np.sin(z * 0.21)
            + 0.02 * rng.normal(size=(nz, ny, nx))).astype(np.float32)


def _loader(vol):
    def load(c):
        x0, lx, y0, ly, z0, lz = c
        return vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]

    return load


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _SimTransport:
    """Sequential simulation of the gather (tests/test_distributed.py): the
    other ranks deposit their blobs first, rank 0 gathers last."""

    def __init__(self, nprocs):
        self.store = [None] * nprocs

    def gather_bytes(self, payload, pid, nprocs):
        self.store[pid] = payload
        if pid != 0:
            return None
        assert all(b is not None for b in self.store), "rank 0 must run last"
        return list(self.store)


# -- the copies --------------------------------------------------------------
@pytest.mark.parametrize("num_chunks,nprocs", [(8, 1), (8, 3), (27, 4), (2, 5), (0, 2)])
def test_local_chunk_ids_copy(num_chunks, nprocs):
    for pid in range(nprocs):
        assert td.local_chunk_ids(num_chunks, pid, nprocs) == jd.local_chunk_ids(num_chunks, pid, nprocs)


def test_split_concat_and_key_copies():
    rng = np.random.default_rng(3)
    lens = [int(v) for v in rng.integers(0, 50, size=9)] + [0]
    blob = bytes(rng.integers(0, 256, size=sum(lens), dtype=np.uint8))
    assert td.split_concat(blob, lens) == jd.split_concat(blob, lens)
    for c in chunk_volume((70, 33, 41), (32, 16, 16)):
        assert td._key(c) == jd._key(c)


@pytest.mark.parametrize("name", ["_HDR", "_recv_exact", "LocalTransport", "SocketGatherTransport",
                                  "default_transport"])
def test_transport_copies_are_the_originals(name):
    a, b = getattr(tt, name), getattr(jt, name)
    if name == "_HDR":
        assert a.format == b.format
    else:
        assert inspect.getsource(a) == inspect.getsource(b)


def test_default_transport_choice(monkeypatch):
    monkeypatch.delenv("SPERR_TPU_GATHER_ADDR", raising=False)
    assert isinstance(tt.default_transport(1), tt.LocalTransport)
    assert isinstance(tt.default_transport(3), tt.AllgatherTransport)
    monkeypatch.setenv("SPERR_TPU_GATHER_ADDR", "127.0.0.1:40001")
    tr = tt.default_transport(3)
    assert isinstance(tr, tt.SocketGatherTransport) and (tr.host, tr.port) == ("127.0.0.1", 40001)
    assert tt.AllgatherTransport().gather_bytes(b"abc", 0, 1) == [b"abc"]


def test_one_process_default_codec_equals_jax():
    """pid 0 of 1 on the default host codec: sperr_tpu's bytes."""
    nx, ny, nz = 40, 30, 50
    vol = _vol(nx, ny, nz)
    args = (_loader(vol), (nx, ny, nz), (16, 16, 16), "psnr", 65.0)
    ours = td.compress_distributed(*args, is_float=True, pid=0, nprocs=1)
    theirs = jd.compress_distributed(*args, is_float=True, pid=0, nprocs=1)
    assert ours == theirs
    assert ours == bytes(Sperr3DCompressor((nx, ny, nz), (16, 16, 16)).compress(vol, "psnr", 65.0))


# -- several ranks -------------------------------------------------------------
@pytest.mark.parametrize("entropy", ["host", "wave"])
def test_simulated_ranks_on_the_device_pipeline(entropy):
    """3 simulated ranks through device_compressor_factory(devices=["cpu"]):
    the container equals one TorchCompressor3D's byte for byte; the
    distributed decode equals the one-process decode element for element,
    and agrees with sperr_tpu's distributed decode as the port's decoder
    agrees with the reference in tests/test_torch_pipeline.py: both within
    TOL + 4 f32 ulps of max|vol| of the data."""
    vol = _vol(*DIMS, seed=12)
    nprocs = 3
    factory = td.device_compressor_factory(CHUNK, devices=["cpu"], entropy=entropy)
    tr = _SimTransport(nprocs)
    out = {}
    for pid in range(nprocs - 1, -1, -1):  # rank 0 gathers last
        out[pid] = td.compress_distributed(
            _loader(vol), DIMS, CHUNK, "pwe", TOL, is_float=True,
            compressor_factory=factory, pid=pid, nprocs=nprocs, transport=tr,
        )
    assert out[1] is None and out[2] is None
    single = tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", entropy=entropy).compress(vol, "pwe", TOL)
    assert out[0] == single

    def decode(pid, transport):
        return td.decompress_distributed(
            single, pid=pid, nprocs=nprocs, transport=transport,
            decompressor_factory=lambda: tb.TorchDecompressor3D(device="cpu"),
        )

    tr2 = _SimTransport(nprocs)
    dout = {pid: decode(pid, tr2) for pid in range(nprocs - 1, -1, -1)}
    assert dout[1] is None and dout[2] is None
    got, dims = dout[0]
    ref, _ = tb.TorchDecompressor3D(device="cpu").decompress(single)
    assert dims == DIMS
    np.testing.assert_array_equal(got, ref)
    tr3 = _SimTransport(nprocs)
    jout = {pid: jd.decompress_distributed(single, pid=pid, nprocs=nprocs, transport=tr3)
            for pid in range(nprocs - 1, -1, -1)}
    slack = 4 * _EPS32 * float(np.abs(vol).max())
    for o in (got, jout[0][0]):
        assert float(np.abs(np.asarray(o, np.float64) - vol).max()) <= TOL + slack


def test_device_blocks_stay_with_their_rank():
    """to_host=False: each rank keeps only its own chunks, as tensors."""
    vol = _vol(*DIMS, seed=4)
    stream = tb.TorchCompressor3D(DIMS, CHUNK, device="cpu").compress(vol, "psnr", 70.0)
    full, _ = tb.TorchDecompressor3D(device="cpu").decompress(stream)
    chunks = chunk_volume(DIMS, CHUNK)
    seen = set()
    for pid in range(3):
        blocks, dims = td.decompress_distributed(
            stream, pid=pid, nprocs=3, to_host=False,
            decompressor_factory=lambda: tb.TorchDecompressor3D(device="cpu"),
        )
        mine = td.local_chunk_ids(len(chunks), pid, 3)
        assert dims == DIMS and set(blocks) == {td._key(chunks[i]) for i in mine}
        for (z0, y0, x0, lz, ly, lx), t in blocks.items():
            assert isinstance(t, torch.Tensor)
            np.testing.assert_array_equal(t.numpy(), full[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx])
        seen |= set(blocks)
    assert len(seen) == len(chunks)


def test_socket_gather_transport_skewed_sizes():
    """Ordered TCP gather to rank 0 with 3 ranks on threads and strongly
    skewed payload sizes: only actual bytes travel, in rank order."""
    rng = np.random.default_rng(5)
    payloads = [bytes(rng.integers(0, 256, size=sz, dtype=np.uint8)) for sz in (700_001, 0, 1_234_567)]
    nprocs = len(payloads)
    tr = tt.SocketGatherTransport(f"127.0.0.1:{_free_port()}", timeout=30.0)
    result = {}

    def run(pid):
        result[pid] = tr.gather_bytes(payloads[pid], pid, nprocs)

    threads = [threading.Thread(target=run, args=(p,)) for p in range(nprocs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert result[0] == payloads
    assert result[1] is None and result[2] is None


_RANK = """
import sys
import numpy as np
from sperr_tpu_torch.parallel import distributed as td
from sperr_tpu_torch.parallel.transport import SocketGatherTransport

rank, port, gport, path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
td.initialize(f"127.0.0.1:{port}", 2, rank)
vol = np.load(path, mmap_mode="r")

def loader(c):
    x0, lx, y0, ly, z0, lz = c
    return np.asarray(vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx])

factory = td.device_compressor_factory((32, 32, 32), devices=["cpu"], entropy="wave")
results = []
for transport in (None, SocketGatherTransport(f"127.0.0.1:{gport}", timeout=60.0)):
    s = td.compress_distributed(loader, (64, 64, 64), (32, 32, 32), "pwe", 1e-3,
                                compressor_factory=factory, transport=transport)
    assert (s is None) == (rank != 0), rank
    results.append(s)
if rank == 0:
    assert results[0] == results[1], "the two transports' containers differ"
    with open(out, "wb") as f:
        f.write(results[0])
print("rank", rank, "ok")
"""


def test_two_ranks_over_gloo(tmp_path):
    """Two real processes over a gloo group, each loading only its own
    chunks: rank 0's container, over the all-gather and over the socket
    gather, equals the one-process container byte for byte."""
    vol = _vol(*DIMS, seed=9)
    np.save(tmp_path / "vol.npy", vol)
    single = tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", entropy="wave").compress(vol, "pwe", TOL)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.pop("SPERR_TPU_GATHER_ADDR", None)
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    port, gport = _free_port(), _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK, str(r), str(port), str(gport), str(tmp_path / "vol.npy"),
             str(tmp_path / "out.sperr")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    assert (tmp_path / "out.sperr").read_bytes() == single


def test_initialize_without_an_address_is_a_no_op():
    td.initialize()
    assert not torch.distributed.is_initialized()
    assert td._rank_and_size() == (0, 1)


def test_own_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.device_compressor_factory(CHUNK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.decompress_distributed(
            tb.TorchCompressor3D(DIMS, CHUNK, device="cpu").compress(_vol(*DIMS), "psnr", 60.0),
            pid=0, nprocs=1,
        )
