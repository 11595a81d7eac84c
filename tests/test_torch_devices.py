"""Batches split over several devices (``devices=``, the port of sperr_tpu's
chunk mesh), on the CPU: a list that names the CPU two or three times
against the one-device run.

Every device stage computes each chunk or field on its own, so the split
changes no arithmetic: containers and streams must be equal byte for byte
in every mode, ``pwe_strict`` tier (dual included) and entropy route, and
decodes element for element.  The counters are summed over the devices."""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

from sperr_tpu.parallel import batched as jb
from sperr_tpu.parallel import batched2d as jb2
from sperr_tpu_torch import kernels
from sperr_tpu_torch.ops import speck_virtual as tsv
from sperr_tpu_torch.parallel import batched as tb
from sperr_tpu_torch.parallel import batched2d as tb2

DIMS, CHUNK = (32, 32, 256), (32, 32, 32)
NX2 = NY2 = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: several pytest workers otherwise fight over the
    cores for the wave path's many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vol(nx, ny, nz, seed=21):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    f = np.sin(x * 0.2) * np.cos(y * 0.15) * np.sin(z * 0.1 + 1.0)
    return (f + 0.02 * rng.normal(size=f.shape)).astype(np.float32)


def _fields(b, seed=1):
    rng = np.random.default_rng(seed)
    return np.cumsum(np.cumsum(rng.normal(size=(b, NY2, NX2)), axis=1), axis=2).astype(np.float32)


def _comp3(devices, entropy, pwe_strict):
    c = tb.TorchCompressor3D(DIMS, CHUNK, devices=devices, entropy=entropy, pwe_strict=pwe_strict)
    # three chunks per sub-batch: 2 with two devices (rounded down to a
    # multiple), 3 with three, so the split meets a remainder sub-batch
    c.dense_elem_budget = c.wave_elem_budget = 3 * 32**3
    return c


@functools.lru_cache(maxsize=None)
def _one_device(entropy, mode, quality, pwe_strict):
    c = _comp3(["cpu"], entropy, pwe_strict)
    s = c.compress(_vol(*DIMS), mode, quality)
    return s, c.last_d2h_bytes, tuple(c.last_wave_tiers), c.last_uncertified_chunks


_MODES = [("pwe", 1e-3, True), ("pwe", 1e-3, "f64"), ("pwe", 1e-3, "device"), ("pwe", 1e-3, False),
          ("psnr", 60.0, True), ("rate", 2.0, True)]


@pytest.mark.parametrize("ndev", [2, 3])
@pytest.mark.parametrize("entropy", ["host", "wave"])
@pytest.mark.parametrize("mode,quality,pwe_strict", _MODES)
def test_split_3d_container_equals_one_device(mode, quality, pwe_strict, entropy, ndev):
    s1, d2h, tiers, unc = _one_device(entropy, mode, quality, pwe_strict)
    c = _comp3(["cpu"] * ndev, entropy, pwe_strict)
    assert c.compress(_vol(*DIMS), mode, quality) == s1
    assert c.last_d2h_bytes == d2h
    assert tuple(c.last_wave_tiers) == tiers and c.last_uncertified_chunks == unc
    if entropy == "wave":
        assert c.last_wave_chunks == 8


@pytest.mark.parametrize("hybrid", [False, True])
def test_split_3d_decode_equals_one_device(hybrid):
    s = _one_device("host", "pwe", 1e-3, True)[0]
    one = tb.TorchDecompressor3D(device="cpu", hybrid=hybrid)
    want, dims = one.decompress(s)
    for ndev in (2, 3):
        dec = tb.TorchDecompressor3D(devices=["cpu"] * ndev, hybrid=hybrid)
        got, dims2 = dec.decompress(s)
        assert dims2 == dims
        np.testing.assert_array_equal(got, want)
        assert (dec.last_hybrid_chunks, dec.last_full_parse_chunks) == (
            one.last_hybrid_chunks, one.last_full_parse_chunks)
        # summed over the parts; each part pads its stream words to its own
        # longest stream, so the sum need not equal the one-device count
        assert dec.last_h2d_bytes > 0
        blocks, _ = dec.decompress(s, to_host=False, only=[0, 3, 4, 7])
        assert len(blocks) == 4
        for (z0, y0, x0, lz, ly, lx), t in blocks.items():
            assert t.device == torch.device("cpu")
            np.testing.assert_array_equal(t.numpy(), want[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx])
    assert one.last_hybrid_chunks == (8 if hybrid else 0)


def test_split_3d_multi_res_decode():
    vol = _vol(64, 64, 64, seed=3)
    s = tb.TorchCompressor3D((64, 64, 64), CHUNK, device="cpu").compress(vol, "psnr", 70.0)
    one = tb.TorchDecompressor3D(device="cpu")
    two = tb.TorchDecompressor3D(devices=["cpu", "cpu"])
    a, _ = one.decompress(s, multi_res=True)
    b, _ = two.decompress(s, multi_res=True)
    np.testing.assert_array_equal(a, b)
    assert len(one.hierarchy) == len(two.hierarchy) > 0
    for x, y in zip(one.hierarchy, two.hierarchy):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ndev", [2, 3])
@pytest.mark.parametrize("entropy", ["host", "wave"])
@pytest.mark.parametrize("mode,quality,pwe_strict", [("pwe", 1e-2, True), ("pwe", 1e-2, "f64"),
                                                     ("psnr", 60.0, True)])
def test_split_2d_streams_and_decodes(mode, quality, pwe_strict, entropy, ndev):
    """Seven fields, sub-batches of at most four (three with three devices):
    neither the batch nor a sub-batch is a multiple of the device count."""
    fields = _fields(7)
    comps = []
    for devs in (["cpu"], ["cpu"] * ndev):
        c = tb2.TorchCompressor2D((NX2, NY2), devices=devs, entropy=entropy, pwe_strict=pwe_strict)
        c.elem_budget = 4 * NX2 * NY2
        comps.append((c, c.compress_batch(fields, mode, quality)))
    (c1, s1), (cn, sn) = comps
    assert sn == s1
    assert (cn.last_d2h_bytes, cn.last_wave_tiers, cn.last_uncertified_chunks) == (
        c1.last_d2h_bytes, c1.last_wave_tiers, c1.last_uncertified_chunks)
    if entropy == "wave":
        assert cn.last_wave_chunks == 7
    for multi_res in (False, True):
        d1 = tb2.TorchDecompressor2D((NX2, NY2), device="cpu")
        dn = tb2.TorchDecompressor2D((NX2, NY2), devices=["cpu"] * ndev)
        for a, b in zip(d1.decompress_batch(s1, multi_res=multi_res), dn.decompress_batch(s1, multi_res=multi_res)):
            np.testing.assert_array_equal(a, b)
        assert len(dn.hierarchy) == 7
        for h1, hn in zip(d1.hierarchy, dn.hierarchy):
            assert len(h1) == len(hn) and (len(hn) > 0) == multi_res
            for a, b in zip(h1, hn):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("entropy", ["host", "wave"])
def test_from_jax_of_a_meshed_3d_compressor(entropy):
    """A TpuCompressor3D on the 8 virtual CPU devices' mesh maps onto the
    caller's device list; its container equals the meshless port's."""
    dims = (64, 64, 64)
    vol = _vol(*dims, seed=8)
    t = jb.TpuCompressor3D(dims, CHUNK, entropy=entropy, transfer="dense", mesh=jb.make_chunk_mesh())
    assert t.mesh.devices.size == 8
    meshless = tb.TorchCompressor3D.from_jax(
        jb.TpuCompressor3D(dims, CHUNK, entropy=entropy, transfer="dense"), "cpu")
    want = meshless.compress(vol, "pwe", 1e-3)
    for device in (["cpu", "cpu"], "cpu"):
        p = tb.TorchCompressor3D.from_jax(t, device)
        assert p.devices == [torch.device("cpu")] * (2 if isinstance(device, list) else 1)
        assert p.compress(vol, "pwe", 1e-3) == want


def test_from_jax_of_a_meshed_2d_compressor():
    fields = _fields(5, seed=4)
    t = jb2.TpuCompressor2D((NX2, NY2), mesh=jb.make_chunk_mesh())
    p = tb2.TorchCompressor2D.from_jax(t, ["cpu"] * 3)
    assert p.devices == [torch.device("cpu")] * 3
    want = tb2.TorchCompressor2D.from_jax(jb2.TpuCompressor2D((NX2, NY2)), "cpu").compress_batch(
        fields, "pwe", 1e-3)
    assert p.compress_batch(fields, "pwe", 1e-3) == want


def test_device_arguments():
    assert tb.chunk_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert tb._split(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert tb._split(2, 3) == [(0, 1), (1, 2), (2, 2)]
    with pytest.raises(ValueError, match="not both"):
        tb.TorchCompressor3D(DIMS, CHUNK, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="not both"):
        tb2.TorchDecompressor2D((NX2, NY2), device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="empty"):
        tb.TorchDecompressor3D(devices=[])
    with pytest.raises(ValueError, match="list of devices"):
        tb.TorchDecompressor3D(devices="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.chunk_devices(["cpu", "meta"])


def test_device_defaults_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.chunk_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.chunk_devices(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb2.TorchCompressor2D((NX2, NY2), devices=["cuda", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="all be CUDA or all CPU"):
        tb.chunk_devices(["cpu", "cuda:0"])


def test_a_device_thread_failure_raises():
    """A part that fails on its device fails the compress (after the other
    device threads end)."""

    def loader(c):
        if c[4] == 64:
            raise OSError("chunk 2 unreadable")
        return _vol(*DIMS)[c[4] : c[4] + c[5]]

    c = tb.TorchCompressor3D(DIMS, CHUNK, devices=["cpu"] * 3)
    chunks = [(0, 32, 0, 32, z, 32) for z in range(0, 256, 32)]
    with pytest.raises(OSError, match="chunk 2"):
        c.compress_chunks(chunks, loader, "psnr", 60.0)


def test_launch_counts_stay_exact_under_threads():
    """The kernel wrappers count their launches from one host thread per
    device: a stress of more threads than cores, with a short switch
    interval, loses no update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    saved = dict(kernels.launches)
    try:
        kernels.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [kernels._count("quantize") for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert kernels.launches["quantize"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        kernels.launches.update(saved)


def test_device_threads_build_an_index_once(monkeypatch):
    """Threads that need one new index at once build it once."""
    built = []
    real = tsv.VirtualLisIndex

    def counting(dims, device):
        built.append(dims)
        return real(dims, device)

    monkeypatch.setattr(tsv, "VirtualLisIndex", counting)
    dims = (8, 8, 8)
    monkeypatch.delitem(tsv._VIRTUAL, ((8, 8, 8), "cpu"), raising=False)
    out = [None] * 8
    barrier = threading.Barrier(8)

    def run(k):
        barrier.wait(30)
        out[k] = tb._wave_index(dims, "cpu")

    threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert len(built) == 1 and all(o == out[0] for o in out)
