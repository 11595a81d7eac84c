"""The plain reference decoder against fixed facts: streams checked in under
``data/`` with the decode they must give, bit for bit, and the fields they
were made from, within their tolerance; and what it does with broken
streams.  The streams were written once by the port's host route (SPECK
chunks, a 3D container whose remainder joins its last chunk, a batch of two
2D fields).  The reference's agreement with the port's own decoder today is
recorded, not asserted: the port may change how it rounds within its
guarantee, and the yardstick does not follow it."""

import os

import numpy as np
import pytest
import torch

from portbench.reference import decode as ref

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _case(name):
    with np.load(os.path.join(DATA, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name, dims, tol", [("chunk16", (16, 16, 16), 0.05),
                                             ("chunk20x17x13", (20, 17, 13), 0.05),
                                             ("field60x40", (60, 40, 1), 0.02),
                                             ("field17x9", (17, 9, 1), 0.5)])
def test_chunk_decodes_as_fixed(name, dims, tol):
    c = _case(name)
    got = ref.decode_chunk(c["stream"].tobytes(), dims, "cpu")
    nx, ny, nz = dims
    assert got.shape == ((ny, nx) if nz == 1 else (nz, ny, nx)) and got.dtype == torch.float64
    assert np.array_equal(got.numpy(), c["decode"])
    assert np.abs(got.numpy() - c["field"]).max() <= tol


def test_constant_chunk():
    # flags 0x01: a constant chunk, its count (u64) and value (f64)
    s = bytes([1]) + np.uint64(512).tobytes() + np.float64(2.5).tobytes()
    assert torch.equal(ref.decode_chunk(s, (8, 8, 8), "cpu"), torch.full((8, 8, 8), 2.5, dtype=torch.float64))


@pytest.fixture(scope="module")
def container():
    c = _case("container40x24x16")
    return c["field"], c["stream"].tobytes(), c["decode"]


def test_container_decodes_as_fixed(container):
    x, cs, want = container
    vol = ref.decode_container(cs, "cpu", threads=3)
    _, chunks, _ = ref.parse_container(cs)
    assert [c[1] for c in chunks] == [16, 24]  # a remainder joins the last chunk
    assert np.array_equal(vol.numpy(), want)
    assert float((vol - torch.from_numpy(x).double()).abs().max()) <= 0.05


def test_fields_decode_as_fixed():
    c = _case("fields48x40")
    raw = c["stream"].tobytes()
    ends = np.cumsum(c["lens"])
    streams = [raw[e - n:e] for e, n in zip(ends, c["lens"])]
    got = ref.decode_fields(streams, (48, 40), "cpu")
    assert np.array_equal(got.numpy(), c["decode"])
    assert float((got - torch.from_numpy(c["field"]).double()).abs().max()) <= 0.01


def test_port_decoder_agreement_is_recorded(container, record_property):
    """The port's decoder against the reference on the fixed container: its
    values within the tolerance of the field (the configuration's
    guarantee); whether it equals the reference bit for bit is recorded."""
    from sperr_tpu_torch.parallel.batched import TorchDecompressor3D

    x, cs, want = container
    port = TorchDecompressor3D(device="cpu").decompress(cs, to_host=True)[0]
    assert np.abs(port.astype(np.float64) - x).max() <= 0.05
    record_property("port_max_gap_over_tol", float(np.abs(port - want).max() / 0.05))


def test_lower_precision_reads_far_off(container):
    _, cs, _ = container
    v64 = ref.decode_container(cs, "cpu")
    v16 = ref.decode_container(cs, "cpu", torch.bfloat16)
    assert v16.dtype == torch.bfloat16
    assert float((v16.double() - v64).abs().max()) > 0.05  # past the tolerance


def test_broken_streams(container):
    _, cs, _ = container
    with pytest.raises(ref.StreamError):
        ref.parse_container(cs[:-1])
    with pytest.raises(ref.StreamError):
        ref.parse_container(cs[:10])
    bad = bytearray(cs)
    _, _, spans = ref.parse_container(cs)
    off, ln = spans[0]
    bad[off + ln // 2] ^= 0xFF  # a byte of the first chunk's SPECK bits
    assert not torch.equal(ref.decode_container(bytes(bad), "cpu"), ref.decode_container(cs, "cpu"))
