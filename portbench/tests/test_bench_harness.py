"""Whole runs of small cells on the CPU: the harness agrees with the
reference on sound runs, and its check comes out false on the control and
on the timed path broken underneath (each fault a cell can have)."""

import time

import numpy as np
import pytest

from portbench import harness
from sperr_tpu_torch.parallel import batched, batched2d

SEED = 2**31 + 77


def _run(root, cell, traced=False, control=False, seconds=0.5):
    bench = harness.Bench(root)
    return harness.run_cell(bench, cell, SEED, seconds, traced, "cpu", time.perf_counter(), control=control)


@pytest.mark.parametrize("cell", ["tiny3.pwe3.write", "tiny3.pwe2.read", "tiny2.pwe3.write", "tiny2.pwe3.read",
                                  "tiny3.rate2.write", "tiny3.psnr.write", "tiny3.mixed"])
def test_sound_run_is_correct(tiny_root, one_thread, cell):
    out = _run(tiny_root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    for k, c in out["checks"].items():
        assert c["value"] <= c["limit"] and (c["value"] >= 0 or k == "psnr_gap_db")
    want = {m["name"] for m in harness.Bench(tiny_root).metrics(cell, False)}
    assert set(out["metrics"]) == want and out["metrics"]["setup_s"]["value"] > 0
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def test_traced_run(tiny_root, one_thread):
    out = _run(tiny_root, "tiny3.pwe3.write", traced=True)
    m = out["metrics"]
    # counters and the host clock read on the CPU; the device readers read nothing
    assert m["host_entropy_share"]["value"] == 0.0 and m["wave_attempts_per_chunk"]["value"] >= 1
    assert m["d2h_MB_per_GB"]["value"] > 0 and m["encode_p95_ms"]["value"] > 0
    assert not any(k.startswith(("dwt_roofline", "device_idle")) for k in m)
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["tiny3.pwe3.write", "tiny2.pwe3.write", "tiny3.pwe2.read", "tiny2.pwe3.read"])
def test_control_fails(tiny_root, one_thread, cell):
    """The control: the fields handed to the program in bfloat16 in a write
    cell, the reference decoder in bfloat16 in a read cell."""
    out = _run(tiny_root, cell, control=True)
    assert not out["correct"] and out["failed"] >= 1


def _flip(stream: bytes) -> bytes:
    b = bytearray(stream)
    b[len(b) // 2] ^= 0x5A
    return bytes(b)


def _stale(fn):
    """A request answers with the answer of the request before it."""
    last = {}

    def wrapped(self, *a, **k):
        out = fn(self, *a, **k)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    return wrapped


def _fault(name, monkeypatch):
    c3, d3, c2 = batched.TorchCompressor3D, batched.TorchDecompressor3D, batched2d.TorchCompressor2D
    comp3, chunks3, dec3, comp2 = c3.compress, c3.compress_chunks, d3.decompress, c2.compress_batch
    if name == "write3.altered":  # a byte of the container changed where it is made
        monkeypatch.setattr(c3, "compress", lambda self, *a: _flip(comp3(self, *a)))
    elif name == "write3.half":  # half of the chunks' streams left out, the others repeated
        def half(self, *a):
            s = chunks3(self, *a)
            return s[: len(s) // 2] * 2
        monkeypatch.setattr(c3, "compress_chunks", half)
    elif name == "write3.stale":
        monkeypatch.setattr(c3, "compress", _stale(comp3))
    elif name == "read3.altered":  # a value of the answer changed
        def altered(self, *a, **k):
            vol, dims = dec3(self, *a, **k)
            vol.reshape(-1)[vol.size // 3] += 0.5
            return vol, dims
        monkeypatch.setattr(d3, "decompress", altered)
    elif name == "read3.half":  # half of the volume left out
        def half(self, *a, **k):
            vol, dims = dec3(self, *a, **k)
            vol[vol.shape[0] // 2:] = 0
            return vol, dims
        monkeypatch.setattr(d3, "decompress", half)
    elif name == "read3.stale":
        monkeypatch.setattr(d3, "decompress", _stale(dec3))
    elif name == "write2.altered":
        monkeypatch.setattr(c2, "compress_batch", lambda self, *a: [_flip(s) for s in comp2(self, *a)])
    elif name == "write2.half":  # half of the batch left out
        monkeypatch.setattr(c2, "compress_batch", lambda self, f, *a: comp2(self, f[: len(f) // 2], *a))
    elif name == "write2.stale":
        monkeypatch.setattr(c2, "compress_batch", _stale(comp2))


FAULTS = {"write3": "tiny3.pwe3.write", "read3": "tiny3.pwe2.read", "write2": "tiny2.pwe3.write"}


@pytest.mark.parametrize("fault", [f"{k}.{f}" for k in FAULTS for f in ("altered", "half", "stale")])
def test_fault_fails(tiny_root, one_thread, monkeypatch, fault):
    _fault(fault, monkeypatch)
    # long enough for two requests: the stale fault shows from the second
    out = _run(tiny_root, FAULTS[fault.split(".")[0]], seconds=2.0)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def test_mixed_window_cycles_its_ops(tiny_root, one_thread):
    """A mixed cell's requests alternate between its ops, each group of
    fields with each op, and each op's numbers are held to its limits."""
    out = _run(tiny_root, "tiny3.mixed", seconds=1.0)
    assert out["correct"] and out["info"]["requests"] >= 2
    assert set(out["checks"]) == {"err64", "err32", "gap"}
    assert out["metrics"]["encode_GBps"]["value"] > 0 and out["metrics"]["decode_GBps"]["value"] > 0
    bench = harness.Bench(tiny_root)
    cell = harness.Cell(bench.traffic("tiny3.mixed"), bench.config("tiny3"), "cpu", SEED)
    assert [cell.op_of(i) for i in range(4)] == ["encode", "decode"] * 2
    assert [cell.group(i) for i in range(6)] == [0, 0, 1, 1, 0, 0] and cell.nreq_distinct == 4


@pytest.mark.parametrize("cell, mode", [("tiny3.rate2.write", "rate"), ("tiny3.psnr.write", "psnr")])
def test_mode_comes_from_the_traffic_file(tiny_root, one_thread, monkeypatch, cell, mode):
    seen = []
    comp3 = batched.TorchCompressor3D.compress

    def spy(self, vol, m, q):
        seen.append((m, q))
        return comp3(self, vol, m, q)

    monkeypatch.setattr(batched.TorchCompressor3D, "compress", spy)
    out = _run(tiny_root, cell)
    t = harness.Bench(tiny_root).traffic(cell)
    assert out["correct"] and set(seen) == {(mode, t["quality"])}


def test_window_keeps_one_answer_of_each_distinct_request():
    """A window runs requests until its time is up and keeps, of each
    distinct request, one answer drawn from the seed, in request order."""

    class Cell:
        op = "encode"
        ops = ("encode",)
        nreq_distinct = 3
        device = type("D", (), {"type": "cpu"})()

        def op_of(self, i):
            return "encode"

        def run_request(self, i):
            time.sleep(0.002)
            return i, 4, 0, {"chunks": 1}

    run = harness.Run(cell="c", op="encode", traffic={}, config={}, device_kind="cpu")
    kept = harness.window(Cell(), run, 0.05, 5, False)
    idx = [i for i, _ in kept]
    assert run.requests > 3 and run.wall_s >= 0.05
    assert run.bytes_in == 4 * run.requests and run.total("chunks") == run.requests
    assert idx == sorted(idx) and sorted(i % 3 for i in idx) == [0, 1, 2] and idx[-1] < run.requests
    assert all(i == a for i, a in kept)
    again = harness.window(Cell(), harness.Run(cell="c", op="encode", traffic={}, config={},
                                               device_kind="cpu"), 0.05, 6, False)
    assert len(again) == 3
