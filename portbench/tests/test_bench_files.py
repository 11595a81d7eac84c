"""BENCHMARK.json against the benchmark's contract, and every configuration,
cell and metric file found by its name; new files are found without an edit
to a file that is there."""

import json
import math
import os
import re

import pytest

from conftest import ROOT, add_files, copy_bench

from portbench import check, harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim|_rank|head|expansion)")


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        names = [e["name"] for e in SPEC[group]]
        assert len(set(names)) == len(names) and 1 <= len(names) <= 24
        for e in SPEC[group]:
            assert set(e) == keys and NAME.match(e["name"]) and _line(e["why"])
    names = METRICS
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs_and_cells_agree():
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/") and _line(c["source"])
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"]) and four <= max(1, len(pairs) // 4)
    for w in SPEC["workloads"]:
        assert w["config"] in CONFIGS and NAME.match(w["traffic"])


def test_metrics_reach_every_cell():
    e2e = SPEC["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in e2e}
        if m["unit"] == "%" or m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and re.search(r"_roofline", m["name"])
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        for cell in m.get("workloads", []):
            assert cell in CELLS
            moved = next(e for e in e2e if e["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)
    bench = harness.Bench(ROOT)
    for cell in CELLS:
        reported = [m["name"] for m in bench.metrics(cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.metrics(cell, True)


@pytest.mark.parametrize("name", CELLS)
def test_cell_file_loads_by_name(name):
    bench = harness.Bench(ROOT)
    t = bench.traffic(name)
    spec = bench.cell(name)
    assert t["name"] == name and t["config"] == spec["config"] and t["why"] == spec["why"]
    ops = [t["op"]] if isinstance(t["op"], str) else t["op"]
    assert ops and set(ops) <= {"encode", "decode"} and t["fields"] % t.get("batch", 1) == 0
    known = set(check.ENCODE if "encode" in ops else ()) | set(check.DECODE if "decode" in ops else ())
    assert t["limits"] and set(t["limits"]) <= known
    if t.get("mode", "pwe") == "pwe":  # the configuration's guarantee, under both decoders
        assert "rel_tol" in t and "err32" in t["limits"]
        assert "encode" not in ops or "err64" in t["limits"]
    assert all(math.isfinite(v) and v > 0 for v in t["limits"].values())


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_loads_by_name(name):
    cfg = harness.Bench(ROOT).config(name)
    assert cfg["name"] == name and cfg["dtype"] == "float32" and len(cfg["dims"]) in (2, 3)
    assert {"slope", "k_cut"} <= set(cfg["fields"]) and cfg["compressor"]["pwe_strict"] is True
    assert cfg["control"]["dtype"] == "bfloat16" and "assumed" in cfg


@pytest.mark.parametrize("name", METRICS)
def test_metric_file_loads_by_name(name):
    read = harness.Bench(ROOT).reader(name)
    # a run of the other kind, with no trace and no requests, reads nothing
    run = harness.Run(cell="x", op="none", traffic={}, config={}, device_kind="cpu")
    assert read(run) is None or name == "setup_s"


def test_new_files_are_found(tmp_path):
    """A configuration, a cell and a per-layer metric added as files of their
    own, with entries added to BENCHMARK.json, are found by name; no file
    that was there is edited."""
    root = copy_bench(str(tmp_path))
    before = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                before[os.path.join(d, f)] = fh.read()
    add_files(root)
    with open(os.path.join(root, "portbench", "metrics", "requests_done.py"), "w") as f:
        f.write("def read(run):\n    return float(run.requests) if run.requests else None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "entry points", "moves": "encode_GBps",
                              "workloads": ["tiny3.pwe3.write"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for path, data in before.items():
        with open(path, "rb") as fh:
            assert fh.read() == data, path
    bench = harness.Bench(root)
    assert bench.config("tiny3")["dims"] == [64, 64, 32]
    assert bench.traffic("tiny2.pwe3.write")["batch"] == 2
    assert "requests_done" in [m["name"] for m in bench.metrics("tiny3.pwe3.write", True)]
    assert "requests_done" not in [m["name"] for m in bench.metrics("tiny2.pwe3.write", True)]
    run = harness.Run(cell="tiny3.pwe3.write", op="encode", traffic={}, config={}, device_kind="cpu",
                      latencies=[0.5, 0.25])
    assert bench.reader("requests_done")(run) == 2.0


def test_split_name_reads_its_base_file(tmp_path):
    """A split metric without a file of its own (``device_idle.mixed``) is
    read by the file of its base name; a file of its own comes first."""
    root = copy_bench(str(tmp_path))
    bench = harness.Bench(root)
    base = os.path.join(root, "portbench", "metrics", "device_idle.py")
    assert bench.reader("device_idle.mixed").__code__.co_filename == base
    with open(os.path.join(root, "portbench", "metrics", "device_idle.mixed.py"), "w") as f:
        f.write("def read(run):\n    return 0.5\n")
    run = harness.Run(cell="x", op="mixed", ops=("encode", "decode"), traffic={}, config={}, device_kind="cpu")
    assert bench.reader("device_idle.mixed")(run) == 0.5 and bench.reader("device_idle.encode")(run) is None
