"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests marked ``chip`` need a CUDA device: they take the ``cuda`` fixture,
which decides at run time and skips without one.  ``tiny_root`` is a copy of
the benchmark's data files with two small configurations and seven small
cells added as new files, so that the harness runs on the CPU in seconds.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIGS = {
    "tiny3": ("cube512", {"dims": [64, 64, 32], "chunk_dims": [32, 32, 32]}),
    "tiny2": ("atm2d", {"dims": [96, 64]}),
}
TINY_CELLS = {
    "tiny3.pwe3.write": ("tiny3", {"op": "encode", "rel_tol": 1e-3, "fields": 2, "batch": 1,
                                   "limits": {"err64": 1.0, "err32": 1.0}}),
    "tiny3.pwe2.read": ("tiny3", {"op": "decode", "rel_tol": 1e-2, "fields": 2, "batch": 1,
                                  "limits": {"gap": 0.001, "err32": 1.0}}),
    "tiny2.pwe3.write": ("tiny2", {"op": "encode", "rel_tol": 1e-3, "fields": 4, "batch": 2,
                                   "limits": {"err64": 1.0, "err32": 1.0}}),
    "tiny2.pwe3.read": ("tiny2", {"op": "decode", "rel_tol": 1e-3, "fields": 4, "batch": 2,
                                  "limits": {"gap": 0.1, "err32": 1.0}}),
    # the planned rate, PSNR and mixed cells' kinds, as data files alone
    "tiny3.rate2.write": ("tiny3", {"op": "encode", "mode": "rate", "quality": 2.0, "fields": 2,
                                    "batch": 1, "limits": {"bpp": 2.01, "gap": 1e-4}}),
    "tiny3.psnr.write": ("tiny3", {"op": "encode", "mode": "psnr", "quality": 60.0, "fields": 2,
                                   "batch": 1, "limits": {"psnr_gap_db": 0.5, "gap": 1e-4}}),
    "tiny3.mixed": ("tiny3", {"op": ["encode", "decode"], "rel_tol": 1e-2, "fields": 2, "batch": 1,
                              "limits": {"err64": 1.0, "err32": 1.0, "gap": 0.1}}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def add_files(root: str, configs=TINY_CONFIGS, cells=TINY_CELLS) -> None:
    """Add configurations and cells to the benchmark under ``root`` as new
    files and new entries of its BENCHMARK.json, nothing else changed."""
    bpath = os.path.join(root, "BENCHMARK.json")
    with open(bpath) as f:
        bench = json.load(f)
    folder = os.path.join(root, "portbench")
    for name, (base, changes) in configs.items():
        with open(os.path.join(folder, "configs", f"{base}.json")) as f:
            cfg = json.load(f)
        cfg.update(changes, name=name)
        rel = f"portbench/configs/{name}.json"
        with open(os.path.join(root, rel), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": cfg["source"], "file": rel,
                                 "reduced": sorted(changes), "why": "a size the CPU runs in seconds"})
    for name, (cfg, traffic) in cells.items():
        t = dict(traffic, name=name, config=cfg, why="a size the CPU runs in seconds")
        with open(os.path.join(folder, "workloads", f"{name}.json"), "w") as f:
            json.dump(t, f)
        bench["workloads"].append({"name": name, "config": cfg, "traffic": name.split(".", 1)[1],
                                   "chips": 1, "why": t["why"]})
        ops = [t["op"]] if isinstance(t["op"], str) else t["op"]
        moves = {"encode": "encode_GBps", "decode": "decode_GBps"}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(moves[o] in (m["name"], m.get("moves")) for o in ops):
                m["workloads"].append(name)
    with open(bpath, "w") as f:
        json.dump(bench, f, indent=1)


def copy_bench(dst: str) -> str:
    """BENCHMARK.json and the benchmark's data and metric files under
    ``dst``; the harness and the reference stay the repository's."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub), os.path.join(dst, "portbench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "portbench", "peaks.json"), os.path.join(dst, "portbench"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = copy_bench(str(tmp_path_factory.mktemp("bench")))
    add_files(root)
    return root


@pytest.fixture
def one_thread():
    """Torch on one thread: several pytest workers on a few cores otherwise
    make the port's many small CPU ops far slower."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
