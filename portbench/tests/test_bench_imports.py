"""Nothing the benchmark runs loads jax or the JAX package; the reference
loads nothing of the program.  Top-level names are compared whole:
sperr_tpu_torch begins with sperr_tpu and is allowed."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

from portbench import harness

BENCH = os.path.join(ROOT, "portbench")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield 0, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.level, node.module or ""


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_forbidden_import(path):
    for level, name in _imports(path):
        if level == 0:
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for level, name in _imports(os.path.join(ref, f)):
                top = name.split(".")[0]
                assert top not in ("sperr_tpu_torch", "portbench"), (f, name)
                assert level <= 1, (f, name)  # nothing of the harness either


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sperr_tpu_torch_x", sys)
    assert "sperr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sperr_tpu.ops", sys)
    assert harness.forbidden_modules() == ["sperr_tpu"]


BLOCK = """
import sys, time
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "sperr_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from portbench import harness
out = harness.run_cell(harness.Bench({tiny!r}), "tiny3.pwe2.read", 5, 0.2, True, "cpu", time.perf_counter())
assert out["correct"], out
print("found", harness.forbidden_modules())
"""


def test_a_run_with_jax_blocked(tiny_root):
    code = BLOCK.format(root=ROOT, tests=os.path.dirname(__file__), tiny=tiny_root)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("found []")


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints nothing
    on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cube512.pwe2.write",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command fails and prints nothing on standard output."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("_build", "__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cube512.pwe2.write",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""
