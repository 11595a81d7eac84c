"""On a card: each cell's control, at the cell's own size, comes out not
correct on three seeds, and a sound run of the cell comes out correct
(``python -m pytest portbench/tests -m chip``; several minutes a cell on
one H100, most of it set-up and the check)."""

import json
import subprocess
import sys

import pytest
import torch

from test_bench_files import CELLS

from conftest import ROOT


def _run(cell, seed, *extra):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
                        "--seconds", "1", "--trace", "0", *extra],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cuda, cell):
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = _run(cell, seed, "--control")
        assert not out["correct"], (seed, out["checks"])


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_the_card(cuda, cell):
    out = _run(cell, 2**31 + 4)
    assert out["correct"], out["checks"]
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
