"""On the card: each cell runs end to end and comes out correct, and at the
cell's own size the float32 control fails a limit that the program keeps."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.calibrate import readings
from benchmark.run import ROOT, Spec

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 5), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200, check=False)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    spec = Spec(BENCH, cell)
    r = readings(spec, 2**31 + 3, card, control=True)
    assert all(r["program"][k] <= v for k, v in spec.limits.items()), r
    assert any(r["control"][k] > v for k, v in spec.limits.items()), r
    torch.cuda.empty_cache()
