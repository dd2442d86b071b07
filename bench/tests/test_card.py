"""On the card: one short run of the first cell through the command line,
a valid and correct result line. Skips without a card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_first_cell_runs_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen2.5-3b.qwentrace",
         "--seed", "2147483659", "--seconds", "5"], cwd=REPO,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
