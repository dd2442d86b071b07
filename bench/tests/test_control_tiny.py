"""The control of the correctness limits at a size a test run holds: the
float8 reference in the program's place fails the tiny cells' limits,
which the program meets (bench/tests/data/cells hold the readings)."""
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from harness import check, files, main

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _control():
    spec = importlib.util.spec_from_file_location("control",
                                                  TOOLS / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", ["qwen2.5-tiny.qwentrace-tiny",
                                  "qwen3-moe-tiny.sharegpt-tiny"])
def test_the_float8_control_is_not_correct(cell, tiny_root):
    c = files.load(tiny_root, cell)
    limits = c.cell["limits"]
    for seed in (201, 202, 203):
        got = _control().readings(c, seed, 2.0, torch.device("cpu"))
        assert not check.judge(got, limits), got
        assert got["logit_err"] > 2 * limits["logit_err"]
        assert got["kv_err"] > 2 * limits["kv_err"]
        if "logit_outliers" in limits:
            # the control's median prompt lies over the per-request limit
            assert got["logit_outliers"] >= got["prompts"] / 2
    prog = main.run(tiny_root, cell, 201, 2.0, False, "cpu",
                    time.monotonic())
    assert prog["correct"], prog["checks"]
