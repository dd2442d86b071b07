"""The harness end to end on the CPU at the tiny configurations: a valid
result on each mix and configuration, traced and not; the command line
refuses to run without the cards it needs."""
import json
import math
import subprocess
import sys
import time

import pytest

from harness import main

CELLS = ["qwen2.5-tiny.qwentrace-tiny", "qwen2.5-tiny.sharegpt-tiny",
         "qwen3-moe-tiny.qwentrace-tiny", "qwen3-moe-tiny.sharegpt-tiny"]


def _valid(out: dict, spec: dict, cell: str, trace: bool, limits) -> None:
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(limits)
    for c in out["checks"].values():
        assert math.isfinite(c["value"]) and c["limit"] >= 0
    json.loads(json.dumps(out, allow_nan=False))
    want = [m for m in (spec["per_layer"] if trace else spec["end_to_end"])
            if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in want}
    for name, m in out["metrics"].items():
        assert name in names
        assert math.isfinite(m["value"])
        assert m["unit"] == next(x["unit"] for x in want if x["name"] == name)
    if not trace:
        assert set(out["metrics"]) == names


def _limits(root, cell):
    return json.loads((root / "bench" / "cells" / f"{cell}.json")
                      .read_text())["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_and_is_correct(cell, tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    out = main.run(tiny_root, cell, 2 ** 31 + 77, 2.0, False, "cpu",
                   time.monotonic())
    _valid(out, spec, cell, False, _limits(tiny_root, cell))
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] == 12
    assert out["metrics"]["goodput_rps"]["value"] <= 6.0


def test_a_traced_run_reads_the_host_side_metrics(tiny_root):
    cell = "qwen3-moe-tiny.qwentrace-tiny"
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    out = main.run(tiny_root, cell, 5, 2.0, True, "cpu", time.monotonic())
    _valid(out, spec, cell, True, _limits(tiny_root, cell))
    assert out["correct"]
    # nothing ran on a device: the device-trace readers return nothing
    assert "prefill_attn_roofline" not in out["metrics"]
    assert {"preemptions_per_req", "prefill_mfu", "ttft_median_ms"} <= \
        set(out["metrics"])
    assert out["device"]["window_s"] > 2.0
    assert out["breakdown"] == {"device_ops": [], "idle_gaps": []}


def test_the_command_needs_a_card():
    """Without a card: a code other than 0, and no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(main.__file__).replace("harness/main.py",
                                                    "run.py"),
         "--workload", "qwen2.5-3b.qwentrace", "--seed", "1", "--seconds",
         "1"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
