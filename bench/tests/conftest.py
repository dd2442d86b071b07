"""Fixtures of the benchmark's CPU tests: a checkout-like root in a
temporary directory, holding the benchmark's files and, beside its real
cells, tiny cells (tests/data) that run through the port's plain kernels on
the CPU in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
for p in (str(REPO / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny stand-in of each real configuration and mix
TINY = {"qwen2.5-3b": "qwen2.5-tiny", "qwen3-30b-a3b": "qwen3-moe-tiny",
        "qwentrace": "qwentrace-tiny", "sharegpt": "sharegpt-tiny"}


def tiny_name(cell: str) -> str:
    config, mix = cell.rsplit(".", 1)
    return f"{TINY[config]}.{TINY[mix]}"


def make_root(dest: Path) -> Path:
    """A root holding bench/ (without its tests) and a BENCHMARK.json whose
    cells are the tiny ones and whose metrics are the real file's."""
    shutil.copytree(BENCH, dest / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for sub in ("configs", "cells", "traffic"):
        for f in (DATA / sub).iterdir():
            shutil.copy(f, dest / "bench" / sub / f.name)
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    tiny = json.loads((DATA / "tiny_cells.json").read_text())
    for key in ("command", "paths", "run_seconds"):
        tiny[key] = real[key]
    for key in ("end_to_end", "per_layer"):
        tiny[key] = []
        for m in real[key]:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [tiny_name(w) for w in m["workloads"]]
            tiny[key].append(m)
    (dest / "BENCHMARK.json").write_text(json.dumps(tiny, indent=1))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
