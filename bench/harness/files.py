"""The benchmark's data, found by the names in BENCHMARK.json: a cell's
configuration (`bench/configs/<config>.json`), the architecture and the
plain reference it names (`bench/arch/<reference>.py`,
`bench/reference/<reference>.py`), traffic mix
(`bench/traffic/<traffic>.json`), rate and limits (`bench/cells/<cell>.json`),
and each metric's reader (`bench/metrics/<metric>.py`). Adding any of them
is adding files.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                  # bench/configs/<config>.json
    mix: dict                     # bench/traffic/<traffic>.json
    cell: dict                    # bench/cells/<name>.json
    end_to_end: List[dict]        # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]
    traffic_dir: Path
    metrics_dir: Path
    arch_dir: Path
    reference_dir: Path


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, workload: str) -> Cell:
    """The cell named `workload` of `<root>/BENCHMARK.json`."""
    spec = _read(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(w['name'] for w in spec['workloads'])}")
    files = {c["name"]: c["file"] for c in spec["configs"]}
    bench = root / "bench"
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    # a per-layer metric without a cell list reports where its end-to-end
    # metric does
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _reports(m, workload)
             and ("workloads" in m or m["moves"] in moved)]
    return Cell(name=workload, chips=int(wl["chips"]),
                config=_read(root / files[wl["config"]]),
                mix=_read(bench / "traffic" / f"{wl['traffic']}.json"),
                cell=_read(bench / "cells" / f"{workload}.json"),
                end_to_end=e2e, per_layer=layer,
                traffic_dir=bench / "traffic", metrics_dir=bench / "metrics",
                arch_dir=bench / "arch", reference_dir=bench / "reference")


def _module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metrics_dir: Path, name: str):
    """`read(run)` of `<metrics_dir>/<name>.py`."""
    return _module(metrics_dir / f"{name}.py", "bench_metric_").read


def arch(arch_dir: Path, name: str):
    """The architecture module `<arch_dir>/<name>.py` (bench/arch/decoder.py
    says what it defines)."""
    return _module(arch_dir / f"{name}.py", "bench_arch_")


def reference(cell: Cell):
    """`forward(weights, config, prompts, kv_layers=..., fp8=...)` of the
    plain reference the cell's configuration names (its `reference` key):
    `bench/reference/<reference>.py`."""
    return _module(cell.reference_dir / f"{cell.config['reference']}.py",
                   "bench_reference_").forward

