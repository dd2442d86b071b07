"""A run's requests: the mix's generator draws a fixed trace of prompt
lengths and inter-arrival gaps from the mix's base seed, and the run's seed
draws the token ids.

So every seed offers the same work in the same order: the same lengths
meeting in the queue at the same times. With a score of requests in a
window, a seed that reordered them would move the median TTFT by a quarter
(the long prompts land before or after the short ones), far more than two
runs of one seed differ. The gaps are scaled to end at the window's close,
so the offered rate is exactly the cell's.
"""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclass
class Item:
    task: str
    n: int                  # prompt tokens
    slo: float              # TTFT SLO, seconds
    offset: float           # due time after the window opens, seconds
    tokens: np.ndarray      # prompt token ids


def generator(traffic_dir: Path, name: str):
    """The module `<traffic_dir>/<name>.py`, loaded from its file."""
    path = traffic_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_traffic_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def schedule(traffic_dir: Path, mix: dict, rate: float, seconds: float,
             seed: int, slos: Dict[str, float], vocab: int) -> List[Item]:
    n = max(1, round(rate * seconds))
    tasks, lengths, gaps = generator(traffic_dir, mix["generator"]).draw(
        mix, n, rate)
    rng = np.random.default_rng(seed)
    gaps = np.asarray(gaps, dtype=np.float64)
    due = np.cumsum(gaps) * (seconds / gaps.sum())
    items = []
    for task, m, offset in zip(tasks, lengths, due):
        m = int(m)
        items.append(Item(task=task, n=m, slo=float(slos[task]),
                          offset=float(offset),
                          tokens=rng.integers(0, vocab, m, dtype=np.int64)))
    return items
