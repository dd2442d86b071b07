"""Generator of a multi-task trace: Poisson arrivals, each request's task
drawn from the mix's ratios and its prompt length from the task's lognormal
fit (paper §6.1, Table 1).

A frozen copy of the non-sharing path of `repro_torch.traces.qwentrace`
(`_lognormal_params`, `sample_length`, `generate`), with the task table read
from the traffic file: the draws are the same, in the same order, so the
copy gives the program's trace for the same seed (bench/tests check it).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def lognormal_params(mean: float, std: float) -> Tuple[float, float]:
    sigma2 = math.log(1.0 + (std / mean) ** 2)
    mu = math.log(mean) - sigma2 / 2.0
    return mu, math.sqrt(sigma2)


def sample_length(table: Dict[str, dict], task: str, rng: np.random.Generator,
                  min_len: int = 16, max_len: int = 32768) -> int:
    mu, sigma = lognormal_params(table[task]["mean"], table[task]["std"])
    n = int(rng.lognormal(mu, sigma))
    return int(np.clip(n, min_len, max_len))


def _requests(table: Dict[str, dict], rate: float, seed: int, min_len: int,
              max_len: int):
    """(arrival, task, prompt length) in the program generator's draw order:
    the gap, the task, the length."""
    rng = np.random.default_rng(seed)
    tasks = list(table)
    probs = np.asarray([table[t]["ratio"] for t in tasks], dtype=np.float64)
    probs = probs / probs.sum()
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        task = tasks[int(rng.choice(len(tasks), p=probs))]
        yield t, task, sample_length(table, task, rng, min_len, max_len)


def generate(table: Dict[str, dict], rate: float, duration: float, seed: int,
             min_len: int = 16, max_len: int = 32768
             ) -> List[Tuple[float, str, int]]:
    """Every request that arrives before `duration`."""
    out = []
    for t, task, n in _requests(table, rate, seed, min_len, max_len):
        if t >= duration:
            return out
        out.append((t, task, n))


def draw(mix: dict, n: int, rate: float):
    """The first n requests of the mix's trace at `rate` from its base seed:
    (tasks, prompt lengths, inter-arrival gaps)."""
    tasks, lengths, gaps = [], [], []
    last = 0.0
    for t, task, m in _requests(mix["tasks"], rate, mix["base_seed"],
                                mix["min_len"], mix["max_len"]):
        if len(tasks) == n:
            break
        tasks.append(task)
        lengths.append(m)
        gaps.append(t - last)
        last = t
    return tasks, lengths, np.asarray(gaps)
