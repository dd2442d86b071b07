"""Generator of a single-SLO chat trace: Poisson arrivals and ShareGPT-like
prompt lengths (paper §6.5; lognormal of the mix's mean and std, clipped).

A frozen copy of `repro_torch.traces.qwentrace.sharegpt_like`: the same
draws in the same order, so the copy gives the program's trace for the same
seed (bench/tests check it).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _lognormal_params(mean: float, std: float) -> Tuple[float, float]:
    sigma2 = math.log(1.0 + (std / mean) ** 2)
    mu = math.log(mean) - sigma2 / 2.0
    return mu, math.sqrt(sigma2)


def generate(n: int, rate: float, seed: int, mean: float = 330.0,
             std: float = 380.0, min_len: int = 16, max_len: int = 2048
             ) -> List[Tuple[float, int]]:
    """(arrival, prompt length) of n requests."""
    rng = np.random.default_rng(seed)
    mu, sigma = _lognormal_params(mean, std)
    out = []
    t = 0.0
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        out.append((t, int(np.clip(int(rng.lognormal(mu, sigma)), min_len,
                                   max_len))))
    return out


def draw(mix: dict, n: int, rate: float):
    """n requests at `rate` from the mix's base seed: (tasks, prompt lengths,
    inter-arrival gaps); every request is of the mix's one task."""
    reqs = generate(n, rate, mix["base_seed"], mix["mean"], mix["std"],
                    mix["min_len"], mix["max_len"])
    arrivals = np.asarray([t for t, _ in reqs])
    gaps = np.diff(arrivals, prepend=0.0)
    return [mix["task"]] * n, [m for _, m in reqs], gaps
