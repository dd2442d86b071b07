"""The benchmark's own arithmetic, the same for every architecture:
percentiles with unfinished requests as +inf, the union of busy intervals,
goodput, and the published peaks of one H100. What depends on the model
(its operations and bytes) is its architecture's, in bench/arch/.

Copied from the program so that a later change to it cannot move the
yardstick: `percentile` follows numpy's linear rule as
`repro_torch.core.metrics.percentile_stats` uses it.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM at 700 W: dense bf16 tensor-core rate, HBM3
PEAK_BF16_OPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def percentile(values: Sequence[float], q: float) -> float:
    """numpy's linear-interpolation percentile, where a value may be +inf:
    a rank that lands on or past an infinite value reads +inf."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    rank = q / 100.0 * (len(v) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(v) - 1)
    frac = rank - lo
    if frac == 0.0 or v[lo] == v[hi]:
        return v[lo]
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * frac


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def length(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def intersect(a: Sequence[Tuple[float, float]],
              b: Sequence[Tuple[float, float]]) -> List[Tuple[int, float]]:
    """(index into a, length) of each piece of the intersection of two
    sorted disjoint interval lists."""
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((i, e - s))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap(a: Sequence[Tuple[float, float]],
            b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    return sum(x for _, x in intersect(a, b))


def goodput(ttfts: Sequence[float], slos: Sequence[float],
            seconds: float) -> float:
    """Requests whose TTFT met their SLO per second of the window; an
    unfinished request (TTFT +inf) misses."""
    met = sum(1 for t, s in zip(ttfts, slos) if t <= s + 1e-9)
    return met / seconds
