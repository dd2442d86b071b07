"""The benchmark's own arithmetic: percentiles with unfinished requests as
+inf, the union of busy intervals, goodput, and the operations and bytes of
the model and of the prefill-attention kernel on the published peaks of one
H100.

Copied from the program so that a later change to it cannot move the
yardstick: `percentile` follows numpy's linear rule as
`repro_torch.core.metrics.percentile_stats` uses it, `attention_work` is
chip_smoke.py's `prefill_work` with its pair sum in closed form.
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


def attention_work(Sq: int, q_offset: int, H: int, K: int, hd: int,
                   es: int) -> Tuple[float, float]:
    """Operations and bytes one causal chunk of Sq queries at q_offset needs
    in one layer (no window): 4*hd per visible (query, key) pair and head;
    q and o once, and k and v once for each of the q_offset + Sq keys."""
    kv_len = q_offset + Sq
    pairs = Sq * q_offset + Sq * (Sq + 1) // 2
    return 4.0 * hd * H * pairs, es * (2 * Sq * H * hd + 2 * kv_len * K * hd)


def prompt_attention_bound(n: int, chunk: int, layers: int, H: int, K: int,
                           hd: int, es: int) -> float:
    """Least seconds the prefill-attention launches of an n-token prompt
    chunked by `chunk` could take: per chunk and layer the larger of its
    operations over the bf16 peak and its bytes over HBM bandwidth."""
    total = 0.0
    for lo in range(0, n, chunk):
        ops, nbytes = attention_work(min(chunk, n - lo), lo, H, K, hd, es)
        total += max(ops / PEAK_BF16_OPS, nbytes / HBM_BYTES_PER_S)
    return total * layers


def model_flops(n: int, *, layers: int, d: int, H: int, K: int, hd: int,
                d_ff: int, vocab: int, experts: int = 0, top_k: int = 0
                ) -> float:
    """Model FLOPs of an n-token prefill: 2 per multiply-add of every matrix
    a token touches (q, k, v and o projections; the SwiGLU FFN, or the
    router and the top_k routed experts, not all of them), 4*hd*H per
    visible causal pair and layer, and the LM head at the last position."""
    proj = d * (H + 2 * K) * hd + H * hd * d
    ffn = d * experts + top_k * 3 * d * d_ff if experts else 3 * d * d_ff
    pairs = n * (n + 1) // 2
    return layers * (2.0 * n * (proj + ffn) + 4.0 * hd * H * pairs) \
        + 2.0 * d * vocab
