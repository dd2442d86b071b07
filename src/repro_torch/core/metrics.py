"""SLO attainment, percentile, and goodput metrics (FlowPrefill §6.1).

Two goodput notions coexist (docs/BENCHMARKS.md, docs/TRACES.md):

  * ``max_goodput`` — attainment-gated: the maximum sustainable rate at an
    SLO-*attainment* goal (90% of requests meet their SLO). This is the
    paper's Fig. 9 definition and what fig9/18/19/20/22 gate on.
  * ``percentile_goodput`` — tail-gated: the maximum rate whose p99
    SLO-normalized latency still meets the SLO (p99(latency/SLO) <= 1).
    Production SLOs are written against tails, not means, and mean- vs
    p99-gated comparisons can ORDER policies differently ("Optimal
    Scheduling Algorithms for LLM Inference", PAPERS.md) — fig23 gates the
    stress-scenario suite on this one.

Percentile families report p50/p90/p99 for TTFT and TBT, per task class and
aggregate. Unfinished requests contribute +inf to normalized-latency
percentiles — a request that never produced its first token can never
improve a tail statistic.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.request import Request

PERCENTILES = (50.0, 90.0, 99.0)


def slo_attainment(requests: Sequence[Request]) -> float:
    """Fraction of requests meeting their TTFT SLO, over ALL submitted
    requests: an unfinished or dropped request counts as a violation (it
    stays in the denominator with ``slo_met == False``), so mid-run or
    partial reports can never inflate attainment by shrinking the
    denominator. (An earlier version filtered on ``arrival is not None`` —
    dead code, ``arrival`` is a float — which read as if unfinished work
    were excluded; it never was, and now the contract is explicit.)"""
    if not requests:
        return 1.0
    return sum(1 for r in requests if r.slo_met) / len(requests)


def attainment_by_task(requests: Sequence[Request]) -> Dict[str, float]:
    by: Dict[str, List[Request]] = {}
    for r in requests:
        by.setdefault(r.task_type, []).append(r)
    return {t: slo_attainment(rs) for t, rs in by.items()}


def percentile_stats(values: Sequence[float]) -> Dict[str, float]:
    """{mean, p50, p90, p99, max} of a latency sample (zeros when empty)."""
    if len(values) == 0:
        return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0, "max": 0.0}
    a = np.asarray(values, dtype=np.float64)
    out = {"mean": float(a.mean()), "max": float(a.max())}
    for q in PERCENTILES:
        out[f"p{q:.0f}"] = float(np.percentile(a, q))
    return out


def ttft_stats(requests: Sequence[Request]) -> Dict[str, float]:
    """TTFT percentile family over FINISHED requests (unfinished requests
    have no TTFT sample; they are violations in `slo_attainment` and +inf in
    `slo_frac_percentile`, which is where tail gating should look)."""
    return percentile_stats([r.ttft for r in requests if r.ttft is not None])


def tbt_stats(requests: Sequence[Request]) -> Dict[str, float]:
    """Mean-TPOT (TBT) percentile family over requests that decoded."""
    return percentile_stats([r.mean_tpot for r in requests
                             if r.output_tokens > 0
                             and r.mean_tpot is not None])


def stats_by_task(requests: Sequence[Request],
                  phase: str = "ttft") -> Dict[str, Dict[str, float]]:
    """Per-task-class percentile families: {task: {mean, p50, p90, p99,
    max}}. ``phase`` is "ttft" or "tbt"."""
    fn = ttft_stats if phase == "ttft" else tbt_stats
    by: Dict[str, List[Request]] = {}
    for r in requests:
        by.setdefault(r.task_type, []).append(r)
    return {t: fn(rs) for t, rs in sorted(by.items())}


def slo_frac_percentile(requests: Sequence[Request], q: float = 99.0,
                        phase: str = "ttft") -> float:
    """Percentile of SLO-NORMALIZED latency: ttft/slo ("ttft"), mean-TPOT /
    tbt_slo ("tbt"), or the per-request max of both ("e2e"). <= 1.0 means
    that percentile of requests met the SLO. Normalizing makes the statistic
    comparable across the heterogeneous per-task SLOs of the QwenTrace mix —
    a raw-seconds p99 would just be the slowest task class's tail.

    Unfinished requests contribute +inf (a missing first token IS a tail
    event); requests with no decode phase contribute nothing to "tbt" and
    only their TTFT fraction to "e2e". Returns 0.0 on an empty sample."""
    fracs: List[float] = []
    for r in requests:
        parts: List[float] = []
        if phase in ("ttft", "e2e"):
            parts.append(r.ttft / r.slo if r.ttft is not None else np.inf)
        if phase in ("tbt", "e2e") and r.output_tokens > 0 \
                and np.isfinite(r.tbt_slo) and r.tbt_slo > 0:
            parts.append(r.mean_tpot / r.tbt_slo
                         if r.mean_tpot is not None else np.inf)
        if parts:
            fracs.append(max(parts))
    if not fracs:
        return 0.0
    a = np.asarray(fracs, dtype=np.float64)
    if np.isinf(a).any():
        # linear interpolation between two +inf order statistics is nan;
        # fall back to the nearest actual sample, which keeps the result
        # inf exactly when the percentile position lands in the inf tail
        return float(np.percentile(a, q, method="lower"))
    return float(np.percentile(a, q))


def max_goodput(rates: Sequence[float], attainments: Sequence[float],
                target: float = 0.9) -> float:
    """Largest rate whose attainment >= target, with linear interpolation to
    the crossing point (the vertical lines in the paper's Fig. 9)."""
    rates = np.asarray(rates, dtype=np.float64)
    att = np.asarray(attainments, dtype=np.float64)
    order = np.argsort(rates)
    rates, att = rates[order], att[order]
    if att[0] < target:
        return 0.0
    best = rates[0]
    for i in range(1, len(rates)):
        if att[i] >= target:
            best = rates[i]
        else:
            # interpolate crossing between i-1 and i
            r0, r1, a0, a1 = rates[i - 1], rates[i], att[i - 1], att[i]
            if a0 != a1:
                best = r0 + (a0 - target) * (r1 - r0) / (a0 - a1)
            break
    return float(best)


def percentile_goodput(rates: Sequence[float], p99_fracs: Sequence[float],
                       target: float = 1.0) -> float:
    """Largest rate whose p99 SLO-normalized latency (`slo_frac_percentile`)
    still meets the SLO (<= target), interpolating to the crossing point —
    the tail-gated counterpart of `max_goodput` (values here are
    lower-is-better, so the crossing is upward). Infinite tail values
    (unfinished requests) clamp the crossing to the last feasible measured
    rate: there is nothing meaningful to interpolate toward."""
    rates = np.asarray(rates, dtype=np.float64)
    vals = np.asarray(p99_fracs, dtype=np.float64)
    order = np.argsort(rates)
    rates, vals = rates[order], vals[order]
    if vals[0] > target:
        return 0.0
    best = rates[0]
    for i in range(1, len(rates)):
        if vals[i] <= target:
            best = rates[i]
        else:
            r0, r1 = rates[i - 1], rates[i]
            v0, v1 = vals[i - 1], vals[i]
            if np.isfinite(v1) and v0 != v1:
                best = r0 + (target - v0) * (r1 - r0) / (v1 - v0)
            break
    return float(best)


def min_slo_scale(scales: Sequence[float], attainments: Sequence[float],
                  target: float = 0.9) -> float:
    """Smallest SLO scale whose attainment >= target (paper Fig. 9 row 2)."""
    scales = np.asarray(scales, dtype=np.float64)
    att = np.asarray(attainments, dtype=np.float64)
    order = np.argsort(scales)
    scales, att = scales[order], att[order]
    for s, a in zip(scales, att):
        if a >= target:
            return float(s)
    return float("inf")


def percentile_report(requests: Sequence[Request],
                      by_task: bool = True) -> dict:
    """The full percentile family as one nested dict — the shape shared by
    `ClusterResult.percentiles()` and `Proxy.report()['percentiles']`:

        {"ttft": {...}, "tbt": {...},
         "ttft_p99_norm": float, "tbt_p99_norm": float, "e2e_p99_norm": float,
         "by_task": {task: {"ttft": {...}, "tbt": {...}}}}
    """
    out: dict = {
        "ttft": ttft_stats(requests),
        "tbt": tbt_stats(requests),
        "ttft_p99_norm": slo_frac_percentile(requests, 99.0, "ttft"),
        "tbt_p99_norm": slo_frac_percentile(requests, 99.0, "tbt"),
        "e2e_p99_norm": slo_frac_percentile(requests, 99.0, "e2e"),
    }
    if by_task:
        ttft_by = stats_by_task(requests, "ttft")
        tbt_by = stats_by_task(requests, "tbt")
        out["by_task"] = {t: {"ttft": ttft_by[t], "tbt": tbt_by[t]}
                          for t in ttft_by}
    return out
