"""Synthetic QwenTrace (paper §6.1, Table 1 / Fig. 1).

The real trace [53] is not shipped with the paper; we generate a synthetic
trace matching its published per-task statistics exactly: four task types with
the Table 1 prompt-length distributions (lognormal fits to mean/std — the fit
reproduces the published P99s within ~5%), mixture ratios, Poisson (or bursty
Gamma) arrivals, and the Table 2 TTFT SLOs. The paper itself uses randomly
generated token IDs of the specified lengths, so content is immaterial.

Shared-prefix structure (prefix-cache workloads, benchmarks/fig22): real
production prompts share massive prefixes — per-task system prompts /
few-shot templates, and multi-turn conversations that resubmit the whole
history. ``shared_prefix_frac`` gives every request of a task class a common
leading template (sized as that fraction of the class's mean length);
``multi_turn_prob`` makes a request a follow-up that extends an earlier
conversation's full prompt. Both populate `Request.prefix_hash` — the block
hash chain (`repro_torch.core.prefixcache.chain_extend` semantics) that the
cache-residency model and prefix-affinity dispatch key on: equal leading
keys == equal leading tokens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.prefixcache import chain_extend
from repro_torch.core.request import Request

# Table 1: prompt length stats per task type
TABLE1 = {
    #                 mean   p99    std   ratio
    "text":   dict(mean=590,  p99=3040,  std=652,  ratio=0.68),
    "image":  dict(mean=532,  p99=2764,  std=510,  ratio=0.08),
    "search": dict(mean=5976, p99=16635, std=3456, ratio=0.20),
    "file":   dict(mean=6833, p99=22390, std=5186, ratio=0.04),
}

# Table 2: TTFT SLOs (seconds) per model
TABLE2_SLO = {
    "llama3-8b":   {"text": 0.25, "image": 0.5, "search": 4.0, "file": 6.0},
    "qwen2.5-14b": {"text": 0.4,  "image": 0.8, "search": 6.5, "file": 9.0},
    "llama3-70b":  {"text": 1.0,  "image": 2.0, "search": 15.0, "file": 18.0},
    # MoE generality model (§6.5) — between 8B and 14B dense cost
    "qwen3-30b-a3b": {"text": 0.4, "image": 0.8, "search": 6.5, "file": 9.0},
}


def _lognormal_params(mean: float, std: float):
    sigma2 = math.log(1.0 + (std / mean) ** 2)
    mu = math.log(mean) - sigma2 / 2.0
    return mu, math.sqrt(sigma2)


def sample_length(task: str, rng: np.random.Generator,
                  min_len: int = 16, max_len: int = 32768) -> int:
    t = TABLE1[task]
    mu, sigma = _lognormal_params(t["mean"], t["std"])
    n = int(rng.lognormal(mu, sigma))
    return int(np.clip(n, min_len, max_len))


@dataclass
class TraceConfig:
    model: str = "llama3-8b"
    rate: float = 2.0                 # requests / second
    duration: float = 60.0            # seconds
    slo_scale: float = 1.0            # Fig. 9 row 2 sweeps this
    burstiness: float = 1.0           # 1 = Poisson; >1 = bursty (Gamma CV)
    seed: int = 0
    task_ratios: Optional[Dict[str, float]] = None
    max_len: int = 32768
    # decode phase (cluster end-to-end accounting); 0 = prefill-only trace
    output_mean: float = 0.0          # mean output length (lognormal)
    output_std: float = 0.0           # 0 -> defaults to output_mean
    tbt_slo: float = 0.1              # per-token TBT SLO when decoding
    # heterogeneous TBT SLOs per task type (e.g. tight for interactive text,
    # loose for search/file agents) — the workload where slack-aware decode
    # admission wins; unlisted tasks fall back to `tbt_slo`
    tbt_slo_by_task: Optional[Dict[str, float]] = None
    # speculative decoding: per-task draft accept probability stamped onto
    # Request.spec_accept (drafts hit well on templated/file tasks, poorly
    # on freeform text). None = legacy trace, spec_accept stays 0.0 —
    # bit-identical requests; unlisted tasks also get 0.0.
    spec_accept_by_task: Optional[Dict[str, float]] = None
    # shared-prefix structure (0.0/0.0 = the original trace, prefix_hash
    # left None — bit-identical requests)
    shared_prefix_frac: float = 0.0   # of each class's MEAN length: the
                                      # class-wide system-prompt template
    multi_turn_prob: float = 0.0      # P(request extends a prior same-class
                                      # conversation's full prompt)
    prefix_block: int = 128           # hash-chain block granularity (tokens)
    multi_turn_window: int = 32       # recent conversations eligible as
                                      # parents (live sessions, not all time)
    # named production/stress scenario (repro_torch.traces.scenarios): when set,
    # generate() delegates to the scenario's fitted generator — lognormal/
    # Gamma distributions fitted from summary statistics and session-
    # structured multi-turn chains replace the uniform knobs above. The
    # sweep knobs (rate/duration/seed/model/slo_scale/max_len/prefix_block)
    # keep their meaning; docs/TRACES.md specifies each scenario.
    scenario: Optional[str] = None


def generate(cfg: TraceConfig) -> List[Request]:
    if cfg.scenario is not None:
        # fitted/stress scenarios own their whole generation path; the
        # legacy uniform-knob path below stays byte-identical for every
        # existing trace (committed fig9/18/19/20/22 baselines depend on it)
        from repro_torch.traces.scenarios import generate_scenario
        return generate_scenario(cfg)
    rng = np.random.default_rng(cfg.seed)
    ratios = cfg.task_ratios or {k: v["ratio"] for k, v in TABLE1.items()}
    tasks = list(ratios)
    probs = np.asarray([ratios[t] for t in tasks], dtype=np.float64)
    probs = probs / probs.sum()
    slos = TABLE2_SLO[cfg.model]

    sharing = cfg.shared_prefix_frac > 0 or cfg.multi_turn_prob > 0
    bs = cfg.prefix_block
    # per-class system-prompt template: a fixed-content (fixed hash chain)
    # leading segment every request of the class shares
    tpl_keys: Dict[str, tuple] = {}
    tpl_len: Dict[str, int] = {}
    if sharing:
        for ti, task in enumerate(tasks):
            n = int(cfg.shared_prefix_frac * TABLE1[task]["mean"])
            tpl_len[task] = n
            tpl_keys[task] = chain_extend((), range(n // bs), salt=1000 + ti)
    # recent conversations per class: (prompt_len, full-block hash chain)
    history: Dict[str, List] = {task: [] for task in tasks}
    uid = 0

    out: List[Request] = []
    t = 0.0
    mean_gap = 1.0 / cfg.rate
    while t < cfg.duration:
        if cfg.burstiness == 1.0:
            gap = rng.exponential(mean_gap)
        else:
            # Gamma interarrival with CV = burstiness (shape k = 1/CV^2)
            k = 1.0 / (cfg.burstiness ** 2)
            gap = rng.gamma(k, mean_gap / k)
        t += gap
        if t >= cfg.duration:
            break
        task = tasks[int(rng.choice(len(tasks), p=probs))]
        out_tokens = 0
        if cfg.output_mean > 0:
            mu, sigma = _lognormal_params(cfg.output_mean,
                                          cfg.output_std or cfg.output_mean)
            out_tokens = int(np.clip(int(rng.lognormal(mu, sigma)), 1, 8192))
        tbt = (cfg.tbt_slo_by_task or {}).get(task, cfg.tbt_slo)
        n_tok = sample_length(task, rng, max_len=cfg.max_len)
        keys = None
        if sharing:
            uid += 1
            hist = history[task]
            if hist and rng.random() < cfg.multi_turn_prob:
                # follow-up turn: the parent's whole prompt is the prefix,
                # the new sample is the appended user turn + response recap
                parent_len, parent_keys = hist[
                    int(rng.integers(len(hist)))]
                n_tok = parent_len + max(n_tok // 2, 16)
                base_keys, base_len = parent_keys, parent_len
            else:
                # fresh conversation: class template + unique remainder
                base_keys, base_len = tpl_keys[task], tpl_len[task]
                n_tok = max(n_tok, base_len + 16)
            # max_len binds the TOTAL prompt, template included — a tight
            # max_len truncates the shared base rather than exceeding the
            # length contract callers size max_seq from
            n_tok = min(n_tok, cfg.max_len)
            n_full = n_tok // bs
            # blocks fully inside the shared base keep its chain; the
            # boundary block (base tail + unique start) and everything
            # after hash uniquely for this request
            shared_full = min(base_len // bs, len(base_keys), n_full)
            keys = chain_extend(base_keys[:shared_full],
                                range(n_full - shared_full), salt=uid)
            hist.append((n_tok, keys))
            del hist[:-cfg.multi_turn_window]
        out.append(Request(
            num_tokens=n_tok,
            slo=slos[task] * cfg.slo_scale,
            arrival=t,
            task_type=task,
            output_tokens=out_tokens,
            tbt_slo=tbt if out_tokens else float("inf"),
            prefix_hash=keys,
            spec_accept=(cfg.spec_accept_by_task or {}).get(task, 0.0),
        ))
    return out


def oracle_hit_rate(requests: Sequence[Request],
                    prefix_block: int = 128) -> float:
    """Trace-intrinsic prefix-cache hit rate: the fraction of prompt tokens
    an UNBOUNDED single cache would serve from blocks already produced by
    earlier requests (arrival order). The upper bound any finite,
    partitioned (per-instance) cache can approach — fig22 sweeps traces by
    this number."""
    seen: set = set()
    hit_tokens = 0
    total = 0
    for r in sorted(requests, key=lambda r: r.arrival):
        total += r.num_tokens
        if not r.prefix_hash:
            continue
        run = 0
        for k in r.prefix_hash:
            if k not in seen:
                break
            run += 1
        hit_tokens += min(run * prefix_block, r.num_tokens)
        seen.update(r.prefix_hash)
    return hit_tokens / max(total, 1)


def sharegpt_like(n: int = 500, rate: float = 2.0, slo: float = 0.25,
                  seed: int = 0, max_len: int = 2048) -> List[Request]:
    """Single-SLO workload (paper §6.5): ShareGPT-like short prompts with the
    chatbot SLO and Poisson arrivals. Lengths follow the published ShareGPT
    prompt distribution shape (lognormal, mean~330, heavy tail, <2K)."""
    rng = np.random.default_rng(seed)
    mu, sigma = _lognormal_params(330.0, 380.0)
    out: List[Request] = []
    t = 0.0
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        n_tok = int(np.clip(int(rng.lognormal(mu, sigma)), 16, max_len))
        out.append(Request(num_tokens=n_tok, slo=slo, arrival=t,
                           task_type="text"))
    return out
