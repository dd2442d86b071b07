"""Production/stress scenario suite: fitted multi-turn traces and
adversarial workloads behind ``TraceConfig.scenario`` (docs/TRACES.md).

The base QwenTrace generator draws arrivals and lengths from hand-set
uniform knobs (``multi_turn_prob``, ``burstiness``). Production traffic is
not shaped like that: conversations arrive as *sessions* whose turn counts,
think times, and per-turn prompt growth follow heavy-tailed distributions,
and the tail — not the mean — is where scheduler differences live
("Taming Request Imbalance", PAPERS.md). This module provides:

  * moment-matching fits (`fit_lognormal`, `fit_gamma`) from summary
    statistics (mean/std or mean/CV) — the *fitted-distribution scenario
    format*: every scenario is fully specified by a handful of published
    moments, never by raw data;
  * a session-structured generator (`SessionFit` + the internal
    ``_session_trace``): sessions arrive Poisson (optionally modulated by a
    deterministic rate profile), each runs a lognormal number of turns with
    Gamma-distributed think times, and each follow-up turn resubmits the
    conversation's full prompt — its hash chain extends the parent's, so
    prefix caches see genuine multi-turn reuse, not a uniform coin flip;
  * the stress suite (`SCENARIOS`): each scenario names the policy or
    mechanism it is designed to punish, and `benchmarks/fig23_scenarios.py`
    gates a p99-goodput frontier per scenario.

Determinism contract (tested in tests/test_traces.py): a given
``TraceConfig`` (scenario, seed, rate, duration, model, ...) produces an
IDENTICAL request list — same arrivals, lengths, SLOs, and hash chains —
across processes and platforms. All randomness flows from
``np.random.default_rng(cfg.seed)``; rejected thinning candidates still
consume draws, so modulated and unmodulated paths stay independently
reproducible.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.prefixcache import chain_extend
from repro_torch.core.request import Request
from repro_torch.traces.qwentrace import (TABLE1, TABLE2_SLO, TraceConfig,
                                    sample_length)


# ---------------------------------------------------------------- fitting
def fit_lognormal(mean: float, std: float):
    """(mu, sigma) of the lognormal with the given mean/std (moment
    matching). The fit is exact: lognormal(mu, sigma) has exactly these
    first two moments."""
    sigma2 = math.log(1.0 + (std / mean) ** 2)
    return math.log(mean) - sigma2 / 2.0, math.sqrt(sigma2)


def fit_gamma(mean: float, cv: float):
    """(shape, scale) of the Gamma with the given mean and coefficient of
    variation (std/mean). cv=1 degenerates to the exponential."""
    shape = 1.0 / (cv * cv)
    return shape, mean / shape


@dataclass(frozen=True)
class SessionFit:
    """Session-structured multi-turn shape, specified purely by summary
    statistics (the fitted-distribution scenario format): turn counts are
    lognormal (clipped to [1, max_turns]), think times Gamma, per-turn
    prompt growth lognormal. Defaults fit a chat-assistant profile: ~3-turn
    sessions with a heavy tail of long conversations, think times of a few
    seconds with occasional minute-long gaps, and each follow-up appending
    the user turn plus the assistant recap to the resubmitted prompt."""
    turns_mean: float = 3.2           # mean turns per session
    turns_std: float = 2.6
    max_turns: int = 12
    think_mean: float = 8.0           # seconds from one turn to the next
    think_cv: float = 1.4             # Gamma CV (>1: bursty re-engagement)
    growth_mean: float = 220.0        # tokens appended per follow-up turn
    growth_std: float = 260.0


CHAT_FIT = SessionFit()

# scenario-default workload knobs, applied only where the caller left the
# TraceConfig field at its zero default (the sweep knobs — rate, duration,
# seed, model, slo_scale, max_len, prefix_block — are always the caller's)
DEFAULT_SHARED_PREFIX_FRAC = 0.25
DEFAULT_OUTPUT_MEAN = 160.0
DEFAULT_TBT_BY_TASK = {"text": 0.03, "image": 0.05,
                       "search": 0.1, "file": 0.1}

# Length-aware TTFT SLO floor (seconds per prompt token). Fixed class SLOs
# are physically unreachable for the far length tail — a 2K-token "text"
# prompt needs ~0.36 s of bare prefill on A800 against a 0.25 s SLO — so a
# p99<=SLO tail gate would be degenerately empty at EVERY rate. Production
# SLOs scale with prompt length; the floor here is ~1.5x the worst-case
# per-token prefill slope on the reference accelerator (~0.23 ms/token for
# a 32K prompt), which makes every request feasible unloaded while leaving
# typical-length requests on their class SLO. Scenario traces only: the
# legacy uniform-knob path keeps fixed class SLOs (attainment-gated
# figures tolerate the infeasible tail; committed baselines byte-equal).
TTFT_SLO_PER_TOKEN = 3.5e-4


def _slo(task: str, n_tok: int, slos: Dict[str, float],
         cfg: TraceConfig) -> float:
    return max(slos[task], n_tok * TTFT_SLO_PER_TOKEN) * cfg.slo_scale


def _with_chat_defaults(cfg: TraceConfig) -> TraceConfig:
    return replace(
        cfg,
        shared_prefix_frac=cfg.shared_prefix_frac
        or DEFAULT_SHARED_PREFIX_FRAC,
        output_mean=cfg.output_mean or DEFAULT_OUTPUT_MEAN,
        tbt_slo_by_task=cfg.tbt_slo_by_task or dict(DEFAULT_TBT_BY_TASK))


def _sample_output(cfg: TraceConfig, rng: np.random.Generator) -> int:
    if cfg.output_mean <= 0:
        return 0
    mu, sigma = fit_lognormal(cfg.output_mean,
                              cfg.output_std or cfg.output_mean)
    return int(np.clip(int(rng.lognormal(mu, sigma)), 1, 8192))


def _sample_turns(rng: np.random.Generator, fit: SessionFit) -> int:
    mu, sigma = fit_lognormal(fit.turns_mean, fit.turns_std)
    return int(np.clip(int(rng.lognormal(mu, sigma)), 1, fit.max_turns))


# ------------------------------------------- session-structured generation
def _session_trace(cfg: TraceConfig, fit: SessionFit, *,
                   rate_fn: Optional[Callable[[float], float]] = None,
                   rate_peak: float = 1.0,
                   output_sampler: Optional[Callable] = None
                   ) -> List[Request]:
    """Fitted multi-turn trace: sessions arrive Poisson at ``cfg.rate /
    fit.turns_mean`` (so the REQUEST rate is ~cfg.rate), optionally thinned
    against ``rate_fn(t)/rate_peak`` for time-varying load. Every follow-up
    turn resubmits the conversation's full prompt — the child's hash chain
    extends the parent's at full-block granularity — and the per-class
    system-prompt template (``shared_prefix_frac``) is shared across all
    sessions of a class, exactly as the legacy generator does."""
    rng = np.random.default_rng(cfg.seed)
    ratios = cfg.task_ratios or {k: v["ratio"] for k, v in TABLE1.items()}
    tasks = list(ratios)
    probs = np.asarray([ratios[t] for t in tasks], dtype=np.float64)
    probs = probs / probs.sum()
    slos = TABLE2_SLO[cfg.model]
    tbt_by = cfg.tbt_slo_by_task or {}
    bs = cfg.prefix_block

    tpl_keys: Dict[str, tuple] = {}
    tpl_len: Dict[str, int] = {}
    for ti, task in enumerate(tasks):
        n = int(cfg.shared_prefix_frac * TABLE1[task]["mean"])
        tpl_len[task] = n
        tpl_keys[task] = chain_extend((), range(n // bs), salt=1000 + ti)

    # session arrivals (thinning keeps the draw sequence deterministic)
    session_rate = cfg.rate / max(fit.turns_mean, 1.0)
    starts: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / (session_rate * rate_peak))
        if t >= cfg.duration:
            break
        if rate_fn is None or rng.random() < rate_fn(t) / rate_peak:
            starts.append(t)

    mu_g, sg_g = fit_lognormal(fit.growth_mean, fit.growth_std)
    shape_th, scale_th = fit_gamma(fit.think_mean, fit.think_cv)
    out: List[Request] = []
    uid = 0
    for t0 in starts:
        task = tasks[int(rng.choice(len(tasks), p=probs))]
        n_turns = _sample_turns(rng, fit)
        base_keys, base_len = tpl_keys[task], tpl_len[task]
        n_tok = min(max(sample_length(task, rng, max_len=cfg.max_len),
                        base_len + 16), cfg.max_len)
        t_turn = t0
        for turn in range(n_turns):
            if turn > 0:
                t_turn += rng.gamma(shape_th, scale_th)
                if t_turn >= cfg.duration:
                    break
                grow = max(int(rng.lognormal(mu_g, sg_g)), 16)
                n_tok = min(n_tok + grow, cfg.max_len)
            uid += 1
            n_full = n_tok // bs
            shared = min(base_len // bs, len(base_keys), n_full)
            keys = chain_extend(base_keys[:shared],
                                range(n_full - shared), salt=uid)
            out_tokens = output_sampler(rng) if output_sampler \
                else _sample_output(cfg, rng)
            tbt = tbt_by.get(task, cfg.tbt_slo)
            out.append(Request(
                num_tokens=n_tok,
                slo=_slo(task, n_tok, slos, cfg),
                arrival=t_turn,
                task_type=task,
                output_tokens=out_tokens,
                tbt_slo=tbt if out_tokens else float("inf"),
                prefix_hash=keys,
            ))
            base_keys, base_len = keys, n_tok  # next turn extends this turn
    out.sort(key=lambda r: r.arrival)
    return out


# ------------------------------------------------------------- scenarios
def _fitted_chat(cfg: TraceConfig) -> List[Request]:
    return _session_trace(_with_chat_defaults(cfg), CHAT_FIT)


DIURNAL_AMPLITUDE = 0.85              # rate swings rate*(1±0.85)
DIURNAL_CYCLES = 2.0                  # bursts per trace


def _diurnal(cfg: TraceConfig) -> List[Request]:
    period = cfg.duration / DIURNAL_CYCLES
    amp = DIURNAL_AMPLITUDE

    def rate_fn(t: float) -> float:
        # trough at t=0 so the trace warms up before the burst hits
        return 1.0 + amp * math.sin(2.0 * math.pi * t / period
                                    - math.pi / 2.0)

    return _session_trace(_with_chat_defaults(cfg), CHAT_FIT,
                          rate_fn=rate_fn, rate_peak=1.0 + amp)


HEAVY_TAIL_FRAC = 0.08                # fraction of requests in the tail
HEAVY_TAIL_ALPHA = 1.15               # Pareto index (alpha<2: infinite var)
HEAVY_TAIL_SCALE = 600.0              # tail minimum output tokens


def _heavy_tail(cfg: TraceConfig) -> List[Request]:
    cfg = _with_chat_defaults(cfg)

    def sample(rng: np.random.Generator) -> int:
        if rng.random() < HEAVY_TAIL_FRAC:
            return int(np.clip(
                HEAVY_TAIL_SCALE * (1.0 + rng.pareto(HEAVY_TAIL_ALPHA)),
                1, 8192))
        return _sample_output(cfg, rng)

    return _session_trace(cfg, CHAT_FIT, output_sampler=sample)


# prefix-adversary geometry (tests/test_traces.py pins the collide/diverge
# property at these constants; docs/TRACES.md documents them)
ADVERSARY_FAMILIES = 24               # distinct hot trunks
ADVERSARY_TRUNK_BLOCKS = 16           # shared chain prefix per family
ADVERSARY_TAIL_BLOCKS = (16, 48)      # unique blocks per request [lo, hi)


def _prefix_adversary(cfg: TraceConfig) -> List[Request]:
    """Prefix-hash adversary: every request probes one of a small set of
    hot trunks (so `prefix-affinity` concentrates whole families onto the
    trunk holder — manufactured hotspots), then appends a LONG unique tail
    (so every request inserts 16-48 never-reused blocks, and the LRU churn
    evicts other families' trunks — the trie thrashes instead of serving).
    Family popularity is Zipf-ish: the hottest trunks stay resident just
    long enough to keep attracting traffic."""
    rng = np.random.default_rng(cfg.seed)
    slos = TABLE2_SLO[cfg.model]
    bs = cfg.prefix_block
    trunks = [chain_extend((), range(ADVERSARY_TRUNK_BLOCKS), salt=7000 + f)
              for f in range(ADVERSARY_FAMILIES)]
    fam_probs = 1.0 / (1.0 + np.arange(ADVERSARY_FAMILIES, dtype=np.float64))
    fam_probs = fam_probs / fam_probs.sum()
    tbt_by = cfg.tbt_slo_by_task or {}
    out: List[Request] = []
    t = 0.0
    uid = 0
    while True:
        t += rng.exponential(1.0 / cfg.rate)
        if t >= cfg.duration:
            break
        uid += 1
        fam = int(rng.choice(ADVERSARY_FAMILIES, p=fam_probs))
        tail = int(rng.integers(*ADVERSARY_TAIL_BLOCKS))
        n_tok = min((ADVERSARY_TRUNK_BLOCKS + tail) * bs
                    + int(rng.integers(bs)), cfg.max_len)
        n_full = n_tok // bs
        shared = min(ADVERSARY_TRUNK_BLOCKS, n_full)
        keys = chain_extend(trunks[fam][:shared], range(n_full - shared),
                            salt=uid)
        out_tokens = _sample_output(cfg, rng)
        out.append(Request(
            num_tokens=n_tok,
            slo=_slo("search", n_tok, slos, cfg),  # long-prompt agentic class
            arrival=t,
            task_type="search",
            output_tokens=out_tokens,
            tbt_slo=tbt_by.get("search", cfg.tbt_slo)
            if out_tokens else float("inf"),
            prefix_hash=keys,
        ))
    return out


FLOOD_MULT = 6.0                      # flood tenant rate vs base rate
FLOOD_WINDOW = (0.35, 0.6)            # active window, fraction of duration
FLOOD_PREFIX_TOKENS = 512             # the tenant's one shared template


def _flood(cfg: TraceConfig) -> List[Request]:
    """Single-tenant flood: the fitted chat mixture at cfg.rate, plus one
    aggressive tenant firing near-identical tight-SLO text requests at
    ``FLOOD_MULT x cfg.rate`` for a window mid-trace. Deadline-blind FCFS
    admission collapses outright under the burst (fig23's flood matchup),
    and even under S-EDF the burst produces the divergence tail gating
    exists to catch: aggregate attainment barely moves while the p99 tail
    runs several SLOs out. S-EDF also has no fairness term — the flood's
    tight deadlines legally preempt the base tenants' turns during the
    window (the motivating case for the ROADMAP multi-tenant-fairness
    item)."""
    cfg = _with_chat_defaults(cfg)
    base = _session_trace(cfg, CHAT_FIT)
    rng = np.random.default_rng(cfg.seed + 0x5EED)
    slos = TABLE2_SLO[cfg.model]
    bs = cfg.prefix_block
    tpl = chain_extend((), range(FLOOD_PREFIX_TOKENS // bs), salt=9999)
    tbt_by = cfg.tbt_slo_by_task or {}
    t = FLOOD_WINDOW[0] * cfg.duration
    end = FLOOD_WINDOW[1] * cfg.duration
    flood: List[Request] = []
    uid = 0
    while True:
        t += rng.exponential(1.0 / (FLOOD_MULT * cfg.rate))
        if t >= end:
            break
        uid += 1
        n_tok = min(FLOOD_PREFIX_TOKENS + 16 + int(rng.integers(256)),
                    cfg.max_len)
        n_full = n_tok // bs
        shared = min(len(tpl), n_full)
        keys = chain_extend(tpl[:shared], range(n_full - shared),
                            salt=0x0F100D + uid)
        out_tokens = _sample_output(cfg, rng)
        flood.append(Request(
            num_tokens=n_tok,
            slo=_slo("text", n_tok, slos, cfg),
            arrival=t,
            task_type="text",
            output_tokens=out_tokens,
            tbt_slo=tbt_by.get("text", cfg.tbt_slo)
            if out_tokens else float("inf"),
            prefix_hash=keys,
        ))
    out = base + flood
    out.sort(key=lambda r: r.arrival)
    return out


@dataclass(frozen=True)
class Scenario:
    name: str
    summary: str                      # one line: what the workload looks like
    punishes: str                     # the policy/mechanism it stresses
    build: Callable[[TraceConfig], List[Request]]


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    Scenario(
        name="fitted-chat",
        summary="fitted session-structured multi-turn chat mixture "
                "(lognormal turns/growth, Gamma think times)",
        punishes="nothing by design — the production-shaped baseline the "
                 "stress scenarios perturb",
        build=_fitted_chat),
    Scenario(
        name="diurnal",
        summary="the fitted chat mixture under a sinusoidal rate profile "
                "(troughs to 0.15x, peaks to 1.85x the nominal rate)",
        punishes="headroom-blind dispatch (round-robin): bursts pile onto "
                 "already-loaded instances while troughs idle them",
        build=_diurnal),
    Scenario(
        name="heavy-tail",
        summary="fitted chat with a Pareto(alpha=1.15) splice on output "
                "lengths: ~8% of decodes run 600 to 8192 tokens",
        punishes="slack-blind FCFS decode admission: marathon decodes "
                 "squat KV slots while tight-TBT streams queue",
        build=_heavy_tail),
    Scenario(
        name="prefix-adversary",
        summary="Zipf traffic over 24 hot trunk chains, each request "
                "appending 16-48 unique blocks",
        punishes="prefix-affinity dispatch (manufactured hotspots) and the "
                 "PrefixBlockManager LRU (unique tails evict hot trunks)",
        build=_prefix_adversary),
    Scenario(
        name="flood",
        summary="fitted chat plus one tenant firing near-identical "
                "tight-SLO text requests at 6x the base rate mid-trace",
        punishes="deadline-blind FCFS admission (collapses under the "
                 "burst) and attainment-gated capacity claims: aggregate "
                 "attainment holds while the p99 tail runs SLOs out",
        build=_flood),
)}


def scenario_names() -> List[str]:
    return sorted(SCENARIOS)


def generate_scenario(cfg: TraceConfig) -> List[Request]:
    """Entry point `repro_torch.traces.qwentrace.generate` delegates to when
    ``cfg.scenario`` is set."""
    sc = SCENARIOS.get(cfg.scenario or "")
    if sc is None:
        raise ValueError(f"unknown scenario {cfg.scenario!r}; known: "
                         f"{scenario_names()}")
    return sc.build(cfg)
