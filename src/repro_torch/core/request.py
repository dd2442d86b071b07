"""Request model shared by the scheduler core, the real serving runtime, and
the discrete-event simulator."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

_rid_counter = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    DONE = "done"
    DROPPED = "dropped"


@dataclass
class Request:
    num_tokens: int                      # prompt length
    slo: float                           # TTFT SLO (seconds)
    arrival: float = 0.0
    task_type: str = "text"
    rid: int = field(default_factory=lambda: next(_rid_counter))
    state: RequestState = RequestState.WAITING

    # runtime-owned progress (operator granularity)
    ops_done: int = 0                    # operators completed so far
    ops_total: int = 0                   # set when execution plan is known
    tokens_done: int = 0                 # prefill tokens fully processed (chunking)

    # batching: rids co-executing with this request (paper Alg. 1)
    batch_members: List[int] = field(default_factory=list)
    batch_tokens: int = 0                # aggregate token count of the batch

    # prefix sharing: the prompt's block hash chain (one key per FULL
    # kv-cache block, repro_torch.core.prefixcache.block_keys semantics) — the
    # dispatch-visible signal prefix-affinity routes on. None = opaque
    # prompt (no sharing possible). Populated by the trace generator (sim)
    # or derived from token ids (runtime).
    prefix_hash: Optional[Tuple[int, ...]] = None
    # tokens of this prompt served from the prefix cache of the instance it
    # was dispatched to (set at dispatch; 0 = cold). Runtime-owned.
    prefix_hit: int = 0

    # decode phase (cluster-level end-to-end accounting; 0 = prefill-only)
    output_tokens: int = 0               # tokens to decode after prefill
    tbt_slo: float = float("inf")        # per-token TBT/TPOT SLO (seconds)
    decode_start: Optional[float] = None  # first decode admission/enqueue time
    decode_migrations: int = 0           # times this decode moved instances
    decode_preemptions: int = 0          # times this decode was displaced
    # speculative decoding (sim): per-token draft accept probability for this
    # stream's fluid accept surface (repro_torch.core.predictor
    # .expected_accept_tokens). 0.0 = drafts never accepted (plain-rate).
    spec_accept: float = 0.0

    # fault recovery (instance churn): times this request was stranded by a
    # failing instance and re-dispatched (KV lost -> recompute); the retry
    # budget caps it. shed=True means admission control rejected it outright
    # (state DROPPED, never dispatched) — distinct from retries-exhausted.
    retries: int = 0
    shed: bool = False

    # outcome
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    mean_tpot: Optional[float] = None    # observed mean time-per-output-token

    def __post_init__(self):
        if self.batch_tokens == 0:
            self.batch_tokens = self.num_tokens

    @property
    def deadline(self) -> float:
        return self.arrival + self.slo

    @property
    def decode_deadline(self) -> float:
        """Decode-phase deadline: the TBT SLO is met iff the decode finishes
        by first-join + output_tokens * tbt_slo (mean-TPOT basis), so that
        instant IS the deadline the decode S-EDF scheduler ranks by. Infinite
        until the decode is first enqueued or for prefill-only requests."""
        if self.decode_start is None or self.output_tokens <= 0:
            return float("inf")
        return self.decode_start + self.output_tokens * self.tbt_slo

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def slo_met(self) -> bool:
        return self.ttft is not None and self.ttft <= self.slo + 1e-9

    @property
    def tbt_met(self) -> bool:
        """Decode-phase SLO: mean time-per-output-token within the TBT SLO
        (vacuously true for prefill-only requests)."""
        if self.output_tokens <= 0:
            return True
        return self.mean_tpot is not None and \
            self.mean_tpot <= self.tbt_slo + 1e-9

    @property
    def e2e_met(self) -> bool:
        """End-to-end goodness: TTFT SLO and decode TBT SLO both attained."""
        return self.slo_met and self.tbt_met

    def remaining_fraction(self) -> float:
        """Fraction of prefill work left (1.0 = untouched)."""
        if self.ops_total <= 0:
            return 1.0
        return max(0.0, 1.0 - self.ops_done / self.ops_total)

    def remaining_tokens(self) -> float:
        """Token-equivalent remaining work, used by the TTFT predictor.
        (Inlined remaining_fraction — this runs once per queued request per
        scheduling round, the simulator's hottest per-element path.)"""
        ot = self.ops_total
        if ot <= 0:
            return self.batch_tokens * 1.0
        frac = 1.0 - self.ops_done / ot
        return self.batch_tokens * frac if frac > 0.0 else 0.0
