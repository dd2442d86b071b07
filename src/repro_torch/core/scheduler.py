"""Event-driven scheduling core (FlowPrefill §5.2) — pure policy logic.

This module is deliberately free of threads and devices: the same functions
drive BOTH the real serving runtime (repro/serving/prefill_instance.py,
repro/serving/decode_instance.py) and the discrete-event simulator (repro/sim/)
so the evaluated policy is the deployed policy.

Prefill side (paper-faithful):
  * S-EDF priority (Eq. 3):  priority = sgn(slack) / deadline,
    slack = deadline - now - TTFT_hat
  * SLO-aware batching (Algorithm 1)
  * The per-event scheduling round of Algorithm 2 (returns control commands;
    the Execution Pool carries them out)
  * Ablation policies (Fig. 10): naive EDF and D-EDF; plus FCFS for the
    DistServe baseline.

Decode side (the paper's core idea — decoupling preemption granularity from
scheduling frequency — generalized to the second serving phase):
  * `DecodeSchedulerCore` ranks decode candidates by TBT-deadline slack
    (`decode_sedf_priority`: slack = decode_deadline - now - remaining_tokens
    * t_step_hat) and selects the continuous batch under a slot cap, optionally
    displacing slack-rich residents at token boundaries (decode preemption).
  * FCFS admission is kept as the baseline (and is what the paper's
    deliberately-plain decode stage does).

Policy-by-policy rationale and the figures that demonstrate each live in
docs/SCHEDULING.md.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import (Callable, List, Mapping, Optional, Sequence, Set, Tuple)

import numpy as np

from repro_torch.core.predictor import TTFTPredictor
from repro_torch.core.request import Request

PriorityFn = Callable[[Request, float, Callable[[float], float]], float]


# ---------------------------------------------------------------------------
# Priority policies
# ---------------------------------------------------------------------------


def _sgn(x: float) -> float:
    return 1.0 if x >= 0.0 else -1.0


def sedf_priority(req: Request, now: float, predict) -> float:
    """Slack-aware EDF (the paper's policy, Eq. 3)."""
    slack = req.deadline - now - predict(req.remaining_tokens())
    return _sgn(slack) / max(req.deadline, 1e-9)


def dedf_priority(req: Request, now: float, predict) -> float:
    """Deadline-aware EDF ablation: numerator sgn(deadline - now)."""
    return _sgn(req.deadline - now) / max(req.deadline, 1e-9)


def edf_priority(req: Request, now: float, predict) -> float:
    """Naive EDF: earliest deadline first, no feasibility awareness."""
    return 1.0 / max(req.deadline, 1e-9)


def fcfs_priority(req: Request, now: float, predict) -> float:
    return -req.arrival


POLICIES = {
    "s-edf": sedf_priority,
    "d-edf": dedf_priority,
    "edf": edf_priority,
    "fcfs": fcfs_priority,
}


# ---------------------------------------------------------------------------
# SLO-aware batching — Algorithm 1
# ---------------------------------------------------------------------------


def slo_aware_batching(
    H: Request,
    candidates: Sequence[Request],
    budget: int,
    now: float,
    predict: Callable[[float], float],
) -> Tuple[Request, List[Request]]:
    """Paper Algorithm 1. Returns (H with updated aggregate tokens, batch list
    including H). Candidates are admitted while H's remaining time covers the
    predicted latency of the aggregate batch and the token budget holds."""
    batch = [H]
    t_remain = H.deadline - now
    n = H.num_tokens
    for r in candidates:
        if r.rid == H.rid:
            continue
        n_new = n + r.num_tokens
        latency = predict(n_new)
        if t_remain > latency and n_new < budget:
            batch.append(r)
            n = n_new
    H.batch_tokens = n
    return H, batch


def greedy_batching(
    H: Request,
    candidates: Sequence[Request],
    budget: int,
) -> Tuple[Request, List[Request]]:
    """Token-budget-only batching (vLLM/Sarathi continuous-batching semantics,
    used by the DistServe-CP baselines): pack while under budget, no deadline
    feasibility check."""
    batch = [H]
    n = H.num_tokens
    for r in candidates:
        if r.rid == H.rid:
            continue
        if n + r.num_tokens < budget:
            batch.append(r)
            n += r.num_tokens
    H.batch_tokens = n
    return H, batch


# ---------------------------------------------------------------------------
# Scheduling round — Algorithm 2 (one event = one round)
# ---------------------------------------------------------------------------


class Action(enum.Enum):
    NOOP = "noop"
    SUBMIT = "submit"          # new batch starts (H was waiting)
    RESUME = "resume"          # H was preempted
    # preemption of the running task is orthogonal and recorded separately


@dataclass
class Decision:
    action: Action
    batch: List[Request] = field(default_factory=list)    # for SUBMIT
    target: Optional[Request] = None                      # H (SUBMIT/RESUME)
    preempt: Optional[Request] = None                     # E to suspend first

    @property
    def is_noop(self) -> bool:
        return self.action == Action.NOOP and self.preempt is None


@dataclass
class SchedulerCore:
    """State-free policy engine. The runtime owns the queues and passes views."""
    predictor: TTFTPredictor
    policy: str = "s-edf"
    batch_budget: int = 4096              # G, tokens (Fig. 11 sweeps this)
    enable_batching: bool = True
    batching_mode: str = "slo"            # "slo" (Alg. 1) | "greedy" (baselines)
    batch_running: bool = False           # paper Alg.2 line 14 admits E into C;
                                          # default off: re-batching the running
                                          # task would discard its progress

    def priority(self, req: Request, now: float) -> float:
        return POLICIES[self.policy](req, now, self.predictor.predict)

    def _priorities_vec(self, requests: Sequence[Request],
                        now: float) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(priorities, deadlines) arrays, elementwise bit-identical to
        `priority` — the per-round ranking is THE scheduler hot path (every
        event re-ranks the whole queue), so the per-request predict/property
        calls are batched. Returns None for policies without a batched form
        or predictors without `predict_many`."""
        n = len(requests)
        dl = np.fromiter((r.arrival + r.slo for r in requests),
                         np.float64, n)
        if self.policy == "s-edf":
            if not hasattr(self.predictor, "predict_many"):
                return None
            rem = np.fromiter((r.remaining_tokens() for r in requests),
                              np.float64, n)
            slack = dl - now - self.predictor.predict_many(rem)
            pri = np.where(slack >= 0.0, 1.0, -1.0) / np.maximum(dl, 1e-9)
        elif self.policy == "d-edf":
            pri = np.where(dl - now >= 0.0, 1.0, -1.0) / np.maximum(dl, 1e-9)
        elif self.policy == "edf":
            pri = 1.0 / np.maximum(dl, 1e-9)
        elif self.policy == "fcfs":
            pri = -np.fromiter((r.arrival for r in requests), np.float64, n)
        else:
            return None
        return pri, dl

    def rank(self, requests: Sequence[Request], now: float) -> List[Request]:
        """Descending priority; deterministic tie-break (deadline, rid)."""
        if len(requests) <= 1:
            return list(requests)
        vec = self._priorities_vec(requests, now)
        if vec is None:
            return sorted(requests, key=lambda r: (-self.priority(r, now),
                                                   r.deadline, r.rid))
        pri, dl = vec
        rid = np.fromiter((r.rid for r in requests), np.int64, len(requests))
        # lexsort keys are applied last-first: (-pri, deadline, rid) — rid is
        # unique, so the order matches the scalar tuple sort exactly
        order = np.lexsort((rid, dl, -pri))
        return [requests[i] for i in order]

    def schedule_round(
        self,
        now: float,
        waiting: Sequence[Request],
        preempted: Sequence[Request],
        running: Optional[Request],
    ) -> Decision:
        """One event-triggered round of Algorithm 2 (lines 7–26)."""
        q_all: List[Request] = list(waiting) + list(preempted)
        if running is not None:
            q_all.append(running)
        if not q_all:
            return Decision(Action.NOOP)

        ranked = self.rank(q_all, now)
        H = ranked[0]

        batch = [H]
        waiting_ids = {r.rid for r in waiting}
        if H.rid in waiting_ids and self.enable_batching:
            cands = [r for r in ranked
                     if r.rid != H.rid and r.rid in waiting_ids]
            if self.batch_running and running is not None:
                cands.append(running)
            if self.batching_mode == "greedy":
                H, batch = greedy_batching(H, cands, self.batch_budget)
            else:
                H, batch = slo_aware_batching(
                    H, cands, self.batch_budget, now, self.predictor.predict)

        if running is not None and H.rid == running.rid:
            return Decision(Action.NOOP)                   # already optimal

        preempt = running                                  # may be None
        if H.rid in waiting_ids:
            return Decision(Action.SUBMIT, batch=batch, target=H,
                            preempt=preempt)
        return Decision(Action.RESUME, target=H, preempt=preempt)


# ---------------------------------------------------------------------------
# Decode-side scheduling: TBT-slack-aware batch admission (S-EDF for decode)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DecodeEntry:
    """One decode candidate as the decode scheduler sees it — owner-agnostic,
    so the SAME ranking drives the fluid `DecodeSim` and the threaded
    `DecodeInstance` (the repo's evaluated-is-deployed rule)."""
    key: int                       # owner handle (request rid)
    remaining_tokens: float        # output tokens still to decode
    deadline: float                # Request.decode_deadline (inf = no TBT SLO)
    order: int                     # admission order (FCFS / deterministic tie)


def decode_sedf_priority(entry: DecodeEntry, now: float,
                         t_step: float) -> float:
    """S-EDF ported to decode (the paper's Eq. 3 with TBT semantics):

        slack    = decode_deadline - now - remaining_tokens * t_step_hat
        priority = sgn(slack) / decode_deadline

    `t_step_hat` is the predicted per-token step time of the batch the entry
    would decode in (DecodeCostModel.step_time via a DecodeStepPredictor).
    Feasible-but-urgent decodes rank first; already-doomed ones (negative
    slack) rank below every feasible candidate, exactly like prefill S-EDF —
    a doomed stream must not displace one that can still meet its TBT SLO.
    Requests without a TBT SLO have an infinite deadline: priority 0, between
    the feasible (positive) and the doomed (negative)."""
    if not math.isfinite(entry.deadline):
        return 0.0
    slack = entry.deadline - now - entry.remaining_tokens * t_step
    return _sgn(slack) / max(entry.deadline, 1e-9)


@dataclass
class DecodeSchedulerCore:
    """Batch-admission policy for one decode instance.

    A decode instance runs a continuous batch of at most `max_batch` streams
    (KV-memory slot cap; <= 0 means unbounded, which degenerates to the
    paper's plain processor-sharing decode). On every join/leave event the
    owner calls `select_batch` with ALL candidates (current residents plus
    queued decodes); the returned batch is the new resident set.

    * ``fcfs``  — admission in arrival order; residents are never displaced
      (an earlier order always outranks a later one).
    * ``s-edf`` — candidates ranked by `decode_sedf_priority`; with
      ``preempt`` (the default) the top-`max_batch` BY PRIORITY become the
      batch, so a near-deadline queued decode displaces a slack-rich resident
      — the decode analogue of operator-level preemption, effective at the
      next token boundary. With ``preempt=False`` residents keep their slots
      and only free slots are filled by rank (admission-only S-EDF).
    """
    policy: str = "s-edf"              # "s-edf" | "fcfs"
    preempt: bool = True

    def priority(self, entry: DecodeEntry, now: float, t_step: float) -> float:
        if self.policy == "fcfs":
            return -float(entry.order)
        return decode_sedf_priority(entry, now, t_step)

    def rank(self, entries: Sequence[DecodeEntry], now: float,
             t_step: float) -> List[DecodeEntry]:
        """Descending priority; deterministic tie-break (deadline, order)."""
        if self.policy == "fcfs":
            return sorted(entries, key=lambda e: e.order)
        return sorted(entries,
                      key=lambda e: (-decode_sedf_priority(e, now, t_step),
                                     e.deadline, e.order))

    def select_batch(self, entries: Sequence[DecodeEntry],
                     resident: Set[int], max_batch: int, now: float,
                     t_step: float) -> Tuple[List[int], List[int]]:
        """Pick the new resident batch from `entries` (residents + queued).

        Returns ``(batch_keys, preempted_keys)``: the keys to run (in rank
        order) and the previously-resident keys displaced by the decision.
        ``max_batch <= 0`` = unbounded: everything is admitted, nothing is
        ever preempted (the plain processor-sharing decode)."""
        ranked = self.rank(entries, now, t_step)
        if max_batch <= 0 or len(entries) <= max_batch:
            return [e.key for e in ranked], []
        if self.preempt:
            batch = [e.key for e in ranked[:max_batch]]
        else:
            keep = [e for e in ranked if e.key in resident]
            free = max_batch - len(keep)
            fill = [e for e in ranked if e.key not in resident][:max(free, 0)]
            batch = [e.key for e in self.rank(keep + fill, now, t_step)]
        chosen = set(batch)
        preempted = [e.key for e in ranked
                     if e.key in resident and e.key not in chosen]
        return batch, preempted


# ---------------------------------------------------------------------------
# Hybrid (colocated prefill + decode) scheduling: one token-budget step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrefillSlice:
    """One prefill admission in a hybrid step: `n_tokens` of request `key`'s
    prompt, starting at token `offset` (the request's resume point — a
    preempted prefill continues exactly where its last admitted slice ended,
    which the executor maps to an operator offset)."""
    key: int
    offset: int
    n_tokens: int


@dataclass
class HybridStepPlan:
    """What one budget-capped hybrid step runs: the resident decode batch
    (one token each) plus the prefill chunk slices that fit in the remaining
    budget. ``budget_used = len(decode_keys) + sum(slice tokens)`` and never
    exceeds the configured token budget."""
    decode_keys: List[int] = field(default_factory=list)
    preempted_decode: List[int] = field(default_factory=list)
    prefill_slices: List[PrefillSlice] = field(default_factory=list)
    budget_used: int = 0

    @property
    def empty(self) -> bool:
        return not self.decode_keys and not self.prefill_slices


@dataclass
class HybridSchedulerCore:
    """Token-budget colocation scheduler: packs all admitted decode tokens
    plus operator-bounded prefill chunk slices into ONE budget-capped step
    (the nano-vLLM / Sarathi chunked-prefill shape — decode first, prefill
    fills the rest — upgraded with S-EDF deadlines on both phases).

    COMPOSES the two standalone policy cores rather than reimplementing
    them: decode admission is `DecodeSchedulerCore.select_batch` verbatim,
    prefill ordering is `SchedulerCore.rank` verbatim — so with
    ``policy="fcfs"`` and ``token_budget <= 0`` (unbounded) the hybrid plan
    is bit-identical to what the standalone engines would run, which
    tests/test_hybrid.py asserts property-style.

    Per `plan_step`:

    1. *Decode first* — every resident/queued decode stream costs one budget
       token. The slot cap is ``min(decode_max_batch, budget)``; when the
       BUDGET (not the slot cap) is binding, streams squeezed out are
       recorded and admitted ahead of rank next step, so a resident decode
       row is never skipped two consecutive steps (guaranteed whenever the
       skipped set itself fits the budget, i.e. candidates <= 2x budget).
    2. *Prefill fills the remainder* — waiting prefills ranked by the
       prefill core's policy (S-EDF by default) each get one chunk-sized
       slice starting at their resume offset; the last admitted slice is
       truncated to the remaining budget (the executor rounds truncation to
       an operator boundary; the budget bound still holds in tokens).

    Preemption falls out of admission: a prefill not sliced this step simply
    does not run (its offset — and therefore its operator cursor — is
    untouched), and a decode not selected keeps its KV and progress. Both
    are the zero-copy preemption semantics of the standalone engines.
    """
    prefill: SchedulerCore
    decode: DecodeSchedulerCore = field(default_factory=DecodeSchedulerCore)
    token_budget: int = 4096          # G: tokens per hybrid step (<= 0: inf)
    chunk_tokens: int = 512           # prefill slice quantum (<= 0: whole)
    decode_max_batch: int = 0         # decode slot cap (<= 0: unbounded)
    # decode keys the budget squeezed out of the previous step's batch
    # (resident rows owed an admission — see the fairness rule above)
    _owed: Set[int] = field(default_factory=set)

    def _select_decode(self, entries: Sequence[DecodeEntry],
                       resident: Set[int], now: float,
                       t_step: float) -> Tuple[List[int], List[int]]:
        """Decode admission under min(slot cap, token budget). Delegates to
        the standalone `select_batch` whenever the slot cap (or nothing) is
        binding — bit-identical batches; only a binding BUDGET engages the
        owed-rows carry."""
        budget = self.token_budget
        cap = self.decode_max_batch
        budget_binding = budget > 0 and (cap <= 0 or budget < cap) \
            and len(entries) > budget
        if not budget_binding:
            self._owed = set()
            return self.decode.select_batch(entries, resident, cap, now,
                                            t_step)
        owed = [e for e in entries if e.key in self._owed]
        owed = self.decode.rank(owed, now, t_step)[:budget]
        owed_keys = {e.key for e in owed}
        rest_cap = budget - len(owed)
        rest = [e for e in entries if e.key not in owed_keys]
        fill: List[int] = []
        if rest_cap > 0 and rest:
            fill, _ = self.decode.select_batch(
                rest, resident - owed_keys, rest_cap, now, t_step)
            fill = fill[:rest_cap]
        batch = [e.key for e in owed] + fill
        chosen = set(batch)
        preempted = [e.key for e in entries
                     if e.key in resident and e.key not in chosen]
        self._owed = {e.key for e in entries
                      if e.key in resident and e.key not in chosen}
        return batch, preempted

    def plan_step(self, now: float, *,
                  prefill: Sequence[Request],
                  prefill_done: Mapping[int, int],
                  decode_entries: Sequence[DecodeEntry],
                  decode_resident: Set[int],
                  t_step: float = 0.0,
                  decode_cost: float = 1.0) -> HybridStepPlan:
        """Plan one hybrid step. ``prefill`` are the waiting/partial prefill
        requests; ``prefill_done[rid]`` is how many prompt tokens of each are
        already computed (the resume offset). ``decode_entries`` covers
        resident AND queued decode streams; ``decode_resident`` the current
        slot holders; ``t_step`` the predicted per-token decode latency the
        decode S-EDF ranks with. ``decode_cost`` is E[tokens a decode stream
        commits this step] (speculative decoding's accept-rate surface;
        1.0 = plain): each admitted stream consumes that many budget tokens,
        so prefill admission prices the decode side's REAL device work — a
        fully-accepting draft pipeline eats k+1 budget tokens per stream,
        exactly the extra positions its verify pass scores."""
        plan = HybridStepPlan()
        budget = self.token_budget if self.token_budget > 0 else 0
        cost = max(float(decode_cost), 1.0)
        if decode_entries:
            plan.decode_keys, plan.preempted_decode = self._select_decode(
                decode_entries, decode_resident, now, t_step)
        used = len(plan.decode_keys) * cost
        left = (budget - used) if budget else float("inf")
        if prefill and left > 0:
            quantum = self.chunk_tokens
            for req in self.prefill.rank(prefill, now):
                if left <= 0:
                    break
                done = int(prefill_done.get(req.rid, 0))
                remaining = int(req.num_tokens) - done
                if remaining <= 0:
                    continue
                n = remaining if quantum <= 0 else min(quantum, remaining)
                n = int(min(n, left))
                plan.prefill_slices.append(
                    PrefillSlice(key=req.rid, offset=done, n_tokens=n))
                used += n
                left -= n
        plan.budget_used = int(round(used))
        return plan
