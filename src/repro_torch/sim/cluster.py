"""Cluster-scale discrete-event simulator: N prefill instances + dispatch +
decode instances with TBT-slack-aware scheduling, on ONE shared event heap.

Each prefill instance is an `InstanceEngine` (the exact state machine behind
`PrefillSim` — a 1-instance round-robin cluster reproduces the single-instance
simulator event-for-event). Arrivals are routed by a pluggable dispatch policy
from `repro_torch.core.dispatch` — the same policy objects the real `Proxy` uses —
and completed prefills hand over to decode instances (`DecodeSim`) modeled as
continuous-batching processor sharing with TPOT/TBT SLO accounting
(`DecodeCostModel`), so the cluster reports *end-to-end* goodput.

The decode stage is schedulable, not just accounted (docs/SCHEDULING.md):

  * With a KV slot cap (``decode_max_batch``) a decode instance admits at most
    B streams; the rest queue. Admission is a `DecodeSchedulerCore` policy —
    FCFS (the paper's deliberately-plain decode) or decode S-EDF, which ranks
    by TBT-deadline slack using `DecodeCostModel.step_time` predictions via a
    `DecodeStepPredictor`.
  * Decode S-EDF preempts at token boundaries: a near-deadline queued stream
    displaces the most slack-rich resident (progress kept, resumed later) —
    the decode analogue of the paper's operator-level prefill preemption.
  * Decode *migration* (``decode_migration=True``): queued decodes are moved
    off an instance whose effective TBT pressure crossed the SLO knee, KV
    handoff priced by `DecodeCostModel.kv_transfer_time`, planned by the
    cost-gated `plan_decode_migrations` (shared with the real Proxy).
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.dispatch import (DecodeCandidate, DecodeLoad, DispatchPolicy,
                                 InstanceLoad, competing_tokens,
                                 make_dispatch, plan_decode_migrations,
                                 predicted_ttft)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.metrics import percentile_report, slo_frac_percentile
from repro_torch.core.predictor import (DecodeStepPredictor, OnlineTTFTPredictor,
                                  expected_accept_tokens,
                                  TTFTPredictor)
from repro_torch.core.prefixcache import PrefixBlockManager
from repro_torch.core.tieredcache import TieredBlockManager
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import (DecodeEntry, DecodeSchedulerCore,
                                  HybridSchedulerCore, SchedulerCore)
from repro_torch.sim.costmodel import (DecodeCostModel, HardwareSpec,
                                 PrefillCostModel, resolve_hardware)
from repro_torch.sim.simulator import (ARRIVAL, DECODE_DONE, DECODE_JOIN,
                                 InstanceEngine, SimConfig, handle_event,
                                 reset_requests)

# hybrid-instance step completion (the colocated engine self-chains these;
# prefill/decode event kinds 0..4 live in repro_torch.sim.simulator)
HYBRID_STEP = 5
# tiered prefix cache: a request whose cold (host/disk-resident) prefix won
# the promote-vs-recompute gate arrives at its instance only after the copy
# lands — TTFT includes the promotion latency by construction
PROMOTE_DONE = 6
# instance churn (core/faults.py FaultPlan): an instance leaves the pool
# (crash / spot kill / watchdog-detected hang / link drop) or rejoins it.
# Payload is (phase, FaultEvent); phases: "drain" (spot notice), "freeze"
# (hang onset), "kill" (strand queued+running work), "slow"/"unslow"
# (gray slowdown), "link"/"unlink" (decode kv_link drop), "up" (rejoin).
INSTANCE_DOWN = 7
INSTANCE_UP = 8

# token count at which per-instance peak prefill throughput (the
# capacity-weighted dispatch normalizer) is probed: long enough to saturate
# compute on every supported hardware generation
CAPACITY_PROBE_TOKENS = 8192


@dataclass
class _DecodeJob:
    request: Request
    joined: float                         # first enqueue (fixes the deadline)
    done: float = 0.0                     # tokens decoded (fractional)
    order: int = 0                        # admission order (FCFS / tiebreak)

    @property
    def context(self) -> float:
        """Current context (prompt + decoded) — KV held / to hand off."""
        return self.request.num_tokens + self.done

    @property
    def remaining(self) -> float:
        return self.request.output_tokens - self.done


class DecodeSim:
    """One decode instance: a continuous batch in which all RESIDENT requests
    advance together at 1/t_step(B, mean_context) tokens/sec (processor
    sharing). Batch changes re-rate everyone; stale completion events are
    invalidated by an epoch counter, so events are O(joins + leaves).

    With ``max_batch > 0`` at most that many streams are resident (KV slot
    cap); the rest wait in an admission queue ordered by the scheduler policy
    (`DecodeSchedulerCore`): FCFS, or decode S-EDF with token-boundary
    preemption. ``max_batch = 0`` (default) reproduces the original unbounded
    processor-sharing decode event-for-event."""

    def __init__(self, cost: DecodeCostModel, heap: List, seq,
                 instance_id: int = 0, *, max_batch: int = 0,
                 scheduler: Optional[DecodeSchedulerCore] = None,
                 step_predictor: Optional[DecodeStepPredictor] = None,
                 spec_decode: bool = False, draft_k: int = 4,
                 spec_accept: float = 0.0):
        self.cost = cost
        self.heap = heap
        self.seq = seq
        self.instance_id = instance_id
        self.max_batch = max_batch
        self.sched = scheduler or DecodeSchedulerCore(policy="fcfs")
        self.step_pred = step_predictor \
            or DecodeStepPredictor(prior=cost.step_time)
        # speculative decoding (fluid model): a stream with per-token accept
        # probability `a` (Request.spec_accept, falling back to the
        # instance-wide `spec_accept`) advances expected_accept_tokens(a, k)
        # tokens per step — the SAME analytic accept surface the runtime's
        # EMA converges to (evaluated-is-deployed). Off by default: every
        # rate below multiplies/divides by exactly 1.0, bit-identical.
        self.spec_decode = spec_decode
        self.draft_k = draft_k
        self.spec_accept = spec_accept
        self.jobs: Dict[int, _DecodeJob] = {}      # resident batch
        self.waiting: Dict[int, _DecodeJob] = {}   # queued for admission
        self.epoch = 0
        self.last_update = 0.0
        self.finished: List[Request] = []
        self.preemptions = 0
        self.frozen = False     # hung (fault injection): no progress, no
                                # completion events, until killed or revived
        self._order = itertools.count()

    def _step_time(self) -> float:
        if not self.jobs:
            return 0.0
        ctx = sum(j.request.num_tokens + j.done for j in self.jobs.values())
        return self.cost.step_time(len(self.jobs), ctx / len(self.jobs))

    def _e_of(self, job: _DecodeJob) -> float:
        """E[tokens committed per step] for one stream (1.0 = plain)."""
        if not self.spec_decode:
            return 1.0
        a = float(getattr(job.request, "spec_accept", 0.0) or self.spec_accept)
        return expected_accept_tokens(a, self.draft_k)

    def _e_mean(self, jobs) -> float:
        jobs = list(jobs)
        if not self.spec_decode or not jobs:
            return 1.0
        return sum(self._e_of(j) for j in jobs) / len(jobs)

    def _advance(self, now: float) -> None:
        dt = now - self.last_update
        self.last_update = now
        if dt <= 0 or not self.jobs or self.frozen:
            return
        t_step = self._step_time()
        gained = dt / t_step if t_step > 0 else float("inf")
        for j in self.jobs.values():
            j.done = min(j.done + gained * self._e_of(j),
                         float(j.request.output_tokens))

    def _reschedule(self, now: float) -> None:
        self.epoch += 1
        if not self.jobs or self.frozen:
            return
        t_step = self._step_time()
        t_next = min((j.request.output_tokens - j.done) * t_step
                     / self._e_of(j)
                     for j in self.jobs.values())
        heapq.heappush(self.heap, (now + max(t_next, 0.0), next(self.seq),
                                   DECODE_DONE, (self, self.epoch)))

    def _rebatch(self, now: float) -> None:
        """Re-run batch admission after a membership change. Residents keep
        insertion order (the float-sum order of `_step_time`); preempted
        streams keep their progress and re-queue."""
        everyone = {**self.jobs, **self.waiting}
        if self.max_batch <= 0:
            self.jobs = everyone          # unbounded: plain processor sharing
            self.waiting = {}
            return
        if not everyone:
            return
        total = len(everyone)
        b_eff = min(self.max_batch, total)
        ctx = sum(j.context for j in everyone.values())
        # per-accepted-token pricing for S-EDF slack (speculation commits
        # E[tokens/step] tokens per step; /1.0 without it)
        t_step = self.step_pred.step_time(b_eff, ctx / total) \
            / self._e_mean(everyone.values())
        entries = [DecodeEntry(key=rid, remaining_tokens=j.remaining,
                               deadline=j.request.decode_deadline,
                               order=j.order)
                   for rid, j in everyone.items()]
        batch, preempted = self.sched.select_batch(
            entries, set(self.jobs), self.max_batch, now, t_step)
        for rid in preempted:
            self.preemptions += 1
            everyone[rid].request.decode_preemptions += 1
        self.jobs = {rid: everyone[rid] for rid in batch}
        self.waiting = {rid: j for rid, j in everyone.items()
                        if rid not in self.jobs}

    # ------------------------------------------------------------- pressure
    def pressure(self, req: Request, now: float) -> float:
        """Predicted TBT pressure were `req`'s decode to join this instance
        now: the effective step time (`DecodeLoad.effective_step` — the ONE
        slot-cap + queue-time-sharing formula, shared with the migration
        planner) at population N+1 over the candidate's TBT SLO (1.0 =
        exactly at the SLO knee). Read-only — uses the jobs' last
        materialized progress, which only perturbs the mean context."""
        if req.tbt_slo <= 0 or not math.isfinite(req.tbt_slo):
            return 0.0
        return self.snapshot_load().effective_step(
            1, float(req.num_tokens)) / req.tbt_slo

    @property
    def backlog(self) -> int:
        """Streams held (resident + queued) — the least-batch join signal."""
        return len(self.jobs) + len(self.waiting)

    def snapshot_load(self) -> DecodeLoad:
        """Migration-planner view of this instance (core/dispatch.py)."""
        ctx = sum(j.context for j in self.jobs.values()) \
            + sum(j.context for j in self.waiting.values())
        step_time = self.step_pred.step_time
        if self.spec_decode:
            # migration gating prices the per-ACCEPTED-token service rate
            e = self._e_mean(list(self.jobs.values())
                             + list(self.waiting.values()))
            if e > 1.0:
                raw = step_time
                step_time = lambda b, c, _f=raw, _e=e: _f(b, c) / _e  # noqa: E731
        return DecodeLoad(instance_id=self.instance_id,
                          n_resident=len(self.jobs),
                          n_waiting=len(self.waiting),
                          ctx_tokens=ctx, max_batch=self.max_batch,
                          step_time=step_time)

    # --------------------------------------------------------------- events
    def join(self, req: Request, now: float) -> None:
        if req.decode_start is None:
            req.decode_start = now        # fixes Request.decode_deadline
        job = _DecodeJob(request=req, joined=now, order=next(self._order))
        self._admit(job, now)

    def migrate_in(self, job: _DecodeJob, now: float) -> None:
        """Arrival of a migrated stream (KV transfer done): re-enters
        admission with its progress and ORIGINAL deadline intact."""
        job.order = next(self._order)
        self._admit(job, now)

    def _admit(self, job: _DecodeJob, now: float) -> None:
        self._advance(now)
        self.waiting[job.request.rid] = job
        self._rebatch(now)
        self._reschedule(now)

    def pop_waiting(self, rid: int) -> _DecodeJob:
        """Remove a QUEUED stream (migration departure). Never touches the
        resident batch, so no re-rate or reschedule is needed."""
        return self.waiting.pop(rid)

    # ------------------------------------------------------- fault injection
    def freeze(self, now: float) -> None:
        """Hang onset: materialize progress up to now, then stop — pending
        completion events go stale (epoch bump) and no new ones schedule
        until the instance is killed (strand) or thaws."""
        self._advance(now)
        self.frozen = True
        self.epoch += 1                   # invalidates in-flight DECODE_DONE

    def thaw(self, now: float) -> None:
        self.frozen = False
        self.last_update = now
        self._rebatch(now)
        self._reschedule(now)

    def strand(self, now: float) -> List[Request]:
        """Instance death: every held stream (resident + queued) loses its
        KV and is returned to the cluster for recovery. Leaves the instance
        empty and un-frozen (ready for a later rejoin)."""
        if not self.frozen:
            self._advance(now)
        victims = [j.request for j in self.jobs.values()] \
            + [j.request for j in self.waiting.values()]
        self.jobs.clear()
        self.waiting.clear()
        self.epoch += 1
        self.frozen = False
        self.last_update = now
        return victims

    def on_decode_done(self, payload, now: float) -> List[Request]:
        _, epoch = payload
        if epoch != self.epoch:
            return []                                  # stale
        self._advance(now)
        done = [j for j in self.jobs.values()
                if j.done >= j.request.output_tokens - 1e-6]
        for j in done:
            r = j.request
            r.finish_time = now
            r.mean_tpot = (now - j.joined) / max(r.output_tokens, 1)
            del self.jobs[r.rid]
            self.finished.append(r)
        self._rebatch(now)                # freed slots admit from the queue
        self._reschedule(now)
        return [j.request for j in done]


class _SlowedCost:
    """Gray-failure wrapper around a PrefillCostModel: every operator takes
    ``factor``x as long. The task already running when the slowdown fires
    keeps its scheduled completion (the factor applies from the next task),
    and dispatch sees the de-rated capacity immediately."""

    def __init__(self, base, factor: float):
        self._base = base
        self.factor = factor
        self.m = base.m
        self.hw = base.hw

    def op_durations(self, tokens, chunk_tokens=0, prefix=0):
        return self._base.op_durations(tokens, chunk_tokens, prefix) \
            * self.factor


@dataclass
class _HybridPrefill:
    """One prompt mid-prefill on a hybrid instance: `done` tokens computed
    so far — the resume offset the next admitted slice starts at."""
    request: Request
    done: int = 0


class HybridSim:
    """One colocated (prefill + decode) instance: the unified token-budget
    runtime's cost-model twin (serving/hybrid_instance.py — evaluated is
    deployed: both drive the SAME `HybridSchedulerCore`).

    Round-driven rather than task-driven: each self-chained HYBRID_STEP event
    executes one `plan_step` round — the admitted prefill slices run as
    operator-chunked compute, and decode steps are WOVEN between operators at
    an SLO-derived cadence (the colocation payoff of operator-level
    interruption: a prefill chunk yields to decode within ~1 operator, so
    decode TBT is set by the weave cadence, not by whole-chunk serialization).
    With C = sum of slice costs, s = DecodeCostModel.step_time(B, mean_ctx),
    and cadence target tau = margin * min resident tbt_slo (clamped to
    s + one operator — the true yield latency floor), the round prices as

        k      = ceil(C / (tau - s))     woven decode steps (>= 1)
        t_round = round_overhead + C + k*s

    so every admitted decode stream advances k tokens with TPOT ~= tau, and
    phase interference is the measured-model cost of real work serialized at
    operator granularity — not fig16's hard-coded 0.65 utilization tax. A
    prefill-completed request joins THIS instance's decode phase directly
    (its KV is already in the shared pool — no PD handoff, no
    `kv_transfer_time`)."""

    # decode cadence targets this fraction of the tightest resident TBT SLO,
    # leaving headroom for round overheads and plan jitter
    CADENCE_MARGIN = 0.8

    def __init__(self, cost: PrefillCostModel, decode_cost: DecodeCostModel,
                 heap: List, seq, instance_id: int = 0, *,
                 token_budget: int = 4096, chunk_tokens: int = 512,
                 decode_max_batch: int = 0, policy: str = "s-edf",
                 decode_policy: str = "s-edf",
                 decode_preempt: Optional[bool] = None,
                 predictor: Optional[TTFTPredictor] = None,
                 round_overhead: float = 100e-6, capacity: float = 1.0,
                 spec_decode: bool = False, draft_k: int = 4,
                 spec_accept: float = 0.0):
        self.cost = cost
        self.decode_cost = decode_cost
        # speculative decoding (fluid model) — same accept surface as
        # DecodeSim: each woven decode step advances E[a, k] tokens and each
        # admitted stream prices E budget tokens in plan_step
        self.spec_decode = spec_decode
        self.draft_k = draft_k
        self.spec_accept = spec_accept
        self.heap = heap
        self.seq = seq
        self.instance_id = instance_id
        self.capacity = capacity
        self.predictor = predictor
        self.chunk_tokens = chunk_tokens
        self.round_overhead = round_overhead
        self.core = HybridSchedulerCore(
            prefill=SchedulerCore(predictor=predictor, policy=policy,
                                  enable_batching=False),
            decode=DecodeSchedulerCore(
                policy=decode_policy,
                preempt=(decode_policy == "s-edf") if decode_preempt is None
                else decode_preempt),
            token_budget=token_budget, chunk_tokens=chunk_tokens,
            decode_max_batch=decode_max_batch)
        # yield latency floor: the longest single operator of a budget-sized
        # chunk — decode can interrupt prefill no faster than one operator
        probe = chunk_tokens if chunk_tokens > 0 else 512
        self.op_yield = float(max(cost.op_durations(probe, chunk_tokens)))
        self.prefills: Dict[int, _HybridPrefill] = {}
        self.jobs: Dict[int, _DecodeJob] = {}     # every local decode stream
        self.resident: Set[int] = set()           # last step's decode batch
        self.busy = False
        self.epoch = 0
        self.steps = 0
        self.preemptions = 0                      # decode displacements
        self.finished: List[Request] = []
        self.n_dispatched = 0
        self.blocking: List[float] = []           # kept for result plumbing
        self._order = itertools.count()
        # mixed-pool wiring (set by ClusterSim.run when a dedicated decode
        # pool exists and hybrid_decode_offload is on): completed prefills
        # hand off instead of decoding locally, so the hybrid stays a
        # weave-tax-free prefill absorber and decode consolidates on the
        # dedicated cards
        self.offload: Optional[Callable[[Request, float], None]] = None
        # tiered prefix residency (set by ClusterSim.run in tiered mode):
        # called when a prefill finishes so the cluster can commit the
        # prompt's chain keys to THIS instance's block manager
        self.on_prefill_done: Optional[Callable[[Request, float],
                                                None]] = None

    # ---------------------------------------------------------------- load
    def snapshot_load(self, candidate: Request, now: float) -> InstanceLoad:
        items = [(float(p.request.num_tokens - p.done),
                  p.request.deadline) for p in self.prefills.values()]
        predict = self.predictor.predict if self.predictor is not None \
            else None
        return InstanceLoad(
            instance_id=self.instance_id,
            queued_tokens=competing_tokens(items, candidate, now, predict),
            n_outstanding=len(self.prefills),
            capacity=self.capacity)

    def pressure(self, req: Request, now: float) -> float:
        """Predicted TBT pressure were this request decoded here — the SAME
        `DecodeLoad.effective_step` formula DecodeSim/the migration planner
        price with, over the local decode population."""
        if req.tbt_slo <= 0 or not math.isfinite(req.tbt_slo):
            return 0.0
        cap = self.core.decode_max_batch
        n = len(self.jobs)
        n_res = min(n, cap) if cap > 0 else n
        load = DecodeLoad(instance_id=self.instance_id, n_resident=n_res,
                          n_waiting=n - n_res,
                          ctx_tokens=sum(j.context for j in self.jobs.values()),
                          max_batch=cap, step_time=self.decode_cost.step_time)
        return load.effective_step(1, float(req.num_tokens)) / req.tbt_slo

    # --------------------------------------------------------------- events
    def on_arrival(self, req: Request, now: float) -> None:
        self.n_dispatched += 1
        # prefix-cache hit (set by the cluster's residency model, 0 without
        # sharing): those tokens' KV is already resident, so the first
        # admitted slice resumes past them — same as the runtime's
        # table.length-seeded chunk offset
        done = min(int(getattr(req, "prefix_hit", 0)),
                   max(req.num_tokens - 1, 0))
        self.prefills[req.rid] = _HybridPrefill(request=req, done=done)
        if not self.busy:
            self._start_step(now)

    def _decode_entries(self) -> List[DecodeEntry]:
        return [DecodeEntry(key=rid, remaining_tokens=j.remaining,
                            deadline=j.request.decode_deadline, order=j.order)
                for rid, j in self.jobs.items()]

    def _e_of(self, job) -> float:
        """Expected accepted tokens per decode step for one stream."""
        if not self.spec_decode:
            return 1.0
        a = float(getattr(job.request, "spec_accept", 0.0) or self.spec_accept)
        return expected_accept_tokens(a, self.draft_k)

    def _e_mean(self, jobs) -> float:
        jobs = list(jobs)
        if not self.spec_decode or not jobs:
            return 1.0
        return sum(self._e_of(j) for j in jobs) / len(jobs)

    def _start_step(self, now: float) -> None:
        """Plan one hybrid step and schedule its completion event."""
        entries = self._decode_entries()
        e_mean = self._e_mean(self.jobs.values())
        t_hint = 0.0
        if entries:
            cap = self.core.decode_max_batch
            b = min(len(entries), cap) if cap > 0 else len(entries)
            ctx = sum(j.context for j in self.jobs.values()) / len(self.jobs)
            # slack hint prices the per-ACCEPTED-token rate, matching the
            # runtime's `_t_token` (decode_instance.py)
            t_hint = self.decode_cost.step_time(b, ctx) / e_mean
        plan = self.core.plan_step(
            now, prefill=[p.request for p in self.prefills.values()],
            prefill_done={rid: p.done for rid, p in self.prefills.items()},
            decode_entries=entries, decode_resident=self.resident,
            t_step=t_hint, decode_cost=e_mean)
        if plan.empty:
            self.busy = False
            return
        for rid in plan.preempted_decode:
            self.preemptions += 1
            self.jobs[rid].request.decode_preemptions += 1
        s_dec = 0.0
        if plan.decode_keys:
            ctx = sum(self.jobs[k].context for k in plan.decode_keys) \
                / len(plan.decode_keys)
            s_dec = self.decode_cost.step_time(len(plan.decode_keys), ctx)
        c_pre = 0.0
        for s in plan.prefill_slices:
            # incremental resumed-chunk cost: compute [offset, offset+n)
            # with the first `offset` tokens' KV already present
            c_pre += self.cost.prefill_time(s.offset + s.n_tokens,
                                            self.chunk_tokens, prefix=s.offset)
        # weave k decode steps through the round's prefill compute at the
        # SLO-derived cadence (see class docstring); pure decode rounds and
        # pure prefill rounds degenerate to k=1 / k=0
        k = 0
        if plan.decode_keys:
            if c_pre > 0:
                tau = self.CADENCE_MARGIN * min(
                    (self.jobs[key].request.tbt_slo
                     for key in plan.decode_keys
                     if math.isfinite(self.jobs[key].request.tbt_slo)
                     and self.jobs[key].request.tbt_slo > 0),
                    default=math.inf)
                gap = max(tau - s_dec, self.op_yield)
                k = max(1, math.ceil(c_pre / gap)) if math.isfinite(gap) \
                    else 1
            else:
                k = 1
        t = self.round_overhead + c_pre + k * s_dec
        self.busy = True
        self.epoch += 1
        heapq.heappush(self.heap, (now + t, next(self.seq), HYBRID_STEP,
                                   (self, self.epoch, plan, k)))

    def on_step(self, payload, now: float) -> None:
        _, epoch, plan, k = payload
        if epoch != self.epoch:
            return                                 # stale (defensive)
        self.steps += 1
        done_decode: List[int] = []
        for key in plan.decode_keys:
            j = self.jobs[key]
            j.done += min(float(k) * self._e_of(j), j.remaining)
            if j.done >= j.request.output_tokens:
                r = j.request
                r.finish_time = now
                r.mean_tpot = (now - j.joined) / max(r.output_tokens, 1)
                done_decode.append(key)
                self.finished.append(r)
        gone = set(done_decode)
        for key in gone:
            del self.jobs[key]
        self.resident = {k for k in plan.decode_keys if k not in gone}
        for s in plan.prefill_slices:
            p = self.prefills[s.key]
            p.done += s.n_tokens
            r = p.request
            # remaining-work basis for S-EDF ranking (ops_total stays 0, so
            # Request.remaining_tokens() reads batch_tokens directly)
            r.batch_tokens = max(r.num_tokens - p.done, 1)
            if p.done >= r.num_tokens:
                r.first_token_time = now
                r.state = RequestState.DONE
                del self.prefills[s.key]
                if self.on_prefill_done is not None:
                    self.on_prefill_done(r, now)
                if r.output_tokens > 0:
                    if self.offload is not None:
                        self.offload(r, now)
                    else:
                        # local decode join: the KV is already resident —
                        # no PD handoff, no transfer pricing
                        r.decode_start = now
                        self.jobs[r.rid] = _DecodeJob(
                            request=r, joined=now, order=next(self._order))
        self._start_step(now)


@dataclass
class ClusterResult:
    requests: List[Request]
    blocking_times: List[float]
    rounds: int
    preemptions: int
    makespan: float
    dispatched: List[int]                 # requests routed per prefill instance
    decoded: int = 0
    decode_preemptions: int = 0           # token-boundary batch displacements
    migrations: int = 0                   # decode streams moved cross-instance
    prefix_hit_tokens: int = 0            # prompt tokens served from prefix
                                          # caches (skipped recompute)
    prefix_evictions: int = 0             # cache blocks LRU-evicted
    prefix_promoted_tokens: int = 0       # hit tokens that had to be copied
                                          # up from host/disk first (tiered)
    tier_demotions: int = 0               # blocks demoted HBM -> host tier
    retries: int = 0                      # stranded-work re-dispatches (churn)
    shed_requests: int = 0                # rejected at admission (shedding)
    lost_requests: int = 0                # stranded forever: naive mode, or
                                          # retry budget exhausted

    @property
    def attainment(self) -> float:
        """TTFT-SLO attainment (comparable with single-instance SimResult)."""
        met = sum(1 for r in self.requests if r.slo_met)
        return met / max(len(self.requests), 1)

    @property
    def tbt_attainment(self) -> float:
        """Decode-phase TBT/TPOT-SLO attainment (prefill-only requests are
        vacuously met, mirroring Request.tbt_met)."""
        met = sum(1 for r in self.requests if r.tbt_met)
        return met / max(len(self.requests), 1)

    @property
    def e2e_attainment(self) -> float:
        """End-to-end goodness: TTFT and decode-TBT SLOs both attained."""
        met = sum(1 for r in self.requests if r.e2e_met)
        return met / max(len(self.requests), 1)

    @property
    def ttft_p99_norm(self) -> float:
        """p99 of TTFT/SLO over all requests (<= 1.0: the 99th-percentile
        request met its TTFT SLO; unfinished requests count as +inf). The
        tail-gated statistic fig23 frontiers are built from."""
        return slo_frac_percentile(self.requests, 99.0, "ttft")

    @property
    def tbt_p99_norm(self) -> float:
        """p99 of mean-TPOT/tbt_slo over decoding requests."""
        return slo_frac_percentile(self.requests, 99.0, "tbt")

    @property
    def e2e_p99_norm(self) -> float:
        """p99 of max(TTFT/SLO, TPOT/TBT-SLO) per request — the end-to-end
        tail counterpart of `e2e_attainment`."""
        return slo_frac_percentile(self.requests, 99.0, "e2e")

    def percentiles(self, by_task: bool = True) -> dict:
        """Full percentile families (p50/p90/p99 TTFT & TBT, aggregate and
        per task class) — `repro_torch.core.metrics.percentile_report` shape,
        identical to `Proxy.report()['percentiles']`."""
        return percentile_report(self.requests, by_task=by_task)

    @property
    def admitted(self) -> List[Request]:
        """Requests NOT rejected by admission control (shedding). Shed
        requests get an explicit rejection, so they are not tail events for
        the clients the system chose to serve — the admitted-view metrics
        are what the overload panel of fig26 gates."""
        return [r for r in self.requests if not r.shed]

    @property
    def admitted_attainment(self) -> float:
        adm = self.admitted
        met = sum(1 for r in adm if r.slo_met)
        return met / max(len(adm), 1)

    @property
    def admitted_ttft_p99_norm(self) -> float:
        return slo_frac_percentile(self.admitted, 99.0, "ttft")

    @property
    def imbalance(self) -> float:
        """max/mean dispatched requests across instances (1.0 = perfect)."""
        mean = sum(self.dispatched) / max(len(self.dispatched), 1)
        return max(self.dispatched) / max(mean, 1e-9)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from per-instance prefix caches
        (0.0 with sharing disabled)."""
        total = sum(r.num_tokens for r in self.requests)
        return self.prefix_hit_tokens / max(total, 1)

    @property
    def promote_hit_rate(self) -> float:
        """Fraction of prefix-hit tokens that were cold — served by paying
        a host/disk promotion copy rather than from warm HBM (0.0 when
        untiered: every hit is warm)."""
        return self.prefix_promoted_tokens / max(self.prefix_hit_tokens, 1)


class ClusterSim:
    """N-instance prefill cluster + dispatch + decode phase, one event heap.

    Heterogeneous pools: pass ``hardware`` (one HardwareSpec per prefill
    instance — ``num_instances`` is then taken from its length). Each instance
    gets its own cost model, its own TTFT predictor fitted to its hardware
    (shared across same-spec instances), and a capacity (peak prefill
    throughput) surfaced to dispatch via ``InstanceLoad.capacity``. The
    dispatch-level predictor stays the reference one — load-blind JSQ on a
    mixed pool prices every instance's backlog at the same speed, which is
    exactly the failure mode capacity-weighted dispatch fixes.

    ``online_refit=True`` replaces each instance's predictor with an
    `OnlineTTFTPredictor` seeded from the reference fit: engines feed observed
    batch latencies back, so per-instance feasibility pricing converges to the
    instance's true speed even when the prior was fitted elsewhere.

    Decode stage: with ``decode-aware`` dispatch (or ``decode_affinity=True``)
    completed prefills hand over to the PAIRED decode instance (prefill i ->
    decode i mod D, the disaggregated-pool wiring that makes downstream
    pressure attributable); otherwise they join the least-loaded decode batch
    as before. ``decode_hardware`` heterogenizes the decode pool the same way.

    Decode scheduling (see module docstring / docs/SCHEDULING.md):
    ``decode_max_batch`` caps each decode instance's continuous batch (KV
    slots; 0 = unbounded processor sharing, the original model);
    ``decode_policy`` picks the admission order ("fcfs" | "s-edf");
    ``decode_preempt`` enables token-boundary displacement (defaults to True
    exactly when the policy is "s-edf"); ``decode_migration`` turns on
    cost-gated migration of queued decodes off over-the-knee instances
    (``migration_knee``, ``max_migrations`` tune the gates).
    """

    def __init__(self, cost: PrefillCostModel, sim_cfg: SimConfig, *,
                 num_instances: int = 2,
                 dispatch: str = "round-robin",
                 predictor: Optional[TTFTPredictor] = None,
                 decode_instances: int = 0,
                 decode_cost: Optional[DecodeCostModel] = None,
                 hardware: Optional[Sequence[HardwareSpec]] = None,
                 decode_hardware: Optional[Sequence[HardwareSpec]] = None,
                 online_refit: bool = False,
                 decode_affinity: Optional[bool] = None,
                 decode_max_batch: int = 0,
                 decode_policy: str = "fcfs",
                 decode_preempt: Optional[bool] = None,
                 decode_migration: bool = False,
                 migration_knee: float = 0.85,
                 max_migrations: int = 1,
                 prefix_cache_blocks: int = 0,
                 prefix_block: int = 128,
                 host_cache_blocks: int = 0,
                 disk_cache_blocks: int = 0,
                 hybrid_instances: int = 0,
                 hybrid_token_budget: Optional[int] = None,
                 hybrid_chunk_tokens: Optional[int] = None,
                 hybrid_decode_offload: bool = False,
                 fault_plan: Optional["FaultPlan"] = None,
                 recovery: str = "retry",
                 max_retries: int = 3,
                 retry_backoff: float = 0.05,
                 retry_backoff_cap: float = 2.0,
                 watchdog_s: float = 1.0,
                 shed_policy: str = "off",
                 shed_budget: float = 2.0,
                 spec_decode: bool = False,
                 draft_k: int = 4,
                 spec_accept: float = 0.0):
        if hardware is not None:
            hardware = [resolve_hardware(hw) for hw in hardware]
            num_instances = len(hardware)
        if num_instances < 1 and hybrid_instances < 1:
            raise ValueError("need at least one prefill or hybrid instance")
        self.cost = cost
        self.cfg = sim_cfg
        chunk = sim_cfg.chunk_tokens
        self.predictor = predictor or TTFTPredictor.from_cost_model(
            lambda n: cost.prefill_time(n, chunk), max_tokens=32768)
        self.num_instances = num_instances
        self.policy: DispatchPolicy = make_dispatch(dispatch, self.predictor)
        self.online_refit = online_refit

        # per-instance cost models + predictors (predictors cached per
        # hardware spec so a 4x-same-card pool fits once)
        if hardware is not None:
            self.instance_costs = [PrefillCostModel(cost.m, hw)
                                   for hw in hardware]
        else:
            self.instance_costs = [cost] * num_instances
        fits: Dict[str, TTFTPredictor] = {cost.hw.name: self.predictor}
        self.instance_predictors: List[TTFTPredictor] = []
        for c in self.instance_costs:
            if c.hw.name not in fits:
                fits[c.hw.name] = TTFTPredictor.from_cost_model(
                    lambda n, c=c: c.prefill_time(n, chunk), max_tokens=32768)
            self.instance_predictors.append(fits[c.hw.name])
        self.capacities = [c.throughput(CAPACITY_PROBE_TOKENS, chunk)
                           for c in self.instance_costs]

        self.num_decode = decode_instances
        if decode_hardware is not None:
            decode_hardware = [resolve_hardware(hw) for hw in decode_hardware]
            if decode_instances and len(decode_hardware) != decode_instances:
                raise ValueError("decode_hardware length must match "
                                 "decode_instances")
            self.num_decode = len(decode_hardware)
            self.decode_costs = [DecodeCostModel(cost.m, hw)
                                 for hw in decode_hardware]
        else:
            self.decode_costs = [decode_cost
                                 or DecodeCostModel(cost.m, cost.hw)] \
                * self.num_decode
        if decode_affinity is None:
            decode_affinity = self.policy.needs_decode_pressure
        self.decode_affinity = decode_affinity and self.num_decode > 0
        if decode_policy not in ("fcfs", "s-edf"):
            raise ValueError(f"unknown decode_policy {decode_policy!r}; "
                             f"known: ['fcfs', 's-edf']")
        self.decode_max_batch = decode_max_batch
        self.decode_policy = decode_policy
        self.decode_preempt = (decode_policy == "s-edf") \
            if decode_preempt is None else decode_preempt
        if decode_migration and decode_max_batch <= 0:
            # migration moves QUEUED decodes; an unbounded instance admits
            # everything immediately, so the flag would be a silent no-op
            raise ValueError("decode_migration requires a decode_max_batch "
                             "slot cap (> 0): unbounded decode never queues")
        self.decode_migration = decode_migration and self.num_decode > 1
        self.migration_knee = migration_knee
        self.max_migrations = max_migrations
        # prefix sharing: per-instance cache-residency model (the SAME
        # PrefixBlockManager the real PagedKVCache delegates to — evaluated
        # is deployed), `prefix_cache_blocks` capacity each, keyed on
        # Request.prefix_hash at `prefix_block` tokens per block. 0 = no
        # sharing: every request prefills from token 0 (the original model).
        self.prefix_cache_blocks = prefix_cache_blocks
        self.prefix_block = prefix_block
        # tiered residency: evicted blocks demote into a `host_cache_blocks`
        # host tier (then a `disk_cache_blocks` disk tier) instead of
        # vanishing, and dispatch prices warm/cold/absent as three prices —
        # a cold hit is taken only when the predictor says the promotion
        # copy (HardwareSpec.host_bw/disk_bw links) beats recompute. 0 host
        # blocks = the single-tier model above, byte-identical.
        if host_cache_blocks > 0 and prefix_cache_blocks <= 0:
            raise ValueError("host_cache_blocks requires prefix sharing "
                             "(prefix_cache_blocks > 0)")
        self.host_cache_blocks = host_cache_blocks
        self.disk_cache_blocks = disk_cache_blocks
        self.tiered = prefix_cache_blocks > 0 and host_cache_blocks > 0
        # colocated pool: `hybrid_instances` HybridSim engines appended after
        # the prefill pool in dispatch order (indices num_instances..), each
        # running prefill chunks + local decode in one token-budget step.
        # Budget defaults to the sim batch budget, slice quantum to the
        # prefill chunk size; 0 instances leaves every legacy path untouched.
        self.num_hybrid = hybrid_instances
        self.hybrid_token_budget = sim_cfg.batch_budget \
            if hybrid_token_budget is None else hybrid_token_budget
        self.hybrid_chunk_tokens = sim_cfg.chunk_tokens \
            if hybrid_chunk_tokens is None else hybrid_chunk_tokens
        self.hybrid_decode_cost = decode_cost \
            or DecodeCostModel(cost.m, cost.hw)
        self.hybrid_capacity = cost.throughput(CAPACITY_PROBE_TOKENS, chunk) \
            if hybrid_instances > 0 else 0.0
        # mixed pools: hand hybrid-prefilled streams to the dedicated decode
        # pool (requires one) instead of decoding them locally
        self.hybrid_decode_offload = hybrid_decode_offload \
            and hybrid_instances > 0 and self.num_decode > 0
        # instance churn (core/faults.py): a FaultPlan schedules per-instance
        # crash/hang/slowdown/spot/kv_link faults. `recovery="retry"` strands
        # a dying instance's work back to the dispatch layer and re-dispatches
        # with capped exponential backoff under a per-request retry budget;
        # `recovery="none"` is the naive baseline (stranded = lost, +inf tail
        # events). With `fault_plan=None` (default) every churn branch is
        # unreachable — committed fig9..fig25 baselines stay byte-equal.
        if recovery not in ("none", "retry"):
            raise ValueError(f"unknown recovery mode {recovery!r}; "
                             f"known: ['none', 'retry']")
        if shed_policy not in ("off", "doomed-only", "budget"):
            raise ValueError(
                f"unknown shed_policy {shed_policy!r}; "
                f"known: ['off', 'doomed-only', 'budget']")
        self.fault_plan = fault_plan
        self.recovery = recovery
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.retry_backoff_cap = retry_backoff_cap
        self.watchdog_s = watchdog_s
        # SLO-aware admission control (graceful degradation): "doomed-only"
        # sheds a fresh arrival when every live instance predicts a TTFT past
        # its SLO AND the pool is saturated; "budget" sheds when the best
        # predicted TTFT exceeds shed_budget * slo. Off by default.
        self.shed_policy = shed_policy
        self.shed_budget = shed_budget
        # speculative decoding (fluid model): decode/hybrid engines advance
        # expected_accept_tokens(a, draft_k) tokens per step, with `a` read
        # from Request.spec_accept (falling back to the cluster-wide
        # spec_accept). Off by default — every E factor is exactly 1.0 and
        # committed fig9..fig26 baselines stay byte-equal.
        self.spec_decode = spec_decode
        self.draft_k = draft_k
        self.spec_accept = spec_accept

    def run(self, requests: Sequence[Request]) -> ClusterResult:
        heap: List[Tuple[float, int, int, object]] = []
        seq = itertools.count()
        predictors = self.instance_predictors
        if self.online_refit:
            predictors = [OnlineTTFTPredictor.from_predictor(p)
                          for p in predictors]
        self.run_predictors = predictors      # exposed for refit inspection
        engines = [InstanceEngine(self.instance_costs[i], self.cfg,
                                  predictors[i], heap, seq, instance_id=i,
                                  capacity=self.capacities[i])
                   for i in range(self.num_instances)]
        decodes = [DecodeSim(self.decode_costs[i], heap, seq, instance_id=i,
                             max_batch=self.decode_max_batch,
                             scheduler=DecodeSchedulerCore(
                                 policy=self.decode_policy,
                                 preempt=self.decode_preempt),
                             spec_decode=self.spec_decode,
                             draft_k=self.draft_k,
                             spec_accept=self.spec_accept)
                   for i in range(self.num_decode)]
        hybrids = [HybridSim(self.cost, self.hybrid_decode_cost, heap, seq,
                             instance_id=self.num_instances + i,
                             token_budget=self.hybrid_token_budget,
                             chunk_tokens=self.hybrid_chunk_tokens,
                             decode_max_batch=self.decode_max_batch,
                             policy=self.cfg.policy,
                             decode_policy=self.decode_policy,
                             decode_preempt=self.decode_preempt,
                             predictor=self.predictor,
                             round_overhead=self.cfg.round_overhead,
                             capacity=self.hybrid_capacity,
                             spec_decode=self.spec_decode,
                             draft_k=self.draft_k,
                             spec_accept=self.spec_accept)
                   for i in range(self.num_hybrid)]
        n_migrations = 0
        reset_requests(requests)
        for r in requests:
            heapq.heappush(heap, (r.arrival, next(seq), ARRIVAL, r))

        # ---------------------------------------------------- instance churn
        # pool-membership state driven by INSTANCE_DOWN/INSTANCE_UP events.
        # All sets stay empty with fault_plan=None, so the legacy event loop
        # is untouched (committed baselines byte-equal).
        down_p: Set[int] = set()        # dead prefill engines
        drain_p: Set[int] = set()       # spot notice: no new dispatch
        frozen_p: Set[int] = set()      # hung: events dropped until killed
        down_dec: Set[int] = set()      # dead decode instances
        drain_dec: Set[int] = set()
        link_down: Set[int] = set()     # kv_link drop: no handoffs land
        slowed: Dict[int, Tuple[object, float]] = {}  # idx -> (cost, cap)
        # a kill starts a new engine incarnation: any event the old one
        # pushed (COMPLETION / PREEMPT_AT, identified by heap seq < the seq
        # consumed at kill time) is dropped outright. The per-task
        # running/tid/epoch stale checks are NOT enough across a kill — a
        # leftover PREEMPT_AT firing post-rejoin clears the NEW task's
        # pending_preempt flag and lets stale decisions interleave.
        killed_seq: Dict[int, int] = {}
        n_retries = n_shed = n_lost = 0
        prefill_up_times: List[float] = []
        if self.fault_plan is not None:
            for ev in self.fault_plan:
                pool_n = len(engines) if ev.target == "prefill" \
                    else len(decodes)
                if ev.instance >= pool_n:
                    continue             # plan sized for a bigger pool
                if ev.kind == "slowdown":
                    heapq.heappush(heap, (ev.time, next(seq), INSTANCE_DOWN,
                                          ("slow", ev)))
                    if math.isfinite(ev.duration):
                        heapq.heappush(heap, (ev.time + ev.duration,
                                              next(seq), INSTANCE_UP,
                                              ("unslow", ev)))
                    continue
                if ev.kind == "kv_link":
                    heapq.heappush(heap, (ev.time, next(seq), INSTANCE_DOWN,
                                          ("link", ev)))
                    if math.isfinite(ev.duration):
                        heapq.heappush(heap, (ev.time + ev.duration,
                                              next(seq), INSTANCE_UP,
                                              ("unlink", ev)))
                    continue
                kill_at = ev.down_at
                if ev.kind == "spot":
                    heapq.heappush(heap, (ev.time, next(seq), INSTANCE_DOWN,
                                          ("drain", ev)))
                elif ev.kind == "hang":
                    # undetected until the watchdog deadline: the instance
                    # keeps accepting dispatch but completes nothing
                    heapq.heappush(heap, (ev.time, next(seq), INSTANCE_DOWN,
                                          ("freeze", ev)))
                    kill_at = ev.time + self.watchdog_s
                heapq.heappush(heap, (kill_at, next(seq), INSTANCE_DOWN,
                                      ("kill", ev)))
                if math.isfinite(ev.duration):
                    up = max(ev.up_at, kill_at + 1e-9)
                    heapq.heappush(heap, (up, next(seq), INSTANCE_UP,
                                          ("up", ev)))
                    if ev.target == "prefill":
                        prefill_up_times.append(up)
        prefill_up_times.sort()

        def recover(victims: Sequence[Request], now: float) -> None:
            """Stranded work returns to the dispatch layer: progress and KV
            died with the instance, so the request resets to scratch and
            re-enters as a delayed ARRIVAL (capped exponential backoff)
            until its retry budget runs out. recovery="none" is the naive
            baseline: stranded requests are simply lost (+inf tail)."""
            nonlocal n_retries, n_lost
            for r in victims:
                r.state = RequestState.WAITING
                r.ops_done = 0
                r.ops_total = 0
                r.batch_tokens = r.num_tokens
                r.prefix_hit = 0
                r.first_token_time = None
                r.decode_start = None
                r.mean_tpot = None
                if self.recovery == "none":
                    n_lost += 1
                    continue
                r.retries += 1
                if r.retries > self.max_retries:
                    r.state = RequestState.DROPPED   # retries exhausted
                    n_lost += 1
                    continue
                n_retries += 1
                delay = min(self.retry_backoff * (2 ** (r.retries - 1)),
                            self.retry_backoff_cap)
                heapq.heappush(heap, (now + delay, next(seq), ARRIVAL, r))

        def strand_engine(e: InstanceEngine) -> List[Request]:
            """A dying engine's queued + preempted + running requests, with
            its scheduling state cleared (leftover heap events go stale via
            the existing running/tid/epoch checks)."""
            victims: List[Request] = list(e.waiting)
            for t in e.preempted.values():
                victims.extend(t.requests)
            if e.running is not None:
                victims.extend(e.running.requests)
            e.waiting.clear()
            e.preempted.clear()
            e.running = None
            e.pending_preempt = None
            return victims

        # load-oblivious policies (round-robin) skip snapshot building
        idle_loads = [InstanceLoad(instance_id=e.instance_id,
                                   capacity=e.capacity)
                      for e in engines]
        idle_hloads = [InstanceLoad(instance_id=h.instance_id,
                                    capacity=h.capacity)
                       for h in hybrids]
        with_pressure = self.policy.needs_decode_pressure and decodes
        # per-instance prefix-cache residency (None = sharing disabled);
        # exposed as `prefix_managers` for leak/invariant inspection.
        # Tiered mode swaps in TieredBlockManagers (eviction demotes through
        # host/disk instead of dropping) and extends coverage to the hybrid
        # pool — colocated instances share the same residency vocabulary.
        mgrs = None
        if self.tiered:
            mgrs = [TieredBlockManager(self.prefix_cache_blocks,
                                       host_blocks=self.host_cache_blocks,
                                       disk_blocks=self.disk_cache_blocks)
                    for _ in range(len(engines) + len(hybrids))]
            for hi, h in enumerate(hybrids):
                h.on_prefill_done = (
                    lambda r, t, m=mgrs[len(engines) + hi]:
                    m.commit(r.rid, r.prefix_hash or ()))
        elif self.prefix_cache_blocks > 0:
            mgrs = [PrefixBlockManager(self.prefix_cache_blocks)
                    for _ in engines]
        self.prefix_managers = mgrs
        bs = self.prefix_block
        n_promoted = 0

        # streams mid-KV-transfer, per destination: [count, ctx tokens].
        # They are invisible to the destination's snapshot until DECODE_JOIN
        # lands, so the planner must count them as queued there or two plans
        # within one transfer window would over-dump the same destination
        # past the knee (each stream's migration budget then strands it).
        in_flight: Dict[int, List[float]] = {}

        def migrate_from(src: DecodeSim, now: float) -> int:
            """Plan + enact cost-gated migrations of `src`'s queued decodes
            (KV handoff = a DECODE_JOIN event after the transfer delay)."""
            if not src.waiting:
                return 0
            loads = [d.snapshot_load() for d in decodes]
            for dst_id, (cnt, ctx) in in_flight.items():
                loads[dst_id].n_waiting += int(cnt)
                loads[dst_id].ctx_tokens += ctx
            cands = [DecodeCandidate(key=rid, context_tokens=j.context,
                                     remaining_tokens=j.remaining,
                                     deadline=j.request.decode_deadline,
                                     migrations=j.request.decode_migrations)
                     for rid, j in src.waiting.items()]
            plan = plan_decode_migrations(
                loads[src.instance_id], cands, loads, now,
                transfer_time=src.cost.kv_transfer_time,
                knee=self.migration_knee, max_migrations=self.max_migrations)
            for rid, dst_id, xfer in plan:
                if dst_id in down_dec or dst_id in drain_dec \
                        or dst_id in link_down:
                    continue             # planner is churn-blind: veto here
                job = src.pop_waiting(rid)
                job.request.decode_migrations += 1
                fl = in_flight.setdefault(dst_id, [0, 0.0])
                fl[0] += 1
                fl[1] += job.context
                heapq.heappush(heap, (now + xfer, next(seq), DECODE_JOIN,
                                      (decodes[dst_id], job)))
            return len(plan)

        if self.hybrid_decode_offload and decodes:
            def hybrid_offload(r: Request, t: float) -> None:
                nonlocal n_migrations
                live = [d for d in decodes
                        if d.instance_id not in down_dec
                        and d.instance_id not in drain_dec
                        and d.instance_id not in link_down] or decodes
                dec = min(live, key=lambda d: (d.backlog, d.instance_id))
                dec.join(r, t)
                if self.decode_migration:
                    n_migrations += migrate_from(dec, t)
            for h in hybrids:
                h.offload = hybrid_offload

        now = 0.0
        while heap:
            now, sq, kind, payload = heapq.heappop(heap)
            if kind == ARRIVAL:
                req: Request = payload
                # admission control needs a real backlog view even under
                # load-oblivious dispatch (round-robin)
                if self.policy.needs_loads or self.shed_policy != "off":
                    loads = [e.snapshot_load(req, now) for e in engines]
                else:
                    loads = idle_loads
                if with_pressure:
                    loads = [replace(
                        ld, decode_pressure=decodes[
                            i % len(decodes)].pressure(req, now))
                        for i, ld in enumerate(loads)]
                hits = None
                if mgrs is not None and not self.tiered:
                    # per-instance cached-prefix length of THIS prompt,
                    # capped so at least one token is always computed (the
                    # first output token needs a live forward pass)
                    keys = req.prefix_hash or ()
                    cap = max(req.num_tokens - 1, 0)
                    hits = [min(m.probe_len(keys) * bs, cap) for m in mgrs]
                    if self.policy.needs_prefix:
                        n = req.num_tokens
                        loads = [replace(
                            ld, prefix_hit=hits[i],
                            ttft_saved=max(
                                predictors[i].predict(n)
                                - predictors[i].predict(n - hits[i]), 0.0))
                            for i, ld in enumerate(loads)]
                if hybrids:
                    # colocated pool joins the dispatch decision after the
                    # prefill pool: same policy, same load vocabulary (queued
                    # prefill tokens + own decode pressure)
                    if self.policy.needs_loads:
                        hloads = [h.snapshot_load(req, now) for h in hybrids]
                    else:
                        hloads = idle_hloads
                    if self.policy.needs_decode_pressure:
                        hloads = [replace(ld, decode_pressure=hybrids[
                            i].pressure(req, now))
                            for i, ld in enumerate(hloads)]
                    loads = list(loads) + hloads
                colds = promos = None
                if self.tiered:
                    # three prices per instance: warm tokens are free,
                    # cold (host/disk) tokens cost a promotion copy and are
                    # counted only when that copy beats recompute, absent
                    # tokens cost full recompute. `ttft_saved` is already
                    # NET of the copy; `prefix_hit_cold`/`promote_time` are
                    # the observability split.
                    keys = req.prefix_hash or ()
                    cap = max(req.num_tokens - 1, 0)
                    n = req.num_tokens
                    hits, colds, promos, saveds = [], [], [], []
                    for i, m in enumerate(mgrs):
                        th = m.probe_tiers(keys)
                        warm = min(th.hbm_blocks * bs, cap)
                        host_t = min(th.host_blocks * bs, cap - warm)
                        disk_t = min(th.disk_blocks * bs,
                                     max(cap - warm - host_t, 0))
                        pred = predictors[i] if i < len(engines) \
                            else self.predictor
                        cost_i = self.instance_costs[i] \
                            if i < len(engines) else self.cost
                        saved = max(pred.predict(n)
                                    - pred.predict(n - warm), 0.0)
                        cold = host_t + disk_t
                        promote_s = 0.0
                        if cold > 0:
                            promote_s = cost_i.promote_time(host_t, disk_t)
                            gain = max(pred.predict(n - warm)
                                       - pred.predict(n - warm - cold), 0.0)
                            if gain > promote_s:
                                saved += gain - promote_s
                            else:            # recompute is cheaper: skip it
                                cold, promote_s = 0, 0.0
                        hits.append(warm)
                        colds.append(cold)
                        promos.append(promote_s)
                        saveds.append(saved)
                    if self.policy.needs_prefix:
                        loads = [replace(
                            ld, prefix_hit=hits[i] + colds[i],
                            ttft_saved=saveds[i],
                            prefix_hit_cold=colds[i],
                            promote_time=promos[i])
                            for i, ld in enumerate(loads)]
                excluded = down_p | drain_p
                if excluded:
                    # dispatch never routes to a known-down or draining
                    # instance. A HUNG one still receives work until the
                    # watchdog flags it (hangs are undetected by design —
                    # that is what makes them worse than crashes). NOTE: the
                    # per-instance arrays above (hits/colds/promos) stay
                    # indexed by instance_id, and every policy returns
                    # ld.instance_id, so filtering the load list is enough.
                    loads = [ld for ld in loads
                             if ld.instance_id not in excluded]
                    if not loads:
                        # whole pool down: park until the next rejoin, or
                        # lose the request if nothing ever comes back
                        t_up = next((t for t in prefill_up_times
                                     if t > now + 1e-12), None)
                        if t_up is None:
                            req.state = RequestState.DROPPED
                            n_lost += 1
                        else:
                            heapq.heappush(heap, (t_up, next(seq),
                                                  ARRIVAL, req))
                        continue
                if self.shed_policy != "off" and req.retries == 0:
                    # SLO-aware admission control: shed a doomed fresh
                    # arrival with an explicit rejection instead of letting
                    # it queue, miss, and poison the p99 tail. Retried
                    # (stranded-then-recovered) requests are never shed —
                    # the no-request-lost invariant outranks the tail.
                    best = min(predicted_ttft(req, ld, self.predictor)
                               for ld in loads)
                    if self.shed_policy == "doomed-only":
                        doomed = best > req.slo and \
                            all(ld.n_outstanding > 0 for ld in loads)
                    else:                                       # "budget"
                        doomed = best > self.shed_budget * req.slo
                    if doomed:
                        req.state = RequestState.DROPPED
                        req.shed = True
                        n_shed += 1
                        continue
                idx = self.policy.select(req, loads, now)
                if self.tiered:
                    m = mgrs[idx]
                    keys = req.prefix_hash or ()
                    cap = max(req.num_tokens - 1, 0)
                    warm = hits[idx]
                    if colds[idx] > 0:
                        # residency flips instantly; the copy's latency is
                        # priced by delaying the arrival (PROMOTE_DONE
                        # below), mirroring the runtime where the promotion
                        # ticket settles before the prefill resumes
                        for key, _b, _t in m.promote_begin(
                                keys,
                                max_blocks=(colds[idx] + bs - 1) // bs):
                            m.promote_commit(key)
                    # re-probe: promotion may have landed fewer blocks than
                    # planned (pool pressure) — pin what actually exists
                    hit = min(m.probe_len(keys) * bs, cap)
                    req.prefix_hit = hit
                    n_promoted += max(hit - warm, 0)
                    m.lock_prefix(req.rid, keys,
                                  max_blocks=(hit + bs - 1) // bs)
                    target = engines[idx] if idx < len(engines) \
                        else hybrids[idx - len(engines)]
                    if hit > warm and promos[idx] > 0:
                        # the promoted blocks stay pinned while the copy is
                        # in flight (lock_prefix above); the request itself
                        # is invisible to later load snapshots until it
                        # lands — same convention as mid-transfer decode
                        # streams
                        heapq.heappush(heap, (now + promos[idx], next(seq),
                                              PROMOTE_DONE, (target, req)))
                    else:
                        target.on_arrival(req, now)
                else:
                    if hits is not None and idx < len(engines):
                        # pin the hit until the dependent prefill completes
                        # — eviction must never pull KV out from under it
                        req.prefix_hit = hits[idx]
                        mgrs[idx].lock_prefix(
                            req.rid, req.prefix_hash or (),
                            max_blocks=(hits[idx] + bs - 1) // bs)
                    if idx < len(engines):
                        engines[idx].on_arrival(req, now)
                    else:
                        hybrids[idx - len(engines)].on_arrival(req, now)
            elif kind == DECODE_DONE:
                dec: DecodeSim = payload[0]
                if dec.on_decode_done(payload, now) and self.decode_migration:
                    # freed slots elsewhere may now clear a queued stream's
                    # cost gate; re-plan for THIS instance's remaining queue
                    n_migrations += migrate_from(dec, now)
            elif kind == DECODE_JOIN:
                dec, job = payload
                fl = in_flight[dec.instance_id]
                fl[0] -= 1
                fl[1] -= job.context
                if dec.instance_id in down_dec \
                        or dec.instance_id in link_down:
                    # the KV transfer failed mid-flight (dead destination or
                    # dropped kv_link): retry the handoff into a live
                    # instance, else full recovery (re-prefill from scratch)
                    alts = [d for d in decodes
                            if d.instance_id not in down_dec
                            and d.instance_id not in link_down
                            and d.instance_id != dec.instance_id]
                    if alts and self.recovery != "none":
                        alt = min(alts, key=lambda d: (d.backlog,
                                                       d.instance_id))
                        n_retries += 1
                        xfer = alt.cost.kv_transfer_time(job.context)
                        fl2 = in_flight.setdefault(alt.instance_id,
                                                   [0, 0.0])
                        fl2[0] += 1
                        fl2[1] += job.context
                        heapq.heappush(heap, (now + xfer, next(seq),
                                              DECODE_JOIN, (alt, job)))
                    else:
                        recover([job.request], now)
                else:
                    dec.migrate_in(job, now)
            elif kind == HYBRID_STEP:
                payload[0].on_step(payload, now)
            elif kind == PROMOTE_DONE:
                # the cold prefix finished copying up — the request enters
                # its instance now, so its TTFT includes the promotion
                target, r = payload
                if isinstance(target, InstanceEngine) \
                        and target.instance_id in down_p:
                    recover([r], now)   # destination died mid-promotion
                else:
                    target.on_arrival(r, now)
            elif kind == INSTANCE_DOWN:
                phase, ev = payload
                i = ev.instance
                if ev.target == "prefill":
                    if phase == "drain":
                        drain_p.add(i)
                    elif phase == "freeze":
                        frozen_p.add(i)
                    elif phase == "slow":
                        e = engines[i]
                        slowed[i] = (e.cost, e.capacity)
                        e.cost = _SlowedCost(e.cost, ev.factor)
                        e.capacity = e.capacity / ev.factor
                    else:                                   # kill
                        down_p.add(i)
                        drain_p.discard(i)
                        frozen_p.discard(i)
                        killed_seq[i] = next(seq)   # new incarnation
                        victims = strand_engine(engines[i])
                        if mgrs is not None:
                            # the instance's memory died with it — HBM
                            # prefix cache, host/disk staging tiers, and
                            # every arrival-time pin. Chains committed on
                            # OTHER instances survive, so re-dispatched
                            # requests can still resume from their caches.
                            mgrs[i] = TieredBlockManager(
                                self.prefix_cache_blocks,
                                host_blocks=self.host_cache_blocks,
                                disk_blocks=self.disk_cache_blocks) \
                                if self.tiered else \
                                PrefixBlockManager(self.prefix_cache_blocks)
                        recover(victims, now)
                else:
                    if phase == "drain":
                        drain_dec.add(i)
                    elif phase == "freeze":
                        decodes[i].freeze(now)
                    elif phase == "link":
                        link_down.add(i)
                    elif phase == "slow":
                        pass          # decode slowdown not modeled
                    else:                                   # kill
                        down_dec.add(i)
                        drain_dec.discard(i)
                        recover(decodes[i].strand(now), now)
            elif kind == INSTANCE_UP:
                phase, ev = payload
                i = ev.instance
                if phase == "unslow":
                    if i in slowed:
                        engines[i].cost, engines[i].capacity = slowed.pop(i)
                elif phase == "unlink":
                    link_down.discard(i)
                elif ev.target == "prefill":
                    down_p.discard(i)   # rejoins empty (cleared at kill)
                else:
                    down_dec.discard(i)
                    decodes[i].thaw(now)
            else:
                engine: InstanceEngine = payload[0]
                if engine.instance_id in frozen_p:
                    continue            # hung: no progress until the kill
                if sq < killed_seq.get(engine.instance_id, -1):
                    continue            # pushed by a dead incarnation
                for r in handle_event(kind, payload, now):
                    if mgrs is not None:
                        # completion: the prompt's KV now exists on this
                        # instance — cache it (best-effort under capacity)
                        # and drop the arrival-time pins
                        mgrs[engine.instance_id].commit(
                            r.rid, r.prefix_hash or ())
                    if decodes and r.output_tokens > 0:
                        if self.decode_affinity:
                            # paired handoff: prefill i -> decode i mod D
                            dec = decodes[engine.instance_id % len(decodes)]
                        else:
                            # join the decode instance holding the fewest
                            # streams (resident + queued)
                            dec = min(decodes, key=lambda d: (d.backlog,
                                                              d.instance_id))
                        no_join = down_dec | drain_dec | link_down
                        if dec.instance_id in no_join:
                            # affinity/least-backlog chose an unreachable
                            # decode: fall to the least-loaded live one, or
                            # full recovery when the decode pool is gone
                            live = [d for d in decodes
                                    if d.instance_id not in no_join]
                            if not live:
                                recover([r], now)
                                continue
                            dec = min(live, key=lambda d: (d.backlog,
                                                           d.instance_id))
                        dec.join(r, now)
                        if self.decode_migration:
                            n_migrations += migrate_from(dec, now)
                if self.fault_plan is not None \
                        and engine.running is None \
                        and engine.pending_preempt is None \
                        and (engine.waiting or engine.preempted):
                    # un-wedge a latent engine tail race that churn exposes:
                    # a cooperative preempt scheduled at the task's FINAL
                    # boundary ties with its completion; completion pops
                    # first, and its _round early-returns (pending_preempt
                    # still set); the now-stale PREEMPT_AT clears the flag
                    # but never re-rounds — idle engine, queued work, no
                    # future events. Fault-free traces always rescue it with
                    # a later arrival (committed baselines stay byte-equal
                    # behind the fault_plan gate); churn's backoff-delayed
                    # tail can leave it terminal, so kick the round here.
                    engine._round(now)

        return ClusterResult(
            requests=list(requests),
            blocking_times=[b for e in engines for b in e.blocking],
            rounds=sum(e.rounds for e in engines)
            + sum(h.steps for h in hybrids),
            preemptions=sum(e.preemptions for e in engines),
            makespan=now,
            dispatched=[e.n_dispatched for e in engines]
            + [h.n_dispatched for h in hybrids],
            decoded=sum(len(d.finished) for d in decodes)
            + sum(len(h.finished) for h in hybrids),
            decode_preemptions=sum(d.preemptions for d in decodes)
            + sum(h.preemptions for h in hybrids),
            migrations=n_migrations,
            prefix_hit_tokens=sum(r.prefix_hit for r in requests),
            prefix_evictions=sum(m.evictions for m in mgrs) if mgrs else 0,
            prefix_promoted_tokens=n_promoted,
            tier_demotions=sum(getattr(m, "demotions", 0)
                               for m in mgrs) if mgrs else 0,
            retries=n_retries,
            shed_requests=n_shed,
            lost_requests=n_lost,
        )


def simulate_cluster(system: str, requests: Sequence[Request], *,
                     model: str = "llama3-8b",
                     num_instances: int = 2,
                     dispatch: str = "round-robin",
                     decode_instances: int = 0,
                     hw=None, hardware=None, decode_hardware=None,
                     online_refit: bool = False,
                     decode_affinity: Optional[bool] = None,
                     decode_max_batch: int = 0,
                     decode_policy: str = "fcfs",
                     decode_preempt: Optional[bool] = None,
                     decode_migration: bool = False,
                     migration_knee: float = 0.85,
                     max_migrations: int = 1,
                     prefix_cache_blocks: int = 0,
                     prefix_block: int = 128,
                     host_cache_blocks: int = 0,
                     disk_cache_blocks: int = 0,
                     hybrid_instances: int = 0,
                     hybrid_token_budget: Optional[int] = None,
                     hybrid_chunk_tokens: Optional[int] = None,
                     hybrid_decode_offload: bool = False,
                     fault_plan: Optional[FaultPlan] = None,
                     recovery: str = "retry",
                     max_retries: int = 3,
                     retry_backoff: float = 0.05,
                     retry_backoff_cap: float = 2.0,
                     watchdog_s: float = 1.0,
                     shed_policy: str = "off",
                     shed_budget: float = 2.0,
                     spec_decode: bool = False,
                     draft_k: int = 4,
                     spec_accept: float = 0.0,
                     **overrides) -> ClusterResult:
    """Cluster counterpart of `repro_torch.sim.policies.simulate` — same baseline
    presets, same fresh-copy semantics, plus instance count, dispatch,
    heterogeneous pool layout (`hardware` / `decode_hardware` accept
    HardwareSpecs or names like "a800"), decode scheduling
    (`decode_max_batch` / `decode_policy` / `decode_preempt` /
    `decode_migration`), prefix-cache sharing (`prefix_cache_blocks`
    per-instance residency capacity + the `prefix-affinity` dispatch;
    `host_cache_blocks` / `disk_cache_blocks` add demotion tiers and a
    promote-vs-recompute gate instead of dropping evictions), and
    colocated pools (`hybrid_instances` unified prefill+decode engines —
    pool layouts mix freely: `num_instances=0, hybrid_instances=4` is fully
    colocated, `num_instances=1, decode_instances=1, hybrid_instances=2`
    is a mixed pool at the same card count as 2P+2D disaggregation), and
    speculative decoding (`spec_decode` + `draft_k` + `spec_accept`: fluid
    multi-token advancement off the analytic accept surface the runtime's
    per-stream EMA converges to)."""
    import copy

    from repro_torch.sim.costmodel import A800, MODEL_SPECS, MODEL_TP
    from repro_torch.sim.policies import preset

    spec = replace(MODEL_SPECS[model], tp=MODEL_TP.get(model, 1))
    cost = PrefillCostModel(spec, resolve_hardware(hw) if hw else A800)
    sim = ClusterSim(cost, preset(system, **overrides),
                     num_instances=num_instances, dispatch=dispatch,
                     decode_instances=decode_instances,
                     hardware=hardware, decode_hardware=decode_hardware,
                     online_refit=online_refit,
                     decode_affinity=decode_affinity,
                     decode_max_batch=decode_max_batch,
                     decode_policy=decode_policy,
                     decode_preempt=decode_preempt,
                     decode_migration=decode_migration,
                     migration_knee=migration_knee,
                     max_migrations=max_migrations,
                     prefix_cache_blocks=prefix_cache_blocks,
                     prefix_block=prefix_block,
                     host_cache_blocks=host_cache_blocks,
                     disk_cache_blocks=disk_cache_blocks,
                     hybrid_instances=hybrid_instances,
                     hybrid_token_budget=hybrid_token_budget,
                     hybrid_chunk_tokens=hybrid_chunk_tokens,
                     hybrid_decode_offload=hybrid_decode_offload,
                     fault_plan=fault_plan,
                     recovery=recovery,
                     max_retries=max_retries,
                     retry_backoff=retry_backoff,
                     retry_backoff_cap=retry_backoff_cap,
                     watchdog_s=watchdog_s,
                     shed_policy=shed_policy,
                     shed_budget=shed_budget,
                     spec_decode=spec_decode,
                     draft_k=draft_k,
                     spec_accept=spec_accept)
    return sim.run([copy.copy(r) for r in requests])
