"""Instance-level dispatch policies (cluster layer).

Pure policy logic, shared — like SchedulerCore — between the real runtime
(repro/serving/proxy.py) and the discrete-event cluster simulator
(repro/sim/cluster.py), so the dispatch policy evaluated in simulation is the
one deployed.

A policy sees a per-instance load snapshot (`InstanceLoad`) taken *relative to
the arriving request* and picks the instance for it:

  * ``round-robin``  — the paper's §4 proxy baseline (blind cycling).
  * ``least-loaded`` — join-shortest-predicted-queue: pick the instance whose
    predicted TTFT for the newcomer (TTFTPredictor over the instance's
    outstanding competing tokens plus the newcomer's) is smallest.  Follows
    the load-aware direction of arXiv 2605.02329 (SLO-aware scheduling for
    disaggregated inference).
  * ``deflection``   — slack-aware deflection (arXiv 2607.02043): keep the
    round-robin default target, but when the target's backlog (its running
    head plus queue) would eat too much of the newcomer's slack, deflect to a
    feasible instance; with none feasible, take the least predicted TTFT.
  * ``capacity-weighted`` — heterogeneous-pool JSQ: rank instances by
    *drain time* = outstanding tokens normalized by the instance's peak
    prefill throughput (`InstanceLoad.capacity`), so a mixed A800/A100/TPU
    pool routes proportionally more work to faster hardware instead of
    equalizing raw token backlogs.
  * ``decode-aware`` — capacity-weighted drain time, inflated when the
    instance's downstream decode stage is near its TBT-SLO knee
    (`InstanceLoad.decode_pressure`, fed from `DecodeCostModel.step_time`):
    prefills are deflected away from instances whose decode batch would blow
    the token-by-token SLO right after handoff (the load-aware prefill
    deflection direction of arXiv 2607.02043 applied to downstream pressure).
  * ``prefix-affinity`` — the decode-aware score MINUS the predicted TTFT
    saved by the instance's prefix cache (`InstanceLoad.ttft_saved`, priced
    by the owner from its per-instance predictor/residency model): route a
    request to the instance already holding its prompt prefix's KV — unless
    that instance's queue pressure outweighs the recompute saved. Affinity
    deliberately concentrates load where prefixes live, so the queue term
    (drain time, which grows with backlog) is what keeps it from re-creating
    the hotspot problem load-aware deflection exists to solve; with no hits
    anywhere the score degrades exactly to decode-aware/capacity-weighted.

The load measure matters: under S-EDF with cheap operator-level preemption,
a long or already-doomed (negative-slack) request in an instance's queue does
NOT delay a short strict-SLO newcomer — it gets preempted or ranked below.
`competing_tokens` therefore counts only work that would actually run before
the newcomer: outstanding items with an earlier deadline that are themselves
still feasible.  (Raw aggregate tokens make join-shortest-queue *worse* than
round-robin here: doomed long requests repel traffic from instances that
would serve it instantly.)

Decode-side rebalancing lives here too: `DecodeLoad` snapshots a decode
instance's continuous batch + admission queue, and `plan_decode_migrations`
produces a cost-gated plan for moving QUEUED decodes off an instance whose
effective TBT pressure has crossed the SLO knee — the decode-aware policy's
dispatch-time avoidance turned into a run-time correction. The same plan
function drives `ClusterSim` (KV-handoff priced by the cost model) and the
real `Proxy` (host-memory handoff). Policy-by-policy rationale and the
figures demonstrating each live in docs/SCHEDULING.md.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.predictor import TTFTPredictor
from repro_torch.core.request import Request


@dataclass(frozen=True)
class InstanceLoad:
    """Snapshot of one prefill instance's backlog, relative to a candidate
    request (see `competing_tokens`). Built fresh per dispatch decision by the
    owner (Proxy / ClusterSim); policies never mutate it."""
    instance_id: int
    queued_tokens: float = 0.0           # competing waiting+preempted tokens
    running_tokens: float = 0.0          # competing in-flight tokens
    n_outstanding: int = 0
    # heterogeneous pools: instance peak prefill throughput (tokens/s).
    # 1.0 = unknown/uniform — capacity-weighted then degrades to raw-token JSQ.
    capacity: float = 1.0
    # downstream decode TBT pressure were this request's decode to join now:
    # predicted step time / TBT SLO (1.0 = exactly at the SLO knee)
    decode_pressure: float = 0.0
    # prefix sharing: tokens of THIS request's prompt cached at the
    # instance, and the predicted seconds of prefill service time that hit
    # would save (owner-priced: predictor(n) - predictor(n - hit)). With a
    # tiered cache `prefix_hit` is the EFFECTIVE hit (warm + cold tokens the
    # owner decided to promote) and `ttft_saved` is already NET of the
    # promotion copy time — warm, cold, and absent are three prices, not a
    # binary hit bit, but the policy score needs no tier awareness.
    prefix_hit: int = 0
    ttft_saved: float = 0.0
    # tier observability: cold (host/disk-resident) tokens behind the warm
    # run, and the predicted copy time to promote them (0 when untiered)
    prefix_hit_cold: int = 0
    promote_time: float = 0.0

    @property
    def outstanding_tokens(self) -> float:
        return self.queued_tokens + self.running_tokens


def competing_tokens(items: Iterable[Tuple[float, float]],
                     candidate: Request, now: float,
                     predict: Optional[Callable[[float], float]]) -> float:
    """Backlog that would run BEFORE `candidate` under S-EDF: the sum of
    remaining tokens over `items` (pairs of (remaining_tokens, deadline))
    whose deadline is earlier than the candidate's and which are still
    feasible (positive slack) — infeasible work ranks below any feasible
    newcomer and preemptable work yields within one operator.

    Built per dispatch decision for EVERY instance, so large backlogs batch
    the predictions through the predictor's `predict_many` (bit-identical:
    same elementwise Horner, same sequential accumulation order)."""
    items = list(items)
    if predict is not None and len(items) >= 8:
        pm = getattr(getattr(predict, "__self__", None), "predict_many", None)
        if pm is not None:
            k = len(items)
            rems = np.fromiter((it[0] for it in items), np.float64, k)
            dls = np.fromiter((it[1] for it in items), np.float64, k)
            keep = (dls <= candidate.deadline) & (dls - now - pm(rems) > 0)
            n = 0.0
            for v in rems[keep].tolist():
                n += v
            return n
    n = 0.0
    for rem, deadline in items:
        if deadline > candidate.deadline:
            continue
        lat = predict(rem) if predict is not None else 0.0
        if deadline - now - lat > 0:
            n += rem
    return n


def drain_time(req: Request, load: InstanceLoad) -> float:
    """Capacity-normalized backlog: seconds for `load`'s instance to drain its
    competing work plus the newcomer at peak throughput. With the default
    capacity of 1.0 this is just raw tokens (monotone, so homogeneous pools
    behave like token-JSQ)."""
    return (load.outstanding_tokens + req.num_tokens) / max(load.capacity,
                                                            1e-9)


def predicted_ttft(req: Request, load: InstanceLoad,
                   predictor: Optional[TTFTPredictor]) -> float:
    """Predicted TTFT were `req` dispatched to `load`'s instance now: the
    predictor evaluated over the instance's competing tokens plus the
    newcomer's (a serial-drain estimate; with no predictor, raw tokens act as
    the time proxy — monotone, which is all least-loaded needs)."""
    n = load.outstanding_tokens + req.num_tokens
    if predictor is None:
        return float(n)
    return predictor.predict(n)


class DispatchPolicy:
    """Picks an instance id for one request given per-instance load."""
    name = "base"
    needs_loads = True        # False: owner may pass zeroed load snapshots
    needs_decode_pressure = False  # True: owner attaches decode_pressure
                                   # (and pairs prefill->decode instances)
    needs_prefix = False      # True: owner attaches prefix_hit/ttft_saved
                              # from its per-instance residency model

    def __init__(self, predictor: Optional[TTFTPredictor] = None):
        self.predictor = predictor

    def select(self, req: Request, loads: Sequence[InstanceLoad],
               now: float) -> int:
        raise NotImplementedError


class RoundRobinDispatch(DispatchPolicy):
    name = "round-robin"
    needs_loads = False       # blind cycling: only len(loads) matters

    def __init__(self, predictor: Optional[TTFTPredictor] = None):
        super().__init__(predictor)
        self._next = 0

    def select(self, req: Request, loads: Sequence[InstanceLoad],
               now: float) -> int:
        i = self._next % len(loads)
        self._next += 1
        return loads[i].instance_id


class LeastLoadedDispatch(DispatchPolicy):
    name = "least-loaded"

    def select(self, req: Request, loads: Sequence[InstanceLoad],
               now: float) -> int:
        return min(loads, key=lambda ld: (predicted_ttft(req, ld,
                                                         self.predictor),
                                          ld.instance_id)).instance_id


class DeflectionDispatch(DispatchPolicy):
    """Slack-aware deflection: round-robin default target, deflected when the
    newcomer's predicted TTFT there would consume more than `slack_margin` of
    its slack. The small default margin deflects *early*: by the time the
    predicted TTFT reaches the full slack it is too late to recover under
    bursty arrivals (headroom is what absorbs the burst)."""
    name = "deflection"

    def __init__(self, predictor: Optional[TTFTPredictor] = None,
                 slack_margin: float = 0.25):
        super().__init__(predictor)
        self._next = 0
        self.slack_margin = slack_margin    # fraction of slack we may consume

    def select(self, req: Request, loads: Sequence[InstanceLoad],
               now: float) -> int:
        i = self._next % len(loads)
        self._next += 1
        budget = (req.deadline - now) * self.slack_margin
        primary = loads[i]
        if predicted_ttft(req, primary, self.predictor) <= budget:
            return primary.instance_id
        feasible = [ld for ld in loads
                    if predicted_ttft(req, ld, self.predictor) <= budget]
        pool = feasible or list(loads)
        return min(pool, key=lambda ld: (predicted_ttft(req, ld,
                                                        self.predictor),
                                         ld.instance_id)).instance_id


class CapacityWeightedDispatch(DispatchPolicy):
    """Capacity-weighted JSQ for heterogeneous pools: join the instance whose
    backlog drains fastest AT ITS OWN SPEED. Raw-token JSQ equalizes token
    backlogs, which on mixed hardware means the slow instance's equal-sized
    queue takes longer to clear — its requests burn SLO slack in line. Peak
    throughput as the normalizer is deliberately workload-independent: it
    needs one offline number per hardware generation, not a per-request
    latency model."""
    name = "capacity-weighted"

    def select(self, req: Request, loads: Sequence[InstanceLoad],
               now: float) -> int:
        return min(loads, key=lambda ld: (drain_time(req, ld),
                                          ld.instance_id)).instance_id


class DecodeAwareDispatch(DispatchPolicy):
    """Capacity-weighted drain time, inflated by downstream decode pressure.

    An instance whose paired decode stage sits near its TBT-SLO knee will
    violate the token-by-token SLO for any prefill handed to it — routing by
    prefill backlog alone green-lights requests into a decode stage that
    dooms them. The score multiplies drain time by (1 + penalty * excess),
    excess = max(0, decode_pressure - knee): below the knee decode is free
    capacity and the policy IS capacity-weighted JSQ; above it the instance
    is repelled in proportion to how deep into the knee its decode sits.
    Multiplicative (not additive) so the penalty needs no absolute scale —
    drain time already carries the units, and the newcomer's own tokens keep
    it nonzero even on an idle pool."""
    name = "decode-aware"
    needs_decode_pressure = True

    def __init__(self, predictor: Optional[TTFTPredictor] = None,
                 knee: float = 0.85, penalty: float = 8.0):
        super().__init__(predictor)
        self.knee = knee                 # pressure fraction where TBT binds
        self.penalty = penalty           # repulsion strength past the knee

    def _score(self, req: Request, ld: InstanceLoad) -> float:
        excess = max(0.0, ld.decode_pressure - self.knee)
        return drain_time(req, ld) * (1.0 + self.penalty * excess)

    def select(self, req: Request, loads: Sequence[InstanceLoad],
               now: float) -> int:
        return min(loads, key=lambda ld: (self._score(req, ld),
                                          ld.instance_id)).instance_id


class PrefixAffinityDispatch(DecodeAwareDispatch):
    """Prefix-cache-affinity dispatch: the decode-aware score minus the
    predicted TTFT saved by each instance's cached prefix of THIS prompt.

    score(i) = drain_time * (1 + penalty * decode excess)
               - affinity_weight * ttft_saved(i)

    Both terms are seconds (drain time is capacity-normalized backlog;
    ttft_saved is predictor-priced recompute), so `affinity_weight` is a
    pure preference knob: 1.0 trades a second of queueing for a second of
    saved prefill. The subtraction — not a hard affinity pin — is the
    load-aware deflection tension: once the prefix-holding instance's
    backlog exceeds the saving, colder instances win and the affinity
    stream SPILLS, spreading the hot prefix to a second cache instead of
    melting the first (cf. load-aware prefill deflection, arXiv 2607.02043).
    With zero hits everywhere this IS decode-aware dispatch (and, with no
    decode pressure attached, capacity-weighted JSQ)."""
    name = "prefix-affinity"
    needs_prefix = True

    def __init__(self, predictor: Optional[TTFTPredictor] = None,
                 knee: float = 0.85, penalty: float = 8.0,
                 affinity_weight: float = 1.0):
        super().__init__(predictor, knee=knee, penalty=penalty)
        self.affinity_weight = affinity_weight

    def _score(self, req: Request, ld: InstanceLoad) -> float:
        return super()._score(req, ld) - self.affinity_weight * ld.ttft_saved


DISPATCH_POLICIES = {
    p.name: p for p in
    (RoundRobinDispatch, LeastLoadedDispatch, DeflectionDispatch,
     CapacityWeightedDispatch, DecodeAwareDispatch, PrefixAffinityDispatch)
}


# ---------------------------------------------------------------------------
# Decode migration (cost-gated rebalancing of queued decodes)
# ---------------------------------------------------------------------------


@dataclass
class DecodeLoad:
    """Snapshot of one decode instance for migration planning: the continuous
    batch (`n_resident`, capped at `max_batch` slots), the admission queue
    (`n_waiting`), and the aggregate context those streams hold. Built fresh
    per planning decision by the owner (ClusterSim / Proxy)."""
    instance_id: int
    n_resident: int = 0
    n_waiting: int = 0
    ctx_tokens: float = 0.0        # total context (prompt + decoded) held
    max_batch: int = 0             # batch slot cap; 0 = unbounded
    step_time: Optional[Callable[[int, float], float]] = None

    @property
    def total(self) -> int:
        return self.n_resident + self.n_waiting

    def effective_step(self, extra_jobs: int = 0,
                       extra_ctx: float = 0.0) -> float:
        """Predicted effective per-token latency of one stream on this
        instance with `extra_jobs` streams added (negative = removed): the
        analytic step time of the slot-capped batch, inflated by the
        time-sharing factor N/max_batch once the population N exceeds the cap
        — B slots shared by N streams serve each at B/N of the batch rate, so
        queueing shows up as TBT degradation, the signal the knee is defined
        on. Uncapped instances never queue: the factor is exactly 1."""
        n = self.total + extra_jobs
        if n <= 0 or self.step_time is None:
            return 0.0
        b = min(n, self.max_batch) if self.max_batch > 0 else n
        t = self.step_time(b, (self.ctx_tokens + extra_ctx) / n)
        if self.max_batch > 0 and n > self.max_batch:
            t *= n / self.max_batch
        return t


@dataclass(frozen=True)
class DecodeCandidate:
    """One queued (not yet resident) decode considered for migration."""
    key: int                       # owner handle (request rid)
    context_tokens: float          # KV to hand off (prompt + decoded so far)
    remaining_tokens: float        # output tokens still to decode
    deadline: float                # Request.decode_deadline
    migrations: int = 0            # times already migrated


def plan_decode_migrations(
        src: DecodeLoad, candidates: Sequence[DecodeCandidate],
        loads: Sequence[DecodeLoad], now: float, *,
        transfer_time: Optional[Callable[[float], float]] = None,
        knee: float = 0.85, max_migrations: int = 1,
        margin: float = 0.25) -> List[Tuple[int, int, float]]:
    """Cost-gated plan for migrating queued decodes off a saturating `src`.

    For each candidate (earliest decode deadline first) the per-token budget
    is its REMAINING slack rate, (deadline - now) / remaining_tokens; `src` is
    saturating for that stream when its effective step time exceeds
    ``knee * budget``. Every gate below must hold, so a pool in which every
    instance sits past the knee produces an EMPTY plan (no thrash):

      * the candidate still has a finite deadline, positive budget, and fewer
        than `max_migrations` prior moves (KV churn cap);
      * the best destination, with the migrated stream's context added, stays
        at or below the knee for that stream;
      * the predicted finish at the destination — including the KV-handoff
        time `transfer_time(context_tokens)` plus a `margin` multiple of it
        as hysteresis — beats the predicted finish at `src`.

    Planned moves update the running tallies on both sides, so one planning
    pass cannot dump every queued stream onto the same target, and draining
    `src` below the knee stops further moves.

    Returns ``[(candidate key, destination instance_id, transfer seconds)]``.
    """
    others = [ld for ld in loads if ld.instance_id != src.instance_id]
    if not others:
        return []
    extra = {ld.instance_id: [0, 0.0] for ld in others}
    moved_jobs, moved_ctx = 0, 0.0
    plan: List[Tuple[int, int, float]] = []
    for cand in sorted(candidates, key=lambda c: (c.deadline, c.key)):
        if cand.migrations >= max_migrations:
            continue
        if not math.isfinite(cand.deadline) or cand.remaining_tokens <= 0:
            continue
        budget = (cand.deadline - now) / cand.remaining_tokens
        if budget <= 0:
            continue                # already doomed: a transfer can't save it
        t_src = src.effective_step(-moved_jobs, -moved_ctx)
        if t_src <= knee * budget:
            continue                # src under the knee for this stream
        xfer = transfer_time(cand.context_tokens) if transfer_time else 0.0
        best: Optional[Tuple[DecodeLoad, float]] = None
        for ld in others:
            ej, ec = extra[ld.instance_id]
            t_dst = ld.effective_step(1 + ej, cand.context_tokens + ec)
            if t_dst > knee * budget:
                continue            # destination would be saturated too
            finish_dst = now + xfer + cand.remaining_tokens * t_dst
            if best is None or finish_dst < best[1]:
                best = (ld, finish_dst)
        if best is None:
            continue                # every destination past the knee: no move
        finish_src = now + cand.remaining_tokens * t_src
        if best[1] + margin * xfer >= finish_src:
            continue                # benefit doesn't clear the handoff cost
        plan.append((cand.key, best[0].instance_id, xfer))
        extra[best[0].instance_id][0] += 1
        extra[best[0].instance_id][1] += cand.context_tokens
        moved_jobs += 1
        moved_ctx += cand.context_tokens
    return plan


def make_dispatch(policy: Union[str, DispatchPolicy],
                  predictor: Optional[TTFTPredictor] = None,
                  **kwargs) -> DispatchPolicy:
    """`policy` may also be a ready-made DispatchPolicy (passed through,
    adopting `predictor` if it has none)."""
    if isinstance(policy, DispatchPolicy):
        if policy.predictor is None:
            policy.predictor = predictor
        return policy
    try:
        cls = DISPATCH_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown dispatch policy {policy!r}; "
            f"known: {sorted(DISPATCH_POLICIES)}") from None
    return cls(predictor=predictor, **kwargs)
