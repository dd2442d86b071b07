"""Discrete-event simulator of prefill instances (cluster-scale evaluation).

The simulator drives the SAME SchedulerCore as the real runtime — only the
executor is simulated. Each device is a serial processor executing operator
units whose durations come from the analytic cost model; preemption takes
effect at the next boundary of the configured granularity (op / layer / chunk /
whole), exactly like the cooperative protocol. Events are lazily invalidated
via task epochs, so the event count is O(actions), not O(operators).

The per-instance state machine lives in `InstanceEngine`, which pushes its
events into a caller-owned heap: `PrefillSim` runs ONE engine on a private
heap (the single-device study), while `repro_torch.sim.cluster.ClusterSim` runs N
engines plus dispatch and a decode-phase model on one shared heap — both paths
execute identical engine code, so a 1-instance cluster reproduces `PrefillSim`
event-for-event.

Baseline systems are expressed as SimConfig presets (policies.py):
DistServe (FCFS), DistServe-CP2K/8K (chunk boundaries + EDF), layer-level
(layer boundaries + per-boundary polling cost), and FlowPrefill.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dispatch import InstanceLoad, competing_tokens
from repro_torch.core.predictor import TTFTPredictor
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import Action, SchedulerCore
from repro_torch.sim.costmodel import PrefillCostModel

# event kinds (shared heap: (time, seq, kind, payload))
ARRIVAL, COMPLETION, PREEMPT_AT, DECODE_DONE, DECODE_JOIN = 0, 1, 2, 3, 4


@dataclass
class SimTask:
    requests: List[Request]
    tokens: int
    op_ends: np.ndarray                  # cumulative op end offsets (exec secs)
    boundary_ends: np.ndarray            # preemption boundaries (exec secs)
    exec_offset: float = 0.0             # completed execution seconds
    resume_time: float = 0.0             # sim time of last (re)start
    epoch: int = 0                       # invalidates stale events
    tid: int = field(default_factory=itertools.count().__next__)
    min_deadline: float = 0.0            # over members (fixed once built)
    preempted_tokens: float = 0.0        # remaining tokens frozen at preempt

    def __post_init__(self):
        self.min_deadline = min(r.deadline for r in self.requests)

    @property
    def head(self) -> Request:
        return self.requests[0]

    @property
    def total(self) -> float:
        return float(self.op_ends[-1])

    def position(self, now: float) -> float:
        return self.exec_offset + (now - self.resume_time)

    def remaining_fraction(self, now: float, running: bool) -> float:
        pos = self.position(now) if running else self.exec_offset
        return max(0.0, 1.0 - pos / max(self.total, 1e-12))

    def next_boundary(self, now: float) -> float:
        """Execution offset of the first boundary at/after `now`."""
        pos = self.position(now)
        i = int(np.searchsorted(self.boundary_ends, pos - 1e-12))
        i = min(i, len(self.boundary_ends) - 1)
        return float(self.boundary_ends[i])


@dataclass
class SimConfig:
    policy: str = "s-edf"
    granularity: str = "op"              # op | layer | chunk | whole
    chunk_tokens: int = 0                # >0: chunked prefill
    batch_budget: int = 4096
    enable_batching: bool = True
    batching_mode: str = "slo"           # "slo" (Alg. 1) | "greedy" (vLLM-like)
    preempt: bool = True
    check_overhead: float = 0.0          # per-boundary scheduling cost (layer-
                                         # level polling baselines)
    round_overhead: float = 100e-6       # per scheduling round
    submit_overhead: float = 8e-3        # per execution task (cache alloc,
                                         # runner setup) — amortized by batching


@dataclass
class SimResult:
    requests: List[Request]
    blocking_times: List[float]
    rounds: int
    preemptions: int
    makespan: float

    @property
    def attainment(self) -> float:
        met = sum(1 for r in self.requests if r.slo_met)
        return met / max(len(self.requests), 1)


class InstanceEngine:
    """One prefill instance's scheduling + execution state machine.

    Pushes COMPLETION / PREEMPT_AT events (tagged with itself) into the
    owner's heap; the owner pops events and routes them back via the
    ``on_*`` handlers. The owner also decides which engine receives each
    ARRIVAL (that is the cluster dispatch decision).
    """

    def __init__(self, cost: PrefillCostModel, cfg: SimConfig,
                 predictor: TTFTPredictor, heap: List, seq: Iterator[int],
                 instance_id: int = 0, capacity: float = 1.0):
        self.cost = cost
        self.cfg = cfg
        self.predictor = predictor
        self.heap = heap
        self.seq = seq
        self.instance_id = instance_id
        self.capacity = capacity        # peak prefill throughput (tokens/s);
                                        # 1.0 = uniform pool (capacity unused)
        # online predictor feedback: engines feed observed (tokens, latency)
        # into predictors that expose observe() (OnlineTTFTPredictor)
        self._observe = getattr(predictor, "observe", None)
        self.core = SchedulerCore(
            predictor=predictor, policy=cfg.policy,
            batch_budget=cfg.batch_budget,
            enable_batching=cfg.enable_batching,
            batching_mode=cfg.batching_mode)
        self.waiting: List[Request] = []
        self.preempted: Dict[int, SimTask] = {}      # tid -> task
        self.running: Optional[SimTask] = None
        self.pending_preempt: Optional[Tuple] = None
        self.blocking: List[float] = []
        self.rounds = 0
        self.preemptions = 0
        self.n_dispatched = 0

    # ---------------------------------------------------------------- load
    def outstanding_tokens(self, now: float) -> float:
        """Raw token-equivalent backlog (waiting + preempted + running)."""
        n = float(sum(r.num_tokens for r in self.waiting))
        for t in self.preempted.values():
            n += t.tokens * t.remaining_fraction(now, running=False)
        if self.running is not None:
            n += self.running.tokens * self.running.remaining_fraction(
                now, running=True)
        return n

    def snapshot_load(self, candidate: Request, now: float) -> InstanceLoad:
        """InstanceLoad snapshot relative to `candidate`, counting only
        competing work (repro_torch.core.dispatch.competing_tokens): queued items
        filtered by deadline + feasibility; the running task included when its
        batch deadline is earlier (it finishes first — otherwise it yields
        within one boundary)."""
        # a waiting request's actual work is its suffix: the dispatched-on
        # prefix hit is never recomputed (prefix_hit = 0 without sharing)
        items = [(float(r.num_tokens - r.prefix_hit), r.deadline)
                 for r in self.waiting]
        items += [(t.preempted_tokens, t.min_deadline)
                  for t in self.preempted.values()]
        queued = competing_tokens(items, candidate, now, self.predictor.predict)
        running = 0.0
        if self.running is not None:
            t = self.running
            if t.min_deadline <= candidate.deadline:
                running = t.tokens * t.remaining_fraction(now, running=True)
        return InstanceLoad(
            instance_id=self.instance_id, queued_tokens=queued,
            running_tokens=running,
            n_outstanding=len(self.waiting) + len(self.preempted)
            + (self.running is not None),
            capacity=self.capacity)

    # --------------------------------------------------------------- build
    def _boundaries(self, op_ends: np.ndarray, tokens: int) -> np.ndarray:
        g = self.cfg.granularity
        m = self.cost.m
        n_ops = len(m.op_names)
        if g == "op":
            return op_ends
        if g == "layer":
            return op_ends[n_ops - 1::n_ops]
        if g == "chunk":
            per_chunk = m.num_layers * n_ops
            return op_ends[per_chunk - 1::per_chunk]
        if g == "whole":
            return op_ends[-1:]
        raise ValueError(g)

    def _make_task(self, batch: List[Request], now: float) -> SimTask:
        tokens = sum(r.num_tokens for r in batch)
        # prefix-cache hits (set at dispatch): the cached leading tokens'
        # chunks are skipped outright — the batch executes as one prefill
        # starting at the aggregate cached offset (suffix-only compute,
        # attention still reading the cached prefix KV). prefix=0 (no
        # sharing, the default) is the exact original path.
        prefix = min(sum(r.prefix_hit for r in batch), tokens - 1)
        op_ends = np.cumsum(self.cost.op_durations(tokens,
                                                   self.cfg.chunk_tokens,
                                                   prefix))
        op_ends = op_ends + self.cfg.submit_overhead
        boundaries = self._boundaries(op_ends, tokens)
        if self.cfg.check_overhead:
            # polling cost at every boundary (coupled scheduling baselines)
            op_ends = op_ends + self.cfg.check_overhead * (
                1 + np.searchsorted(boundaries, op_ends - 1e-12))
            boundaries = self._boundaries(op_ends, tokens)
        t = SimTask(requests=batch, tokens=tokens - prefix, op_ends=op_ends,
                    boundary_ends=boundaries, resume_time=now)
        for r in batch:
            r.ops_total = len(op_ends)
            r.ops_done = 0
            r.batch_tokens = tokens - prefix  # remaining-work basis (S-EDF)
        return t

    # ------------------------------------------------------------ execution
    def _schedule_completion(self, task: SimTask, t0: float) -> None:
        t_done = t0 + (task.total - task.exec_offset)
        heapq.heappush(self.heap, (t_done, next(self.seq), COMPLETION,
                                   (self, task, task.epoch)))

    def _enact(self, decision, t0: float) -> None:
        if decision.action == Action.SUBMIT:
            batch = decision.batch
            for r in batch:
                r.state = RequestState.RUNNING
            ids = {r.rid for r in batch}
            self.waiting[:] = [r for r in self.waiting if r.rid not in ids]
            task = self._make_task(batch, t0)
            self.running = task
            self._schedule_completion(task, t0)
        elif decision.action == Action.RESUME:
            rid = decision.target.rid
            tid = next(t for t, task_ in self.preempted.items()
                       if any(r.rid == rid for r in task_.requests))
            task = self.preempted.pop(tid)
            for r in task.requests:
                r.state = RequestState.RUNNING
            task.resume_time = t0
            task.epoch += 1
            self.running = task
            self._schedule_completion(task, t0)

    def _preempted_reps(self, t0: float) -> List[Request]:
        """Each preempted TASK is represented by its highest-priority member
        (Alg. 2's Q_all contains requests, not tasks — a batch must not
        starve because its head went infeasible). Unbatched tasks need no
        priority evaluation; batched ones share one vectorized pass
        (np.argmax takes the first maximum, exactly like max())."""
        tasks = list(self.preempted.values())
        multi = [t for t in tasks if len(t.requests) > 1]
        if not multi:
            return [t.requests[0] for t in tasks]
        members = [r for t in multi for r in t.requests]
        vec = self.core._priorities_vec(members, t0) \
            if len(members) >= 16 else None
        if vec is None:
            return [t.requests[0] if len(t.requests) == 1
                    else max(t.requests,
                             key=lambda r: self.core.priority(r, t0))
                    for t in tasks]
        pri = vec[0]
        best: Dict[int, Request] = {}
        i = 0
        for t in multi:
            k = len(t.requests)
            best[t.tid] = t.requests[int(np.argmax(pri[i:i + k]))]
            i += k
        return [best[t.tid] if t.tid in best else t.requests[0]
                for t in tasks]

    def _round(self, t0: float) -> None:
        cfg = self.cfg
        self.rounds += 1
        if self.pending_preempt is not None:
            return                          # round resumes after the ACK
        running = self.running
        running_head = running.head if running is not None else None
        reps = self._preempted_reps(t0)
        decision = self.core.schedule_round(
            t0 + cfg.round_overhead, self.waiting, reps, running_head)
        if decision.is_noop:
            return
        if decision.preempt is not None and running is not None:
            if not cfg.preempt:
                return                      # baseline without preemption
            # effective at the next boundary (cooperative)
            b = running.next_boundary(t0)
            t_eff = running.resume_time + (b - running.exec_offset)
            heapq.heappush(self.heap, (t_eff, next(self.seq), PREEMPT_AT,
                                       (self, running, running.epoch,
                                        decision)))
            self.pending_preempt = (running, running.epoch, decision)
            self.preemptions += 1
            self.blocking.append(t_eff - t0)
            return
        self._enact(decision, t0 + cfg.round_overhead)

    # -------------------------------------------------------- event handlers
    def on_arrival(self, req: Request, now: float) -> None:
        self.n_dispatched += 1
        self.waiting.append(req)
        self._round(now)

    def on_completion(self, payload, now: float) -> List[Request]:
        """Returns the completed requests ([] if the event was stale)."""
        _, task, epoch = payload
        if self.running is None or task.tid != self.running.tid or \
                epoch != task.epoch:
            return []                       # stale
        for r in task.requests:
            r.first_token_time = now
            r.state = RequestState.DONE
            r.ops_done = r.ops_total
        if self._observe is not None:
            # observed service time for the batch — the quantity the TTFT
            # predictor models (queueing is priced separately by dispatch)
            self._observe(task.tokens, task.total)
        self.running = None
        self._round(now)
        return list(task.requests)

    def on_preempt_at(self, payload, now: float) -> None:
        _, task, epoch, decision = payload
        if self.running is None or task.tid != self.running.tid or \
                epoch != task.epoch:
            self.pending_preempt = None
            return
        task.epoch += 1                 # cancels its completion event
        task.exec_offset = task.next_boundary(now)
        task.preempted_tokens = task.tokens * task.remaining_fraction(
            now, running=False)         # frozen until resume (load snapshots)
        # boundary index -> ops completed (for S-EDF remaining work)
        ops_done = int(np.searchsorted(
            task.op_ends, task.exec_offset - 1e-12) + 1)
        for r in task.requests:
            r.state = RequestState.PREEMPTED
            r.ops_done = ops_done
        self.preempted[task.tid] = task
        self.running = None
        self.pending_preempt = None
        self._enact(decision, now)


def handle_event(kind: int, payload, now: float) -> List[Request]:
    """Route one popped engine event (COMPLETION / PREEMPT_AT) to its engine.
    Returns requests whose prefill completed at this event."""
    engine: InstanceEngine = payload[0]
    if kind == COMPLETION:
        return engine.on_completion(payload, now)
    if kind == PREEMPT_AT:
        engine.on_preempt_at(payload, now)
        return []
    raise ValueError(kind)


def reset_requests(requests: Sequence[Request]) -> None:
    for r in requests:
        r.state = RequestState.WAITING
        r.first_token_time = None
        r.finish_time = None
        r.mean_tpot = None
        r.ops_done = 0
        r.ops_total = 0
        r.batch_tokens = r.num_tokens
        r.prefix_hit = 0
        r.decode_start = None
        r.decode_migrations = 0
        r.decode_preemptions = 0
        r.retries = 0
        r.shed = False


class PrefillSim:
    """Single-instance simulator (the paper's per-device study)."""

    def __init__(self, cost: PrefillCostModel, sim_cfg: SimConfig,
                 predictor: Optional[TTFTPredictor] = None):
        self.cost = cost
        self.cfg = sim_cfg
        chunk = sim_cfg.chunk_tokens
        self.predictor = predictor or TTFTPredictor.from_cost_model(
            lambda n: cost.prefill_time(n, chunk), max_tokens=32768)

    def run(self, requests: Sequence[Request]) -> SimResult:
        heap: List[Tuple[float, int, int, object]] = []
        seq = itertools.count()
        engine = InstanceEngine(self.cost, self.cfg, self.predictor,
                                heap, seq)
        reset_requests(requests)
        for r in requests:
            heapq.heappush(heap, (r.arrival, next(seq), ARRIVAL, r))

        now = 0.0
        while heap:
            now, _, kind, payload = heapq.heappop(heap)
            if kind == ARRIVAL:
                engine.on_arrival(payload, now)
            else:
                handle_event(kind, payload, now)

        return SimResult(requests=list(requests),
                         blocking_times=engine.blocking,
                         rounds=engine.rounds,
                         preemptions=engine.preemptions,
                         makespan=now)
