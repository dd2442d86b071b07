"""Proxy (FlowPrefill §4): receives frontend requests, dispatches them across
prefill instances via a pluggable instance-level policy (repro_torch.core.dispatch —
the SAME policy objects the cluster simulator evaluates), hands completed
prefills to decode instances (the PD KV transfer), and aggregates results.

The proxy owns per-instance load accounting (`InstanceLoad`): outstanding
tokens are added at dispatch and retired when the instance reports the prefill
done, so load-aware policies (least-loaded / slack-aware deflection) see live
backlog without polling instance internals across threads.

Heterogeneous pools: pass `capacities` (peak prefill tokens/s per instance)
to feed capacity-weighted dispatch, and `decode_cost` (an analytic
DecodeCostModel) to derive downstream decode pressure for decode-aware
dispatch from each decode instance's live backlog. When the wired predictor
exposes `observe()` (OnlineTTFTPredictor), the proxy feeds measured prefill
latencies back on every completion — online refit against real hardware.

Prefix affinity: with a `needs_prefix` policy (``dispatch="prefix-
affinity"``) each dispatch decision probes every instance's prefix-sharing
KV cache for the arriving prompt (`PrefillInstance.probe_prefix`) and
attaches the hit plus its predictor-priced `ttft_saved` to the load
snapshot, so requests route to the instance already holding their prefix KV
unless its queue pressure outweighs the recompute saved
(docs/SCHEDULING.md).

Decode migration (``decode_migration=True``, needs `decode_cost`): after each
handoff the proxy re-plans with the SAME cost-gated planner the cluster
simulator uses (`repro_torch.core.dispatch.plan_decode_migrations`) and moves
queued decode jobs off instances whose effective TBT pressure crossed the SLO
knee — the KV handoff is priced by `DecodeCostModel.kv_transfer_time` even
though the in-process transfer is a reference pass, so real decisions stay
conservative and consistent with the simulated ones (docs/SCHEDULING.md).

Counterpart of src/repro/serving/proxy.py, the same code on torch tensors:
the handoff passes each request's cache row as a view of the prefill's KV
with the event after its last write. The report's ``spec`` key carries the
speculative-decoding counters (all zeros with spec off), and
``watchdog_fires`` counts the hangs the watchdog declared, each logged in
``watchdog_log`` with the stall it saw (beyond the reference, which
keeps no such record).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Union

import numpy as np

from repro_torch.core.dispatch import (DispatchPolicy, InstanceLoad,
                                       competing_tokens, make_dispatch,
                                       plan_decode_migrations, predicted_ttft)
from repro_torch.core.prefixcache import block_keys
from repro_torch.core.metrics import (attainment_by_task, percentile_report,
                                      slo_attainment, tbt_stats, ttft_stats)
from repro_torch.core.predictor import TTFTPredictor
from repro_torch.core.request import Request, RequestState
from repro_torch.serving.decode_instance import DecodeInstance, DecodeJob
from repro_torch.serving.pool import ExecTask
from repro_torch.serving.prefill_instance import PrefillInstance


class Proxy:
    def __init__(self, prefill_instances: List[PrefillInstance],
                 decode_instances: Optional[List[DecodeInstance]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 dispatch: Union[str, DispatchPolicy] = "round-robin",
                 predictor: Optional[TTFTPredictor] = None,
                 capacities: Optional[Sequence[float]] = None,
                 decode_cost=None,
                 decode_migration: bool = False,
                 migration_knee: float = 0.85,
                 max_migrations: int = 1,
                 recovery: str = "retry",
                 max_retries: int = 3,
                 retry_backoff: float = 0.05,
                 retry_backoff_cap: float = 2.0,
                 watchdog_s: float = 0.0,
                 auto_restart_s: float = 0.0,
                 shed_policy: str = "off",
                 shed_budget: float = 2.0):
        if recovery not in ("none", "retry"):
            raise ValueError(f"unknown recovery mode {recovery!r}; "
                             f"known: ['none', 'retry']")
        if shed_policy not in ("off", "doomed-only", "budget"):
            raise ValueError(
                f"unknown shed_policy {shed_policy!r}; "
                f"known: ['off', 'doomed-only', 'budget']")
        self.prefill_instances = prefill_instances
        self.decode_instances = decode_instances or []
        self.clock = clock
        if predictor is None:
            # load-aware policies price backlog with the instances' own
            # TTFT predictor when available
            sched = getattr(prefill_instances[0], "scheduler", None)
            predictor = getattr(sched, "predictor", None)
        self.dispatch = make_dispatch(dispatch, predictor)
        if capacities is not None and len(capacities) != \
                len(prefill_instances):
            raise ValueError("capacities length must match prefill_instances")
        self.capacities = list(capacities) if capacities is not None \
            else [1.0] * len(prefill_instances)
        self.decode_cost = decode_cost        # analytic DecodeCostModel
        self.decode_migration = decode_migration and decode_cost is not None \
            and len(self.decode_instances) > 1
        self.migration_knee = migration_knee
        self.max_migrations = max_migrations
        self.decode_migrations = 0            # streams moved cross-instance
        self._migration_lock = threading.Lock()
        self._observe = getattr(self.dispatch.predictor, "observe", None)
        self._outstanding: List[dict] = [{} for _ in prefill_instances]
        self._load_lock = threading.Lock()
        self._rr_dec = 0
        self.requests: List[Request] = []
        self.dispatched: List[int] = [0] * len(prefill_instances)

        # ---------------- fault tolerance (docs/ARCHITECTURE.md) ----------
        # Supervised recovery: a failing instance strands its in-flight
        # requests back here via `on_fault`; the proxy re-dispatches them
        # with capped exponential backoff under a per-request retry budget
        # (the sim's ClusterSim.recover, identically). Invariant: no request
        # lost, none completed twice — `_completed_rids` dedupes zombie
        # prefill completions, the retained `_tokens` make full-recompute
        # retries possible after the instance's KV died with it.
        self.recovery = recovery
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.retry_backoff_cap = retry_backoff_cap
        self.watchdog_s = watchdog_s
        # supervisor restart policy: > 0 re-admits a failed instance after
        # this cooldown (the worker threads survive exceptions, so restart
        # is always safe). 0 = instances stay down until revive_instance()
        # — the chaos harness drives rejoins from its FaultPlan instead.
        self.auto_restart_s = auto_restart_s
        self.shed_policy = shed_policy
        self.shed_budget = shed_budget
        self.retries = 0                     # re-dispatches performed
        self.shed_requests = 0               # admission-control rejections
        self.lost_requests = 0               # retries exhausted / naive mode
        self.lost_rids: List[int] = []
        self._down: Set[int] = set()         # prefill idx marked unhealthy
        self._down_dec: Set[int] = set()     # decode idx marked unhealthy
        self._completed_rids: Set[int] = set()
        self._tokens: Dict[int, np.ndarray] = {}
        self._pending_retries = 0            # backoff timers not yet landed
        # requests in a handoff between tracked homes: popped from
        # _outstanding (done/fault callback) but not yet re-homed (decode
        # submit / retry timer / park / drop). drain() must not settle while
        # any exist — without this, a thread descheduled between the pop and
        # _recover's _pending_retries increment makes a wedged system look
        # quiescent (outstanding empty, pending 0) for the whole gap.
        self._inflight_handoffs = 0
        # adaptive watchdog backoff state (see _watchdog_loop): per-instance
        # multiplier on watchdog_s, doubled per fire, halved back toward 1.0
        # only after a fire-free interval of several effective periods
        self._wd_scale = [1.0] * len(prefill_instances)
        self._wd_scale_dec = [1.0] * len(self.decode_instances)
        self._wd_last_fire: Dict[int, float] = {}
        self._wd_last_fire_dec: Dict[int, float] = {}
        # (kind, index, seconds without progress, period) of each
        # instance the watchdog stranded
        self.watchdog_log: List[tuple] = []
        self._timers: List[threading.Timer] = []
        self._proxy_shutdown = False

        # wire prefill completion -> load retirement + decode handoff,
        # and worker failure -> supervised recovery
        for i, inst in enumerate(prefill_instances):
            inst.on_prefill_done = self._make_done_cb(i)
            if hasattr(inst, "on_fault"):
                inst.on_fault = self._make_fault_cb(i)
        for j, dec in enumerate(self.decode_instances):
            if hasattr(dec, "on_fault"):
                dec.on_fault = self._make_decode_fault_cb(j)

        self._watchdog_stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        if watchdog_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, daemon=True,
                name="proxy-watchdog")
            self._watchdog.start()

    # ------------------------------------------------------------- dispatch
    def _decode_pressure(self, prefill_idx: int, req: Request) -> float:
        """Downstream TBT pressure for the decode instance paired with
        `prefill_idx` (i mod D): the effective step time were this request's
        decode to join now (`DecodeLoad.effective_step` — the ONE slot-cap +
        queue-time-sharing formula shared with `DecodeSim.pressure` and the
        migration planner) over the candidate's TBT SLO. 0.0 without decode
        instances or a cost model."""
        if not self.decode_instances or self.decode_cost is None:
            return 0.0
        if req.tbt_slo <= 0 or req.tbt_slo == float("inf"):
            return 0.0
        dec = self.decode_instances[prefill_idx % len(self.decode_instances)]
        load = dec.snapshot_load(prefill_idx, self.decode_cost.step_time)
        return load.effective_step(1, float(req.num_tokens)) / req.tbt_slo

    def _ttft_saved(self, idx: int, req: Request, hit: int) -> float:
        """Predicted prefill seconds instance `idx`'s cached prefix would
        save this request: predictor-priced recompute of the hit tokens,
        falling back to capacity-normalized tokens (same units as drain
        time) when no predictor is wired."""
        return self._saved_seconds(idx, req.num_tokens, 0, hit)

    def _saved_seconds(self, idx: int, n: int, warm: int,
                       extra: int) -> float:
        """Predicted prefill seconds that `extra` additional cached tokens
        save, on top of `warm` tokens already served cached — the marginal
        value of a cold (tiered) run is priced from the warm baseline, not
        from zero."""
        if extra <= 0:
            return 0.0
        predict = getattr(self.dispatch.predictor, "predict", None)
        if predict is not None:
            return max(predict(n - warm) - predict(n - warm - extra), 0.0)
        return extra / max(self.capacities[idx], 1e-9)

    def _snapshot_loads(self, req: Request, now: float,
                        tokens=None) -> List[InstanceLoad]:
        """Per-instance competing-work snapshots for one dispatch decision
        (see repro_torch.core.dispatch). Remaining tokens come from the requests'
        own progress counters, which the instances update as ops complete.
        Prefix-affinity policies additionally get each instance's cached-
        prefix hit for THIS prompt (`PrefillInstance.probe_prefix`) and its
        predictor-priced ttft_saved."""
        if not (self.dispatch.needs_loads or self.shed_policy != "off"):
            # admission control needs a real backlog view even under
            # load-oblivious dispatch (round-robin) — same forcing as
            # ClusterSim's arrival path
            return [InstanceLoad(instance_id=i)
                    for i in range(len(self._outstanding))]
        predict = getattr(self.dispatch.predictor, "predict", None)
        want_pressure = self.dispatch.needs_decode_pressure
        want_prefix = self.dispatch.needs_prefix and tokens is not None
        keys_by_bs: dict = {}
        if want_prefix:
            # hash the prompt ONCE per block size (instances normally share
            # one); each instance then only walks its trie
            tokens = np.asarray(tokens)
            for inst in self.prefill_instances:
                bs = inst.kv_block_size
                if bs not in keys_by_bs:
                    keys_by_bs[bs] = block_keys(tokens, bs)
        loads = []
        for i, outstanding in enumerate(self._outstanding):
            items = [(max(r.remaining_tokens(), 0.0), r.deadline)
                     for r in outstanding.values()]
            inst = self.prefill_instances[i]
            hit = cold = 0
            saved = promote_s = 0.0
            if want_prefix:
                inst_keys = keys_by_bs[inst.kv_block_size]
                n = int(tokens.size)
                probe_tiers = getattr(inst, "probe_keys_tiers", None)
                if probe_tiers is not None:
                    # tier-aware affinity: warm tokens are free, cold ones
                    # pay the promotion copy — the load carries the NET
                    # saving so warm/cold/absent are three prices to the
                    # policy, and an unprofitable cold run contributes
                    # nothing (the instance will recompute it)
                    warm, host_t, disk_t = probe_tiers(inst_keys, n)
                    cold = host_t + disk_t
                    hit = warm
                    saved = self._saved_seconds(i, n, 0, warm)
                    if cold > 0:
                        promote_s = inst.promote_seconds(host_t, disk_t)
                        net = self._saved_seconds(i, n, warm, cold) \
                            - promote_s
                        if net > 0:
                            saved += net
                            hit = warm + cold
                else:
                    hit = inst.probe_keys(inst_keys, n)
                    saved = self._ttft_saved(i, req, hit)
            loads.append(InstanceLoad(
                instance_id=i,
                queued_tokens=competing_tokens(items, req, now, predict),
                n_outstanding=len(outstanding),
                capacity=self.capacities[i],
                decode_pressure=self._decode_pressure(i, req)
                if want_pressure else 0.0,
                prefix_hit=hit,
                ttft_saved=saved,
                prefix_hit_cold=cold,
                promote_time=promote_s))
        return loads

    def submit(self, req: Request, tokens: np.ndarray) -> None:
        tokens = np.asarray(tokens)
        now = self.clock()
        with self._load_lock:
            self.requests.append(req)
            # retained for fault recovery: the dying instance's KV dies with
            # it, so a stranded request re-prefills from these tokens
            self._tokens[req.rid] = tokens
        if self.shed_policy != "off" and req.retries == 0:
            # SLO-aware admission control (sim-identical semantics): shed a
            # doomed FRESH arrival with an explicit rejection instead of
            # letting it queue, miss, and poison the p99 tail. Stranded-
            # then-recovered requests are never shed.
            with self._load_lock:
                loads = self._snapshot_loads(req, now, tokens)
                loads = [ld for ld in loads
                         if ld.instance_id not in self._down]
            if loads:
                best = min(predicted_ttft(req, ld, self.dispatch.predictor)
                           for ld in loads)
                if self.shed_policy == "doomed-only":
                    doomed = best > req.slo and \
                        all(ld.n_outstanding > 0 for ld in loads)
                else:                                           # "budget"
                    doomed = best > self.shed_budget * req.slo
                if doomed:
                    with self._load_lock:
                        req.state = RequestState.DROPPED
                        req.shed = True
                        self.shed_requests += 1
                        self._tokens.pop(req.rid, None)
                    return
        if not self._dispatch(req, tokens):
            self._park(req)

    def _dispatch(self, req: Request, tokens: np.ndarray) -> bool:
        """Dispatch to a live instance (down instances are excluded exactly
        like ClusterSim's arrival path). False when NO instance is live —
        the caller parks the request until one rejoins."""
        now = self.clock()
        with self._load_lock:
            if self.decode_instances and \
                    len(self._down_dec) == len(self.decode_instances):
                # prefilling now would only strand the handoff: every decode
                # instance is down, so hold the request until one rejoins
                return False
            loads = self._snapshot_loads(req, now, tokens)
            live = [ld for ld in loads if ld.instance_id not in self._down]
            if not live:
                return False
            idx = self.dispatch.select(req, live, now)
            self._outstanding[idx][req.rid] = req
            self.dispatched[idx] += 1
        self.prefill_instances[idx].submit_request(req, tokens)
        return True

    # ------------------------------------------------------ fault recovery
    def _make_fault_cb(self, idx: int):
        def cb(stranded: List[Request], exc: BaseException) -> None:
            with self._load_lock:
                self._down.add(idx)
                self._inflight_handoffs += len(stranded)
                for r in stranded:
                    self._outstanding[idx].pop(r.rid, None)
            try:
                self._arm_restart(idx, "prefill")
                self._recover(stranded)
            finally:
                with self._load_lock:
                    self._inflight_handoffs -= len(stranded)
        return cb

    def _make_decode_fault_cb(self, j: int):
        def cb(stranded: List[Request], exc: BaseException) -> None:
            with self._load_lock:
                self._down_dec.add(j)
                self._inflight_handoffs += len(stranded)
                for r in stranded:
                    # the decode KV died with the instance: recovery is a
                    # FULL re-prefill, so the rid must be completable again
                    self._completed_rids.discard(r.rid)
            try:
                self._arm_restart(j, "decode")
                self._recover(stranded)
            finally:
                with self._load_lock:
                    self._inflight_handoffs -= len(stranded)
        return cb

    def _arm_restart(self, idx: int, kind: str) -> None:
        if self.auto_restart_s <= 0:
            return
        t = threading.Timer(self.auto_restart_s, self.revive_instance,
                            args=(idx, kind))
        t.daemon = True
        with self._load_lock:
            if self._proxy_shutdown:
                return
            self._timers.append(t)
        t.start()

    @staticmethod
    def _reset_progress(req: Request) -> None:
        """Full progress reset before a re-dispatch: the partial prefill /
        decode state died with the instance (KV-lost convention, exactly the
        simulator's `recover`)."""
        req.state = RequestState.WAITING
        req.ops_done = 0
        req.ops_total = 0
        req.tokens_done = 0
        req.batch_members = []
        req.batch_tokens = req.num_tokens
        req.prefix_hit = 0
        req.first_token_time = None
        req.decode_start = None
        req.mean_tpot = None

    def _recover(self, stranded: List[Request]) -> None:
        """Re-dispatch stranded requests with capped exponential backoff
        under the per-request retry budget (ClusterSim.recover, identically:
        full progress reset — the KV is gone, recompute from scratch)."""
        for req in stranded:
            if req.finish_time is not None:
                continue                      # already terminal (paranoia)
            if self.recovery == "none" or req.retries >= self.max_retries:
                with self._load_lock:
                    req.state = RequestState.DROPPED
                    self.lost_requests += 1
                    self.lost_rids.append(req.rid)
                    self._tokens.pop(req.rid, None)
                continue
            req.retries += 1
            self._reset_progress(req)
            delay = min(self.retry_backoff * 2 ** (req.retries - 1),
                        self.retry_backoff_cap)
            with self._load_lock:
                self.retries += 1
                self._pending_retries += 1
            self._arm_retry(req, delay)

    def _arm_retry(self, req: Request, delay: float) -> None:
        t = threading.Timer(delay, self._retry_fire, args=(req,))
        t.daemon = True
        with self._load_lock:
            if self._proxy_shutdown:
                self._pending_retries -= 1
                return
            self._timers.append(t)
        t.start()

    def _retry_fire(self, req: Request) -> None:
        tokens = self._tokens.get(req.rid)
        if req.finish_time is not None or tokens is None \
                or self._proxy_shutdown:
            with self._load_lock:
                self._pending_retries -= 1
            return
        if self._dispatch(req, tokens):
            with self._load_lock:
                self._pending_retries -= 1
            return
        # every instance down: park at the cap delay WITHOUT charging a
        # retry — waiting for a rejoin is not the request's fault
        self._arm_park(req)

    def _park(self, req: Request) -> None:
        """No live instance at submit time: hold the request (counted as a
        pending retry so drain() waits for it) until one rejoins."""
        with self._load_lock:
            self._pending_retries += 1
        self._arm_park(req)

    def _arm_park(self, req: Request) -> None:
        t = threading.Timer(self.retry_backoff_cap, self._retry_fire,
                            args=(req,))
        t.daemon = True
        with self._load_lock:
            if self._proxy_shutdown:
                self._pending_retries -= 1
                return
            self._timers.append(t)
        t.start()

    # ---------------------------------------------------- chaos / watchdog
    def kill_instance(self, idx: int, kind: str = "prefill",
                      exc: Optional[BaseException] = None) -> None:
        """Chaos-harness entry point: crash one instance NOW. Its in-flight
        work strands to the recovery path; the instance stays excluded from
        dispatch until revive_instance()."""
        exc = exc or RuntimeError(f"injected crash: {kind}[{idx}]")
        if kind == "prefill":
            self.prefill_instances[idx]._on_worker_failure(exc)
        else:
            self.decode_instances[idx]._on_worker_failure(exc)

    def revive_instance(self, idx: int, kind: str = "prefill") -> None:
        """Delayed rejoin: restart the worker and readmit the instance to
        the dispatch pool. Beyond the reference: an instance that never
        went down (a hang the watchdog has not yet caught) is left alone, as
        its restart would reset its progress clock and hide the hang for
        another watchdog period."""
        insts, down = (self.prefill_instances, self._down) \
            if kind == "prefill" else (self.decode_instances, self._down_dec)
        with self._load_lock:
            if idx not in down and getattr(insts[idx], "healthy", False):
                return
        if kind == "prefill":
            self.prefill_instances[idx].restart()
            with self._load_lock:
                self._down.discard(idx)
        else:
            self.decode_instances[idx].restart()
            with self._load_lock:
                self._down_dec.discard(idx)

    def _watchdog_loop(self) -> None:
        """Hang detection: a hung worker makes no progress but raises
        nothing — the only signal is a stalled progress timestamp while work
        is outstanding. Strand it like a crash (TimeoutError).

        The per-instance period is ADAPTIVE (the classic failure-detector
        compromise): a fixed timeout cannot separate a hang from an honest
        stall when the host is oversubscribed, and repeatedly stranding a
        slow-but-progressing worker livelocks recovery — every re-dispatch
        gets killed before it can finish. Each watchdog fire doubles that
        instance's effective period, so a sustained storm self-damps once
        the period outgrows the true stall scale. Decay keys on FIRE
        RECENCY, not on progress: an oversubscribed-but-honest worker shows
        fresh progress between the very hiccups that trip the watchdog, so
        progress-keyed decay would race the growth back down and the storm
        would never damp. Only after several fire-free effective periods
        does the scale halve back toward the configured base, restoring
        fast detection once the load subsides."""
        period = max(self.watchdog_s / 4.0, 0.01)

        def step(kind: str, k: int, scales: list, last_fire: dict,
                 obj, busy: bool, progress_ts: float, now: float) -> None:
            wd = self.watchdog_s * scales[k]
            if busy and now - progress_ts > wd:
                scales[k] = min(scales[k] * 2.0, 64.0)
                last_fire[k] = now
                self.watchdog_log.append((kind, k, now - progress_ts, wd))
                obj._on_worker_failure(TimeoutError(
                    f"watchdog: {kind}[{k}] made no progress for "
                    f"{wd:.3f}s"))
            elif now - last_fire.get(k, -math.inf) > 4.0 * wd:
                scales[k] = max(scales[k] / 2.0, 1.0)

        while not self._watchdog_stop.wait(period):
            now = self.clock()
            for i, inst in enumerate(self.prefill_instances):
                if not getattr(inst, "healthy", True) or i in self._down:
                    continue
                with self._load_lock:
                    busy = bool(self._outstanding[i])
                step("prefill", i, self._wd_scale, self._wd_last_fire,
                     inst, busy, inst.progress_ts, now)
            for j, dec in enumerate(self.decode_instances):
                if not getattr(dec, "healthy", True) or j in self._down_dec:
                    continue
                step("decode", j, self._wd_scale_dec,
                     self._wd_last_fire_dec, dec, not dec.idle(),
                     dec.progress_ts, now)

    def _make_done_cb(self, idx: int) -> Callable[[ExecTask], None]:
        def cb(task: ExecTask) -> None:
            with self._load_lock:
                # exactly-once: a request re-dispatched after a fault may be
                # completed by two incarnations in pathological interleavings
                # (the instance-level zombie guard is the first defense);
                # only the FIRST completion proceeds to the decode handoff.
                keep = [i for i, r in enumerate(task.requests)
                        if r.rid not in self._completed_rids]
                for i in keep:
                    self._completed_rids.add(task.requests[i].rid)
                for r in task.requests:
                    self._outstanding[idx].pop(r.rid, None)
                if not self.decode_instances:
                    for r in task.requests:
                        self._tokens.pop(r.rid, None)
                # the kept requests are now in NO tracked home until the
                # decode submit (or park) below lands — hold drain open
                self._inflight_handoffs += len(keep)
            if not keep:
                return
            try:
                if self._observe is not None \
                        and task.complete_time is not None:
                    # online refit: measured service time of the batched
                    # prefill. complete_time is only ever set by the pool,
                    # which stamped submit_time first (possibly a legitimate
                    # 0.0 under an injected zero-based clock); observe()
                    # drops non-positive latencies itself.
                    self._observe(sum(r.num_tokens for r in task.requests),
                                  task.complete_time - task.submit_time)
                self._prefill_done(task, idx, keep)
            finally:
                with self._load_lock:
                    self._inflight_handoffs -= len(keep)
        return cb

    def _prefill_done(self, task: ExecTask, idx: int,
                      keep: Optional[List[int]] = None) -> None:
        if not self.decode_instances:
            return
        if keep is None:
            keep = list(range(len(task.requests)))
        with self._load_lock:           # called from every instance's thread
            live = [j for j in range(len(self.decode_instances))
                    if j not in self._down_dec]
            if not live:
                dec = None
            elif self.dispatch.needs_decode_pressure:
                # paired handoff (prefill i -> decode i mod D): keeps the
                # pressure signal attributable to the dispatch decision —
                # redirected to a live peer when the pair is down
                j = idx % len(self.decode_instances)
                if j not in live:
                    j = live[idx % len(live)]
                dec = self.decode_instances[j]
            else:
                dec = self.decode_instances[live[self._rr_dec % len(live)]]
                self._rr_dec += 1
        if dec is None:
            # nowhere live to decode: the prefill result dies with the
            # handoff — park the requests for re-prefill once a decode
            # instance rejoins. No retry charged: waiting out a pool-wide
            # outage is not the request's fault.
            victims = [task.requests[i] for i in keep]
            with self._load_lock:
                for r in victims:
                    self._completed_rids.discard(r.rid)
            for r in victims:
                self._reset_progress(r)
                self._park(r)
            return
        first = task.prefill_task.logits.argmax(-1).tolist()
        st = task.prefill_task.state
        for i in keep:
            req = task.requests[i]
            # slice this request's cache row out of the batched prefill: a
            # view of a tensor made on the prefill instance's stream, handed
            # over with the event after its last write ("ready") for the
            # decode instance to wait on (DecodeInstance._adopt)
            cache = {
                "k": st["k_cache"][:, i:i + 1],
                "v": st["v_cache"][:, i:i + 1],
                "pos": int(st["lens"][i]),
                "ready": task.prefill_task.sync_token,
            }
            dec.submit(DecodeJob(request=req, cache=cache,
                                 first_token=int(first[i])))
        if self.decode_migration:
            self.rebalance_decodes()

    def rebalance_decodes(self) -> int:
        """One pass of cost-gated decode migration (core/dispatch planner):
        queued jobs leave instances whose effective TBT pressure crossed the
        knee for the queue's streams. Returns the number of jobs moved.

        One pass at a time (`_migration_lock` — `_prefill_done` fires from
        every prefill instance's thread), and loads are re-snapshotted per
        SOURCE so a later source sees the jobs an earlier one just moved —
        matching ClusterSim's per-event `migrate_from` exactly; otherwise two
        over-the-knee sources planning from one stale snapshot would both
        dump onto the same destination and push it past the knee."""
        if self.decode_cost is None or len(self.decode_instances) < 2:
            return 0
        with self._load_lock:
            if self._down_dec:
                # no rebalancing during decode churn: the planner's loads
                # would nominate a down instance as a destination
                return 0
        moved = 0
        with self._migration_lock:
            for i, src in enumerate(self.decode_instances):
                if src.pending() == 0:
                    continue
                now = self.clock()
                loads = [dec.snapshot_load(j, self.decode_cost.step_time)
                         for j, dec in enumerate(self.decode_instances)]
                plan = plan_decode_migrations(
                    loads[i], src.snapshot_candidates(), loads, now,
                    transfer_time=self.decode_cost.kv_transfer_time,
                    knee=self.migration_knee,
                    max_migrations=self.max_migrations)
                for rid, dst_id, _ in plan:
                    for job in src.take([rid]):
                        job.request.decode_migrations += 1
                        self.decode_instances[dst_id].submit(job)
                        moved += 1
            self.decode_migrations += moved
        return moved

    def drain(self, timeout: float = 120.0) -> bool:
        """True iff every non-lost request reached its terminal state within
        `timeout`. Waits out in-flight backoff retries (`_pending_retries`)
        and re-checks from the top after each pass — a fault mid-drain
        re-queues work that an earlier check already saw as done. Down
        instances are skipped: their work was stranded to the retry path.

        ALL decode instances must be idle in one atomic observation under
        the migration lock: a migrating job is momentarily in NO instance
        (take -> submit inside rebalance_decodes), and per-instance
        sequential drains could each look empty while a job hops between
        already-checked instances."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            with self._load_lock:
                busy = self._pending_retries > 0 \
                    or self._inflight_handoffs > 0
            if busy:
                time.sleep(0.005)
                continue
            live = [inst for i, inst in enumerate(self.prefill_instances)
                    if i not in self._down]
            if not all(inst.drain(min(remaining, 1.0)) for inst in live):
                continue
            if self.decode_instances:
                with self._migration_lock:
                    idle = all(dec.idle() for j, dec
                               in enumerate(self.decode_instances)
                               if j not in self._down_dec)
                if not idle:
                    time.sleep(0.005)
                    continue
            with self._load_lock:
                # settle check: a fault while we drained may have re-armed
                # a retry — only a pass with NO pending work all the way
                # through counts
                if self._pending_retries == 0 \
                        and self._inflight_handoffs == 0 \
                        and not any(self._outstanding):
                    return True
            time.sleep(0.005)

    def shutdown(self) -> None:
        with self._load_lock:
            self._proxy_shutdown = True
            timers = list(self._timers)
            self._timers.clear()
        for t in timers:
            t.cancel()
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(2.0)
        for inst in self.prefill_instances:
            inst.shutdown()
        for dec in self.decode_instances:
            dec.shutdown()

    # ------------------------------------------------------------- metrics
    def _terminal(self, r: Request) -> bool:
        if r.state == RequestState.DROPPED:
            return True
        if r.output_tokens > 0:
            return r.finish_time is not None
        return r.first_token_time is not None

    def _spec_report(self) -> dict:
        decs = self.decode_instances
        proposed = sum(d.draft_proposed for d in decs)
        accepted = sum(d.draft_accepted for d in decs)
        steps = [s for d in decs for s in d.step_samples]
        tokens = sum(len(d.tbt_samples) for d in decs)
        row_steps = sum(d.row_steps for d in decs)
        return {
            "spec_steps": sum(d.spec_steps for d in decs),
            "draft_proposed": proposed,
            "draft_accepted": accepted,
            "accept_rate": accepted / proposed if proposed else 0.0,
            # per-STREAM tokens committed per step (1.0 = plain decode)
            "tokens_per_step": tokens / row_steps if row_steps else 0.0,
            "step_latency_mean": float(np.mean(steps)) if steps else 0.0,
        }

    def report(self) -> dict:
        with self._load_lock:
            dispatched = list(self.dispatched)
            stranded = sorted(r.rid for r in self.requests
                              if not self._terminal(r))
            fault = {
                # supervised-recovery accounting (mirrors ClusterResult)
                "retries": self.retries,
                "shed_requests": self.shed_requests,
                "lost_requests": self.lost_requests,
                "lost_rids": sorted(self.lost_rids),
                "watchdog_fires": len(self.watchdog_log),
                # non-terminal at report time: after a clean drain this MUST
                # equal lost_rids' complement of nothing — any other rid here
                # is a stranded request the drain timed out on
                "stranded_rids": stranded,
                "pending_retries": self._pending_retries,
                "inflight_handoffs": self._inflight_handoffs,
                "down_instances": sorted(self._down),
                "down_decode_instances": sorted(self._down_dec),
                "instance_health": {
                    "prefill": [bool(getattr(i, "healthy", True))
                                for i in self.prefill_instances],
                    "decode": [bool(getattr(d, "healthy", True))
                               for d in self.decode_instances],
                },
            }
        return {
            **fault,
            "n_requests": len(self.requests),
            "dispatch_policy": self.dispatch.name,
            "dispatched_by_instance": dispatched,
            "slo_attainment": slo_attainment(self.requests),
            "by_task": attainment_by_task(self.requests),
            "ttft": ttft_stats(self.requests),
            "tbt": tbt_stats(self.requests),
            # full percentile families (p50/p90/p99 TTFT & TBT, aggregate +
            # per task, SLO-normalized p99s) — same shape as
            # ClusterResult.percentiles(): production SLOs gate on tails,
            # and a mid-run report counts unfinished requests as +inf tail
            # events rather than silently dropping them
            "percentiles": percentile_report(self.requests),
            "decode_migrations": self.decode_migrations,
            "decode_preemptions": sum(d.preemptions
                                      for d in self.decode_instances),
            "decode_steps": sum(getattr(d, "steps", 0)
                                for d in self.decode_instances),
            # speculative decoding: draft/accept counters plus the two
            # latencies multi-token steps split apart — per-accepted-token
            # TBT (tbt_samples) vs per-step wall latency (step_samples)
            "spec": self._spec_report(),
            "prefix_hits": sum(getattr(i, "prefix_hits", 0)
                               for i in self.prefill_instances),
            "prefix_hit_tokens": sum(getattr(i, "prefix_hit_tokens", 0)
                                     for i in self.prefill_instances),
            "prefix_promoted_tokens": sum(
                getattr(i, "prefix_promoted_tokens", 0)
                for i in self.prefill_instances),
            "scheduling_rounds": sum(i.scheduling_rounds
                                     for i in self.prefill_instances),
            "blocking_mean": float(np.mean(
                [i.blocking_stats.mean for i in self.prefill_instances])),
        }
