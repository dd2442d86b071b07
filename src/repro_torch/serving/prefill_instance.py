"""Prefill instance (FlowPrefill §4/§5): Request Queue + Scheduler + Execution
Pool, wired event-driven. The Scheduler thread blocks on the Event Monitor;
each ARRIVAL/COMPLETION event triggers exactly one SchedulerCore round whose
Decision is enacted as submit / preempt / resume commands on the pool.

Prefix sharing (``prefix_share=True``): the instance owns a prefix-sharing
`PagedKVCache` holding completed prompts' KV. On ARRIVAL the prompt's block
hash chain probes the trie and the sequence is allocated with the cached
prefix pinned (only the suffix gets fresh blocks); at SUBMIT the pinned
prefix KV is gathered from the pool and `SegmentedPrefill.start` resumes at
operator offset ``prefix_len`` — a hit is pure skipped compute. On
COMPLETION the computed suffix KV is written into the fresh blocks, the
full blocks are registered in the trie, and the sequence is released
(refcount decrement: its blocks stay CACHED for the next matching prompt).
With ``host_cache_blocks > 0`` evicted blocks demote to host (and disk)
copies, and a prompt whose chain runs into a cold tier promotes it back when
the copy is predicted cheaper than the recompute.

Counterpart of src/repro/serving/prefill_instance.py. On the card the
instance owns one CUDA stream: task set-up on the scheduler thread, every
segment on the pool worker, and every read and write of the prefix pool run
on it, so the pool's event waits cover only this instance's work.

With the tracer on (`repro_torch.tracing`; each arriving request polls it,
so a `torch.profiler` session turns it on), the instance records a `queue`
span per request (ARRIVAL published to its task's submit), a `round` span
per scheduling round, and inside a round a `preempt` span around the pool's
preemption handshake and a `handoff` span around `on_prefill_done`.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.events import Event, EventKind, EventMonitor
from repro_torch.core.prefixcache import block_keys
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import Action, SchedulerCore
from repro_torch.models.segments import (SegmentedPrefill, on_stream,
                                         stream_for)
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.pool import ExecTask, ExecutionPool


class PrefillInstance:
    def __init__(self, params, cfg, scheduler: SchedulerCore, *, max_seq: int,
                 granularity: str = "op", chunk_tokens: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 on_prefill_done: Optional[Callable] = None,
                 executor: Optional[SegmentedPrefill] = None,
                 dispatch_depth: int = 2,
                 cache_dtype: torch.dtype = torch.float32,
                 prefix_share: bool = False,
                 prefix_cache_blocks: int = 512,
                 kv_block_size: int = 128,
                 host_cache_blocks: int = 0,
                 disk_cache_blocks: int = 0,
                 promote_wait_s: float = 10.0):
        self.cfg = cfg
        self.scheduler = scheduler
        self.clock = clock
        self.max_seq = max_seq
        self.on_prefill_done = on_prefill_done
        # a pre-built executor may be shared across instances
        self.executor = executor or SegmentedPrefill(
            params, cfg, max_seq=max_seq, granularity=granularity,
            chunk_tokens=chunk_tokens, cache_dtype=cache_dtype)
        self.stream = stream_for(self.executor.device)

        # prefix-sharing prompt KV cache (None = disabled, the default), in
        # the executor's cache dtype on its device, read and written on
        # this instance's stream
        self.kv: Optional[PagedKVCache] = None
        self.kv_block_size = kv_block_size
        if prefix_share:
            self.kv = PagedKVCache(
                cfg.num_layers, prefix_cache_blocks, kv_block_size,
                cfg.num_kv_heads, cfg.resolved_head_dim,
                dtype=self.executor.cache_dtype, device=self.executor.device,
                prefix_share=True, host_cache_blocks=host_cache_blocks,
                disk_cache_blocks=disk_cache_blocks, stream=self.stream)
        # guards self.kv: the scheduler thread mutates it on every
        # arrival/completion while the Proxy probes it for affinity routing
        self._kv_lock = threading.Lock()
        self._prefix: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        # rid -> (pool hit tokens, hash chain) for sequences holding blocks
        self.prefix_hits = 0                 # requests with a nonzero hit
        self.prefix_hit_tokens = 0           # prompt tokens served cached
        # tiered promotion: rid -> in-flight PromotionTicket, settled by
        # _make_task before the prefill that depends on the blocks starts
        self._tickets: Dict[int, object] = {}
        self.promote_wait_s = promote_wait_s
        self.prefix_promotions = 0           # blocks re-warmed from a tier
        self.prefix_promoted_tokens = 0      # hit tokens gained by promotion

        self.monitor = EventMonitor()
        self.pool = ExecutionPool(step_fn=self._step, on_complete=self._complete,
                                  clock=clock, dispatch_depth=dispatch_depth,
                                  on_error=self._on_pool_error)

        # supervised-worker health: a crash in either worker thread strands
        # the queued + in-flight requests back to `on_fault` (the Proxy
        # re-dispatches them) and flips healthy=False until restart().
        # last_progress feeds the Proxy's watchdog (hang detection).
        self.healthy = True
        self.on_fault: Optional[Callable] = None   # (requests, exc) -> None
        self.last_error: Optional[BaseException] = None
        self.last_progress = clock()

        # request bookkeeping (owned by the scheduler thread)
        self._tokens: Dict[int, np.ndarray] = {}
        self._waiting: List[Request] = []
        self._running: Optional[ExecTask] = None
        self._preempted: Dict[int, ExecTask] = {}   # head rid -> task
        # submitted requests whose ARRIVAL the scheduler thread has not
        # handled yet: the event leaves the monitor's queue before the
        # thread takes the lock, and drain() must not call that idle
        self._arriving = 0
        # tasks running when the instance was stranded: their requests were
        # re-dispatched, so a COMPLETION they queued is a zombie's
        self._stranded_tasks: set = set()
        # tracer on: rid -> time.monotonic() its ARRIVAL was published, until
        # its task is submitted; and the id of the round being handled
        self._queued_at: Dict[int, float] = {}
        self._round_sid = 0
        self.completed: List[Request] = []
        self.completed_tasks: List[ExecTask] = []
        self._lock = threading.Lock()
        # drain() waits here; the scheduler thread notifies after any event
        # that may have emptied the instance
        self._idle_cv = threading.Condition(self._lock)

        self._shutdown = False
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        daemon=True, name="scheduler")
        self._thread.start()

    # ------------------------------------------------------------- frontend
    def submit_request(self, req: Request, tokens: np.ndarray) -> None:
        tracing.poll()
        with self._lock:
            if self.healthy and not self._busy():
                # beyond the reference: work arriving at an idle instance
                # restarts its progress clock, or the Proxy's watchdog would
                # measure the idle time before it as a stall
                self.last_progress = self.clock()
            self._tokens[req.rid] = np.asarray(tokens)
            self._arriving += 1
        if tracing.on:
            self._queued_at[req.rid] = time.monotonic()
        self.monitor.publish(Event(time=self.clock(), kind=EventKind.ARRIVAL,
                                   payload=req))

    def probe_prefix(self, tokens: np.ndarray) -> int:
        """Cached-prefix tokens this instance's pool holds for `tokens` —
        the affinity signal the Proxy's prefix-affinity dispatch routes on.
        0 without prefix sharing. Capped at len-1: the last position is
        always computed live (first-token logits)."""
        if self.kv is None:
            return 0
        tokens = np.asarray(tokens)
        return self.probe_keys(block_keys(tokens, self.kv_block_size),
                               int(tokens.size))

    def probe_keys(self, keys, num_tokens: int) -> int:
        """`probe_prefix` for a pre-hashed chain: the Proxy hashes the
        prompt ONCE per dispatch and probes every instance with the same
        chain — only the trie walk runs under each instance's lock."""
        if self.kv is None:
            return 0
        with self._kv_lock:
            hit = self.kv.probe(keys)
        return min(hit, max(num_tokens - 1, 0))

    def probe_keys_tiers(self, keys, num_tokens: int) -> Tuple[int, int, int]:
        """`probe_keys` with tier-tagged lengths: (warm, host, disk) cached
        tokens, jointly capped at num_tokens - 1. Warm tokens are free;
        cold ones cost `promote_seconds`."""
        if self.kv is None:
            return (0, 0, 0)
        with self._kv_lock:
            warm, host, disk = self.kv.probe_tiers(keys)
        cap = max(num_tokens - 1, 0)
        warm = min(warm, cap)
        host = min(host, cap - warm)
        disk = min(disk, cap - warm - host)
        return warm, host, disk

    def promote_seconds(self, host_tokens: int, disk_tokens: int = 0) -> float:
        """Predicted copy time to promote that many cold tokens (0 when
        this instance has no cold tiers)."""
        if self.kv is None or not self.kv.tiered:
            return 0.0
        return self.kv.promote_seconds(host_tokens, disk_tokens)

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until all submitted requests completed (condition variable
        notified by the scheduler thread after every processed event)."""
        def idle() -> bool:
            # unhealthy => never drained: the strand sweep clears these
            # queues BEFORE on_fault hands the victims to the supervisor
            return self.healthy and not self._busy()
        with self._idle_cv:
            return self._idle_cv.wait_for(idle, timeout)

    def _busy(self) -> bool:
        """Work submitted and not finished (read under self._lock)."""
        return bool(self._arriving or self._waiting or self._preempted
                    or self._running is not None
                    or self.monitor.qsize() > 0)

    def shutdown(self) -> None:
        self._shutdown = True
        self.monitor.publish(Event(time=self.clock(), kind=EventKind.SHUTDOWN))
        self._thread.join(5.0)
        self.pool.shutdown()
        if self.kv is not None:
            # settle any promotion that never reached a SUBMIT (its request
            # is abandoned) so the pool accounting stays leak-free
            self._settle_abandoned(list(self._tickets))
            self.kv.close()

    # ---------------------------------------------------------------- worker
    def _step(self, task: ExecTask) -> bool:
        with on_stream(self.stream):
            return self.executor.step(task.prefill_task)

    def _complete(self, task: ExecTask) -> None:
        if not self.healthy:
            # zombie completion: the instance already stranded this task's
            # requests to the Proxy — mutating them now would race their
            # re-dispatch
            return
        now = task.complete_time
        for r in task.requests:
            r.first_token_time = now
            r.state = RequestState.DONE
            r.ops_done = r.ops_total
        self.monitor.publish(Event(time=now, kind=EventKind.COMPLETION,
                                   payload=task))

    # ------------------------------------------------------------- scheduler
    def _scheduler_loop(self) -> None:
        while not self._shutdown:
            ev = self.monitor.next_event(timeout=1.0)
            if ev is None:
                continue
            tr = tracing.on
            if tr:
                t0 = time.monotonic()
                self._round_sid = tracing.new_id()
            if ev.kind == EventKind.SHUTDOWN:
                return
            try:
                if ev.kind == EventKind.FAULT:
                    inj = ev.payload
                    if isinstance(inj, tuple) and inj and inj[0] == "hang":
                        # simulated hang: stall OUTSIDE the lock so the
                        # watchdog can still strand the queues
                        time.sleep(float(inj[1]))
                        continue
                    raise inj if isinstance(inj, BaseException) \
                        else RuntimeError(str(inj))
                if not self.healthy:
                    if ev.kind == EventKind.ARRIVAL:
                        with self._lock:
                            self._arriving -= 1
                        # a dispatch that raced the failure: bounce it
                        # straight back to the recovery path
                        cb = self.on_fault
                        if cb is not None:
                            cb([ev.payload], self.last_error
                               or RuntimeError("instance down"))
                    continue        # stranded: drop zombies until restart()
                with self._lock:
                    self._handle_event(ev)
                    self._round()
                    if tr:
                        tracing.record("round", t0, time.monotonic(),
                                       cause=ev.seq, sid=self._round_sid,
                                       kind=ev.kind.value, published=ev.time)
                    if not self._busy():
                        self._idle_cv.notify_all()
                self.last_progress = self.clock()
            except Exception as exc:
                self._on_worker_failure(exc)

    # ------------------------------------------------ supervised recovery
    def _on_worker_failure(self, exc: Exception) -> None:
        """Strand everything back to the proxy layer: idempotent (first
        failure wins), callable from the scheduler thread, the pool worker,
        or the Proxy's watchdog. Queued, suspended, and running requests are
        all returned — their partial prefill state died with the instance."""
        with self._lock:
            if not self.healthy:
                return
            self.healthy = False
            self.last_error = exc
            stranded: List[Request] = list(self._waiting)
            for task in self._preempted.values():
                stranded.extend(task.requests)
            if self._running is not None:
                stranded.extend(self._running.requests)
                self._stranded_tasks.add(self._running.task_id)
            self._waiting = []
            self._preempted = {}
            self._running = None
            if self.kv is not None:
                # the stranded requests may come back here after restart():
                # settle their promotions and unpin their blocks now
                rids = [r.rid for r in stranded]
                self._settle_abandoned(rids)
                with self._kv_lock:
                    for rid in rids:
                        if self._prefix.pop(rid, None) is not None:
                            self.kv.free(rid)
            self._idle_cv.notify_all()
        # stop the pool's in-flight task too, so it cannot collide with the
        # first submit after restart()
        self.pool.preempt_current(timeout=5.0)
        self.pool.clear_preempted()
        cb = self.on_fault
        if cb is not None:
            cb(stranded, exc)       # outside the lock: the Proxy re-enters

    def _on_pool_error(self, task, exc: Exception) -> None:
        self._on_worker_failure(exc)

    def inject_fault(self, fault) -> None:
        """Chaos-harness entry: an Exception crashes the scheduler loop at
        its next event; ("hang", seconds) stalls it."""
        self.monitor.publish(Event(time=self.clock(), kind=EventKind.FAULT,
                                   payload=fault))

    def restart(self) -> None:
        """Rejoin after a failure: both worker threads survive exceptions,
        so recovery is a state reset, not a thread respawn."""
        with self._lock:
            self.healthy = True
            self.last_error = None
            self.last_progress = self.clock()
        self.pool.restart()

    @property
    def progress_ts(self) -> float:
        """Latest liveness signal across both worker threads."""
        return max(self.last_progress, self.pool.last_step)

    def _settle_abandoned(self, rids) -> None:
        """Settle the promotions of requests that will not be submitted
        here: landed copies commit, the rest abort back to their tier."""
        for rid in rids:
            ticket = self._tickets.pop(rid, None)
            if ticket is not None:
                with self._kv_lock:
                    self.kv.promote_settle(ticket)

    def _acquire_prefix(self, req: Request, tokens: np.ndarray) -> None:
        """ARRIVAL-time trie probe + allocation: pin the cached prefix and
        reserve fresh suffix blocks, so eviction cannot touch the hit while
        the request waits/executes. A full pool (even after LRU eviction)
        just means this prompt goes uncached — never an error."""
        n = len(tokens)
        keys = block_keys(tokens, self.kv_block_size)
        with self._kv_lock:
            try:
                table = self.kv.allocate(req.rid, n, keys=keys)
            except MemoryError:
                return
            hit = min(table.length, max(n - 1, 0))
            ticket = self._begin_promotion(keys, n, table.length)
        self._prefix[req.rid] = (hit, keys)
        req.prefix_hit = hit
        if ticket is not None and ticket.blocks:
            self._tickets[req.rid] = ticket
        if hit:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hit

    def _begin_promotion(self, keys, n: int, warm: int):
        """Under _kv_lock at ARRIVAL: if the prompt's chain extends into a
        cold tier, start promoting it — but only when the predicted copy
        time beats the recompute the promotion would save (the scheduler's
        TTFT predictor prices the save). Returns a PromotionTicket or
        None."""
        if not self.kv.tiered:
            return None
        _, host_t, disk_t = self.kv.probe_tiers(keys)
        cap = max(n - 1, 0) - warm         # useful tokens beyond the warm run
        cold = min(host_t + disk_t, cap)
        if cold <= 0:
            return None
        pred = getattr(self.scheduler, "predictor", None)
        if pred is not None:
            saved = max(float(pred.predict(n - warm))
                        - float(pred.predict(n - warm - cold)), 0.0)
            host_use = min(host_t, cold)
            cost = self.kv.promote_seconds(host_use, cold - host_use)
            if cost >= saved:
                return None                # cheaper to recompute than copy
        bs = self.kv_block_size
        return self.kv.promote_async(keys, max_blocks=(cold + bs - 1) // bs)

    def _publish_prefix(self, task: ExecTask) -> None:
        """COMPLETION-time insert: write each member's computed suffix KV
        into its fresh blocks, register the full blocks in the trie, release
        the sequence (refcount decrement — blocks stay cached, LRU-ordered).
        The prefill state's cache rows are fully valid (< prefix seeded,
        >= prefix computed), so the slice is always well-defined. The
        task's cache was written on this instance's stream by the pool
        worker; the pool writes are enqueued on the same stream."""
        st = task.prefill_task.state
        with on_stream(self.stream), self._kv_lock:
            for i, req in enumerate(task.requests):
                entry = self._prefix.pop(req.rid, None)
                if entry is None:
                    continue                      # pool was full at arrival
                _, keys = entry
                table = self.kv.table(req.rid)
                start = table.prefix_blocks * self.kv_block_size
                n = int(st["lens"][i])
                if start < n:
                    self.kv.write_prompt(
                        req.rid, st["k_cache"][:, i, start:n],
                        st["v_cache"][:, i, start:n], start=start)
                self.kv.insert(req.rid, keys)
                self.kv.free(req.rid)

    def _handle_event(self, ev: Event) -> None:
        if ev.kind == EventKind.ARRIVAL:
            req: Request = ev.payload
            req.state = RequestState.WAITING
            self._arriving -= 1
            if self.kv is not None:
                self._acquire_prefix(req, self._tokens[req.rid])
            self._waiting.append(req)
        elif ev.kind == EventKind.COMPLETION:
            task: ExecTask = ev.payload
            if task.task_id in self._stranded_tasks:
                # beyond the reference: the task completed, and queued this
                # event, while this thread hung; the strand then handed its
                # requests back, and a restart() since let the event through
                # the health check. Handing it on would decode a request
                # its re-dispatch also serves.
                self._stranded_tasks.discard(task.task_id)
                return
            if self._running is not None and task.task_id == self._running.task_id:
                self._running = None
            if self.kv is not None:
                self._publish_prefix(task)
            self.completed.extend(task.requests)
            self.completed_tasks.append(task)
            if self.on_prefill_done is not None:
                tr = tracing.on
                if tr:
                    t0 = time.monotonic()
                self.on_prefill_done(task)
                if tr:
                    tracing.record("handoff", t0, time.monotonic(),
                                   cause=self._round_sid, task=task.task_id)

    def _round(self) -> None:
        """One scheduling round (Alg. 2) + command execution."""
        now = self.clock()
        running_req = self._running.head if self._running is not None else None
        preempted_reqs = [t.head for t in self._preempted.values()]
        decision = self.scheduler.schedule_round(
            now, self._waiting, preempted_reqs, running_req)
        if decision.is_noop:
            return

        if decision.preempt is not None and self._running is not None:
            tr = tracing.on
            if tr:
                t0 = time.monotonic()
            suspended = self.pool.preempt_current()
            if tr:
                tracing.record("preempt", t0, time.monotonic(),
                               cause=self._round_sid,
                               task=self._running.task_id,
                               suspended=suspended is not None)
            if suspended is not None:
                head = suspended.head
                for r in suspended.requests:
                    r.state = RequestState.PREEMPTED
                head.ops_total = suspended.prefill_task.total_segments
                head.ops_done = suspended.prefill_task.cursor
                self._preempted[head.rid] = suspended
                self._running = None
            elif self.pool.current() is self._running:
                # beyond the reference: not acknowledged and still the
                # pool's task, so the worker is stuck inside one operator
                # past the timeout. Strand it like a crash (the scheduler
                # loop's handler); dropping `_running` here would orphan
                # its requests, which no strand could then hand back.
                raise TimeoutError("preemption not acknowledged: the pool "
                                   "worker is stuck in an operator")
            else:
                # completed concurrently; the COMPLETION event will arrive.
                self._running = None

        if decision.action == Action.SUBMIT:
            batch = decision.batch
            task = self._make_task(batch)
            for r in batch:
                r.state = RequestState.RUNNING
                r.ops_total = task.prefill_task.total_segments
                r.ops_done = 0
            waiting_ids = {r.rid for r in batch}
            self._waiting = [r for r in self._waiting
                             if r.rid not in waiting_ids]
            self._running = task
            if tracing.on:
                now = time.monotonic()
                for r in batch:
                    t0 = self._queued_at.pop(r.rid, None)
                    if t0 is not None:
                        tracing.record("queue", t0, now, cause=r.rid)
            self.pool.submit(task)
        elif decision.action == Action.RESUME:
            head = decision.target
            task = self._preempted.pop(head.rid)
            for r in task.requests:
                r.state = RequestState.RUNNING
            self._running = task
            self.pool.resume(task.task_id)

    def _settle_promotion(self, req: Request, ticket) -> None:
        """SUBMIT-time settle for one batch member: wait for the copies
        OUTSIDE the kv lock (workers never take it — the prefill BLOCKS on a
        copy still in flight, it never crashes into one), then commit under
        the lock and re-pin the now-longer prefix. Every failure mode
        degrades to the pre-promotion hit: a timed-out copy aborts back to
        its tier, a corrupt one is dropped (recompute — never stale KV),
        and a full pool on re-pin just leaves the prompt uncached."""
        ticket.wait(self.promote_wait_s)
        entry = self._prefix.get(req.rid)
        with self._kv_lock:
            committed = self.kv.promote_settle(ticket)
            if committed > 0 and entry is not None:
                old_hit, keys = entry
                n = int(self._tokens[req.rid].size)
                self.kv.free(req.rid)
                try:
                    table = self.kv.allocate(req.rid, n, keys=keys)
                except MemoryError:
                    self._prefix.pop(req.rid, None)
                    req.prefix_hit = 0
                    return
                hit = min(table.length, max(n - 1, 0))
                self._prefix[req.rid] = (hit, keys)
                req.prefix_hit = hit
                gained = max(hit - old_hit, 0)
                self.prefix_promotions += committed
                self.prefix_promoted_tokens += gained
                if old_hit == 0 and hit > 0:
                    self.prefix_hits += 1
                self.prefix_hit_tokens += gained

    def _make_task(self, batch: List[Request]) -> ExecTask:
        if self.kv is not None:
            for r in batch:
                ticket = self._tickets.pop(r.rid, None)
                if ticket is not None:
                    self._settle_promotion(r, ticket)
        toks = [self._tokens[r.rid] for r in batch]
        lens = [len(t) for t in toks]
        arr = np.zeros((len(batch), max(lens)), dtype=np.int64)
        for i, t in enumerate(toks):
            arr[i, :len(t)] = t
        # prefix-cache resumption: the batch shares one operator offset, so
        # it starts at the MINIMUM member hit (rows with longer hits just
        # recompute a little). Capped at min(lens) - 1: the head needs a
        # live last position.
        P = 0
        if self.kv is not None and batch:
            P = min(self._prefix.get(r.rid, (0, ()))[0] for r in batch)
            P = min(P, min(lens) - 1)
        with on_stream(self.stream):
            if P > 0:
                with self._kv_lock:
                    ks, vs = [], []
                    for r in batch:
                        k, v, _ = self.kv.gather(r.rid)
                        ks.append(k[:, :P])
                        vs.append(v[:, :P])
                pt = self.executor.start(
                    arr, lens=lens, prefix_len=P,
                    prefix_k=torch.stack(ks, dim=1),     # (L, B, P, K, hd)
                    prefix_v=torch.stack(vs, dim=1))
            else:
                pt = self.executor.start(arr, lens=lens)
        task = ExecTask(prefill_task=pt, requests=list(batch))
        pt.task_id = task.task_id
        return task

    # ------------------------------------------------------------- metrics
    @property
    def blocking_stats(self):
        return self.pool.blocking

    @property
    def scheduling_rounds(self) -> int:
        return self.monitor.rounds
