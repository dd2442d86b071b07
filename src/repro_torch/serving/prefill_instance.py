"""Prefill instance (FlowPrefill §4/§5): Request Queue + Scheduler + Execution
Pool, wired event-driven. The Scheduler thread blocks on the Event Monitor;
each ARRIVAL/COMPLETION event triggers exactly one SchedulerCore round whose
Decision is enacted as submit / preempt / resume commands on the pool.

Counterpart of src/repro/serving/prefill_instance.py without prefix sharing
or KV tiers (not ported yet: asking for them raises). On the card the
instance owns one CUDA stream: task set-up on the scheduler thread and every
segment on the pool worker run on it, so the pool's event waits cover only
this instance's work.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.events import Event, EventKind, EventMonitor
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import Action, SchedulerCore
from repro_torch.models.segments import (SegmentedPrefill, on_stream,
                                         stream_for)
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
                 host_cache_blocks: int = 0,
                 disk_cache_blocks: int = 0):
        if prefix_share or host_cache_blocks or disk_cache_blocks:
            raise NotImplementedError(
                "prefix sharing and KV tiers are not ported yet")
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
        with self._lock:
            self._tokens[req.rid] = np.asarray(tokens)
        self.monitor.publish(Event(time=self.clock(), kind=EventKind.ARRIVAL,
                                   payload=req))

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until all submitted requests completed (condition variable
        notified by the scheduler thread after every processed event)."""
        def idle() -> bool:
            # unhealthy => never drained: the strand sweep clears these
            # queues BEFORE on_fault hands the victims to the supervisor
            return self.healthy and not (
                self._waiting or self._preempted
                or self._running is not None
                or self.monitor.qsize() > 0)
        with self._idle_cv:
            return self._idle_cv.wait_for(idle, timeout)

    def shutdown(self) -> None:
        self._shutdown = True
        self.monitor.publish(Event(time=self.clock(), kind=EventKind.SHUTDOWN))
        self._thread.join(5.0)
        self.pool.shutdown()

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
                    if not (self._waiting or self._preempted
                            or self._running is not None
                            or self.monitor.qsize() > 0):
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
            self._waiting = []
            self._preempted = {}
            self._running = None
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

    def _handle_event(self, ev: Event) -> None:
        if ev.kind == EventKind.ARRIVAL:
            req: Request = ev.payload
            req.state = RequestState.WAITING
            self._waiting.append(req)
        elif ev.kind == EventKind.COMPLETION:
            task: ExecTask = ev.payload
            if self._running is not None and task.task_id == self._running.task_id:
                self._running = None
            self.completed.extend(task.requests)
            self.completed_tasks.append(task)
            if self.on_prefill_done is not None:
                self.on_prefill_done(task)

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
            suspended = self.pool.preempt_current()
            if suspended is not None:
                head = suspended.head
                for r in suspended.requests:
                    r.state = RequestState.PREEMPTED
                head.ops_total = suspended.prefill_task.total_segments
                head.ops_done = suspended.prefill_task.cursor
                self._preempted[head.rid] = suspended
                self._running = None
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
            self.pool.submit(task)
        elif decision.action == Action.RESUME:
            head = decision.target
            task = self._preempted.pop(head.rid)
            for r in task.requests:
                r.state = RequestState.RUNNING
            self._running = task
            self.pool.resume(task.task_id)

    def _make_task(self, batch: List[Request]) -> ExecTask:
        toks = [self._tokens[r.rid] for r in batch]
        lens = [len(t) for t in toks]
        arr = np.zeros((len(batch), max(lens)), dtype=np.int64)
        for i, t in enumerate(toks):
            arr[i, :len(t)] = t
        with on_stream(self.stream):
            pt = self.executor.start(arr, lens=lens)
        return ExecTask(prefill_task=pt, requests=list(batch))

    # ------------------------------------------------------------- metrics
    @property
    def blocking_stats(self):
        return self.pool.blocking

    @property
    def scheduling_rounds(self) -> int:
        return self.monitor.rounds
