"""Execution Pool (FlowPrefill §4, §5.1).

Manages execution tasks: runs at most one at a time, safely preserves the
state of preempted tasks until resumption, and acts ONLY on explicit commands
(submit / preempt / resume) from the Scheduler — it makes no scheduling
decisions itself.

The worker thread advances the current task segment-by-segment, performing the
cooperative preemption check (a flag read) at every operator boundary — the
exact protocol of paper Fig. 7 including the signal/ACK handshake and the
completion race (a task finishing while a signal is pending ACKs immediately
so the scheduler never stalls; the ACK is distinguishable from suspension).

Counterpart of src/repro/serving/pool.py. The reference's three
`jax.block_until_ready` calls (drain on suspension, the dispatch-ahead
window, completion) each wait on the CUDA event the executor records after
a segment (`PrefillTask.sync_token`), on the instance's own stream, so they
wait only for prefill's own work. On the CPU the token is None and the
waits are no-ops.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.preemption import BlockingStats, PreemptionSignal
from repro_torch.core.request import Request
from repro_torch.models.segments import wait

_task_ids = itertools.count()


@dataclass
class ExecTask:
    """One execution task = one (possibly batched) prefill."""
    prefill_task: object                      # models.segments.PrefillTask
    requests: List[Request]                   # batch members (H first)
    task_id: int = field(default_factory=lambda: next(_task_ids))
    submit_time: float = 0.0
    complete_time: Optional[float] = None

    @property
    def head(self) -> Request:
        return self.requests[0]


class ExecutionPool:
    def __init__(self, step_fn: Callable[[ExecTask], bool],
                 on_complete: Callable[[ExecTask], None],
                 clock: Callable[[], float] = time.monotonic,
                 dispatch_depth: int = 2,
                 on_error: Optional[Callable[[Optional[ExecTask],
                                              Exception], None]] = None):
        """dispatch_depth bounds how many operator dispatches may be enqueued
        ahead of device completion. Without this bound CUDA's asynchronous
        launches would let the host race to the end of the prefill, making the
        cooperative check vacuous; with it, preemption latency is
        <= (dispatch_depth + 1) x one operator — the paper's bound."""
        self._step = step_fn
        self._on_complete = on_complete
        self._on_error = on_error
        self._clock = clock
        self._dispatch_depth = max(dispatch_depth, 0)
        self.signal = PreemptionSignal()
        self.blocking = BlockingStats()
        self.healthy = True             # False after a worker exception
        self.last_step = clock()        # watchdog progress signal: stamped
                                        # at every operator boundary
        self._cv = threading.Condition()
        self._current: Optional[ExecTask] = None
        self._preempted: Dict[int, ExecTask] = {}
        self._shutdown = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="execution-pool")
        self._thread.start()

    # ------------------------------------------------------------------ API
    def submit(self, task: ExecTask) -> None:
        with self._cv:
            assert self._current is None, "pool executes at most one task"
            task.submit_time = self._clock()
            self._current = task
            self._cv.notify_all()

    def resume(self, task_id: int) -> ExecTask:
        with self._cv:
            task = self._preempted.pop(task_id)
        self.submit(task)
        return task

    def preempt_current(self, timeout: float = 10.0) -> Optional[ExecTask]:
        """Scheduler-side preemption (Fig. 7). Returns the suspended task, or
        None if nothing was running / the task completed concurrently."""
        with self._cv:
            task = self._current
        if task is None:
            return None
        self.signal.request_preemption()
        acked = self.signal.wait_ack(timeout)
        with self._cv:
            if acked and task.task_id in self._preempted:
                return task
        # completed before the boundary check could suspend it
        self.signal.cancel()
        return None

    def preempted_tasks(self) -> List[ExecTask]:
        with self._cv:
            return list(self._preempted.values())

    def clear_preempted(self) -> List[ExecTask]:
        """Drop all suspended tasks (supervised recovery: their requests are
        being re-dispatched elsewhere, so keeping the device state would only
        leak memory and invite zombie resumes)."""
        with self._cv:
            dropped = list(self._preempted.values())
            self._preempted.clear()
        return dropped

    def restart(self) -> None:
        """Mark the pool serviceable again after a worker exception (the
        worker thread survives errors, so this is just the health flip)."""
        with self._cv:
            self.healthy = True
            self.last_step = self._clock()

    def current(self) -> Optional[ExecTask]:
        with self._cv:
            return self._current

    def idle(self) -> bool:
        with self._cv:
            return self._current is None

    def shutdown(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(timeout)

    # --------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            with self._cv:
                while self._current is None and not self._shutdown:
                    self._cv.wait()
                if self._shutdown:
                    return
                task = self._current

            try:
                self._run_task(task)
            except Exception as exc:        # supervised worker: a failing
                # operator (OOM, bad kernel, injected chaos) must not strand
                # the task forever — mark unhealthy, errback, keep the thread
                # alive so restart() can revive the instance
                with self._cv:
                    self.healthy = False
                    self._current = None
                if self.signal.check():
                    # unblock a racing preemption request (the scheduler
                    # would otherwise stall its full ack timeout)
                    self.signal.consume_and_ack()
                if self._on_error is not None:
                    self._on_error(task, exc)

    def _run_task(self, task: ExecTask) -> None:
        window: List = []                      # dispatched, maybe unfinished
        while True:
            # cooperative preemption check at the operator boundary
            if self.signal.check():
                # drain the in-flight operators (bounded by dispatch_depth)
                wait(task.prefill_task.sync_token)
                dt = self.signal.consume_and_ack()
                self.blocking.record(dt)
                with self._cv:
                    self._preempted[task.task_id] = task
                    self._current = None
                return

            done = self._step(task)
            self.last_step = self._clock()
            # flow control: keep at most dispatch_depth segments in flight
            tok = task.prefill_task.sync_token
            if tok is not None:
                window.append(tok)
                if len(window) > self._dispatch_depth:
                    wait(window.pop(0))

            if done:
                wait(task.prefill_task.sync_token)
                task.complete_time = self._clock()
                with self._cv:
                    self._current = None
                # unblock a racing preemption request (scheduler will see
                # the task is NOT in the preempted set -> completed)
                if self.signal.check():
                    self.signal.consume_and_ack()
                self._on_complete(task)
                return
