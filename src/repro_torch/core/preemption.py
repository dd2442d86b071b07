"""Cooperative operator-level preemption protocol (FlowPrefill §5.1, Fig. 7).

The Scheduler sets a signal and waits for an ACK; the execution runtime checks
the signal at every operator boundary (a lock-free flag read — "simple
concurrency primitive operations, incurring negligible overhead"), and on a set
signal it unsets it, ACKs, and suspends after the in-flight operator completes.

`SyncCounter` implements the paper's tensor-parallel safety mechanism: workers
may only suspend when all of them have reached the same iteration counter, so
nobody stops inside a collective. Under single-controller JAX one dispatch is
SPMD across the mesh and boundaries are globally synchronized by construction;
SyncCounter is used on the multi-process (multi-pod) runtime path.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


class PreemptionSignal:
    """Signal / ACK pair with blocking-time accounting."""

    def __init__(self):
        self._flag = threading.Event()
        self._ack = threading.Event()
        self._lock = threading.Lock()
        self._signal_time: Optional[float] = None
        self.blocking_times: List[float] = []

    # --- scheduler side -----------------------------------------------------
    def request_preemption(self) -> None:
        with self._lock:
            self._ack.clear()
            self._signal_time = time.monotonic()
            self._flag.set()

    def wait_ack(self, timeout: Optional[float] = None) -> bool:
        """Blocks until the runtime acknowledges suspension. Returns False on
        timeout (runtime finished without needing to preempt)."""
        return self._ack.wait(timeout)

    def cancel(self) -> None:
        """Withdraw an un-acknowledged signal (e.g. task completed first)."""
        with self._lock:
            self._flag.clear()
            self._signal_time = None

    # --- runtime side (called at every operator boundary) --------------------
    def check(self) -> bool:
        """Lock-free fast path: no signal -> proceed immediately."""
        return self._flag.is_set()

    def consume_and_ack(self) -> float:
        """Unset the signal, record blocking time, ACK. Returns blocking dt."""
        with self._lock:
            self._flag.clear()
            dt = 0.0
            if self._signal_time is not None:
                dt = time.monotonic() - self._signal_time
                self.blocking_times.append(dt)
                self._signal_time = None
        self._ack.set()
        return dt


@dataclass
class BlockingStats:
    samples: List[float] = field(default_factory=list)

    def record(self, dt: float) -> None:
        self.samples.append(dt)

    def extend(self, dts) -> None:
        self.samples.extend(dts)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def p99(self) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[min(int(0.99 * len(s)), len(s) - 1)]

    @property
    def max(self) -> float:
        return max(self.samples) if self.samples else 0.0


class SyncCounter:
    """Synchronized iteration counter across tensor-parallel workers.

    Workers call `step()` after each operator; `safe_to_suspend(c)` is true
    only when every worker has reached counter c, guaranteeing no worker is
    inside (or about to enter) a collective the others abandoned.
    """

    def __init__(self, num_workers: int):
        self.num_workers = num_workers
        self._counters = [0] * num_workers
        self._cond = threading.Condition()

    def step(self, worker: int) -> int:
        with self._cond:
            self._counters[worker] += 1
            self._cond.notify_all()
            return self._counters[worker]

    def min_counter(self) -> int:
        with self._cond:
            return min(self._counters)

    def safe_to_suspend(self, at_counter: int) -> bool:
        with self._cond:
            return all(c >= at_counter for c in self._counters)

    def wait_all(self, at_counter: int, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not all(c >= at_counter for c in self._counters):
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True
