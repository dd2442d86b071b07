"""Event queue for event-driven scheduling (FlowPrefill §5.2).

Only two event kinds exist by design — ARRIVAL and COMPLETION — so the number
of scheduling rounds is bounded by 2x the number of requests (§6.4 scheduling
cost analysis). The real runtime's Event Monitor blocks on this queue; the
simulator uses its own time-ordered heap and calls the same SchedulerCore.
"""
from __future__ import annotations

import enum
import itertools
import queue
from dataclasses import dataclass, field
from typing import Any, Optional


class EventKind(enum.Enum):
    ARRIVAL = "arrival"
    COMPLETION = "completion"
    SHUTDOWN = "shutdown"
    # chaos-harness injection (core/faults.py): payload is an Exception to
    # raise inside the scheduler loop (crash) or ("hang", seconds) to stall
    # it. Never emitted by normal serving; scheduling-round bound unchanged.
    FAULT = "fault"


_seq = itertools.count()


@dataclass(order=True)
class Event:
    time: float
    seq: int = field(default_factory=lambda: next(_seq))
    kind: EventKind = field(compare=False, default=EventKind.ARRIVAL)
    payload: Any = field(compare=False, default=None)


class EventMonitor:
    """Thread-safe FIFO the Scheduler blocks on. Each consumed event triggers
    exactly one scheduling round."""

    def __init__(self):
        self._q: "queue.Queue[Event]" = queue.Queue()
        self.rounds = 0                   # scheduling rounds triggered
        self.counts = {k: 0 for k in EventKind}

    def publish(self, event: Event) -> None:
        self.counts[event.kind] += 1
        self._q.put(event)

    def next_event(self, timeout: Optional[float] = None) -> Optional[Event]:
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        self.rounds += 1
        return ev

    def qsize(self) -> int:
        return self._q.qsize()
