"""Reading the traced run's profile: `torch.profiler` (CUPTI) over the whole
window and its drain, read from the raw Kineto events.

Times are put on the host's monotonic clock through a marker: a
`record_function` range opened at a known `time.monotonic()`.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from harness import stats

MARK = "bench.window"
# CUDA runtime and driver calls, recorded on every thread
RUNTIME = re.compile(r"^(cuda|cu[A-Z])")


class Profile:
    """A running profiler; `stop()` returns its `Trace`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        # operators are recorded on this thread only (the serving threads
        # started before the profiler); the CUDA runtime calls of every
        # thread are recorded. profile_all_threads would record the serving
        # threads' operators, at a host cost that fails requests (PERF.md)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        with record_function(MARK):
            self.t_mark = time.monotonic()

    def stop(self) -> "Trace":
        self._prof.__exit__(None, None, None)
        t_stop = time.monotonic()
        return Trace(self._prof.profiler.kineto_results.events(), self.t_mark,
                     t_stop)


class Trace:
    """Device operations (start, end on the monotonic clock, name), and the
    host-side events that can name an idle gap: the CUDA runtime calls of
    every thread and the operators of this one."""

    def __init__(self, events, t_mark: float, t_stop: float):
        from torch.autograd import DeviceType
        mark_ns = None
        host = []                     # (start ns, name)
        dev = []                      # (start ns, end ns, name)
        for e in events:
            name = e.name()
            on_device = e.device_type() == DeviceType.CUDA
            if name == MARK:
                if not on_device and mark_ns is None:
                    mark_ns = e.start_ns()
            elif e.is_user_annotation():
                continue
            elif on_device:
                dev.append((e.start_ns(), e.end_ns(), name))
            elif RUNTIME.match(name) or ("::" in name and not e.is_async()):
                host.append((e.start_ns(), name))
        if mark_ns is None:
            raise RuntimeError(f"profile holds no {MARK} marker")

        def mono(ns):
            return (np.asarray(ns, dtype=np.float64) - mark_ns) * 1e-9 + t_mark
        dev.sort()
        host.sort()
        self.ops_start = mono([d[0] for d in dev])
        self.ops_end = mono([d[1] for d in dev])
        self.ops_name = [d[2] for d in dev]
        self.host_start = mono([h[0] for h in host])
        self.host_name = [h[1] for h in host]
        self.t_start, self.t_stop = t_mark, t_stop

    # ------------------------------------------------------------ readings
    def device_time(self, pattern=None) -> float:
        """Summed seconds of the device operations whose name `pattern` (a
        compiled regular expression) finds, or of all of them."""
        total = 0.0
        for s, e, name in zip(self.ops_start, self.ops_end, self.ops_name):
            if pattern is None or pattern.search(name):
                total += e - s
        return total

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals."""
        return stats.union(zip(self.ops_start.tolist(), self.ops_end.tolist()))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, name in zip(self.ops_start, self.ops_end, self.ops_name):
            by[name] += e - s
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, within: Sequence[Tuple[float, float]], n: int = 10
                  ) -> List[list]:
        """Idle device time inside `within`, summed by the host-side event
        (runtime call or operator) that began last before each gap began,
        the largest n."""
        busy = self.busy()
        gaps = []
        prev = None
        for s, e in busy:
            if prev is not None and s > prev:
                gaps.append((prev, s))
            prev = e
        by: Dict[str, float] = defaultdict(float)
        for i, inside in stats.intersect(gaps, within):
            h = int(np.searchsorted(self.host_start, gaps[i][0],
                                    side="right")) - 1
            by[self.host_name[h] if h >= 0 else "(none)"] += inside
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
