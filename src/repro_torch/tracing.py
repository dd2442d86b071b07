"""Program spans of the prefill serving path, kept in memory.

A span is one interval of host time on `time.monotonic()`, the clock the
program stamps requests with: the queue wait of a request, one scheduling
round, the preemption handshake and the KV handoff inside a round, the
host time of one operator segment, and each host block on the device.
Each records its thread's native id and its pthread id: a device trace
(Kineto's) names the thread of each CUDA launch by one of the two, so a
kernel can be joined to the span that launched it.

The tracer is process-wide and off by default. A call site reads `on` once
and does nothing more while it is False:

    tr = tracing.on
    if tr:
        t0 = time.monotonic()
    ...
    if tr:
        tracing.record("segment", t0, time.monotonic(), cause=task_id)

`enable()` starts a recording, `take()` ends it and returns its spans.
Only spans that begin after `enable()` and end before `take()` are kept.
`poll()`, which the prefill instance calls as each request arrives, also
records while a `torch.profiler` session runs: the device trace is what
the spans are joined to, so a profiled process records them with no
switch of its own, as `record_function` ranges appear only under a
profiler.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

on = False                       # read by every call site
_by_profiler = False             # the recording was started by poll()
_t_enable = 0.0
# the fields of each span in a row (_ROW of them, the thread's two ids as
# one pair), made Spans by take(): no object the garbage collector tracks
# is kept while recording
_spans: list = []
_ROW = 7
_ids = itertools.count(1)
_thread = threading.local()      # .ids: (native id, pthread id)


@dataclass
class Span:
    name: str
    start: float                 # time.monotonic(), s
    end: float
    tid: int                     # threading.get_native_id() of the recorder
    ident: int                   # threading.get_ident(), its pthread id
    sid: int                     # this span's id
    cause: Optional[int] = None  # the request, event, task or span it serves
    attrs: Dict[str, object] = field(default_factory=dict)


def enable() -> None:
    """Start a new recording; spans of an earlier one are dropped."""
    global on, _by_profiler, _t_enable, _spans
    _by_profiler = False
    _spans = []
    _t_enable = time.monotonic()
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays for `take()`."""
    global on
    on = False


def poll() -> None:
    """Follow a `torch.profiler` session: start a recording when one runs
    and none is on, and stop the recording it started once the session
    has ended, its spans kept for `take()`."""
    global _by_profiler
    # torch sets this flag as a session starts and clears it as it stops
    live = getattr(_profiler, "_is_profiler_enabled", False)
    if live and not on:
        enable()
        _by_profiler = True
    elif on and _by_profiler and not live:
        disable()


def take() -> List[Span]:
    """End the recording and return its spans in the order they ended."""
    global _spans
    disable()
    raw, _spans = _spans, []
    return [Span(*raw[i:i + 3], *raw[i + 3], *raw[i + 4:i + _ROW])
            for i in range(0, len(raw), _ROW)]


def new_id() -> int:
    """An id for a span whose children are recorded before it ends."""
    return next(_ids)


def record(name: str, start: float, end: float, cause: Optional[int] = None,
           sid: Optional[int] = None, **attrs) -> None:
    """Keep one span, if the recording is on and began before `start`."""
    if on and start >= _t_enable:
        try:
            ids = _thread.ids
        except AttributeError:
            ids = _thread.ids = (threading.get_native_id(),
                                 threading.get_ident())
        # one extend, so another thread's row never interleaves
        _spans.extend((name, start, end, ids,
                       next(_ids) if sid is None else sid, cause, attrs))
