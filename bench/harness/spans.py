"""Reading the program's spans (`repro_torch.tracing`) beside the device
trace: both are on `time.monotonic()`.

The program records its spans while a `torch.profiler` session runs, so a
`--trace 1` run holds them and a `--trace 0` run records none. The first
reader of a traced run takes them from the tracer (`of`); a program
without the tracer, or a run it recorded nothing in, gives None, and the
span metrics are left out of the result line.

A span is read by its fields alone (name, start, end, tid, ident, sid,
cause, attrs), so the tests hand in spans of their own making, as a run's
`spans` attribute.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from harness import stats

# the traced run whose spans were taken, and its spans
_taken: list = [None, None]


def of(run) -> Optional[list]:
    """The program's spans of `run`: those it carries (`run.spans`), else
    those the program recorded inside its traced window, taken from the
    tracer by the first reader. None in an untraced run, with a program
    that has no tracer, or where nothing was recorded."""
    if hasattr(run, "spans"):
        return run.spans
    if run.trace is None:
        return None
    if _taken[0] is not run.trace:
        try:
            from repro_torch import tracing
        except ImportError:
            got = None
        else:
            t0, t1 = run.trace.t_start, run.trace.t_stop
            got = [s for s in tracing.take()
                   if t0 <= s.start and s.end <= t1] or None
        _taken[:] = [run.trace, got]
    return _taken[1]


def named(spans, name: str) -> list:
    """The spans called `name`."""
    return [s for s in spans if s.name == name]


def durations(spans) -> List[float]:
    return [s.end - s.start for s in spans]


def union(spans) -> List[Tuple[float, float]]:
    return stats.union((s.start, s.end) for s in spans)


def subtract(a: Sequence[Tuple[float, float]],
             b: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted disjoint intervals `a` less sorted disjoint intervals `b`."""
    out = []
    j = 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def idle_split(run) -> Optional[Tuple[float, float, float]]:
    """The device's idle seconds inside the union of the requests' [due
    time, first token] (what `device_idle_when_busy` reads), the seconds of
    it inside a `segment` span, and the seconds of it outside every
    `segment` and `device_wait` span. None without spans, or where
    `device_idle_when_busy` reads nothing: no device operation ran while
    the instance had work, or the device never idled then."""
    got = of(run)
    if run.trace is None or got is None:
        return None
    ran = run.trace.busy()
    idle = subtract(run.busy, ran)
    total = stats.length(idle)
    if total <= 0 or stats.overlap(ran, run.busy) <= 0:
        return None
    segments = named(got, "segment")
    host = union(segments + named(got, "device_wait"))
    return (total, stats.overlap(idle, union(segments)),
            total - stats.overlap(idle, host))
