"""90th percentile, in ms, of the prefill instance's queue wait over every
request due in the window: the program's `queue` span, from the ARRIVAL
event's publish to the submit of the first task holding the request. A
request never submitted counts +inf; where that puts the percentile at
+inf, there is no number to report."""
import math

from harness import spans, stats


def read(run):
    got = spans.of(run)
    if got is None or not run.n:
        return None
    first = {}
    for s in got:
        if s.name == "queue" and (s.cause not in first
                                  or s.start < first[s.cause].start):
            first[s.cause] = s
    waits = [s.end - s.start for s in first.values()]
    waits += [math.inf] * max(len(run.n) - len(waits), 0)
    p90 = stats.percentile(waits, 90) * 1e3
    return p90 if math.isfinite(p90) else None
