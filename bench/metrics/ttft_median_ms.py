"""Median TTFT over every request due in the window, in milliseconds: what
a typical user waits, from the due time the Proxy stamps to the first token
at the handoff. A request with no first token counts as +inf; where that
puts the median at +inf, there is no number to report."""
import math

from harness import stats


def read(run):
    p50 = stats.percentile(run.ttft, 50) * 1e3
    return p50 if math.isfinite(p50) else None
