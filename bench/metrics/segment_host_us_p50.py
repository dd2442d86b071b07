"""Median, in us, of the host time of one operator segment: the program's
`segment` span around `SegmentedPrefill.step` on the pool worker (launches
and Python, the event recorded after them)."""
from harness import spans, stats


def read(run):
    got = spans.of(run)
    if got is None:
        return None
    times = spans.durations(spans.named(got, "segment"))
    return stats.percentile(times, 50) * 1e6 if times else None
