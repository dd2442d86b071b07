"""95th percentile, in us, of the prefill scheduler's own time a round:
the program's `round` span (an event taken off the monitor to the end of
its handling and the scheduling round) less its `preempt` and `handoff`
children, the pool's handshake and the consumer's work."""
from collections import defaultdict

from harness import spans, stats


def read(run):
    got = spans.of(run)
    if got is None:
        return None
    children = defaultdict(float)
    for s in got:
        if s.name in ("preempt", "handoff"):
            children[s.cause] += s.end - s.start
    own = [s.end - s.start - children[s.sid] for s in got
           if s.name == "round"]
    if not own:
        return None
    return stats.percentile(own, 95) * 1e6
