"""95th percentile, in ms, of the execution pool's blocking time: from the
scheduler's preemption signal to the suspended prefill's acknowledgement,
one sample per preemption. Nothing to read in a run without a
preemption."""
from harness import stats


def read(run):
    if not run.blocking:
        return None
    return stats.percentile(run.blocking, 95) * 1e3
