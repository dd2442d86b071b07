"""Of the card's idle time while the instance had work (the time
`device_idle_when_busy` reads), the share in % during which the pool
worker had no `segment` or `device_wait` span open: between tasks, where
the scheduling round, the event's lag, task set-up, the KV handoff or a
want of work hold the device."""
from harness import spans


def read(run):
    split = spans.idle_split(run)
    if split is None:
        return None
    idle, _, between = split
    return 100.0 * between / idle
