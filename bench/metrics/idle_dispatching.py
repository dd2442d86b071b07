"""Of the card's idle time while the instance had work (the time
`device_idle_when_busy` reads), the share in % during which the pool
worker was inside a `segment` span: the device waits for the host to
dispatch an operator."""
from harness import spans


def read(run):
    split = spans.idle_split(run)
    if split is None:
        return None
    idle, dispatching, _ = split
    return 100.0 * dispatching / idle
