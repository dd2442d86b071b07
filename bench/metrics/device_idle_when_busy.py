"""The card's idle share while the instance had work, in %: 1 - (time some
device operation ran, inside the union of every request's [arrival, first
token]) / (that union's length). Below the knee the card also idles for
want of requests; this leaves that out."""
from harness import stats


def read(run):
    if run.trace is None:
        return None
    busy = stats.length(run.busy)
    ran = stats.overlap(run.trace.busy(), run.busy)
    if busy <= 0 or ran <= 0:
        return None
    return 100.0 * (1.0 - ran / busy)
