"""Requests due in the window whose TTFT met their SLO, per second of the
window (the paper's throughput under a latency limit, at the cell's fixed
rate). A request with no first token misses."""
from harness import stats


def read(run):
    return stats.goodput(run.ttft, run.slo, run.seconds)
