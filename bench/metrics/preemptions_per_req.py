"""Operator-level preemptions per request due in the window: one sample of
the execution pool's BlockingStats per preemption (the pool records one
each time a running prefill yields at an operator boundary)."""


def read(run):
    return len(run.blocking) / len(run.n)
