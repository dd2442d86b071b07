"""The port's program spans (`repro_torch.tracing`) on the CPU: a tiny
model served through `PrefillInstance`, with two preemptions forced by
short strict requests arriving while a long prefill runs. With the tracer
off nothing is recorded; with it on each request has one `queue` span,
each segment a task stepped one `segment` span across its preemptions and
resumes, every `segment` and `device_wait` span lies inside its task's
tenure in the pool, the suspending `preempt` spans count the pool's
blocking samples, and every span lies inside the recording. Threads
recording at once keep every span whole. A `torch.profiler` session turns
the tracer on at the next arrival, and it stops after the session."""
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.base import get_tiny_config
from repro_torch.core import Request, SchedulerCore, TTFTPredictor
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.params import init_params
from repro_torch.serving.prefill_instance import PrefillInstance

CFG = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=2,
                          d_model=64, d_ff=128)
MAX_SEQ = 256
LONG, SHORT = 200, 16
PACE_S = 0.003            # host time added to each segment, outside its span


class Paced(SegmentedPrefill):
    """Each step sleeps first, so a long prefill lasts long enough for the
    short requests to preempt it at known points."""

    def step(self, task):
        time.sleep(PACE_S)
        return super().step(task)


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, n)


def _instance(done):
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    ex = Paced(params, CFG, max_seq=MAX_SEQ, granularity="op",
               chunk_tokens=64)
    pred = TTFTPredictor(coeffs=np.array([1e-4, 0.0]), floor=0.0)
    core = SchedulerCore(predictor=pred, policy="s-edf",
                         enable_batching=False)
    return PrefillInstance(params, CFG, core, max_seq=MAX_SEQ, executor=ex,
                           on_prefill_done=done.append)


def _until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.001)


def _serve(inst):
    """A long request, and twice, once the long prefill runs and has
    stepped a few more segments, a short strict one that preempts it."""
    long_r = Request(num_tokens=LONG, slo=60.0, task_type="file",
                     arrival=time.monotonic())
    inst.submit_request(long_r, _tokens(LONG, 1))
    reqs = [long_r]
    for i in range(2):
        def long_runs():
            cur = inst.pool.current()
            return cur is not None and cur.head is long_r and \
                cur.prefill_task.cursor >= 3 + 12 * i
        _until(long_runs)
        r = Request(num_tokens=SHORT, slo=5.0, task_type="text",
                    arrival=time.monotonic())
        inst.submit_request(r, _tokens(SHORT, 2 + i))
        reqs.append(r)
        _until(lambda: r.first_token_time is not None)
    assert inst.drain(60.0)
    return reqs


@pytest.fixture(scope="module")
def served():
    """The traced serve: its spans, requests, completed tasks, each task's
    submit times, the pool's blocking samples, and the recording's
    bounds."""
    done = []
    inst = _instance(done)
    submits = {}
    submit = inst.pool.submit

    def stamped(task):
        submits.setdefault(task.task_id, []).append(time.monotonic())
        submit(task)
    inst.pool.submit = stamped
    try:
        t_enable = time.monotonic()
        tracing.enable()
        reqs = _serve(inst)
        spans = tracing.take()
        t_take = time.monotonic()
    finally:
        tracing.take()
        inst.shutdown()
    return dict(spans=spans, reqs=reqs, tasks=done, submits=submits,
                blocking=list(inst.blocking_stats.samples), t_enable=t_enable,
                t_take=t_take)


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_the_tracer_off_records_nothing():
    tracing.take()
    assert not tracing.on
    done = []
    inst = _instance(done)
    try:
        reqs = _serve(inst)
    finally:
        inst.shutdown()
    assert len(done) == len(reqs) == 3
    assert inst.blocking_stats.samples            # preempted all the same
    assert tracing.take() == [] and inst._queued_at == {}
    tracing.record("segment", time.monotonic(), time.monotonic())
    assert tracing.take() == []


def test_a_recording_keeps_only_its_own_spans():
    t0 = time.monotonic()
    tracing.enable()
    tracing.record("queue", t0 - 1.0, time.monotonic(), cause=1)  # before
    tracing.record("queue", time.monotonic(), time.monotonic(), cause=2)
    tracing.enable()                          # a new recording drops it
    tracing.record("queue", time.monotonic(), time.monotonic(), cause=3,
                   task=7)
    got = tracing.take()
    assert [(s.name, s.cause, s.attrs) for s in got] == \
        [("queue", 3, {"task": 7})]
    assert got[0].tid > 0 and got[0].ident > 0 and not tracing.on
    assert tracing.take() == []


def test_a_profiler_session_records_from_the_next_arrival():
    from torch.profiler import ProfilerActivity, profile
    tracing.take()
    tracing.poll()
    assert not tracing.on                         # no session, no recording
    done = []
    inst = _instance(done)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert not tracing.on
            r = Request(num_tokens=SHORT, slo=5.0, task_type="text",
                        arrival=time.monotonic())
            inst.submit_request(r, _tokens(SHORT, 9))
            assert tracing.on
            assert inst.drain(60.0)
        tracing.poll()
        assert not tracing.on                     # the session has ended
        got = tracing.take()
        # a recording enabled by hand outlives a session
        tracing.enable()
        with profile(activities=[ProfilerActivity.CPU]):
            tracing.poll()
        tracing.poll()
        assert tracing.on
    finally:
        tracing.take()
        inst.shutdown()
    assert [s.cause for s in _named(got, "queue")] == [r.rid]
    assert len(_named(got, "segment")) == \
        done[0].prefill_task.total_segments


def test_threads_recording_at_once_keep_every_row_whole():
    """More recording threads than cores, switching as often as the
    interpreter allows: no span is lost and no row mixes two threads'."""
    workers, each = 2 * (os.cpu_count() or 1) + 2, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.enable()

        def work(k):
            for i in range(each):
                t = time.monotonic()
                tracing.record(f"w{k}", t, t, cause=k, i=i)
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        got = tracing.take()
    finally:
        sys.setswitchinterval(switch)
        tracing.take()
    assert len(got) == workers * each
    by = {}
    for s in got:
        assert s.name == f"w{s.cause}"
        by.setdefault(s.cause, []).append(s)
    for k, mine in by.items():
        assert [s.attrs["i"] for s in mine] == list(range(each))
        assert len({(s.tid, s.ident) for s in mine}) == 1
    assert len({s.tid for s in got}) == workers
    assert len({s.sid for s in got}) == len(got)


def test_one_queue_span_per_request_ends_by_its_first_token(served):
    queue = _named(served["spans"], "queue")
    by_rid = {s.cause: s for s in queue}
    assert len(queue) == len(by_rid) == len(served["reqs"])
    for r in served["reqs"]:
        s = by_rid[r.rid]
        assert s.start <= s.end <= r.first_token_time


def test_segment_spans_equal_the_segments_stepped(served):
    """Across two preemptions and resumes of the long prefill, each task's
    segments are each recorded once, in order."""
    segs = _named(served["spans"], "segment")
    tasks = served["tasks"]
    assert len(segs) == sum(t.prefill_task.total_segments for t in tasks)
    ops = ("qkv_proj", "attn", "o_proj", "gate_up_proj", "down_proj")
    for t in tasks:
        pt = t.prefill_task
        mine = [s for s in segs if s.cause == t.task_id]
        assert len(mine) == pt.total_segments == pt.cursor
        want = [(op, layer, chunk) for chunk in range(pt.n_chunks)
                for layer in range(CFG.num_layers) for op in ops]
        want.append(("head", None, None))
        assert [(s.attrs["op"], s.attrs["layer"], s.attrs["chunk"])
                for s in mine] == want
        assert all(a.end <= b.start for a, b in zip(mine, mine[1:]))
    assert max(t.prefill_task.n_chunks for t in tasks) == 4


def test_segment_and_device_wait_spans_lie_in_their_tasks_tenure(served):
    """A tenure runs from the pool's submit (or resume) to the suspension
    the scheduler's `preempt` span waited for, or to the completion."""
    spans = served["spans"]
    stops = {}
    for s in _named(spans, "preempt"):
        if s.attrs["suspended"]:
            stops.setdefault(s.attrs["task"], []).append(s.end)
    for t in served["tasks"]:
        starts = served["submits"][t.task_id]
        ends = stops.get(t.task_id, []) + [t.complete_time]
        assert len(starts) == len(ends)
        tenures = list(zip(starts, ends))
        mine = [s for s in spans if s.cause == t.task_id
                and s.name in ("segment", "device_wait")]
        assert any(s.name == "device_wait" for s in mine)
        for s in mine:
            assert any(a <= s.start <= s.end <= b for a, b in tenures), s
    assert len(served["submits"][served["tasks"][-1].task_id]) == 3


def test_suspending_preempt_spans_count_the_blocking_samples(served):
    spans = served["spans"]
    preempts = _named(spans, "preempt")
    assert len(served["blocking"]) == 2
    assert sum(s.attrs["suspended"] for s in preempts) == \
        len(served["blocking"])
    rounds = {s.sid for s in _named(spans, "round")}
    assert all(s.cause in rounds for s in preempts)


def test_rounds_and_handoffs(served):
    """One round per ARRIVAL and COMPLETION event; one handoff per task,
    inside the round of its COMPLETION."""
    spans = served["spans"]
    rounds = {s.sid: s for s in _named(spans, "round")}
    kinds = sorted(s.attrs["kind"] for s in rounds.values())
    assert kinds == ["arrival"] * 3 + ["completion"] * 3
    for s in rounds.values():
        assert s.attrs["published"] <= s.start <= s.end
    handoffs = _named(spans, "handoff")
    assert sorted(s.attrs["task"] for s in handoffs) == \
        sorted(t.task_id for t in served["tasks"])
    for h in handoffs:
        r = rounds[h.cause]
        assert r.attrs["kind"] == "completion"
        assert r.start <= h.start <= h.end <= r.end


def test_every_span_lies_inside_the_recording(served):
    spans = served["spans"]
    assert {s.name for s in spans} == {"queue", "round", "preempt",
                                       "handoff", "segment", "device_wait"}
    assert all(served["t_enable"] <= s.start <= s.end <= served["t_take"]
               for s in spans)
    assert len({s.sid for s in spans}) == len(spans)
