"""The readers of the program's spans (`harness/spans.py` and the span
metrics) on hand-made spans and a hand-made `Trace`: the idle split, the
round's own time, the percentiles, and the spans a traced run's readers
take from the tracer; then the harness on the CPU, traced (the host-side
span metrics read, the device-side ones stay silent) and not (the tracer
is never enabled)."""
import builtins
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import BENCH
from harness import files, main, spans
from harness.trace import Trace
from repro_torch import tracing
from repro_torch.tracing import Span


def _read(name, run):
    return files.reader(BENCH / "metrics", name)(run)


def _span(name, start, end, cause=None, sid=0, tid=1, ident=1, **attrs):
    return Span(name, start, end, tid, ident, sid, cause, attrs)


def _trace(ops, calls, t_start=0.0, t_stop=10.0):
    """A Trace of device operations (start, end, name) and host-side
    events (start, name)."""
    tr = Trace.__new__(Trace)
    tr.ops_start = np.array([o[0] for o in ops], dtype=np.float64)
    tr.ops_end = np.array([o[1] for o in ops], dtype=np.float64)
    tr.ops_name = [o[2] for o in ops]
    tr.host_start = np.array([c[0] for c in calls], dtype=np.float64)
    tr.host_name = [c[1] for c in calls]
    tr.t_start, tr.t_stop = t_start, t_stop
    return tr


def test_subtract_by_hand():
    a = [(0, 10), (12, 14)]
    b = [(-1, 1), (2, 3), (9, 13), (20, 21)]
    assert spans.subtract(a, b) == [(1, 2), (3, 9), (13, 14)]
    assert spans.subtract(a, []) == a
    assert spans.subtract([(0, 1)], [(0, 1)]) == []


def _idle_run():
    """The instance has work over [0, 10); the device runs [1, 2), [4, 5)
    and [8, 9): idle [0, 1), [2, 4), [5, 8), [9, 10), 7 s. The worker
    dispatches over [0.5, 1.5), [2, 3) and [9.5, 10), and waits on the
    device over [3, 4.5)."""
    tr = _trace([(1, 2, "k"), (4, 5, "k"), (8, 9, "k")], [])
    got = [_span("segment", 0.5, 1.5), _span("segment", 2, 3),
           _span("device_wait", 3, 4.5), _span("segment", 9.5, 10),
           _span("round", 5, 8)]
    return SimpleNamespace(busy=[(0.0, 10.0)], trace=tr, spans=got)


def test_the_idle_split_by_hand():
    run = _idle_run()
    assert spans.idle_split(run) == pytest.approx((7.0, 2.0, 4.0))
    # inside segments 0.5 + 1 + 0.5; outside both kinds 7 - 0.5 - 2 - 0.5;
    # the rest, [3, 4) inside the wait, is neither
    assert _read("idle_dispatching", run) == pytest.approx(200 / 7)
    assert _read("idle_between_tasks", run) == pytest.approx(400 / 7)
    device_idle = _read("device_idle_when_busy", run)
    assert device_idle == pytest.approx(70.0)


def test_the_idle_split_is_silent_without_the_device_or_the_spans():
    run = _idle_run()
    for off in (dict(trace=None), dict(spans=None),
                dict(trace=_trace([], []))):
        r = SimpleNamespace(**{**vars(run), **off})
        assert _read("idle_dispatching", r) is None
        assert _read("idle_between_tasks", r) is None
    busy = SimpleNamespace(**{**vars(run), "busy": [(1.0, 2.0)]})
    assert spans.idle_split(busy) is None            # never idle


def test_queue_wait_p90_counts_requests_never_submitted():
    waits = np.random.default_rng(0).uniform(0.001, 0.2, 20)
    got = [_span("queue", 5.0, 5.0 + w, cause=i) for i, w in
           enumerate(waits)]
    # a request handed to the instance twice keeps its first wait
    got.append(_span("queue", 9.0, 19.0, cause=3))
    run = SimpleNamespace(n=[16] * 20, spans=got)
    assert _read("queue_wait_ms_p90", run) == \
        pytest.approx(np.percentile(waits, 90) * 1e3, rel=1e-9)
    # four of 24 due never submitted: rank 20.7 lands on +inf
    run = SimpleNamespace(n=[16] * 24, spans=got)
    assert _read("queue_wait_ms_p90", run) is None
    # one of 21: rank 18 is the 19th wait
    run = SimpleNamespace(n=[16] * 21, spans=got)
    assert math.isfinite(_read("queue_wait_ms_p90", run))
    assert _read("queue_wait_ms_p90",
                 SimpleNamespace(n=[16], spans=None)) is None


def test_a_round_less_its_handshake_and_handoff():
    rng = np.random.default_rng(1)
    got, own = [], []
    for sid in range(1, 41):
        t, d = 10.0 * sid, rng.uniform(1e-4, 2e-3)
        pre, hand = rng.uniform(0, 5e-3, 2) * (sid % 3 == 0)
        got.append(_span("round", t, t + d + pre + hand, cause=sid + 100,
                         sid=sid))
        if pre:
            got.append(_span("preempt", t, t + pre, cause=sid))
        if hand:
            got.append(_span("handoff", t + pre, t + pre + hand, cause=sid))
        own.append(d)
    got.append(_span("segment", 0.0, 5.0))          # not a round's child
    run = SimpleNamespace(spans=got)
    assert _read("sched_round_us_p95", run) == \
        pytest.approx(np.percentile(own, 95) * 1e6, rel=1e-6)
    assert _read("sched_round_us_p95", SimpleNamespace(spans=[])) is None


def test_segment_host_median():
    d = [3e-4, 1e-4, 2e-4, 9e-4]
    got = [_span("segment", i, i + x, op="attn") for i, x in enumerate(d)]
    got.append(_span("device_wait", 0, 100))
    assert _read("segment_host_us_p50", SimpleNamespace(spans=got)) == \
        pytest.approx(250.0)


def test_a_traced_runs_spans_are_taken_once_inside_its_window(
        monkeypatch):
    """A run without `spans` of its own reads what the tracer recorded
    inside its traced window: the first reader takes the recording, the
    next ones read the same spans. Untraced, with nothing recorded, or
    with a program that has no tracer, there are none."""
    tracing.enable()
    now = time.monotonic()
    for name, a, b in (("queue", now - 9.0, now), ("queue", now, now + 1),
                       ("round", now + 1, now + 2),
                       ("round", now + 2, now + 9)):
        tracing.record(name, a, b)
    run = SimpleNamespace(trace=_trace([], [], now - 1.0, now + 5.0))
    got = spans.of(run)
    assert [(s.name, s.end - s.start) for s in got] == \
        [("queue", pytest.approx(1.0)), ("round", pytest.approx(1.0))]
    assert spans.of(run) is got and not tracing.on
    assert spans.of(SimpleNamespace(trace=None)) is None
    assert spans.of(SimpleNamespace(trace=_trace([], []))) is None
    assert spans.of(SimpleNamespace(trace=_trace([], []),
                                    spans=got)) is got
    real = builtins.__import__

    def no_tracer(name, *a, **k):
        if name == "repro_torch" and a[2] and "tracing" in a[2]:
            raise ImportError(name)
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_tracer)
    tracing.enable()
    tracing.record("queue", now + 1, now + 2)
    assert spans.of(SimpleNamespace(trace=_trace([], [], now, now + 5))) \
        is None
    monkeypatch.undo()
    tracing.take()


def _capture_runs(monkeypatch):
    """The `Run` each reader of a harness run is handed."""
    runs = []
    reader = files.reader

    def capturing(metrics_dir, name):
        read = reader(metrics_dir, name)

        def keep(run):
            runs.append(run)
            return read(run)
        return keep
    monkeypatch.setattr(files, "reader", capturing)
    return runs


def test_a_traced_tiny_run_reads_the_host_span_metrics(tiny_root,
                                                       monkeypatch):
    runs = _capture_runs(monkeypatch)
    out = main.run(tiny_root, "qwen2.5-tiny.sharegpt-tiny", 2 ** 31 + 5, 2.0,
                   True, "cpu", time.monotonic())
    assert out["correct"] and not tracing.on
    m = out["metrics"]
    for name in ("queue_wait_ms_p90", "sched_round_us_p95",
                 "segment_host_us_p50"):
        assert m[name]["value"] > 0 and math.isfinite(m[name]["value"])
    assert m["queue_wait_ms_p90"]["unit"] == "ms"
    assert m["sched_round_us_p95"]["unit"] == "us"
    # no device: the device-side readers stay silent
    for name in ("idle_dispatching", "idle_between_tasks"):
        assert name not in m
    got = spans.of(runs[0])
    assert {s.name for s in got} >= {"queue", "round", "segment",
                                     "device_wait", "handoff"}
    assert len({s.cause for s in got if s.name == "queue"}) == \
        out["attempted"]
    assert all(spans.of(r) is got for r in runs)


def test_an_untraced_run_never_enables_the_tracer(tiny_root, monkeypatch):
    calls = []
    monkeypatch.setattr(tracing, "enable", lambda: calls.append("enable"))
    monkeypatch.setattr(tracing, "record",
                        lambda *a, **k: calls.append("record"))
    runs = _capture_runs(monkeypatch)
    out = main.run(tiny_root, "qwen2.5-tiny.sharegpt-tiny", 2 ** 31 + 5, 2.0,
                   False, "cpu", time.monotonic())
    assert out["correct"] and calls == [] and not tracing.on
    assert runs and all(spans.of(r) is None for r in runs)
