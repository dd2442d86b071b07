"""On the card: the program's spans and the device trace share one clock
and join. A lone, uncontended prefill of qwen2.5-3b (drawn weights, the
cell's deployment) served through `PrefillInstance` under the profiler:
at least 99 % of the device time is launched inside `segment` spans, and
every launch of the prefill-attention kernel inside an `attn` one. The
join reads Kineto's correlation and thread ids from the profile's raw
events (the harness's `Trace` keeps neither); it is checked on hand-made
events on the CPU too. The card test skips without a card."""
import bisect
import json
import time
from typing import Dict, Sequence

import numpy as np
import pytest

from conftest import BENCH
from harness.trace import RUNTIME
from repro_torch.tracing import Span

# Kineto's thread id of a runtime call fits in 32 bits
_THREAD_MASK = 0xFFFFFFFF


def launchers(ops_corr: Sequence[int], calls, segments) -> list:
    """For each device operation, given by the correlation id Kineto gave
    it (`ops_corr`), the `segment` span whose step launched it, or None.
    `calls` are the profile's host-side events as (start on the monotonic
    clock, name, correlation id, Kineto's thread id): a kernel carries the
    id of the runtime call that launched it, and that call the thread it
    ran on (Kineto names it by its native id or by its pthread id cut to 32
    bits; a span records both). On that thread a step's calls end with the
    event it records after its work (`cudaEventRecord*`): each call belongs
    to the step of the next such record, and the record to the span of
    that thread that ends nearest it. The order joins, not the clock: the
    two clocks drift apart by tens of microseconds, a launch's length."""
    by_thread: Dict[int, list] = {}
    for s in segments:
        for key in {s.tid & _THREAD_MASK, s.ident & _THREAD_MASK}:
            by_thread.setdefault(key, []).append(s)
    ends = {}
    for key, mine in by_thread.items():
        mine.sort(key=lambda s: s.end)
        ends[key] = [s.end for s in mine]
    on_thread: Dict[int, list] = {}
    for t, name, corr, tid in calls:
        key = tid & _THREAD_MASK
        if key in by_thread and RUNTIME.match(name):
            on_thread.setdefault(key, []).append((float(t), name, corr))
    span_of = {}
    for key, mine in on_thread.items():
        mine.sort()
        pending = []
        for t, name, corr in mine:
            pending.append(corr)
            if name.startswith("cudaEventRecord"):
                span_of.update(dict.fromkeys(
                    pending, _nearest(by_thread[key], ends[key], t)))
                pending = []
    return [span_of.get(corr) for corr in ops_corr]


def _nearest(spans, ends, t):
    i = bisect.bisect_left(ends, t)
    near = [j for j in (i - 1, i) if 0 <= j < len(spans)]
    return spans[min(near, key=lambda j: abs(ends[j] - t))]


def _span(name, start, end, tid, ident, **attrs):
    return Span(name, start, end, tid, ident, 0, None, attrs)


def test_kernels_join_the_step_that_launched_them():
    """Each runtime call on a worker's thread belongs to the step whose
    event record follows it, and that record to the span ending nearest
    it: a launch that the trace's clock puts past its span's end still
    joins. Kineto names a serving thread by its pthread id cut to 32 bits
    and the profiling thread by its native id; operators' correlation ids
    are another count and never join."""
    ident = (1 << 40) + 77
    experts = _span("segment", 0.0, 2.0, tid=501, ident=ident, op="experts")
    attn = _span("segment", 2.0, 3.0, tid=501, ident=ident, op="attn")
    head = _span("segment", 5.0, 6.0, tid=900, ident=(5 << 33) + 1,
                 op="head")
    ops_corr = [10, 11, 12, 13, 14, 15, 99, 16]
    calls = [(0.5, "cudaLaunchKernel", 10, 77),
             (1.5, "cuLaunchKernelEx", 11, 77),
             (0.6, "cudaLaunchKernel", 12, 600),           # another thread
             (0.55, "aten::mm", 12, 77),                   # an operator
             (2.01, "cudaLaunchKernel", 15, 77),           # past the end
             (2.03, "cudaEventRecordWithFlags", 20, 77),   # closes experts
             (2.05, "cudaLaunchKernel", 13, 77),
             (2.9, "cudaEventSynchronize", 21, 77),
             (3.02, "cudaEventRecordWithFlags", 22, 77),   # closes attn
             (3.5, "cudaLaunchKernel", 14, 77),            # no record after
             (5.5, "cudaLaunchKernel", 16, 900),           # native id
             (5.9, "cudaEventRecord", 23, 900)]
    segs = [experts, attn, head]
    assert launchers(ops_corr, calls, segs) == \
        [experts, experts, None, attn, None, experts, None, head]
    assert launchers(ops_corr, calls, [attn, head]) == \
        [attn, attn, None, attn, None, attn, None, head]
    assert launchers(ops_corr, [], segs) == [None] * len(ops_corr)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _launches(events, t_mark: float):
    """From a profile's raw Kineto events: each device operation as (start,
    end on the monotonic clock, name, correlation id), and each CUDA
    runtime call as (start, name, correlation id, Kineto's thread id),
    on the clock of the `bench.window` marker opened at `t_mark`."""
    from torch.autograd import DeviceType

    from harness.trace import MARK, RUNTIME
    mark = next(e.start_ns() for e in events if e.name() == MARK)

    def mono(ns):
        return (ns - mark) * 1e-9 + t_mark
    ops, calls = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ops.append((mono(e.start_ns()), mono(e.end_ns()), e.name(),
                        e.correlation_id()))
        elif RUNTIME.match(e.name()):
            calls.append((mono(e.start_ns()), e.name(), e.correlation_id(),
                          e.device_resource_id()))
    return ops, calls


@pytest.mark.cuda
def test_a_lone_prefill_launches_inside_its_segment_spans(card):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness import deploy, spans
    from harness.trace import MARK
    from repro_torch import tracing
    from repro_torch.core import Request, SchedulerCore, TTFTPredictor
    from repro_torch.models.segments import SegmentedPrefill
    from repro_torch.serving.prefill_instance import PrefillInstance

    spec = json.loads((BENCH / "configs" / "qwen2.5-3b.json").read_text())
    dep = spec["deployment"]
    cfg = deploy.model_config(spec)
    dev = torch.device("cuda")
    params = deploy.draw_weights(cfg, 2147483659, dev, torch.bfloat16)
    n = 2048
    ex = SegmentedPrefill(params, cfg, max_seq=n,
                          granularity=dep["granularity"],
                          chunk_tokens=dep["chunk_tokens"],
                          cache_dtype=torch.bfloat16)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, n)
    ex.run_all(ex.start(prompt[None]))                # builds and warms
    torch.cuda.synchronize()
    core = SchedulerCore(predictor=TTFTPredictor.fit([256, n], [0.05, 0.4]),
                         policy=dep["policy"])
    inst = PrefillInstance(params, cfg, core, max_seq=n, executor=ex,
                           dispatch_depth=dep["dispatch_depth"])
    try:
        # the profiler alone turns the tracer on, at the request's arrival
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(MARK):
                t_mark = time.monotonic()
            inst.submit_request(Request(num_tokens=n, slo=60.0), prompt)
            assert inst.drain(120.0)
            torch.cuda.synchronize()
        got = tracing.take()
    finally:
        tracing.take()
        inst.shutdown()
    segs = spans.named(got, "segment")
    assert len(segs) == ex.segments_for(n)
    ops, calls = _launches(prof.profiler.kineto_results.events(), t_mark)
    by = launchers([o[3] for o in ops], calls, segs)
    took = np.array([o[1] - o[0] for o in ops])
    inside = np.array([s is not None for s in by])
    assert took.sum() > 0
    assert took[inside].sum() >= 0.99 * took.sum(), \
        (took[inside].sum(), took.sum(),
         sorted({ops[i][2][:60] for i in np.flatnonzero(~inside)}))
    tc = [s is not None and s.attrs["op"] == "attn"
          for s, o in zip(by, ops) if "prefill_tc_kernel" in o[2]]
    assert len(tc) == cfg.num_layers * n // dep["chunk_tokens"] and all(tc)
