"""Chaos tests of the port's threaded runtime on the CPU: the six runtime
cases of tests/test_faults.py (no fault, crash and revive, a decode crash,
a hang the watchdog catches, naive mode losing the stranded requests, the
shed policy) on the port's `PrefillInstance`, `DecodeInstance` and `Proxy`,
held to the reference's invariants (`_assert_chaos_invariants`) and drain
timeouts; and one colocated case: a fault injected into a `HybridInstance`
strands both phases, and after `restart()` the resubmitted requests decode
to the JAX dense reference and leave no pool block behind.

The weights are bridged from the JAX `init_params` on the reference's
config, so the hybrid case can hold its trajectories to the JAX model."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step, prefill
from repro_torch.configs.base import get_tiny_config
from repro_torch.core import (Request, RequestState, SchedulerCore,
                              TTFTPredictor)
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.params import from_jax_params
from repro_torch.serving.decode_instance import DecodeInstance
from repro_torch.serving.hybrid_instance import HybridInstance
from repro_torch.serving.prefill_instance import PrefillInstance
from repro_torch.serving.proxy import Proxy

JCFG = dataclasses.replace(jax_tiny_config("llama3_8b"),
                           num_layers=2, d_model=64, d_ff=128)
CFG = dataclasses.replace(get_tiny_config("llama3_8b"),
                          num_layers=2, d_model=64, d_ff=128)
MAX_SEQ = 512


@pytest.fixture(scope="module")
def chaos_model():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    ex = SegmentedPrefill(params, CFG, max_seq=MAX_SEQ, granularity="op",
                          chunk_tokens=128)
    pred = TTFTPredictor(coeffs=np.array([1e-4, 0.0]), floor=0.0)
    return params, ex, pred, jparams


def _mk_prefill(params, ex, pred):
    core = SchedulerCore(predictor=pred, policy="s-edf",
                         enable_batching=False)
    return PrefillInstance(params, CFG, core, max_seq=MAX_SEQ, executor=ex)


def _assert_chaos_invariants(name, proxy, decs, reqs):
    """The runtime mirror of the simulator's churn invariants
    (tests/test_faults.py:241): exactly-once completion, conservation of
    finished+lost, and KV block accounting (only the decode scratch slot
    may remain resident after drain)."""
    rep = proxy.report()
    served = [r for r in reqs if r.state is not RequestState.DROPPED]
    fin_rids = [r.rid for d in decs for r in d.finished]
    assert len(fin_rids) == len(set(fin_rids)), \
        f"{name}: a request completed twice"
    for r in served:
        assert r.first_token_time is not None, \
            f"{name}: rid {r.rid} neither served nor declared lost"
    if decs:   # every served request made it through decode exactly once
        assert set(fin_rids) == {r.rid for r in served}
        assert all(r.finish_time is not None for r in served)
    assert len(served) + rep["lost_requests"] == len(reqs), \
        f"{name}: {len(served)} served + {rep['lost_requests']} lost " \
        f"!= {len(reqs)} submitted"
    assert rep["stranded_rids"] == [], \
        f"{name}: non-terminal requests left after drain"
    for d in decs:
        if d.kv is not None:
            live = d.kv.num_blocks - d.kv.free_blocks
            assert live <= 1, f"{name}: {live} KV blocks leaked after drain"
    return rep


def _run_chaos(params, ex, pred, *, n_prefill=2, n_decode=1, n_reqs=10,
               fault_at=4, fault=None, seed=0, drain_s=120.0, **proxy_kw):
    insts = [_mk_prefill(params, ex, pred) for _ in range(n_prefill)]
    decs = [DecodeInstance(params, CFG, decode_tokens=4, policy="fcfs")
            for _ in range(n_decode)]
    proxy = Proxy(insts, decs, dispatch="round-robin",
                  retry_backoff=0.02, retry_backoff_cap=0.2, **proxy_kw)
    rng = np.random.default_rng(seed)
    reqs = []
    try:
        for i in range(n_reqs):
            n = int(rng.integers(64, 256))
            r = Request(num_tokens=n, slo=30.0, arrival=time.monotonic(),
                        output_tokens=4 if n_decode else 0,
                        tbt_slo=5.0 if n_decode else None)
            reqs.append(r)
            proxy.submit(r, rng.integers(0, CFG.vocab_size, size=n))
            time.sleep(0.01)
            if i == fault_at and fault is not None:
                fault(proxy, insts, decs)
        assert proxy.drain(drain_s), "drain timed out mid-recovery"
        return proxy, insts, decs, reqs
    except BaseException:
        proxy.shutdown()
        raise


def test_runtime_no_fault_baseline(chaos_model):
    proxy, _, decs, reqs = _run_chaos(*chaos_model[:3], fault=None)
    try:
        rep = _assert_chaos_invariants("no-fault", proxy, decs, reqs)
        assert rep["retries"] == rep["lost_requests"] == 0
        assert all(rep["instance_health"]["prefill"])
    finally:
        proxy.shutdown()


def test_runtime_crash_and_revive_recovers_all(chaos_model):
    timers = []

    def fault(proxy, insts, decs):
        proxy.kill_instance(0, "prefill")
        timers.append(threading.Timer(0.3, proxy.revive_instance,
                                      args=(0, "prefill")))
        timers[0].start()

    proxy, _, decs, reqs = _run_chaos(*chaos_model[:3], fault=fault)
    try:
        # the drain skips the down instance, and the port's tiny prefills can
        # drain the trace inside the 0.3 s outage: let the revive land
        timers[0].join(10.0)
        rep = _assert_chaos_invariants("crash+revive", proxy, decs, reqs)
        assert rep["lost_requests"] == 0        # stranded work re-dispatched
        assert rep["retries"] >= 1              # ... by charging retries
        assert all(rep["instance_health"]["prefill"])  # revive took
    finally:
        proxy.shutdown()


def test_runtime_decode_crash_recovers_all(chaos_model):
    def fault(proxy, insts, decs):
        # crash the decode instance only once it actually holds in-flight
        # work: crashing an EMPTY decode instance strands nothing
        deadline = time.monotonic() + 30.0
        while decs[0].idle() and time.monotonic() < deadline:
            time.sleep(0.005)
        proxy.kill_instance(0, "decode")
        threading.Timer(0.3, proxy.revive_instance,
                        args=(0, "decode")).start()

    proxy, _, decs, reqs = _run_chaos(*chaos_model[:3], n_prefill=1,
                                      n_decode=2, fault=fault)
    try:
        rep = _assert_chaos_invariants("decode-crash", proxy, decs, reqs)
        # a decode-stranded request needs a FULL re-prefill (its KV died
        # with the instance), so recovery shows up as prefill retries
        assert rep["lost_requests"] == 0
        assert rep["retries"] >= 1
    finally:
        proxy.shutdown()


def test_runtime_hang_detected_by_watchdog(chaos_model):
    """A hung (not dead) worker makes no progress; the watchdog must strand
    its work, the supervisor auto-restarts it, and every request still
    finishes exactly once. The watchdog period is calibrated from one warm
    prefill of the largest request on this host, as in the reference."""
    params, ex, pred, _ = chaos_model
    toks = np.zeros((1, 256), np.int64)
    ex.run_all(ex.start(toks))                      # warm
    t0 = time.monotonic()
    ex.run_all(ex.start(toks))
    wd = min(4.0, max(0.4, 25 * (time.monotonic() - t0)))
    hang = max(1.0, 2.5 * wd)

    def fault(proxy, insts, decs):
        insts[0].inject_fault(("hang", hang))
        decs[0].inject_fault(("hang", hang))

    # the budget covers every watchdog fire during the hang (the reference's
    # reasoning, tests/test_faults.py:371-378)
    proxy, _, decs, reqs = _run_chaos(params, ex, pred, n_reqs=8,
                                      fault=fault, watchdog_s=wd,
                                      auto_restart_s=1.25 * wd,
                                      max_retries=50,
                                      drain_s=max(120.0, 30 * wd))
    try:
        rep = _assert_chaos_invariants("hang+watchdog", proxy, decs, reqs)
        assert rep["lost_requests"] == 0
        assert rep["retries"] >= 1              # watchdog fired at least once
    finally:
        proxy.shutdown()


def test_watchdog_does_not_count_idle_time_as_a_stall(chaos_model):
    """Beyond the reference: an instance's progress clock restarts when
    work reaches it idle. Both instances sit idle for 2x the watchdog
    period, then one request arrives whose first step on each instance
    takes half a period (the scheduler's ARRIVAL round, the decode
    ingest): honest work, so the watchdog must not fire. Without the
    restart it measures the idle time as a stall and strands both."""
    params, ex, pred, _ = chaos_model
    toks = np.zeros((1, 256), np.int64)
    ex.run_all(ex.start(toks))                      # warm
    t0 = time.monotonic()
    ex.run_all(ex.start(toks))
    wd = min(4.0, max(0.4, 25 * (time.monotonic() - t0)))
    inst = _mk_prefill(params, ex, pred)
    dec = DecodeInstance(params, CFG, decode_tokens=4, policy="fcfs")

    def slow_first(obj, name):
        fn, calls = getattr(obj, name), []

        def slow(*a, **kw):
            if not calls:
                calls.append(1)
                time.sleep(wd / 2)
            return fn(*a, **kw)
        setattr(obj, name, slow)
    slow_first(inst, "_handle_event")
    slow_first(dec, "_ingest")
    proxy = Proxy([inst], [dec], watchdog_s=wd)
    try:
        time.sleep(2 * wd)
        r = Request(num_tokens=128, slo=30.0, arrival=time.monotonic(),
                    output_tokens=4, tbt_slo=5.0)
        proxy.submit(r, np.arange(128) % CFG.vocab_size)
        assert proxy.drain(max(60.0, 30 * wd))
        rep = proxy.report()
        assert rep["watchdog_fires"] == 0
        assert rep["retries"] == 0 and r.finish_time is not None
    finally:
        proxy.shutdown()


def test_decode_hang_waits_for_work_and_a_revive_does_not_hide_it(
        chaos_model):
    """Beyond the reference: a hang injected into an idle DecodeInstance
    takes effect when work reaches it, and a revive that lands mid-hang on
    the still-healthy instance leaves it alone. Before, the idle worker
    slept the hang out before its work came and the revive restarted its
    progress clock, so the watchdog saw no stall (a chaos run of
    chip_smoke.py phase 18 with no fire). Here the work comes only after
    the whole hang, and the revive lands as it arrives."""
    params, ex, pred, _ = chaos_model
    toks = np.zeros((1, 256), np.int64)
    ex.run_all(ex.start(toks))                      # warm
    t0 = time.monotonic()
    ex.run_all(ex.start(toks))
    wd = min(4.0, max(0.4, 25 * (time.monotonic() - t0)))
    hang = 3 * wd
    inst = _mk_prefill(params, ex, pred)
    dec = DecodeInstance(params, CFG, decode_tokens=4, policy="fcfs")
    proxy = Proxy([inst], [dec], watchdog_s=wd, auto_restart_s=wd,
                  retry_backoff=0.02, retry_backoff_cap=0.2)
    try:
        dec.inject_fault(("hang", hang))
        time.sleep(hang + wd / 2)
        r = Request(num_tokens=128, slo=60.0, arrival=time.monotonic(),
                    output_tokens=4, tbt_slo=5.0)
        proxy.submit(r, np.arange(128) % CFG.vocab_size)
        deadline = time.monotonic() + 30.0
        while dec.idle() and time.monotonic() < deadline:
            time.sleep(0.001)
        assert not dec.idle()                   # the handoff reached dec
        ts = dec.progress_ts
        proxy.revive_instance(0, "decode")
        assert dec.progress_ts == ts            # the clock was left alone
        assert proxy.drain(max(60.0, 30 * wd))
        rep = _assert_chaos_invariants("idle hang", proxy, [dec], [r])
        assert rep["watchdog_fires"] >= 1 and rep["retries"] >= 1
        assert rep["lost_requests"] == 0
    finally:
        proxy.shutdown()


def test_unacknowledged_preemption_strands_the_stuck_task(chaos_model):
    """Beyond the reference: a pool worker stuck inside one operator past
    the preemption timeout. An urgent request makes S-EDF preempt the
    long one; the worker never acks, so the instance strands both
    requests to `on_fault` instead of dropping the stuck task (whose
    request no strand could then hand back)."""
    params, ex, pred, _ = chaos_model
    inst = _mk_prefill(params, ex, pred)
    stuck, release = threading.Event(), threading.Event()
    step = inst.pool._step

    def held(task):
        stuck.set()
        release.wait(30.0)
        return step(task)
    inst.pool._step = held
    preempt = inst.pool.preempt_current
    inst.pool.preempt_current = lambda timeout=10.0: preempt(timeout=0.3)
    got = []
    done = threading.Event()

    def on_fault(stranded, exc):
        got.append(([r.rid for r in stranded], exc))
        done.set()
    inst.on_fault = on_fault
    try:
        a = Request(num_tokens=400, slo=60.0, arrival=time.monotonic())
        inst.submit_request(a, np.arange(400) % CFG.vocab_size)
        assert stuck.wait(30.0)
        b = Request(num_tokens=64, slo=0.5, arrival=time.monotonic())
        inst.submit_request(b, np.arange(64) % CFG.vocab_size)
        assert done.wait(30.0)
        (rids, exc), = got
        assert sorted(rids) == sorted([a.rid, b.rid])
        assert isinstance(exc, TimeoutError)
        assert not inst.healthy
    finally:
        release.set()
        inst.shutdown()


def test_runtime_naive_mode_loses_stranded(chaos_model):
    """recovery="none" is the contrast case: a crash with no revive loses
    exactly the stranded requests, and the report names them."""
    params, ex, pred, _ = chaos_model
    insts = [_mk_prefill(params, ex, pred) for _ in range(2)]
    proxy = Proxy(insts, [], dispatch="round-robin", recovery="none")
    rng = np.random.default_rng(0)
    reqs = []
    try:
        # pin instance 0 so its queue cannot drain before the kill
        insts[0].inject_fault(("hang", 0.5))
        for i in range(8):
            n = int(rng.integers(64, 256))
            r = Request(num_tokens=n, slo=30.0, arrival=time.monotonic())
            reqs.append(r)
            proxy.submit(r, rng.integers(0, CFG.vocab_size, size=n))
        proxy.kill_instance(0, "prefill")   # strands its queued requests
        assert proxy.drain(60.0)
        rep = _assert_chaos_invariants("naive", proxy, [], reqs)
        assert rep["lost_requests"] > 0
        assert rep["lost_rids"] == sorted(
            r.rid for r in reqs if r.state is RequestState.DROPPED)
        # the healthy instance still served its share
        assert rep["lost_requests"] < len(reqs)
    finally:
        proxy.shutdown()


def test_runtime_shed_policy_rejects_doomed(chaos_model):
    """Proxy admission control mirrors the sim: with every instance busy
    and a predicted TTFT already past the SLO, a fresh arrival is shed
    (DROPPED + shed, never dispatched) instead of deepening the queue."""
    params, ex, pred, _ = chaos_model
    insts = [_mk_prefill(params, ex, pred)]
    # a predictor that makes every request look doomed once one is queued
    slow_pred = TTFTPredictor(coeffs=np.array([1.0, 0.0]), floor=0.0)
    proxy = Proxy(insts, [], dispatch="round-robin",
                  shed_policy="doomed-only", predictor=slow_pred)
    try:
        rng = np.random.default_rng(3)
        reqs = []
        for i in range(4):
            r = Request(num_tokens=128, slo=0.5, arrival=time.monotonic())
            reqs.append(r)
            proxy.submit(r, rng.integers(0, CFG.vocab_size, size=128))
        assert proxy.drain(60.0)
        rep = proxy.report()
        shed = [r for r in reqs if r.shed]
        assert rep["shed_requests"] == len(shed) >= 1
        assert all(r.state is RequestState.DROPPED and
                   r.first_token_time is None for r in shed)
        # the first arrival found an empty instance: never shed
        assert not reqs[0].shed
        assert rep["lost_requests"] == 0
    finally:
        proxy.shutdown()


def test_zombie_completion_after_restart_is_dropped(chaos_model):
    """A task completes while the scheduler thread hangs, so its COMPLETION
    waits in the queue; a strand (the watchdog's) hands its request back,
    and restart() revives the instance before the thread wakes. The queued
    event must not hand the request on: its re-dispatch serves it. (The
    hang+watchdog case above met this race on the port's fast CPU path: a
    request finished decode with no first token and a dropped retry.)"""
    params, ex, pred, _ = chaos_model
    inst = _mk_prefill(params, ex, pred)
    done, stranded = [], []
    inst.on_prefill_done = done.append
    inst.on_fault = lambda reqs, exc: stranded.extend(reqs)
    gate = threading.Event()
    step = inst.pool._step

    def gated(task):
        gate.wait(30.0)
        return step(task)

    inst.pool._step = gated
    try:
        r = Request(num_tokens=64, slo=30.0, arrival=time.monotonic())
        inst.submit_request(r, np.zeros(64, np.int64))
        deadline = time.monotonic() + 30.0
        while r.state is not RequestState.RUNNING \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        inst.inject_fault(("hang", 2.0))
        while inst.monitor.qsize() and time.monotonic() < deadline:
            time.sleep(0.001)                   # the thread took the hang
        gate.set()
        while inst.monitor.qsize() == 0 and time.monotonic() < deadline:
            time.sleep(0.001)                   # COMPLETION queued
        assert inst.monitor.qsize() == 1 and r.first_token_time is not None
        inst._on_worker_failure(TimeoutError("watchdog"))
        assert stranded == [r]
        inst.restart()
        assert inst.drain(30.0)
        assert done == [] and inst.completed == []
    finally:
        inst.shutdown()


# --- the colocated instance ---------------------------------------------------


def _jax_reference(jparams, toks, n_out):
    """Dense JAX prefill, then a greedy decode_step loop."""
    logits, cache = prefill(jparams, JCFG, {"tokens": jnp.asarray(toks[None])},
                            max_seq=MAX_SEQ)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [int(tok[0])]
    c = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
    step = jax.jit(lambda p, t, cc: decode_step(p, JCFG, t, cc))
    for _ in range(n_out):
        logits, c = step(jparams, tok, c)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(int(tok[0]))
    return out


def test_hybrid_fault_strands_both_phases_and_restart_recovers(chaos_model):
    """A (64 tokens) decodes while B (256 tokens) still prefills under a
    tight budget; an injected RuntimeError strands both to on_fault and
    frees their blocks. After restart() the same requests, resubmitted,
    decode to the JAX dense reference, and the pool holds only its scratch
    block."""
    params, _, _, jparams = chaos_model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in (64, 256)]
    outs = (8, 4)
    inst = HybridInstance(params, CFG, max_seq=MAX_SEQ, token_budget=24,
                          chunk_tokens=16, decode_max_batch=4,
                          decode_cadence=0.002, kv_block_size=16,
                          kv_pool_blocks=64, prefix_share=False)
    faults = []
    inst.on_fault = lambda reqs, exc: faults.append(
        ([(r.rid, r.decode_start is not None) for r in reqs], exc))
    reqs = [Request(num_tokens=len(p), slo=30.0, arrival=time.monotonic(),
                    output_tokens=o, tbt_slo=10.0)
            for p, o in zip(prompts, outs)]
    try:
        for r, p in zip(reqs, prompts):
            inst.submit(r, p)
        deadline = time.monotonic() + 60.0
        while not (inst.resident() == 1 and inst.pending() == 1) \
                and time.monotonic() < deadline:
            time.sleep(0.0005)
        assert inst.resident() == 1 and inst.pending() == 1
        inst.inject_fault(RuntimeError("injected"))
        deadline = time.monotonic() + 60.0
        while not faults and time.monotonic() < deadline:
            time.sleep(0.001)
        assert len(faults) == 1 and not inst.healthy
        stranded, exc = faults[0]
        assert isinstance(exc, RuntimeError)
        # one stream stranded mid-decode, one mid-prefill
        assert sorted(stranded) == sorted([(reqs[0].rid, True),
                                           (reqs[1].rid, False)])
        assert not inst.finished
        free, live, cached, total = inst.kv.accounting()
        assert (free, live) == (total - 1, 1)   # stranded blocks freed
        inst.restart()
        for r, p in zip(reqs, prompts):
            r.state = RequestState.WAITING
            r.first_token_time = r.decode_start = None
            inst.submit(r, p)
        assert inst.drain(120.0) and inst.healthy
    finally:
        inst.shutdown()
    got = {j.request.rid: j.emitted for j in inst.finished_jobs}
    assert [got[r.rid] for r in reqs] == [
        _jax_reference(jparams, p, o) for p, o in zip(prompts, outs)]
    free, live, cached, total = inst.kv.accounting()
    assert (free, live, cached) == (total - 1, 1, 0)
