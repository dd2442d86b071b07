"""The port's threaded serving runtime on the CPU: the paged-pool tests of
tests/test_decode_batched.py, the single-stream and batched decode workers
against a sequential replay, ports of the runtime scenarios of
tests/test_serving_integration.py (bounds calibrated from the fitted
prefill profile, as there), and a greedy trajectory through proxy ->
prefill -> batched decode against the JAX model functions on the same
bridged weights."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step_ragged as jax_decode_step_ragged
from repro.models.segments import SegmentedPrefill as JaxSegmentedPrefill
from repro_torch.configs.base import get_tiny_config
from repro_torch.core import (DecodeStepPredictor, Request, RequestState,
                              SchedulerCore, TTFTPredictor)
from repro_torch.models.model import decode_step
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.params import from_jax_params, init_params
from repro_torch.serving.decode_instance import DecodeInstance, DecodeJob
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.prefill_instance import PrefillInstance
from repro_torch.serving.proxy import Proxy

# wide enough that a long prefill takes a measurable time on a CPU, so
# preemption effects are unambiguous; MAX_SEQ kept at 1024 to stay cheap
CFG = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=4,
                          d_model=512, num_heads=8, num_kv_heads=2, d_ff=2048)
MAX_SEQ = 1024
LONG, SHORT = 1024, 64


# --- paged pool I/O (tests/test_decode_batched.py:331-386) -------------------


def test_write_tokens_matches_scalar_write():
    cache_a = PagedKVCache(2, 16, 4, 2, 8, device="cpu")
    cache_b = PagedKVCache(2, 16, 4, 2, 8, device="cpu")
    rng = np.random.default_rng(0)
    for sid in (0, 1):
        cache_a.allocate(sid, 12)
        cache_b.allocate(sid, 12)
    k = torch.from_numpy(rng.standard_normal((2, 2, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 2, 8)).astype(np.float32))
    positions = [5, 2]
    for i, sid in enumerate((0, 1)):
        cache_a.write(sid, positions[i], k[:, i], v[:, i])
    cache_b.write_tokens([0, 1], positions, k, v)
    assert torch.equal(cache_a.k_pool, cache_b.k_pool)
    assert torch.equal(cache_a.v_pool, cache_b.v_pool)
    assert cache_b.table(0).length == 6 and cache_b.table(1).length == 3


def test_gather_batch_matches_per_seq_gather():
    cache = PagedKVCache(2, 32, 4, 2, 8, device="cpu")
    rng = np.random.default_rng(1)
    lens = {0: 10, 1: 5, 2: 7}
    for sid, n in lens.items():
        cache.allocate(sid, n)
        k = torch.from_numpy(rng.standard_normal((2, n, 2, 8)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((2, n, 2, 8)).astype(np.float32))
        cache.write_prompt(sid, k, v)
    kb, vb, out_lens = cache.gather_batch([0, 1, 2], width=4)
    assert tuple(kb.shape) == (2, 3, 16, 2, 8)
    assert out_lens.tolist() == [10, 5, 7]
    for i, sid in enumerate((0, 1, 2)):
        ks, vs, ln = cache.gather(sid)
        assert ln == lens[sid]
        assert torch.equal(kb[:, i, :ln], ks[:, :ln])
        assert torch.equal(vb[:, i, :ln], vs[:, :ln])


def test_pool_grow_preserves_data_and_free_accounting():
    cache = PagedKVCache(1, 4, 4, 1, 8, device="cpu")
    cache.allocate(0, 8)
    k = torch.ones((1, 8, 1, 8))
    cache.write_prompt(0, k, k)
    free_before = cache.free_blocks
    cache.grow(4)
    assert cache.num_blocks == 8
    assert cache.free_blocks == free_before + 4
    ks, _, ln = cache.gather(0)
    assert ln == 8 and ks[:, :8].sum().item() == 8 * 8
    assert cache.accounting() == (cache.free_blocks, 2, 0, 8)
    shared = PagedKVCache(1, 4, 4, 1, 8, device="cpu", prefix_share=True)
    shared.allocate(0, 8)
    shared.grow(4)
    assert shared.accounting() == (6, 2, 0, 8)


# --- decode workers against a sequential replay -----------------------------


@pytest.fixture(scope="module")
def small_model():
    cfg = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _handoff(cfg, params, n, seed, max_seq=256):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n))
    ex = SegmentedPrefill(params, cfg, max_seq=max_seq)
    task = ex.start(toks)
    logits = ex.run_all(task)
    return int(logits.argmax(-1)[0]), {"k": task.state["k_cache"],
                                       "v": task.state["v_cache"], "pos": n}


def _replay(cfg, params, first, cache, n_tokens):
    tok = torch.tensor([first])
    c = {"k": cache["k"].clone(), "v": cache["v"].clone(),
         "pos": cache["pos"]}
    out = []
    for _ in range(n_tokens):
        logits, c = decode_step(params, cfg, tok, c)
        tok = logits.argmax(-1)
        out.append(int(tok[0]))
    return out, c


def _job(first, cache, out_tokens, tbt=100.0):
    req = Request(num_tokens=int(cache["pos"]), slo=100.0, arrival=0.0,
                  output_tokens=out_tokens, tbt_slo=tbt)
    return DecodeJob(request=req, cache=dict(cache), first_token=first)


def test_b1_path_bitmatches_single_stream_replay(small_model):
    """decode_max_batch=1: the single-stream worker runs the same dense
    decode_step on its own copy of the cache — tokens and final cache are
    bit-equal to a sequential replay, and the handoff cache is untouched."""
    cfg, params = small_model
    first, cache = _handoff(cfg, params, 48, seed=0)
    before = cache["k"].clone()
    want_tokens, want_cache = _replay(cfg, params, first, cache, 5)
    inst = DecodeInstance(params, cfg, decode_tokens=5, decode_max_batch=1)
    try:
        job = _job(first, cache, 5)
        inst.submit(job)
        assert inst.drain(60.0)
    finally:
        inst.shutdown()
    assert inst.outputs[job.request.rid] == [first] + want_tokens
    for key in ("k", "v"):
        assert torch.equal(job.cache[key], want_cache[key]), key
    assert torch.equal(cache["k"], before)


def test_batched_matches_per_stream_replay(small_model):
    """B > 1 continuous batch reproduces each stream's sequential greedy
    decode (ragged lengths, one step per token, paged KV)."""
    cfg, params = small_model
    streams = [_handoff(cfg, params, n, seed=i)
               for i, n in enumerate((32, 48, 80, 100))]
    want = [_replay(cfg, params, f, c, 6)[0] for f, c in streams]
    inst = DecodeInstance(params, cfg, decode_tokens=6, decode_max_batch=4,
                          kv_block_size=64)
    jobs = [_job(f, c, 6) for f, c in streams]
    try:
        for j in jobs:
            inst.submit(j)
        assert inst.drain(60.0)
    finally:
        inst.shutdown()
    assert [j.tokens_done for j in jobs] == [6] * 4
    assert [inst.outputs[j.request.rid][1:] for j in jobs] == want
    assert inst.steps >= 6
    assert len(inst.tbt_samples) == 4 * 6
    assert 1 <= inst.compile_cache_size() <= 2     # (B bucket, width) pairs


def test_continuous_join_and_leave_mid_step(small_model):
    """A stream submitted while the batch is mid-decode joins at a token
    boundary; earlier-finishing streams leave without disturbing the rest."""
    cfg, params = small_model
    s1, s2, s3 = (_handoff(cfg, params, n, seed=10 + i)
                  for i, n in enumerate((32, 48, 64)))
    inst = DecodeInstance(params, cfg, decode_tokens=8, decode_max_batch=4,
                          kv_block_size=64)
    jobs = [_job(s1[0], s1[1], 20), _job(s2[0], s2[1], 4)]
    try:
        for j in jobs:
            inst.submit(j)
        deadline = time.monotonic() + 30.0
        while inst.steps < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert inst.steps >= 2
        late = _job(s3[0], s3[1], 6)
        jobs.append(late)
        inst.submit(late)
        assert inst.drain(60.0)
    finally:
        inst.shutdown()
    assert [j.tokens_done for j in jobs] == [20, 4, 6]
    assert len(inst.finished) == 3
    want, _ = _replay(cfg, params, s3[0], s3[1], 6)
    assert inst.outputs[late.request.rid][1:] == want


def test_preemption_is_slot_eviction_with_resume(small_model):
    """At the slot cap, a tight-TBT arrival displaces the most slack-rich
    resident at a token boundary; the evicted stream keeps progress, KV
    blocks and next token, resumes later and decodes exactly its target,
    matching a sequential replay."""
    cfg, params = small_model
    # ema_alpha=0 pins the calibration scale, as in the reference test
    pred = DecodeStepPredictor(prior=lambda b, c: 1e-4, ema_alpha=0.0)
    loose_s = [_handoff(cfg, params, 32, seed=20),
               _handoff(cfg, params, 48, seed=21)]
    tight_s = _handoff(cfg, params, 40, seed=22)
    inst = DecodeInstance(params, cfg, decode_tokens=8, decode_max_batch=2,
                          kv_block_size=64, policy="s-edf",
                          step_predictor=pred)
    loose = [_job(f, c, 40, tbt=100.0) for f, c in loose_s]
    tight = _job(*tight_s, 6, tbt=2.0)
    try:
        for j in loose:
            inst.submit(j)
        deadline = time.monotonic() + 30.0
        while inst.steps < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        inst.submit(tight)
        assert inst.drain(120.0)
    finally:
        inst.shutdown()
    assert inst.preemptions >= 1
    assert sum(j.request.decode_preemptions for j in loose) >= 1
    assert tight.request.finish_time < max(j.request.finish_time
                                           for j in loose)
    assert [j.tokens_done for j in loose] == [40, 40]
    assert tight.tokens_done == 6
    for j, (f, c) in zip(loose, loose_s):
        want, _ = _replay(cfg, params, f, c, 40)
        assert inst.outputs[j.request.rid][1:] == want


def test_shapes_stepped_bounded_by_buckets(small_model):
    """Sweeping resident populations 1..8 only ever steps the bucketed
    shapes: distinct (B bucket, KV width) pairs <= |batch buckets| x
    |width buckets| (the reference's bound on jit recompiles)."""
    cfg, params = small_model
    inst = DecodeInstance(params, cfg, decode_tokens=2, decode_max_batch=8,
                          kv_block_size=64, batch_buckets=(1, 2, 4, 8))
    try:
        seed = 100
        for n_streams in (1, 2, 3, 5, 7, 8):
            for _ in range(n_streams):
                # 32/48-token prompts + 2 tokens fit ONE 64-token block
                f, c = _handoff(cfg, params, 32 + 16 * (seed % 2), seed)
                seed += 1
                inst.submit(_job(f, c, 2))
            assert inst.drain(120.0)
        assert 0 < inst.compile_cache_size() <= 4
    finally:
        inst.shutdown()


def test_unsupported_family_rejects_batched_decode():
    ssm_cfg = dataclasses.replace(get_tiny_config("llama3_8b"), family="ssm")
    with pytest.raises(ValueError, match="decode_max_batch"):
        DecodeInstance(None, ssm_cfg, decode_max_batch=2)


@pytest.mark.parametrize("dst_cap", [1, 2])
def test_take_extracts_evicted_pool_resident_stream(small_model, dst_cap):
    """A stream whose KV lives in the paged pool (an evicted resident) is
    handed off as a dense cache that another instance, batched or the
    slot-cap-1 path, decodes to the same result."""
    cfg, params = small_model
    f, c = _handoff(cfg, params, 48, seed=30)
    want, _ = _replay(cfg, params, f, c, 6)
    src = DecodeInstance(params, cfg, decode_tokens=6, decode_max_batch=2,
                         kv_block_size=64)
    dst = DecodeInstance(params, cfg, decode_tokens=6,
                         decode_max_batch=dst_cap, kv_block_size=64)
    job = _job(f, c, 6)
    try:
        src.shutdown()        # take() needs no worker; none may re-admit
        with src._cv:
            job.target = 6
            assert src._ingest(job)
            src._waiting.append(job)
        assert job.cache is None
        taken = src.take([job.request.rid])
        assert len(taken) == 1 and taken[0].cache is not None
        assert src.kv.table(job.request.rid) is None
        dst.submit(taken[0])
        assert dst.drain(60.0)
    finally:
        src.shutdown()
        dst.shutdown()
    assert job.tokens_done == 6
    assert dst.outputs[job.request.rid][1:] == want


def test_migrated_midstream_job_resumes_at_correct_position(small_model):
    """A job preempted mid-decode elsewhere (tokens_done > 0, cache pos =
    prompt + decoded) resumes in a batched instance at the right KV
    position."""
    cfg, params = small_model
    f, c = _handoff(cfg, params, 48, seed=40)
    want, _ = _replay(cfg, params, f, c, 8)
    done, mid_cache = _replay(cfg, params, f, c, 3)
    req = Request(num_tokens=48, slo=100.0, arrival=0.0, output_tokens=8,
                  tbt_slo=100.0)
    job = DecodeJob(request=req, first_token=f, tokens_done=3,
                    next_token=done[-1],
                    cache={"k": mid_cache["k"], "v": mid_cache["v"],
                           "pos": mid_cache["pos"]})
    inst = DecodeInstance(params, cfg, decode_tokens=8, decode_max_batch=2,
                          kv_block_size=64)
    try:
        inst.submit(job)
        assert inst.drain(60.0)
    finally:
        inst.shutdown()
    assert job.tokens_done == 8
    assert job.next_token == want[-1]


def test_no_livelock_when_pool_cannot_fit_selected_streams(small_model):
    """No-resident deadlock guard: when every selected stream fails pool
    allocation, the instance grows for the top candidate instead of
    spinning, and every stream finishes."""
    cfg, params = small_model
    pred = DecodeStepPredictor(prior=lambda b, c: 1e-4, ema_alpha=0.0)
    inst = DecodeInstance(params, cfg, decode_tokens=4, decode_max_batch=2,
                          kv_block_size=32, policy="s-edf",
                          step_predictor=pred)
    small = _handoff(cfg, params, 32, seed=50)
    big = [_handoff(cfg, params, 250, seed=51),
           _handoff(cfg, params, 250, seed=52)]
    loose = _job(*small, 4, tbt=100.0)
    tights = [_job(fc[0], fc[1], 50, tbt=0.05) for fc in big]
    try:
        inst.submit(loose)
        deadline = time.monotonic() + 30.0
        while inst.steps < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        for t in tights:
            inst.submit(t)
        assert inst.drain(120.0), "instance livelocked instead of growing"
    finally:
        inst.shutdown()
    assert loose.tokens_done == 4
    assert [t.tokens_done for t in tights] == [50, 50]


def test_oversized_stream_not_starved_while_pool_busy(small_model):
    """A stream whose KV exceeds the whole pool triggers a grow even while
    other streams are resident."""
    cfg, params = small_model
    inst = DecodeInstance(params, cfg, decode_tokens=4, decode_max_batch=2,
                          kv_block_size=32)
    small = _handoff(cfg, params, 32, seed=60)
    big = _handoff(cfg, params, 250, seed=61)
    resident = _job(*small, 30)
    oversized = _job(*big, 4)
    try:
        inst.submit(resident)
        deadline = time.monotonic() + 30.0
        while inst.steps < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        inst.submit(oversized)
        assert inst.drain(120.0), "oversized stream starved"
    finally:
        inst.shutdown()
    assert resident.tokens_done == 30
    assert oversized.tokens_done == 4


# --- runtime scenarios (tests/test_serving_integration.py) -------------------


@pytest.fixture(scope="module")
def served_model():
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    ex = SegmentedPrefill(params, CFG, max_seq=MAX_SEQ, granularity="op",
                          chunk_tokens=512)
    xs, ys = [], []
    for n in (64, 256, 512, 1024):
        toks = np.zeros((1, n), np.int64)
        ex.run_all(ex.start(toks))           # warm-up
        t0 = time.monotonic()
        ex.run_all(ex.start(toks))
        xs.append(n)
        ys.append(time.monotonic() - t0)
    pred = TTFTPredictor.fit(xs, ys, degree=2)
    return params, pred, ex


def make_instance(params, pred, executor, policy="s-edf", **kw):
    core = SchedulerCore(predictor=pred, policy=policy,
                         batch_budget=kw.pop("batch_budget", 200),
                         enable_batching=kw.pop("enable_batching", False))
    return PrefillInstance(params, CFG, core, max_seq=MAX_SEQ,
                           executor=executor)


def rand_tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=n)


def calibrated(pred, ex):
    """Per-operator time and a short request's SLO from the fitted profile
    (the reference's deflaking pattern)."""
    t_long = float(pred.predict(LONG))
    op_time = t_long / ex.start(np.zeros((1, LONG), np.int64)).total_segments
    slo_b = max(1.0, 6 * float(pred.predict(SHORT)) + 12 * op_time)
    return op_time, slo_b


def wait_running(inst, req):
    """Return once `req` is prefilling and its task has crossed a few
    operator boundaries: B then arrives mid-prefill whatever the host's load
    (a sleep calibrated from the profile can overshoot A's whole prefill
    when the load drops between profiling and the test)."""
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        task = inst.pool.current()
        if req.state == RequestState.RUNNING and task is not None \
                and task.head.rid == req.rid and task.prefill_task.cursor >= 3:
            return
        time.sleep(0.002)
    raise AssertionError("A never started prefilling")


def test_fig8_two_request_scenario(served_model):
    """A (long, relaxed SLO) starts; B (short, strict SLO) arrives
    mid-prefill; FlowPrefill preempts A at an operator boundary, serves B
    within its SLO, then resumes and completes A."""
    params, pred, ex = served_model
    op_time, slo_b = calibrated(pred, ex)
    inst = make_instance(params, pred, ex)
    try:
        A = Request(num_tokens=LONG, slo=60.0, arrival=time.monotonic(),
                    task_type="file")
        inst.submit_request(A, rand_tokens(LONG, 1))
        wait_running(inst, A)
        B = Request(num_tokens=SHORT, slo=slo_b, task_type="text",
                    arrival=time.monotonic())
        inst.submit_request(B, rand_tokens(SHORT, 2))
        assert inst.drain(120.0), "instance did not drain"
        assert B.state == RequestState.DONE and A.state == RequestState.DONE
        assert B.ttft < slo_b, f"B TTFT {B.ttft:.3f}s missed {slo_b:.2f}s"
        assert A.ttft > B.ttft, "A (preempted) must finish after B"
        assert len(inst.blocking_stats.samples) >= 1
        assert inst.blocking_stats.max < max(1.2, 15 * op_time), \
            f"blocking {inst.blocking_stats.max:.3f}s not operator-bounded"
    finally:
        inst.shutdown()


def test_event_driven_round_count(served_model):
    """Scheduling rounds <= 2 per request (arrival + completion), whatever
    the operator granularity (§6.4)."""
    params, pred, ex = served_model
    inst = make_instance(params, pred, ex)
    try:
        n = 6
        for i in range(n):
            r = Request(num_tokens=SHORT, slo=30.0, arrival=time.monotonic())
            inst.submit_request(r, rand_tokens(SHORT, i))
        assert inst.drain(120.0)
        assert inst.scheduling_rounds <= 2 * n
    finally:
        inst.shutdown()


def test_preempted_task_result_unchanged(served_model):
    """A preempted-and-resumed prefill produces the same first-token logits
    as an uninterrupted run, through the full threaded runtime."""
    params, pred, ex = served_model
    toks = rand_tokens(LONG, 7)
    want = ex.run_all(ex.start(toks[None]))
    op_time, slo_b = calibrated(pred, ex)
    inst = make_instance(params, pred, ex)
    try:
        A = Request(num_tokens=LONG, slo=60.0, arrival=time.monotonic(),
                    task_type="file")
        inst.submit_request(A, toks)
        wait_running(inst, A)
        B = Request(num_tokens=SHORT, slo=slo_b, arrival=time.monotonic())
        inst.submit_request(B, rand_tokens(SHORT, 8))
        assert inst.drain(120.0)
        assert len(inst.blocking_stats.samples) >= 1
        assert inst.blocking_stats.max < max(1.2, 15 * op_time)
        done = {t.head.rid: t for t in inst.completed_tasks}
        got = done[A.rid].prefill_task.logits
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
    finally:
        inst.shutdown()


def test_pd_pipeline_with_decode(served_model):
    """Full proxy -> prefill -> decode handoff produces finished requests."""
    params, pred, ex = served_model
    inst = make_instance(params, pred, ex)
    dec = DecodeInstance(params, CFG, decode_tokens=4)
    proxy = Proxy([inst], [dec])
    try:
        for i in range(3):
            r = Request(num_tokens=SHORT, slo=30.0, arrival=time.monotonic())
            proxy.submit(r, rand_tokens(SHORT, 300 + i))
        assert proxy.drain(120.0)
        deadline = time.monotonic() + max(1.0, 10 * float(pred.predict(SHORT)))
        while len(dec.finished) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(dec.finished) == 3
        assert all(r.finish_time is not None for r in dec.finished)
        assert all(len(toks) == 5 for toks in dec.outputs.values())
        assert proxy.report()["n_requests"] == 3
    finally:
        proxy.shutdown()


# --- greedy trajectory against the JAX model functions -----------------------


def test_greedy_trajectory_matches_jax_model():
    """Proxy -> PrefillInstance -> batched DecodeInstance on the tiny config
    emits, per prompt, the same greedy tokens as the JAX SegmentedPrefill
    followed by a loop of JAX decode_step_ragged on the same bridged
    weights."""
    n_dec, max_seq, chunk = 6, 256, 32
    jcfg = jax_tiny_config("llama3_8b")
    cfg = get_tiny_config("llama3_8b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 64, 100)]

    want = []
    jex = JaxSegmentedPrefill(jparams, jcfg, max_seq=max_seq,
                              chunk_tokens=chunk)
    for p in prompts:
        task = jex.start(jnp.asarray(p[None]))
        tok = jnp.argmax(jex.run_all(task), -1)
        kc, vc = task.state["k_cache"], task.state["v_cache"]
        out, pos = [int(tok[0])], len(p)
        for _ in range(n_dec):
            logits, k_new, v_new = jax_decode_step_ragged(
                jparams, jcfg, tok, kc, vc, jnp.asarray([pos], jnp.int32))
            kc = kc.at[:, 0, pos].set(k_new[:, 0])
            vc = vc.at[:, 0, pos].set(v_new[:, 0])
            tok = jnp.argmax(logits, -1)
            out.append(int(tok[0]))
            pos += 1
        want.append(out)

    ex = SegmentedPrefill(params, cfg, max_seq=max_seq, chunk_tokens=chunk)
    pred = TTFTPredictor.fit([64, 128, 256], [0.01, 0.02, 0.04])
    core = SchedulerCore(predictor=pred, enable_batching=False)
    inst = PrefillInstance(params, cfg, core, max_seq=max_seq, executor=ex)
    dec = DecodeInstance(params, cfg, decode_tokens=n_dec, decode_max_batch=4,
                         kv_block_size=64)
    proxy = Proxy([inst], [dec])
    try:
        reqs = []
        for p in prompts:
            r = Request(num_tokens=len(p), slo=30.0, arrival=time.monotonic())
            reqs.append(r)
            proxy.submit(r, p)
        assert proxy.drain(120.0)
        deadline = time.monotonic() + 30.0
        while len(dec.finished) < len(prompts) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [dec.outputs[r.rid] for r in reqs] == want
    finally:
        proxy.shutdown()
