"""Speculative decoding in the port, against the JAX package on the
reference's own tiny config (tests/test_spec_decode.py: Llama3-8B tiny, 2
layers, d_model 128, d_ff 256) with weights bridged from the JAX
`init_params` pytree.

- `decode_verify_ragged` against the JAX function with the Pallas verify
  kernel in interpret mode (logits and new K/V at the reference's f32
  tolerance, 2e-5); `write_token_span` and `_ngram_draft` against the
  reference's semantics.
- The runtime tests of tests/test_spec_decode.py on the port's
  `DecodeInstance`: greedy draft-then-verify is bit-identical to plain
  decoding under oracle, adversarial, n-gram and mixed drafters, through an
  eviction mid-draft and for a migrated-in job; the verify shapes stay one
  more shape family; spec off leaves the plain path untouched.
- One spec trajectory against the JAX reference's own plain replay, and the
  split between the output record (`outputs`, whole) and the drafter's
  corpus (`DecodeJob.history`, capped, from the resume point).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import decode_verify_ragged as jax_verify
from repro.models.model import prefill as jax_prefill
from repro.serving.decode_instance import _ngram_draft as jax_ngram_draft
from repro_torch.configs.base import get_tiny_config
from repro_torch.core import DecodeStepPredictor, Request
from repro_torch.core.predictor import expected_accept_tokens
from repro_torch.models.model import decode_step, decode_verify_ragged
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.params import from_jax_params
from repro_torch.serving import decode_instance as DI
from repro_torch.serving.decode_instance import DecodeInstance, DecodeJob
from repro_torch.serving.kvcache import PagedKVCache

JCFG = dataclasses.replace(jax_tiny_config("llama3_8b"),
                           num_layers=2, d_model=128, d_ff=256)
CFG = dataclasses.replace(get_tiny_config("llama3_8b"),
                          num_layers=2, d_model=128, d_ff=256)
MAX_SEQ = 256
K = 4
F32 = dict(rtol=2e-5, atol=2e-5)          # the reference's f32 tolerance


@pytest.fixture(scope="module")
def bridged():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture(scope="module")
def params(bridged):
    return bridged[1]


def _handoff(params, n, seed):
    toks = np.random.default_rng(seed).integers(0, CFG.vocab_size, (1, n))
    ex = SegmentedPrefill(params, CFG, max_seq=MAX_SEQ)
    task = ex.start(toks)
    logits = ex.run_all(task)
    return int(logits.argmax(-1)[0]), {"k": task.state["k_cache"],
                                       "v": task.state["v_cache"], "pos": n}


def _replay(params, first, cache, n_tokens):
    """Plain sequential greedy decode: the bit-parity reference."""
    tok = torch.tensor([first])
    c = {"k": cache["k"].clone(), "v": cache["v"].clone(),
         "pos": cache["pos"]}
    out = []
    for _ in range(n_tokens):
        logits, c = decode_step(params, CFG, tok, c)
        tok = logits.argmax(-1)
        out.append(int(tok[0]))
    return out, c


def _job(first, cache, out_tokens, tbt=100.0):
    req = Request(num_tokens=int(cache["pos"]), slo=100.0, arrival=0.0,
                  output_tokens=out_tokens, tbt_slo=tbt)
    return DecodeJob(request=req, cache=dict(cache), first_token=first)


def _corpus(params, streams, n_tokens):
    """Reference continuations keyed by first token (the drafters' corpus
    and the parity oracle); the drafters dispatch on history[0]."""
    by_first = {f: _replay(params, f, c, n_tokens)[0] for f, c in streams}
    assert len(by_first) == len(streams), "first tokens must be distinct"
    return by_first


def _oracle(by_first):
    def draft(rid, history, k):
        seq = by_first[history[0]]
        done = len(history) - 1
        return seq[done:done + k]
    return draft


def _adversarial(by_first):
    def draft(rid, history, k):
        seq = by_first[history[0]]
        done = len(history) - 1
        return [(seq[done] + 1) % CFG.vocab_size] if done < len(seq) else []
    return draft


def _run_spec(params, streams, out_tokens, *, draft_fn, n_slots=None, **kw):
    inst = DecodeInstance(params, CFG, decode_tokens=out_tokens,
                          decode_max_batch=n_slots or len(streams),
                          kv_block_size=64, spec_decode=True, draft_k=K,
                          draft_fn=draft_fn, **kw)
    jobs = [_job(f, c, out_tokens) for f, c in streams]
    try:
        for j in jobs:
            inst.submit(j)
        assert inst.drain(120.0)
    finally:
        inst.shutdown()
    assert inst.healthy, inst.last_error
    return inst, jobs


# --- the model function, the span write and the drafter ----------------------


def test_decode_verify_ragged_matches_jax(bridged):
    """Logits and new K/V of one verify pass against the JAX function with
    the Pallas verify kernel in interpret mode, on ragged rows including a
    row at position 0."""
    jparams, tparams = bridged
    rng = np.random.default_rng(0)
    B, S, T = 3, K + 1, 64
    Kh, hd = CFG.num_kv_heads, CFG.resolved_head_dim
    tokens = rng.integers(0, CFG.vocab_size, (B, S))
    kv_lens = np.asarray([0, 17, 40])
    kg = rng.standard_normal((CFG.num_layers, B, T, Kh, hd)).astype(np.float32)
    vg = rng.standard_normal((CFG.num_layers, B, T, Kh, hd)).astype(np.float32)
    want = jax_verify(jparams, JCFG, jnp.asarray(tokens, jnp.int32),
                      jnp.asarray(kg), jnp.asarray(vg),
                      jnp.asarray(kv_lens, jnp.int32),
                      attn_impl="pallas_interpret")
    got = decode_verify_ragged(tparams, CFG, torch.from_numpy(tokens),
                               torch.from_numpy(kg.copy()),
                               torch.from_numpy(vg.copy()),
                               torch.from_numpy(kv_lens))
    assert tuple(got[0].shape) == (B, S, CFG.vocab_size)
    assert tuple(got[1].shape) == (CFG.num_layers, B, S, Kh, hd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_verify_span_raises_past_the_gathered_width(params):
    """An in-place index assignment raises where JAX's `.at[].set` would
    drop the write: the gathered width must cover kv_len + S."""
    kg = torch.zeros((CFG.num_layers, 1, 8, CFG.num_kv_heads,
                      CFG.resolved_head_dim))
    with pytest.raises(IndexError):
        decode_verify_ragged(params, CFG, torch.zeros((1, K + 1),
                                                      dtype=torch.int64),
                             kg, kg.clone(), torch.tensor([5]))


def test_write_token_span_commits_by_count():
    """All S positions are written; only counts[i] commit (table length);
    a count-0 row commits nothing; a span past the table raises."""
    cache = PagedKVCache(2, 16, 4, 2, 8, device="cpu")
    ref = PagedKVCache(2, 16, 4, 2, 8, device="cpu")
    for c in (cache, ref):
        c.allocate(0, 12)
        c.allocate(1, 8)
        c.allocate(-1, 1)
    rng = np.random.default_rng(0)
    S = 3
    k = torch.from_numpy(rng.standard_normal((2, 3, S, 2, 8))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 3, S, 2, 8))
                         .astype(np.float32))
    positions, counts = [5, 2, 0], [2, 3, 0]
    cache.write_token_span([0, 1, -1], positions, counts, k, v)
    for i, sid in enumerate((0, 1, -1)):
        for s in range(S):
            ref.write(sid, positions[i] + s, k[:, i, s], v[:, i, s])
    assert torch.equal(cache.k_pool, ref.k_pool)
    assert torch.equal(cache.v_pool, ref.v_pool)
    assert [cache.table(s).length for s in (0, 1, -1)] == [7, 5, 0]
    with pytest.raises(ValueError, match="extend"):
        cache.write_token_span([1], [6], [1], k[:, :1], v[:, :1])


def test_ngram_drafter_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        hist = [int(t) for t in rng.integers(0, 6, int(rng.integers(0, 30)))]
        k = int(rng.integers(0, 6))
        assert DI._ngram_draft(hist, k) == jax_ngram_draft(hist, k)
    assert DI._ngram_draft([1, 2, 3, 9, 1, 2, 3], 2) == [9, 1]


# --- bit parity --------------------------------------------------------------


@pytest.mark.parametrize("seeds,prompts", [
    ((300, 301, 302, 303), (32, 48, 80, 100)),   # full 4-slot bucket
    ((310, 311), (48, 64)),                      # 2-slot bucket
    ((320,), (40,)),                             # single stream, slot cap 1
])
def test_oracle_spec_trajectory_bitmatches_plain_replay(params, seeds,
                                                        prompts):
    """Accept-everything regime: every verify step commits k+1 tokens, and
    the whole trajectory equals the plain sequential replay."""
    out = 12
    streams = [_handoff(params, n, seed=s) for s, n in zip(seeds, prompts)]
    by_first = _corpus(params, streams, out + K)
    inst, jobs = _run_spec(params, streams, out, draft_fn=_oracle(by_first))
    for j, (f, _) in zip(jobs, streams):
        want = by_first[f]
        assert j.tokens_done == out
        assert j.history == [f] + want[:out]
        assert inst.outputs[j.request.rid] == [f] + want[:out]
        assert j.next_token == want[out - 1]
    assert inst.draft_accepted > 0
    assert inst.draft_accepted == inst.draft_proposed
    assert inst.spec_steps > 0
    assert len(inst.tbt_samples) == len(streams) * out
    assert len(inst.tbt_samples) / inst.row_steps > 1.5


def test_adversarial_spec_bitmatches_and_throttles(params):
    """Reject-everything regime: output equal to plain decoding, nothing
    accepted, and the accept-rate EMA throttles drafting so most steps run
    the plain shape."""
    out = 24
    streams = [_handoff(params, n, seed=330 + i)
               for i, n in enumerate((32, 48, 80, 100))]
    by_first = _corpus(params, streams, out + K)
    inst, jobs = _run_spec(params, streams, out,
                           draft_fn=_adversarial(by_first))
    for j, (f, _) in zip(jobs, streams):
        assert inst.outputs[j.request.rid] == [f] + by_first[f][:out]
        assert j.next_token == by_first[f][out - 1]
    assert inst.draft_accepted == 0
    assert inst.draft_proposed > 0
    assert 0 < inst.spec_steps < inst.steps
    assert len(inst.tbt_samples) == len(streams) * out
    assert len(inst.tbt_samples) / inst.row_steps == pytest.approx(1.0)


def test_default_ngram_drafter_bitparity(params):
    """The self-drafting n-gram drafter (draft_fn=None): whatever it
    proposes, the greedy verify keeps the output equal to plain decoding."""
    out = 10
    streams = [_handoff(params, n, seed=340 + i)
               for i, n in enumerate((32, 48))]
    by_first = _corpus(params, streams, out)
    inst, jobs = _run_spec(params, streams, out, draft_fn=None)
    for j, (f, _) in zip(jobs, streams):
        assert inst.outputs[j.request.rid] == [f] + by_first[f][:out]
        assert j.next_token == by_first[f][out - 1]
    assert inst.draft_accepted <= inst.draft_proposed


def test_mixed_accept_streams_in_one_batch(params):
    """One batch mixing an oracle-drafted stream with adversarial ones:
    per-row acceptance keeps them independent, all equal to plain."""
    out = 12
    streams = [_handoff(params, n, seed=350 + i)
               for i, n in enumerate((32, 48, 64))]
    by_first = _corpus(params, streams, out + K)
    lucky_first = streams[0][0]
    oracle, adversarial = _oracle(by_first), _adversarial(by_first)

    def mixed(rid, history, k):
        if history[0] == lucky_first:
            return oracle(rid, history, k)
        return adversarial(rid, history, k)

    inst, jobs = _run_spec(params, streams, out, draft_fn=mixed)
    for j, (f, _) in zip(jobs, streams):
        assert inst.outputs[j.request.rid] == [f] + by_first[f][:out]
    assert inst.draft_accepted > 0
    assert jobs[0].request.finish_time <= jobs[-1].request.finish_time


def test_spec_trajectory_matches_jax_plain_replay(bridged):
    """The port's oracle-drafted spec trajectory against the JAX reference's
    own plain greedy replay (prefill + decode_step) on the same weights."""
    jparams, tparams = bridged
    n, out = 48, 10
    toks = np.random.default_rng(390).integers(0, CFG.vocab_size, (1, n))
    logits, cache = jax_prefill(jparams, JCFG,
                                {"tokens": jnp.asarray(toks, jnp.int32)},
                                max_seq=MAX_SEQ)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [int(tok[0])]
    c = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
    step = jax.jit(lambda p, t, c: jax_decode_step(p, JCFG, t, c))
    for _ in range(out):
        lg, c = step(jparams, tok, c)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        want.append(int(tok[0]))
    f, hc = _handoff(tparams, n, seed=390)
    assert f == want[0]
    inst, jobs = _run_spec(tparams, [(f, hc)], out,
                           draft_fn=_oracle({f: want[1:] + [0] * K}))
    assert inst.outputs[jobs[0].request.rid] == want
    assert inst.draft_accepted > 0


# --- eviction / resume -------------------------------------------------------


def test_eviction_mid_draft_resumes_bitexact(params):
    """A tight-TBT arrival displaces a resident stream between verify steps;
    on resume the evicted stream still decodes exactly its replay."""
    pred = DecodeStepPredictor(prior=lambda b, c: 1e-4, ema_alpha=0.0)
    loose_s = [_handoff(params, 32, seed=360), _handoff(params, 48, seed=361)]
    tight_s = _handoff(params, 40, seed=362)
    by_first = _corpus(params, loose_s + [tight_s], 40 + K)
    inst = DecodeInstance(params, CFG, decode_tokens=8, decode_max_batch=2,
                          kv_block_size=64, policy="s-edf",
                          step_predictor=pred, spec_decode=True, draft_k=K,
                          draft_fn=_adversarial(by_first))
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
    assert [j.tokens_done for j in loose] == [40, 40]
    assert tight.tokens_done == 6
    for j, (f, _) in zip(loose, loose_s):
        assert j.history == [f] + by_first[f][:40]
        assert inst.outputs[j.request.rid] == [f] + by_first[f][:40]
    assert tight.next_token == by_first[tight_s[0]][5]


def _midstream_job(params, n, seed, done, target):
    """A job migrated in after `done` tokens: its cache holds the prompt and
    the first done - 1 decoded tokens (the last one is next_token)."""
    f, c = _handoff(params, n, seed=seed)
    want, _ = _replay(params, f, c, target + K)
    _, mid = _replay(params, f, c, done)
    req = Request(num_tokens=n, slo=100.0, arrival=0.0, output_tokens=target,
                  tbt_slo=100.0)
    job = DecodeJob(request=req, first_token=f, tokens_done=done,
                    next_token=want[done - 1],
                    cache={"k": mid["k"], "v": mid["v"], "pos": mid["pos"]})
    return f, want, job


def test_resumed_midstream_job_drafts_from_prior_history(params):
    """A job migrated in mid-stream (tokens_done > 0, no history yet)
    rebuilds its drafting state from the resume point and stays exact."""
    _, want, job = _midstream_job(params, 48, 370, 3, 8)

    def draft(rid, history, k):
        d = 3 + (len(history) - 1)               # tokens generated overall
        return want[d:d + k]

    inst = DecodeInstance(params, CFG, decode_tokens=8, decode_max_batch=2,
                          kv_block_size=64, spec_decode=True, draft_k=K,
                          draft_fn=draft)
    try:
        inst.submit(job)
        assert inst.drain(120.0)
    finally:
        inst.shutdown()
    assert job.tokens_done == 8
    assert job.next_token == want[7]
    assert inst.draft_accepted > 0


# --- the output record and the drafter's corpus ------------------------------


def test_outputs_stay_whole_past_the_history_cap(params, monkeypatch):
    """The drafter's corpus is the last _SPEC_HISTORY_CAP tokens of the
    stream; the output record is not capped."""
    monkeypatch.setattr(DI, "_SPEC_HISTORY_CAP", 6)
    out = 20
    f, c = _handoff(params, 40, seed=395)
    want, _ = _replay(params, f, c, out + K)
    job = _job(f, c, out)
    seen = []

    def draft(rid, history, k):                # oracle by the job's progress
        done = job.tokens_done
        seen.append((list(history), ([f] + want[:done])[-6:]))
        return want[done:done + k]

    inst = DecodeInstance(params, CFG, decode_tokens=out, decode_max_batch=1,
                          kv_block_size=64, spec_decode=True, draft_k=K,
                          draft_fn=draft)
    try:
        inst.submit(job)
        assert inst.drain(120.0)
    finally:
        inst.shutdown()
    assert inst.outputs[job.request.rid] == [f] + want[:out]
    assert len(seen) >= 3 and all(got == exp for got, exp in seen)
    assert job.history == ([f] + want[:out])[-6:]
    assert inst.draft_accepted > 0


def test_resumed_job_keeps_its_output_record(params):
    """A job resumed from another instance carries its output record, so
    `outputs` is the whole trajectory, while the drafter sees the corpus the
    reference gives it: from the resume point (next_token) on."""
    f, want, job = _midstream_job(params, 48, 371, 3, 8)
    job.output = [f] + want[:3]                # the source instance's record
    seen = []

    def draft(rid, history, k):
        seen.append(list(history))
        d = 3 + (len(history) - 1)
        return want[d:d + k]

    inst = DecodeInstance(params, CFG, decode_tokens=8, decode_max_batch=2,
                          kv_block_size=64, spec_decode=True, draft_k=K,
                          draft_fn=draft)
    try:
        inst.submit(job)
        assert inst.drain(120.0)
    finally:
        inst.shutdown()
    assert inst.outputs[job.request.rid] == [f] + want[:8]
    assert seen[0] == [want[2]]                # corpus starts at the resume
    assert job.history == want[2:8]


# --- shape families ----------------------------------------------------------


def test_spec_shapes_bounded_by_two_shape_families(params):
    """With speculation on, two step families exist — the plain S = 1 step
    and the S = k+1 verify step; sweeping resident populations stays within
    |batch buckets| x |width buckets| shapes per family."""
    by_first = {}

    def flaky(rid, history, k):
        seq = by_first[history[0]]
        done = len(history) - 1
        if done % 2 == 0:
            return seq[done:done + k]
        return [(seq[done] + 1) % CFG.vocab_size] if done < len(seq) else []

    rounds = []
    seed = 400
    for n_streams in (1, 2, 3, 5, 8):
        streams = []
        for _ in range(n_streams):
            f, c = _handoff(params, 32 + 16 * (seed % 2), seed)
            seed += 1
            streams.append((f, c))
        wants = [_replay(params, f, c, 4 + K)[0] for f, c in streams]
        for (f, _), want in zip(streams, wants):
            by_first[f] = want
        rounds.append((streams, wants))

    inst = DecodeInstance(params, CFG, decode_tokens=4, decode_max_batch=8,
                          kv_block_size=64, batch_buckets=(1, 2, 4, 8),
                          spec_decode=True, draft_k=K, draft_fn=flaky,
                          spec_throttle=0.0)
    try:
        for streams, wants in rounds:
            jobs = [_job(f, c, 4) for f, c in streams]
            for j in jobs:
                inst.submit(j)
            assert inst.drain(120.0)
            for j, (f, _), want in zip(jobs, streams, wants):
                assert inst.outputs[j.request.rid] == [f] + want[:4]
        n_widths = 1     # 32/48-token prompts + short targets: one 64 block
        assert 0 < inst.compile_cache_size() <= 2 * 4 * n_widths
        assert {s[2] for s in inst._shapes} == {1, K + 1}
    finally:
        inst.shutdown()


# --- spec off is off ---------------------------------------------------------


def test_spec_off_leaves_plain_path_untouched(params):
    """A plain instance carries no speculative state: no verify shape run,
    counters zero, no drafter corpus built."""
    f, c = _handoff(params, 48, seed=380)
    want, _ = _replay(params, f, c, 6)
    inst = DecodeInstance(params, CFG, decode_tokens=6, decode_max_batch=2,
                          kv_block_size=64)
    assert inst.spec_decode is False
    job = _job(f, c, 6)
    try:
        inst.submit(job)
        assert inst.drain(60.0)
    finally:
        inst.shutdown()
    assert job.next_token == want[-1]
    assert inst.outputs[job.request.rid] == [f] + want
    assert (inst.spec_steps, inst.draft_proposed, inst.draft_accepted) \
        == (0, 0, 0)
    assert job.history is None
    assert 0 < inst.compile_cache_size() <= 4
    assert {s[2] for s in inst._shapes} == {1}
    assert len(inst.tbt_samples) == inst.row_steps == 6


def test_expected_accept_tokens_surface():
    """The analytic E[tokens/step] that the runtime EMA and pricing share:
    exact at the endpoints, monotone in accept rate, capped at k+1."""
    assert expected_accept_tokens(0.0, K) == 1.0
    assert expected_accept_tokens(1.0, K) == K + 1
    assert expected_accept_tokens(0.5, 0) == 1.0
    assert expected_accept_tokens(0.5, 2) == pytest.approx(1.75)
    es = [expected_accept_tokens(a / 10, K) for a in range(11)]
    assert all(lo <= hi for lo, hi in zip(es, es[1:]))
    assert all(1.0 <= e <= K + 1 for e in es)
    assert expected_accept_tokens(-0.3, K) == 1.0
    assert expected_accept_tokens(1.7, K) == K + 1


def test_launcher_serves_with_spec_decode_and_reports_spec():
    """`build(spec_decode=True)` wires the option into the decode instance,
    and the proxy's report carries the reference's `spec` keys."""
    from repro_torch.launch.serve import build, serve_trace
    dep = build(device="cpu", max_seq=512, decode_tokens=6,
                decode_max_batch=2, spec_decode=True, draft_k=3)
    try:
        assert dep.decode.spec_decode and dep.decode.draft_k == 3
        rep = serve_trace(dep, requests=3, seed=0, arrival_mean_s=0.01)
    finally:
        dep.shutdown()
    assert rep["decoded"] == rep["n_requests"] == 3
    spec = rep["spec"]
    assert set(spec) == {"spec_steps", "draft_proposed", "draft_accepted",
                         "accept_rate", "tokens_per_step",
                         "step_latency_mean"}
    assert spec["tokens_per_step"] >= 1.0
    assert spec["draft_accepted"] <= spec["draft_proposed"]
