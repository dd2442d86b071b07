"""The port's colocated `HybridInstance` against the JAX package on the CPU:
the five runtime cases of tests/test_hybrid.py (local decode parity, a
warm prefix hit, a prefill-only request, the offload handoff, a tight
budget) and pool growth while streams decode, on the reference's tiny
config in f32 with the weights bridged from the JAX `init_params`.

Every emitted trajectory must equal both the JAX dense reference (prefill,
then a greedy `decode_step` loop) and the JAX `HybridInstance`'s trajectory
on the same prompts. Equal greedy tokens can hide drift, so each request's
prompt KV in the pool, read when its prefill publishes, is held to the JAX
hybrid pool's at 2e-4 (the bound tests/test_torch_segments.py holds the
port's prefill to). The plan and property tests of tests/test_hybrid.py
exercise `core/scheduler.py`, which the port copies verbatim
(tests/test_torch_isolation.py), so they are not repeated here."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.core import Request as JaxRequest
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step, prefill
from repro.serving.decode_instance import DecodeInstance as JaxDecodeInstance
from repro.serving.hybrid_instance import HybridInstance as JaxHybridInstance
from repro_torch.configs.base import get_tiny_config
from repro_torch.core import Request
from repro_torch.params import from_jax_params
from repro_torch.serving.decode_instance import DecodeInstance
from repro_torch.serving.hybrid_instance import HybridInstance

JCFG = dataclasses.replace(jax_tiny_config("llama3_8b"),
                           num_layers=2, d_model=128, d_ff=256)
CFG = dataclasses.replace(get_tiny_config("llama3_8b"),
                          num_layers=2, d_model=128, d_ff=256)
MAX_SEQ = 128
PROMPT = 64
OUT = 5
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def models():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, params


def _tokens(seed, n=PROMPT):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, n).astype(np.int32)


_decode_step = jax.jit(lambda p, t, c: decode_step(p, JCFG, t, c))


def _reference(jparams, toks, n_out):
    """The standalone engines' answer (tests/test_hybrid.py:286): dense
    prefill + greedy decode_step loop (the step jitted, as the JAX decode
    instance runs it)."""
    logits, cache = prefill(jparams, JCFG, {"tokens": jnp.asarray(toks[None])},
                            max_seq=MAX_SEQ)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [int(tok[0])]
    c = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
    for _ in range(n_out):
        logits, c = _decode_step(jparams, tok, c)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(int(tok[0]))
    return out


class _Side:
    """One implementation: its instance class, config, request class, and
    how to read a pool tensor to numpy."""

    def __init__(self, cls, cfg, request, host):
        self.cls, self.cfg, self.request, self.host = cls, cfg, request, host


JAX = _Side(JaxHybridInstance, JCFG, JaxRequest, np.asarray)
PORT = _Side(HybridInstance, CFG, Request, lambda t: t.numpy())


def _make(side, params, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("token_budget", 256)
    kw.setdefault("chunk_tokens", 32)
    kw.setdefault("decode_max_batch", 4)
    kw.setdefault("decode_cadence", 0.002)
    kw.setdefault("kv_block_size", 16)
    kw.setdefault("kv_pool_blocks", 64)
    kw.setdefault("prefix_share", False)
    inst = side.cls(params, side.cfg, **kw)
    # each prefill's prompt KV as the pool holds it when it publishes, and
    # its first token, keyed by rid
    inst.published = {}
    publish = inst._publish

    def recording_publish(ps, now):
        first = publish(ps, now)
        with inst._kv_lock:
            k, v, _ = inst.kv.gather(ps.request.rid)
        n = len(ps.tokens)
        inst.published[ps.request.rid] = (
            first, side.host(k)[:, :n], side.host(v)[:, :n])
        return first

    inst._publish = recording_publish
    return inst


def _req(side, out_tokens=OUT, slo=30.0, tbt=10.0):
    return side.request(num_tokens=PROMPT, slo=slo, arrival=time.monotonic(),
                        output_tokens=out_tokens, tbt_slo=tbt)


def _run(side, params, seeds, out_tokens=OUT, **kw):
    """Submit one request per seed at once, drain; returns the instance and
    the requests in seed order."""
    inst = _make(side, params, **kw)
    try:
        reqs = []
        for seed in seeds:
            r = _req(side, out_tokens)
            reqs.append(r)
            inst.submit(r, _tokens(seed))
        assert inst.drain(120.0), "hybrid instance did not drain"
    finally:
        inst.shutdown()
    return inst, reqs


def _trajectories(inst, reqs):
    got = {j.request.rid: j.emitted for j in inst.finished_jobs}
    return [got[r.rid] for r in reqs]


def _same_published(port, preqs, jax_, jreqs):
    """The port's pool KV and first token at each publish against the JAX
    hybrid's for the same prompt."""
    for pr, jr in zip(preqs, jreqs):
        first, k, v = port.published[pr.rid]
        jfirst, jk, jv = jax_.published[jr.rid]
        assert first == jfirst
        np.testing.assert_allclose(k, jk, **TOL)
        np.testing.assert_allclose(v, jv, **TOL)


def test_local_decode_parity(models):
    """3 concurrent requests prefill AND decode on one hybrid worker; every
    emitted trajectory equals the dense reference and the JAX hybrid's."""
    jparams, params = models
    seeds = (0, 1, 2)
    port, preqs = _run(PORT, params, seeds)
    jax_, jreqs = _run(JAX, jparams, seeds)
    assert port.rounds > 0 and port.steps > 0
    got = _trajectories(port, preqs)
    assert got == _trajectories(jax_, jreqs)
    for seed, traj, r in zip(seeds, got, preqs):
        assert traj == _reference(jparams, _tokens(seed), OUT), seed
        assert r.finish_time is not None and r.first_token_time is not None
        assert len(traj) == OUT + 1
    _same_published(port, preqs, jax_, jreqs)
    assert 1 <= port.compile_cache_size() <= 3


def test_prefix_share_warm_parity(models):
    """Resubmitting a prompt hits the trie-cached blocks (suffix-only
    compute) and still emits the identical trajectory."""
    jparams, params = models
    t = _tokens(7)
    runs = {}
    for name, side, p in (("port", PORT, params), ("jax", JAX, jparams)):
        inst = _make(side, p, prefix_share=True)
        try:
            a = _req(side)
            inst.submit(a, t)
            assert inst.drain(120.0)
            assert inst.prefix_hits == 0
            b = _req(side)
            inst.submit(b, t)
            assert inst.drain(120.0)
        finally:
            inst.shutdown()
        runs[name] = (inst, [a, b])
    port, preqs = runs["port"]
    assert port.prefix_hits == 1
    # block size 16, 64-token prompt: all 4 blocks cached, hit capped n-1
    assert port.prefix_hit_tokens == PROMPT - 1
    assert preqs[1].prefix_hit == PROMPT - 1
    want = _reference(jparams, t, OUT)
    got = _trajectories(port, preqs)
    assert got == [want, want], "warm (prefix-hit) trajectory diverged"
    assert got == _trajectories(*runs["jax"])
    _same_published(port, preqs, *runs["jax"])


def test_tier_promotion_resumes_to_reference(models):
    """A prompt whose cached blocks two later prompts push into the host
    tier is promoted back at its resubmission (begun at arrival, settled at
    its first slice) and resumes from them: its trajectory equals the
    reference and the JAX hybrid's, and the pool balances."""
    jparams, params = models
    seeds = (40, 41, 42, 40)
    runs = {}
    for name, side, p in (("port", PORT, params), ("jax", JAX, jparams)):
        # 10 blocks of 16 beside the scratch row: two 70-token lifetimes
        inst = _make(side, p, prefix_share=True, kv_pool_blocks=11,
                     host_cache_blocks=16)
        try:
            reqs = []
            for seed in seeds:
                reqs.append(_req(side))
                inst.submit(reqs[-1], _tokens(seed))
                assert inst.drain(120.0)
        finally:
            inst.shutdown()
        runs[name] = (inst, reqs)
    port, preqs = runs["port"]
    assert preqs[-1].prefix_hit == PROMPT - 1
    assert port.prefix_promotions == runs["jax"][0].prefix_promotions == 4
    assert port.prefix_promoted_tokens == PROMPT - 1
    got = _trajectories(port, preqs)
    assert got == _trajectories(*runs["jax"])
    assert got == [_reference(jparams, _tokens(s), OUT) for s in seeds]
    _same_published(port, preqs, *runs["jax"])
    free, live, cached, total = port.kv.accounting()
    assert (free + cached, live) == (total - 1, 1), "promotion leaked blocks"
    assert port.kv.tier_stats()["in_flight"] == 0


def test_prefill_only_request_frees_pool(models):
    """output_tokens=0 is a prefill-only request (fig24's concurrent-prefill
    pressure): it completes without joining decode and returns its blocks;
    its first token and prompt KV equal the JAX hybrid's."""
    jparams, params = models
    port, preqs = _run(PORT, params, (9,), out_tokens=0)
    jax_, jreqs = _run(JAX, jparams, (9,), out_tokens=0)
    r = preqs[0]
    assert r in port.prefilled and not port.finished
    assert r.first_token_time is not None
    free, live, cached, total = port.kv.accounting()
    assert free + live + cached == total
    assert (free, live) == (total - 1, 1), "prefill-only leaked pool blocks"
    assert port.published[r.rid][0] == _reference(jparams, _tokens(9), 0)[0]
    _same_published(port, preqs, jax_, jreqs)


def test_offload_handoff_matches_reference(models):
    """Mixed-pool mode: the dense cache `_offload` hands over feeds the
    port's DecodeInstance to the reference trajectory, and equals the cache
    the JAX hybrid hands over."""
    jparams, params = models
    t = _tokens(11)
    want = _reference(jparams, t, OUT)
    handed = {}
    for name, side, p in (("port", PORT, params), ("jax", JAX, jparams)):
        jobs = []
        _run(side, p, (11,), on_decode_ready=jobs.append)
        assert len(jobs) == 1 and jobs[0].first_token == want[0]
        assert int(jobs[0].cache["pos"]) == PROMPT
        handed[name] = jobs[0]
    job = handed["port"]
    assert job.cache["ready"] is None          # no event on the CPU
    k = job.cache["k"].numpy()
    assert k.shape[2] >= PROMPT + OUT + 1
    np.testing.assert_allclose(
        k[:, 0, :PROMPT], np.asarray(handed["jax"].cache["k"])[:, 0, :PROMPT],
        **TOL)
    np.testing.assert_allclose(
        job.cache["v"].numpy()[:, 0, :PROMPT],
        np.asarray(handed["jax"].cache["v"])[:, 0, :PROMPT], **TOL)
    dec = DecodeInstance(params, CFG, decode_tokens=OUT, decode_max_batch=1)
    jdec = JaxDecodeInstance(jparams, JCFG, decode_tokens=OUT,
                             decode_max_batch=1)
    try:
        dec.submit(job)
        jdec.submit(handed["jax"])
        assert dec.drain(60.0) and jdec.drain(60.0)
    finally:
        dec.shutdown()
        jdec.shutdown()
    assert dec.outputs[job.request.rid] == want
    assert handed["jax"].next_token == want[-1]


def test_tight_budget_still_completes(models):
    """A budget smaller than one chunk (prefill slices truncated every
    round) still drains everything, never starves the decode batch, and
    emits the same tokens as the JAX hybrid and the reference."""
    jparams, params = models
    seeds = (20, 21)
    kw = dict(token_budget=24, chunk_tokens=16)
    port, preqs = _run(PORT, params, seeds, out_tokens=3, **kw)
    jax_, jreqs = _run(JAX, jparams, seeds, out_tokens=3, **kw)
    assert len(port.finished) == 2
    got = _trajectories(port, preqs)
    assert all(len(traj) == 4 for traj in got)
    assert all(r.mean_tpot is not None for r in preqs)
    assert got == _trajectories(jax_, jreqs)
    assert got == [_reference(jparams, _tokens(s), 3) for s in seeds]
    _same_published(port, preqs, jax_, jreqs)


# prompts whose greedy top-2 logit gaps stay above 0.02 over GROW_OUT
# tokens in the JAX dense reference: a longer f32 trajectory meets near-ties
# (seed 31: a gap of 5.9e-4 at token 6), where the JAX hybrid itself departs
# from the JAX dense reference
GROW_SEEDS = (30, 34, 35)
GROW_OUT = 24


def _grow_during_decode(side, params):
    """Two streams fill the pool and decode; a third arrives while they do,
    and its arrival-time allocation must grow the pool from the submitting
    thread."""
    out_tokens = GROW_OUT
    blocks = 2 * -(-(PROMPT + out_tokens + 1) // 16) + 1     # + scratch
    inst = _make(side, params, kv_pool_blocks=blocks)
    try:
        reqs = [_req(side, out_tokens) for _ in range(3)]
        for r, seed in zip(reqs[:2], GROW_SEEDS[:2]):
            inst.submit(r, _tokens(seed))
        deadline = time.monotonic() + 60.0
        while inst.resident() < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert inst.resident() == 2
        inst.submit(reqs[2], _tokens(GROW_SEEDS[2]))
        assert inst.drain(120.0)
    finally:
        inst.shutdown()
    assert inst.kv.num_blocks > blocks
    return inst, reqs


def test_pool_growth_during_decode(models):
    """The pool grows while streams decode (from the submitting thread,
    under the pool lock, on the pool's stream); every trajectory still
    equals the reference and the JAX hybrid's, and the pool balances."""
    jparams, params = models
    port, preqs = _grow_during_decode(PORT, params)
    jax_, jreqs = _grow_during_decode(JAX, jparams)
    got = _trajectories(port, preqs)
    assert got == _trajectories(jax_, jreqs)
    assert got == [_reference(jparams, _tokens(s), GROW_OUT)
                   for s in GROW_SEEDS]
    _same_published(port, preqs, jax_, jreqs)
    free, live, cached, total = port.kv.accounting()
    assert (free, live, cached) == (total - 1, 1, 0)
