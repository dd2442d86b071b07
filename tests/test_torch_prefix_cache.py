"""The port's prefix sharing against the JAX package on the CPU: the
share-mode `PagedKVCache` scenarios of tests/test_prefix_cache.py driven
through both pools with the same ops and data (accounting, tables and pool
contents bit-equal), the allocator conservation property of
tests/test_property.py in plain and share mode, `SegmentedPrefill.start`
resumed over a cached prefix against the JAX `start`, and the runtime
tests: the tiny prefix-sharing `PrefillInstance`, the proxy's
prefix-affinity routing and a share-mode decode instance.

Tolerances: the pools hold copies of the same f32 inputs, so they are
compared bit for bit; prefix-resumed logits and caches at 2e-4, the bound
tests/test_torch_segments.py holds the port's prefill to the JAX one."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.models.segments import SegmentedPrefill as JaxSegmentedPrefill
from repro.serving.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.configs.base import get_tiny_config
from repro_torch.core import Request, SchedulerCore, TTFTPredictor
from repro_torch.core.prefixcache import block_keys, chain_extend
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.params import from_jax_params, init_params
from repro_torch.serving.decode_instance import DecodeInstance, DecodeJob
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.prefill_instance import PrefillInstance
from repro_torch.serving.proxy import Proxy


# --- share-mode pool against the JAX pool ------------------------------------


class _Jax:
    """One side of the pool comparison: how to build a pool and move
    numpy data in and out of it."""

    @staticmethod
    def pool(**kw):
        return JaxPagedKVCache(**kw)

    arr = staticmethod(jnp.asarray)
    host = staticmethod(np.asarray)


class _Torch:
    @staticmethod
    def pool(**kw):
        return PagedKVCache(device="cpu", **kw)

    arr = staticmethod(torch.from_numpy)

    @staticmethod
    def host(x):
        return x.numpy()


def _kv(T, seed=0, layers=2, heads=2, hd=4):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((layers, T, heads, hd)).astype(np.float32)
    return k, k + 1000


def _snap(side, cache, seqs):
    """What a pool shows: accounting, each live table, and each live
    sequence's gathered KV."""
    out = [("acct", cache.accounting()), ("cached", cache.cached_blocks),
           ("free", cache.free_blocks)]
    for sid in seqs:
        t = cache.table(sid)
        if t is None:
            continue
        k, v, n = cache.gather(sid)
        out.append((sid, list(t.blocks), t.length, t.prefix_blocks, n,
                    side.host(k)[:, :n], side.host(v)[:, :n]))
    return out


def _scenario_roundtrip(side):
    """tests/test_prefix_cache.py:170: a second prompt with the same leading
    tokens reads the first prompt's cached KV through its own table."""
    cache = side.pool(num_layers=2, num_blocks=16, block_size=4,
                      num_kv_heads=2, head_dim=4, prefix_share=True)
    toks = np.arange(10)
    keys = block_keys(toks, 4)
    obs = [("alloc", cache.allocate(0, 10, keys=keys).length)]
    k, v = _kv(10)
    cache.write_prompt(0, side.arr(k), side.arr(v))
    obs += _snap(side, cache, [0])
    cache.insert(0, keys)
    cache.free(0)
    toks2 = np.concatenate([toks[:8], np.arange(100, 106)])
    keys2 = block_keys(toks2, 4)
    obs.append(("probe", cache.probe(keys2)))
    cache.allocate(1, 14, keys=keys2)
    obs += _snap(side, cache, [1])
    k2, v2 = _kv(6, seed=1)
    cache.write_prompt(1, side.arr(k2), side.arr(v2), start=8)
    obs += _snap(side, cache, [1])
    cache.insert(1, keys2)
    cache.free(1)
    return cache, obs + _snap(side, cache, [])


def _scenario_copy_on_write(side):
    """tests/test_prefix_cache.py:209: a write into a shared block gives
    the writer a private copy that carries the rest of the block over."""
    cache = side.pool(num_layers=2, num_blocks=16, block_size=4,
                      num_kv_heads=2, head_dim=4, prefix_share=True)
    keys = block_keys(np.arange(8), 4)
    cache.allocate(0, 8, keys=keys)
    k, v = _kv(8)
    cache.write_prompt(0, side.arr(k), side.arr(v))
    cache.insert(0, keys)
    obs = [("hit", cache.allocate(1, 8, keys=keys).prefix_blocks)]
    cache.write(1, 5, side.arr(np.full((2, 2, 4), 7.0, np.float32)),
                side.arr(np.full((2, 2, 4), 9.0, np.float32)))
    obs += _snap(side, cache, [0, 1])
    cache.free(0)
    cache.free(1)
    return cache, obs + _snap(side, cache, [])


def _scenario_lru(side):
    """tests/test_prefix_cache.py:234: LRU eviction under pressure takes
    the least recent unpinned chain and spares the pinned one."""
    cache = side.pool(num_layers=1, num_blocks=8, block_size=4,
                      num_kv_heads=1, head_dim=2, prefix_share=True)
    chains = [chain_extend((), range(2), salt=s) for s in range(4)]
    for s in range(3):
        cache.allocate(s, 8, keys=chains[s])
        k, v = _kv(8, seed=10 + s, layers=1, heads=1, hd=2)
        cache.write_prompt(s, side.arr(k), side.arr(v))
        cache.insert(s, chains[s])
        cache.free(s)
    obs = [("cached", cache.cached_blocks)]
    obs.append(("pin", cache.allocate(10, 8, keys=chains[0]).prefix_blocks))
    cache.allocate(11, 16, keys=chain_extend((), range(4), salt=9))
    obs.append(("probes", [cache.probe(c) for c in chains]))
    obs += _snap(side, cache, [10, 11])
    cache.free(10)
    cache.free(11)
    return cache, obs + _snap(side, cache, [])


def _scenario_grow(side):
    """tests/test_prefix_cache.py:259: capped geometric growth in plain
    mode; in share mode eviction of cached blocks comes before growth."""
    cache = side.pool(num_layers=1, num_blocks=4, block_size=4,
                      num_kv_heads=1, head_dim=2, max_blocks=16)
    cache.allocate(0, 16)
    obs = [("free", cache.free_blocks)]
    cache.extend(0, 17)
    obs.append(("nb", cache.num_blocks))
    cache.extend(0, 64)
    obs.append(("nb", cache.num_blocks, tuple(cache.k_pool.shape)))
    with pytest.raises(MemoryError):
        cache.extend(0, 65)
    c2 = side.pool(num_layers=1, num_blocks=4, block_size=4,
                   num_kv_heads=1, head_dim=2, prefix_share=True)
    keys = chain_extend((), range(2), salt=0)
    c2.allocate(0, 8, keys=keys)
    c2.insert(0, keys)
    c2.free(0)
    c2.allocate(1, 8)
    c2.extend(1, 16)
    obs.append(("c2", c2.num_blocks, c2.cached_blocks))
    c2.extend(1, 17)                          # past the pool: grows
    obs += _snap(side, c2, [1])
    return c2, obs + _snap(side, cache, [0])


def _scenario_batched_writes(side):
    """`write_tokens` and `write_token_span` into a shared prefix copy the
    shared blocks first, and `gather_batch` reads both chains."""
    cache = side.pool(num_layers=2, num_blocks=16, block_size=4,
                      num_kv_heads=2, head_dim=4, prefix_share=True)
    keys = block_keys(np.arange(12), 4)
    cache.allocate(0, 12, keys=keys)
    k, v = _kv(12)
    cache.write_prompt(0, side.arr(k), side.arr(v))
    cache.insert(0, keys)
    cache.allocate(1, 12, keys=keys)
    cache.allocate(2, 12, keys=keys)
    kt, vt = _kv(2, seed=3)                   # (L, B=2, K, hd)
    cache.write_tokens([1, 2], [6, 11], side.arr(kt),
                       side.arr(vt))
    cache.extend(2, 4)
    ks = np.random.default_rng(4).standard_normal(
        (2, 2, 3, 2, 4)).astype(np.float32)
    cache.write_token_span([1, 2], [9, 12], [2, 1], side.arr(ks),
                           side.arr(ks + 5))
    kb, vb, lens = cache.gather_batch([0, 1, 2])
    obs = _snap(side, cache, [0, 1, 2])
    obs.append(("batch", side.host(kb), side.host(vb), list(lens)))
    return cache, obs


POOL_SCENARIOS = {"roundtrip": _scenario_roundtrip,
                  "copy_on_write": _scenario_copy_on_write,
                  "lru_spares_pins": _scenario_lru,
                  "grow_with_cap": _scenario_grow,
                  "batched_writes": _scenario_batched_writes}


def _assert_same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("name", sorted(POOL_SCENARIOS))
def test_share_mode_pool_matches_jax(name):
    """The same op sequence and data through the JAX pool and the port's:
    every observation (accounting, tables, gathered KV) and both whole
    pools are equal bit for bit."""
    jcache, jobs = POOL_SCENARIOS[name](_Jax)
    tcache, tobs = POOL_SCENARIOS[name](_Torch)
    _assert_same(tobs, jobs)
    np.testing.assert_array_equal(tcache.k_pool.numpy(),
                                  np.asarray(jcache.k_pool))
    np.testing.assert_array_equal(tcache.v_pool.numpy(),
                                  np.asarray(jcache.v_pool))
    free, live, cached, total = tcache.accounting()
    assert free + live + cached == total


# --- allocator conservation (tests/test_property.py:87) ----------------------


@pytest.mark.parametrize("share", [False, True])
@given(ops=st.lists(st.tuples(st.integers(1, 300), st.booleans(),
                              st.integers(0, 3)),
                    min_size=1, max_size=30))
@settings(max_examples=40, deadline=None)
def test_kvcache_allocator_conservation(share, ops):
    """Plain mode as the reference has it: free + live == total and no
    block in two tables. Share mode: sequences draw their keys from four
    chains (so prompts share prefixes), completed ones register and free,
    and `accounting()` (which runs the manager's check) balances after
    every op."""
    cache = PagedKVCache(2, 64, 16, 2, 8, device="cpu", prefix_share=share)
    chains = [chain_extend((), range(20), salt=s) for s in range(4)]
    total = cache.num_blocks
    live = {}
    sid = 0
    for tokens, do_free, chain in ops:
        keys = chains[chain][:tokens // 16] if share else None
        if cache.can_allocate(tokens):
            live[sid] = (cache.allocate(sid, tokens, keys=keys), keys)
            sid += 1
        if do_free and live:
            k = next(iter(live))
            if share:
                cache.insert(k, live[k][1])
            cache.free(k)
            del live[k]
        if share:
            free, n_live, cached, n = cache.accounting()
            assert free + n_live + cached == n == total
        else:
            used = [b for t, _ in live.values() for b in t.blocks]
            assert len(used) == len(set(used))
            assert cache.free_blocks + len(used) == total
    for k in list(live):
        cache.free(k)
    free, n_live, cached, _ = cache.accounting()
    assert n_live == 0 and free + cached == total


# --- prefix-resumed prefill against the JAX start ----------------------------

S = 48


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_tiny_config("llama3_8b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, S))
    return jcfg, jparams, params, tokens


@pytest.mark.parametrize("P,chunk", [(16, 0), (32, 16), (S - 1, 0),
                                     (S - 1, 16)])
def test_prefix_resumed_start_matches_jax(bridged, P, chunk):
    """Both executors resume at operator offset P over the same seeded
    prefix (the JAX cold run's first P cache rows): same segment count,
    logits and whole KV cache within 2e-4."""
    jcfg, jparams, params, tokens = bridged
    jex = JaxSegmentedPrefill(jparams, jcfg, max_seq=S, chunk_tokens=chunk)
    cold = jex.start(jnp.asarray(tokens))
    jex.run_all(cold)
    pk = np.array(cold.state["k_cache"])[:, :, :P]
    pv = np.array(cold.state["v_cache"])[:, :, :P]
    jtask = jex.start(jnp.asarray(tokens), prefix_len=P,
                      prefix_k=jnp.asarray(pk), prefix_v=jnp.asarray(pv))
    jlogits = jex.run_all(jtask)
    ex = SegmentedPrefill(params, get_tiny_config("llama3_8b"), max_seq=S,
                          chunk_tokens=chunk)
    task = ex.start(tokens, prefix_len=P, prefix_k=torch.from_numpy(pk),
                    prefix_v=torch.from_numpy(pv))
    logits = ex.run_all(task)
    assert task.total_segments == jtask.total_segments
    assert task.start_offset == P
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    for key in ("k_cache", "v_cache"):
        np.testing.assert_allclose(task.state[key].numpy(),
                                   np.asarray(jtask.state[key]), **tol)
    with pytest.raises(ValueError, match="live token"):
        ex.start(tokens, prefix_len=S, prefix_k=torch.zeros(1),
                 prefix_v=torch.zeros(1))


# --- the runtime -------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_instance():
    cfg = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=2,
                              d_model=128, d_ff=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pred = TTFTPredictor(coeffs=np.array([1e-6, 0.0]), floor=0.0)
    inst = PrefillInstance(
        params, cfg, SchedulerCore(predictor=pred, enable_batching=False),
        max_seq=1024, chunk_tokens=256, prefix_share=True,
        prefix_cache_blocks=256)
    yield inst, cfg
    inst.shutdown()


def _run_once(inst, toks):
    req = Request(num_tokens=len(toks), slo=600.0, arrival=time.monotonic())
    inst.submit_request(req, toks)
    assert inst.drain(600.0)
    return req


def test_runtime_cached_prefix_hits_and_matches_cold_logits(tiny_instance):
    """tests/test_prefix_cache.py:425: the second run of a 700-token prompt
    hits its five full blocks (640 tokens), its first-token logits match the
    cold run's within 2e-4, and the pool is leak-free afterwards."""
    inst, cfg = tiny_instance
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 700)
    cold = _run_once(inst, toks)
    assert cold.prefix_hit == 0
    warm = _run_once(inst, toks)
    assert warm.prefix_hit == 640
    lc = inst.completed_tasks[-2].prefill_task.logits
    lw = inst.completed_tasks[-1].prefill_task.logits
    assert inst.completed_tasks[-1].prefill_task.start_offset == 640
    np.testing.assert_allclose(lw.numpy(), lc.numpy(), rtol=2e-4, atol=2e-4)
    free, live, cached, total = inst.kv.accounting()
    assert free + live + cached == total and live == 0
    assert (inst.prefix_hits, inst.prefix_hit_tokens) == (1, 640)


def test_runtime_fully_cached_prompt_resumes_at_last_token(tiny_instance):
    """A prompt of whole blocks seen before resumes at n - 1: one query row
    over the cached prefix, logits within 2e-4 of its cold run."""
    inst, cfg = tiny_instance
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, 512)
    _run_once(inst, toks)
    warm = _run_once(inst, toks)
    assert warm.prefix_hit == 511
    task = inst.completed_tasks[-1].prefill_task
    assert task.start_offset == 511
    np.testing.assert_allclose(
        task.logits.numpy(), inst.completed_tasks[-2].prefill_task.logits
        .numpy(), rtol=2e-4, atol=2e-4)


def test_drain_waits_for_an_arrival_the_scheduler_has_dequeued(
        tiny_instance, monkeypatch):
    """The scheduler thread takes an ARRIVAL off the monitor's queue before
    it takes the instance lock; held in that gap, the request is in no
    queue. `drain` must still wait for it (the back-to-back prompts of the
    prefix tests rely on it: a drain that returns early lets the second
    prompt arrive before the first one published its blocks)."""
    inst, cfg = tiny_instance
    real = inst.monitor.next_event

    def slow_next_event(timeout=None):
        ev = real(timeout=timeout)
        if ev is not None:
            time.sleep(0.2)
        return ev

    monkeypatch.setattr(inst.monitor, "next_event", slow_next_event)
    time.sleep(1.2)                       # the loop's pending call times out
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, 100)
    req = Request(num_tokens=100, slo=600.0, arrival=time.monotonic())
    inst.submit_request(req, toks)
    time.sleep(0.05)                      # the event is dequeued by now
    assert inst.drain(60.0)
    assert req.first_token_time is not None


def test_stranded_request_releases_its_prefix_and_can_return(tiny_instance):
    """A crash strands a request that holds pinned prefix blocks: the strand
    unpins them (the pool is leak-free while the instance is down), and
    after `restart` the same request (same rid) is served again with its
    hit, where a pin left behind would make its re-allocation raise."""
    inst, cfg = tiny_instance
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, 300)
    _run_once(inst, toks)
    req = Request(num_tokens=300, slo=600.0, arrival=time.monotonic())
    inst.submit_request(req, toks)
    inst.inject_fault(RuntimeError("injected"))
    deadline = time.monotonic() + 60.0
    while inst.healthy and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not inst.healthy
    free, live, cached, total = inst.kv.accounting()
    assert live == 0 and free + cached == total
    inst.restart()
    inst.submit_request(req, toks)
    assert inst.drain(600.0) and inst.healthy, inst.last_error
    assert req.prefix_hit == 256
    assert inst.kv.accounting()[1] == 0


def test_runtime_proxy_prefix_affinity_routes_to_cache_holder():
    """tests/test_prefix_cache.py:470: with prefix-affinity dispatch the
    follow-up prompt lands on the instance that cached its prefix."""
    cfg = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=2,
                              d_model=64, d_ff=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pred = TTFTPredictor(coeffs=np.array([1e-5, 0.0]), floor=0.0)
    insts = [PrefillInstance(
        params, cfg, SchedulerCore(predictor=pred, enable_batching=False),
        max_seq=512, prefix_share=True, prefix_cache_blocks=64)
        for _ in range(2)]
    proxy = Proxy(insts, dispatch="prefix-affinity", predictor=pred,
                  capacities=[1e5, 1e5])
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, 256)
    try:
        req1 = Request(num_tokens=256, slo=60.0, arrival=time.monotonic())
        proxy.submit(req1, toks)
        assert proxy.drain(120.0)
        first = next(i for i, n in enumerate(proxy.dispatched) if n)
        toks2 = np.concatenate([toks, rng.integers(0, cfg.vocab_size, 128)])
        req2 = Request(num_tokens=384, slo=60.0, arrival=time.monotonic())
        proxy.submit(req2, toks2)
        assert proxy.drain(120.0)
        assert proxy.dispatched[first] == 2, "follow-up left the cache holder"
        assert req2.prefix_hit == 256
        rep = proxy.report()
        assert rep["prefix_hits"] == 1
        assert rep["prefix_hit_tokens"] == 256
        assert rep["prefix_promoted_tokens"] == 0
    finally:
        proxy.shutdown()


def test_decode_instance_share_mode_drains_leak_free():
    """A decode instance whose pool is in share mode decodes three streams
    to the same tokens as a plain-mode instance, and once drained every
    block is free or cached (free is a refcount decrement)."""
    cfg = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ex = SegmentedPrefill(params, cfg, max_seq=128)
    handoffs = []
    for i, n in enumerate((40, 72, 17)):
        toks = np.random.default_rng(20 + i).integers(0, cfg.vocab_size,
                                                      (1, n))
        task = ex.start(toks)
        first = int(ex.run_all(task).argmax(-1)[0])
        handoffs.append((first, {"k": task.state["k_cache"],
                                 "v": task.state["v_cache"], "pos": n}))
    outs = {}
    for share in (False, True):
        inst = DecodeInstance(params, cfg, decode_tokens=6,
                              decode_max_batch=4, kv_block_size=16,
                              prefix_share=share)
        reqs = [Request(num_tokens=c["pos"], slo=100.0,
                        arrival=time.monotonic(), output_tokens=6)
                for _, c in handoffs]
        try:
            with inst._cv:
                for r, (first, cache) in zip(reqs, handoffs):
                    inst.submit(DecodeJob(request=r, cache=dict(cache),
                                          first_token=first))
            assert inst.drain(120.0)
        finally:
            inst.shutdown()
        assert inst.healthy, inst.last_error
        outs[share] = [inst.outputs[r.rid] for r in reqs]
        free, live, cached, total = inst.kv.accounting()
        assert free + live + cached == total
        assert live == 1                   # the scratch sequence alone
        assert inst.kv.prefix_share is share
    assert outs[True] == outs[False]
