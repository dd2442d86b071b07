"""The port's KV tiers (HBM -> host -> disk) on the CPU: the pool-level
tests of tests/test_tiered_kv.py (promoted KV bit-equal to the demoted KV
across host and disk, a corrupt or lost copy leads to recompute, an
injected failure returns the key to its tier, engine shutdown with copies
in flight, the re-eviction race), the host copy's checksum against the
reference's `block_checksum` over the same values in f32 and bf16, a
demoted block overwritten while its copy waits, and a tiered
`PrefillInstance` that promotes a demoted prompt back.

The host tiers keep raw bytes, so every round trip is compared bit for
bit."""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tieredcache import block_checksum as ref_block_checksum
from repro_torch.configs.base import get_tiny_config
from repro_torch.core import Request, SchedulerCore, TTFTPredictor
from repro_torch.core.prefixcache import block_keys, chain_extend
from repro_torch.core.tieredcache import BlockCopyEngine, block_checksum
from repro_torch.params import init_params
from repro_torch.serving.kvcache import PagedKVCache, raw_bytes
from repro_torch.serving.prefill_instance import PrefillInstance

# deterministic chain universe, as tests/test_tiered_kv.py's
_CHAINS = [chain_extend((), range(10), salt=s) for s in range(4)]


def _tiered_cache(**kw):
    kw.setdefault("host_cache_blocks", 16)
    return PagedKVCache(num_layers=2, num_blocks=4, block_size=4,
                        num_kv_heads=2, head_dim=4, prefix_share=True,
                        device="cpu", **kw)


def _prompt(cache, sid, keys, n_tokens, seed):
    """Allocate + write a prompt, then commit it to the trie and release."""
    t = cache.allocate(sid, n_tokens, keys=keys)
    hit = t.length
    if hit < n_tokens:
        rng = np.random.default_rng(seed)
        shape = (2, n_tokens - hit, 2, 4)
        k = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        cache.write_prompt(sid, k.to(cache.k_pool.dtype),
                           v.to(cache.v_pool.dtype), start=hit)
    cache.insert(sid, keys)
    cache.free(sid)
    return hit


def _demote_chain0(cache):
    """Cache chain 0's four blocks, then push them all into the host tier
    with two filler prompts."""
    keys = _CHAINS[0][:4]
    _prompt(cache, 0, keys, 16, seed=1)
    _prompt(cache, 1, _CHAINS[1][:4], 16, seed=2)
    _prompt(cache, 2, _CHAINS[2][:4], 16, seed=3)
    assert cache._engine.drain(10.0)
    return keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_promoted_kv_bitmatches_demoted(dtype):
    """tests/test_tiered_kv.py:311: HBM -> host -> disk -> HBM. The host
    tier holds 8 of the 12 demoted blocks, so the probe chain's 4 (the
    oldest) go on to disk and the round trip crosses both cold tiers; the
    promoted blocks equal the originals bit for bit."""
    cache = _tiered_cache(host_cache_blocks=8, disk_cache_blocks=16,
                          dtype=dtype)
    try:
        keys = _CHAINS[0][:4]
        _prompt(cache, 0, keys, 16, seed=1)
        want_k, want_v = cache.k_pool.clone(), cache.v_pool.clone()
        blocks_of = {k: cache._mgr._trie[k] for k in keys}
        _prompt(cache, 1, _CHAINS[1][:4], 16, seed=2)
        _prompt(cache, 2, _CHAINS[2][:4], 16, seed=3)
        _prompt(cache, 3, _CHAINS[3][:4], 16, seed=4)
        assert cache._engine.drain(10.0)
        assert cache.probe(keys) == 0
        _, host_t, disk_t = cache.probe_tiers(keys)
        assert host_t + disk_t == 16 and disk_t > 0
        ticket = cache.promote_async(keys)
        assert ticket.wait(10.0)
        assert cache.promote_settle(ticket) == 4
        assert cache.probe(keys) == 16
        for k in keys:
            b_new, b_old = cache._mgr._trie[k], blocks_of[k]
            assert torch.equal(cache.k_pool[:, b_new], want_k[:, b_old])
            assert torch.equal(cache.v_pool[:, b_new], want_v[:, b_old])
        cache._mgr.check()
        stats = cache.tier_stats()
        assert stats["promotions"] == 4 and stats["spills"] >= 4
    finally:
        cache.close()


def test_corrupt_host_copy_falls_back_to_recompute():
    """tests/test_tiered_kv.py:351: a host copy whose bytes rotted fails
    its checksum at promotion; the entry is dropped (never probed again,
    never written into the pool) and the prompt recomputes."""
    cache = _tiered_cache()
    try:
        keys = _demote_chain0(cache)
        victim = keys[1]
        with cache._store_lock:
            k_raw, v_raw, crc, dtype = cache._host_store[victim]
            k_bad = k_raw.copy()
            k_bad.ravel()[0] ^= 1                   # flip one bit
            cache._host_store[victim] = (k_bad, v_raw, crc, dtype)
        ticket = cache.promote_async(keys)
        assert ticket.wait(10.0)
        assert cache.promote_settle(ticket) < 4
        stats = cache.tier_stats()
        assert stats["copies_failed"] >= 1 and stats["promote_aborts"] >= 1
        assert stats["in_flight"] == 0
        warm, host_t, _ = cache.probe_tiers(keys)
        assert warm == 4 and host_t == 0            # chain breaks at victim
        assert victim not in cache._mgr._host       # dropped, not restored
        bad = torch.from_numpy(k_bad).view(torch.float32)
        assert not any(torch.equal(cache.k_pool[:, b], bad)
                       for b in range(cache.num_blocks))
        t = cache.allocate(9, 16, keys=keys)
        assert t.length < 16                        # suffix is recomputed
        cache.free(9)
        cache._mgr.check()
    finally:
        cache.close()


def test_lost_host_copy_aborts_promotion():
    """tests/test_tiered_kv.py:394: a vanished host entry is a lost copy:
    the promotion errors, the reserved block returns to the pool, and the
    key is dropped rather than re-probed forever."""
    cache = _tiered_cache()
    try:
        keys = _demote_chain0(cache)
        with cache._store_lock:
            del cache._host_store[keys[0]]
        ticket = cache.promote_async(keys)
        assert ticket.wait(10.0)
        assert cache.promote_settle(ticket) == 3
        assert keys[0] not in cache._mgr._host
        assert cache.probe(keys) == 0
        free, live, cached, total = cache.accounting()
        assert free + live + cached == total
    finally:
        cache.close()


def test_injected_copy_failure_returns_key_to_tier():
    """tests/test_tiered_kv.py:419: a transient copy failure aborts
    without dropping: the key returns to its tier, and a retry lands."""
    cache = _tiered_cache()
    try:
        keys = _demote_chain0(cache)
        cache._engine.fail_keys = {keys[0]}
        ticket = cache.promote_async(keys)
        assert ticket.wait(10.0)
        assert cache.promote_settle(ticket) == 3
        assert keys[0] in cache._mgr._host
        assert cache.probe(keys) == 0
        cache._engine.fail_keys = set()
        ticket = cache.promote_async(keys)
        assert ticket.wait(10.0)
        assert cache.promote_settle(ticket) == 1
        assert cache.probe(keys) == 16
        cache._mgr.check()
    finally:
        cache.close()


def test_engine_shutdown_with_transfers_in_flight_drains_clean():
    """tests/test_tiered_kv.py:443: shutdown while promotions are on the
    wire wakes every waiter and aborts every reservation back to the
    pool."""
    engine = BlockCopyEngine()
    engine.delay_s = 0.05
    cache = _tiered_cache(copy_engine=engine)
    try:
        keys = _demote_chain0(cache)
        ticket = cache.promote_async(keys)
        assert cache._mgr.in_flight > 0
        engine.shutdown(wait=True)
        assert ticket.wait(5.0), "shutdown left a waiter hanging"
        cache.promote_settle(ticket)
        assert cache._mgr.in_flight == 0
        free, live, cached, total = cache.accounting()
        assert free + live + cached == total, "shutdown leaked blocks"
        job = engine.submit("promote", 123, lambda: 1)
        assert job.done.is_set() and job.error is not None
    finally:
        cache.close()


def test_reeviction_race_during_promotion():
    """tests/test_tiered_kv.py:470: fresh allocations churn the pool while
    a promotion is in flight; the reservation and conservation hold."""
    engine = BlockCopyEngine()
    engine.delay_s = 0.03
    cache = _tiered_cache(copy_engine=engine)
    try:
        keys = _demote_chain0(cache)
        ticket = cache.promote_async(keys, max_blocks=2)
        _prompt(cache, 3, _CHAINS[3][:2], 8, seed=4)
        assert ticket.wait(10.0)
        committed = cache.promote_settle(ticket)
        assert engine.drain(10.0)
        assert committed >= 0 and cache._mgr.in_flight == 0
        free, live, cached, total = cache.accounting()
        assert free + live + cached == total
        cache._mgr.check()
    finally:
        cache.close()
        engine.shutdown()


def test_overwritten_block_keeps_its_demoted_bytes():
    """The copy worker is held back (delay), so a demoted block is reused
    and overwritten before its copy runs. The stored copy must hold the
    block's bytes at demotion: a snapshot that is a view of the pool would
    store the new prompt's KV under the old key, checksum and all."""
    engine = BlockCopyEngine()
    engine.delay_s = 0.02
    cache = _tiered_cache(copy_engine=engine)
    try:
        keys = _CHAINS[0][:4]
        _prompt(cache, 0, keys, 16, seed=1)
        want = {k: (cache.k_pool[:, b].clone(), cache.v_pool[:, b].clone())
                for k, b in ((k, cache._mgr._trie[k]) for k in keys)}
        _prompt(cache, 1, _CHAINS[1][:4], 16, seed=2)   # reuses all four
        assert engine.drain(10.0)
        for k, (wk, wv) in want.items():
            k_raw, v_raw, crc, dtype = cache._host_store[k]
            assert dtype == "float32"
            assert np.array_equal(k_raw, raw_bytes(wk).numpy())
            assert np.array_equal(v_raw, raw_bytes(wv).numpy())
            assert crc == block_checksum(raw_bytes(wk).numpy(),
                                         raw_bytes(wv).numpy())
        # and the blocks did change under the copies
        assert not any(torch.equal(cache.k_pool[:, b], wk)
                       for b in range(4) for wk, _ in want.values())
    finally:
        cache.close()
        engine.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_copy_checksum_equals_reference(dtype):
    """The crc32 the port stores for a demoted block is the reference's
    `block_checksum` over the same K/V values, cast to the pool dtype in
    JAX. numpy cannot hand an ml_dtypes bf16 array to crc32 as a buffer,
    so in bf16 the reference side passes the same values' bytes as a
    uint16 view."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((2, 4, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 4, 2, 4)).astype(np.float32)
    cache = _tiered_cache(dtype=getattr(torch, dtype))
    try:
        keys = _CHAINS[0][:1]
        cache.allocate(0, 4, keys=keys)
        cache.write_prompt(0, torch.from_numpy(k), torch.from_numpy(v))
        cache.insert(0, keys)
        cache.free(0)
        _prompt(cache, 1, _CHAINS[1][:4], 16, seed=2)   # demotes it
        assert cache._engine.drain(10.0)
        _, _, crc, stored = cache._host_store[keys[0]]
        jk = np.asarray(jnp.asarray(k, getattr(jnp, dtype)))
        jv = np.asarray(jnp.asarray(v, getattr(jnp, dtype)))
        if dtype == "bfloat16":
            jk, jv = jk.view(np.uint16), jv.view(np.uint16)
        assert stored == dtype
        assert crc == ref_block_checksum(jk, jv)
    finally:
        cache.close()


def test_prefill_instance_promotes_a_demoted_prompt():
    """A tiered `PrefillInstance`: prompt A is prefilled twice (a full
    hit), pushed to the host and disk tiers by two other prompts, and
    prefilled again. The promotion brings its blocks back, the hit is
    n - 1 again, and the logits equal the earlier full hit's bit for bit
    (same bytes, same shapes); the pool balances afterwards."""
    cfg = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=2,
                              d_model=64, d_ff=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    # recompute priced far above the copy, so the gate promotes
    pred = TTFTPredictor(coeffs=np.array([1e-3, 0.0]), floor=0.0)
    inst = PrefillInstance(
        params, cfg, SchedulerCore(predictor=pred, enable_batching=False),
        max_seq=512, kv_block_size=64, prefix_share=True,
        prefix_cache_blocks=8, host_cache_blocks=2, disk_cache_blocks=16)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, 256) for _ in range(3)]

    def run(toks):
        req = Request(num_tokens=len(toks), slo=600.0,
                      arrival=time.monotonic())
        inst.submit_request(req, toks)
        assert inst.drain(120.0)
        assert inst.healthy, inst.last_error
        return req, inst.completed_tasks[-1].prefill_task.logits

    try:
        run(prompts[0])
        hit, warm = run(prompts[0])
        assert hit.prefix_hit == 255
        run(prompts[1])
        run(prompts[2])
        assert inst.kv._engine.drain(10.0)
        warm_t, host_t, disk_t = inst.kv.probe_tiers(
            block_keys(prompts[0], 64))
        assert warm_t == 0 and host_t > 0 and disk_t > 0
        again, logits = run(prompts[0])
        assert again.prefix_hit == 255
        assert inst.prefix_promotions == 4
        assert inst.prefix_promoted_tokens == 255
        assert torch.equal(logits, warm)
        free, live, cached, total = inst.kv.accounting()
        assert free + live + cached == total and live == 0
    finally:
        inst.shutdown()
