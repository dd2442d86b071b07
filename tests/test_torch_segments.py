"""The port's operator-segmented prefill: the dense cases of
tests/test_segments.py (segmented == fused, chunked == unchunked, the
granularities agree, suspend/resume bit-exact, per-request lens), with
"fused" the JAX `prefill` on the same bridged weights, plus the port's
logits and KV cache against the JAX `SegmentedPrefill`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.segments import SegmentedPrefill as JaxSegmentedPrefill
from repro_torch.configs.base import get_tiny_config
from repro_torch.models.segments import DENSE_OPS, SegmentedPrefill
from repro_torch.params import from_jax_params

B, S = 2, 48
CFG = get_tiny_config("llama3_8b")


@pytest.fixture(scope="module")
def dense_setup():
    jcfg = jax_tiny_config("llama3_8b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, CFG.vocab_size, (B, S))
    return jcfg, jparams, params, tokens


def test_segmented_matches_fused(dense_setup):
    jcfg, jparams, params, tokens = dense_setup
    ex = SegmentedPrefill(params, CFG, max_seq=S, granularity="op")
    task = ex.start(tokens)
    assert task.total_segments == CFG.num_layers * len(DENSE_OPS) + 1
    got = ex.run_all(task)
    want, _ = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                          max_seq=S, cache_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_chunked_matches_unchunked(dense_setup):
    _, _, params, tokens = dense_setup
    ex1 = SegmentedPrefill(params, CFG, max_seq=S, granularity="op")
    ex2 = SegmentedPrefill(params, CFG, max_seq=S, granularity="op",
                           chunk_tokens=16)
    l1 = ex1.run_all(ex1.start(tokens))
    l2 = ex2.run_all(ex2.start(tokens))
    assert ex2.segments_for(S) > ex1.segments_for(S)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gran", ["layer", "block2", "whole"])
def test_granularities_agree(dense_setup, gran):
    _, _, params, tokens = dense_setup
    ref = SegmentedPrefill(params, CFG, max_seq=S, granularity="op")
    alt = SegmentedPrefill(params, CFG, max_seq=S, granularity=gran)
    l_ref = ref.run_all(ref.start(tokens))
    l_alt = alt.run_all(alt.start(tokens))
    np.testing.assert_allclose(l_ref.numpy(), l_alt.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stop_frac", [0.2, 0.5, 0.8])
def test_suspend_resume_bit_exact(dense_setup, stop_frac):
    """Suspending at ANY operator boundary and resuming later (here with
    another prefill run in between) is bit-identical to uninterrupted
    execution: the state is preserved exactly and nothing is recomputed."""
    _, _, params, tokens = dense_setup
    ex = SegmentedPrefill(params, CFG, max_seq=S, granularity="op",
                          chunk_tokens=16)
    want = ex.run_all(ex.start(tokens))

    t = ex.start(tokens)
    stop_at = int(t.total_segments * stop_frac)
    while t.cursor < stop_at:
        ex.step(t)
    ex.run_all(ex.start(tokens[:1, :20]))      # another task runs meanwhile
    got = ex.run_all(t)
    assert torch.equal(got, want)


def test_per_request_lens_head(dense_setup):
    """Padded batch: first-token logits come from each request's own last
    position, not the pad tail."""
    _, _, params, _ = dense_setup
    rng = np.random.default_rng(5)
    t1 = rng.integers(0, CFG.vocab_size, (1, 20))
    ex = SegmentedPrefill(params, CFG, max_seq=S, granularity="op")
    solo = ex.run_all(ex.start(t1))
    t2 = rng.integers(0, CFG.vocab_size, (1, S))
    toks = np.concatenate([np.pad(t1, ((0, 0), (0, S - 20))), t2], axis=0)
    batched = ex.run_all(ex.start(toks, lens=[20, S]))
    np.testing.assert_allclose(batched[0].numpy(), solo[0].numpy(),
                               rtol=2e-5, atol=2e-5)


def test_matches_jax_segmented_prefill(dense_setup):
    """Logits and the whole KV cache against the JAX SegmentedPrefill, both
    chunked at 16 tokens."""
    jcfg, jparams, params, tokens = dense_setup
    jex = JaxSegmentedPrefill(jparams, jcfg, max_seq=S, granularity="op",
                              chunk_tokens=16)
    jtask = jex.start(jnp.asarray(tokens))
    jlogits = jex.run_all(jtask)
    ex = SegmentedPrefill(params, CFG, max_seq=S, granularity="op",
                          chunk_tokens=16)
    task = ex.start(tokens)
    logits = ex.run_all(task)
    assert task.total_segments == jtask.total_segments
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    for key in ("k_cache", "v_cache"):
        np.testing.assert_allclose(task.state[key].numpy(),
                                   np.asarray(jtask.state[key]), **tol)


def test_prefix_resume_not_ported(dense_setup):
    _, _, params, tokens = dense_setup
    ex = SegmentedPrefill(params, CFG, max_seq=S)
    with pytest.raises(NotImplementedError):
        ex.start(tokens, prefix_len=16)
