"""The port's attention on the CPU (`kernels.ops`, which takes the plain
PyTorch versions for a CPU tensor) against the JAX package: its Pallas
kernels run in interpret mode and its pure-jnp oracles, on the reference's
own cases and tolerances (tests/test_kernels.py), in f32. The CUDA kernels
themselves are held against the same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

F32 = dict(rtol=2e-5, atol=2e-5)          # the reference's f32 tolerance

PREFILL_CASES = [
    # B, Sq, T, H, K, hd, q_offset, causal, window (tests/test_kernels.py:26)
    (1, 128, 128, 4, 4, 64, 0, True, 0),
    (2, 64, 256, 8, 2, 64, 192, True, 0),
    (1, 100, 300, 4, 1, 128, 200, True, 0),
    (2, 128, 384, 4, 2, 64, 256, True, 128),
    (1, 32, 160, 4, 4, 64, 0, False, 0),
    (1, 8, 512, 16, 8, 64, 504, True, 0),
    # head dims of the tiny configs the runtime tests serve
    (2, 48, 48, 4, 2, 32, 0, True, 0),
    (1, 40, 96, 4, 2, 16, 56, True, 0),
]

DECODE_CASES = [
    # B, T, H, K, hd, kv_len (tests/test_kernels.py:94)
    (1, 256, 8, 8, 64, 256),
    (2, 512, 8, 2, 64, 300),
    (4, 128, 4, 1, 128, 77),
    (1, 1024, 16, 8, 64, 1000),
]


def qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in (q_shape, kv_shape, kv_shape))


def both(*arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_plain_matches_pallas_and_oracle(case):
    B, Sq, T, H, K, hd, qoff, causal, window = case
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(0, (B, Sq, H, hd), (B, T, K, hd)))
    got = ops.prefill_attention(tq, tk, tv, q_offset=qoff, causal=causal,
                                local_window=window).numpy()
    pallas = jops.prefill_attention(jq, jk, jv, q_offset=qoff, causal=causal,
                                    local_window=window,
                                    impl="pallas_interpret", block_q=64,
                                    block_k=128)
    oracle = jref.chunked_prefill_attention_ref(
        jq, jk, jv, q_offset=qoff, causal=causal, local_window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)


def test_prefill_kv_len_mask():
    """kv_len < T must ignore the padded cache tail."""
    B, Sq, T, H, K, hd, kv_len = 1, 32, 256, 4, 2, 64, 150
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(1, (B, Sq, H, hd), (B, T, K, hd)))
    got = ops.prefill_attention(tq, tk, tv, q_offset=kv_len - Sq,
                                kv_len=kv_len).numpy()
    pallas = jops.prefill_attention(jq, jk, jv, q_offset=kv_len - Sq,
                                    kv_len=kv_len, impl="pallas_interpret",
                                    block_q=32, block_k=64)
    want = jref.chunked_prefill_attention_ref(
        jq, jk[:, :kv_len], jv[:, :kv_len], q_offset=kv_len - Sq)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_prefill_chunked_equals_full():
    """Chunk-by-chunk prefill (the FlowPrefill execution mode) reproduces the
    single-shot prefill (the reference's 1e-6)."""
    B, S, H, K, hd, chunk = 1, 256, 4, 2, 64, 64
    q, k, v = (torch.from_numpy(a) for a in qkv(2, (B, S, H, hd),
                                                (B, S, K, hd)))
    full = ops.prefill_attention(q, k, v)
    pieces = [ops.prefill_attention(q[:, off:off + chunk],
                                    k[:, :off + chunk], v[:, :off + chunk],
                                    q_offset=off)
              for off in range(0, S, chunk)]
    np.testing.assert_allclose(torch.cat(pieces, dim=1).numpy(),
                               full.numpy(), rtol=1e-6, atol=1e-6)


def test_prefill_empty_rows_are_zero():
    """A row with no visible key outputs 0 (the kernels' l == 0 guard), as
    the JAX oracle does."""
    B, Sq, T, H, K, hd = 1, 16, 64, 4, 2, 32
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(3, (B, Sq, H, hd), (B, T, K, hd)))
    got = ops.prefill_attention(tq, tk, tv, q_offset=40, kv_len=48,
                                local_window=4).numpy()
    want = jref.chunked_prefill_attention_ref(jq, jk, jv, q_offset=40,
                                              kv_len=48, local_window=4)
    assert np.all(got[:, 12:] == 0.0)          # positions 52.. see no key < 48
    np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_pallas_and_oracle(case):
    B, T, H, K, hd, kv_len = case
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(4, (B, H, hd), (B, T, K, hd)))
    got = ops.decode_attention(tq, tk, tv, kv_len).numpy()
    pallas = jops.decode_attention(jq, jk, jv, kv_len,
                                   impl="pallas_interpret", block_k=128)
    oracle = jref.decode_attention_ref(jq, jk, jv, kv_len=kv_len)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)


def test_decode_ragged_per_row_kv_len():
    """Per-row kv_len (continuous batching), including a row that sees only
    its first key."""
    B, T, H, K, hd = 4, 256, 8, 2, 32
    lens = np.asarray([1, 77, 256, 130], np.int32)
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(5, (B, H, hd), (B, T, K, hd)))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens)).numpy()
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                   impl="pallas_interpret", block_k=128)
    oracle = jref.decode_attention_ref(jq, jk, jv, kv_len=jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)
    # the kv_len = 1 row attends to key 0 alone: its output is v[0]
    np.testing.assert_allclose(
        got[0], np.repeat(tv.numpy()[0, 0], H // K, axis=0), **F32)


def test_naive_attention_matches_jax():
    """The reference attention with per-row offsets and lengths (the -1e30
    fill path of the ragged decode step)."""
    from repro.models.layers import naive_attention as jnaive
    B, S, T, H, K, hd = 3, 1, 64, 4, 2, 32
    qoff = np.asarray([5, 63, 20], np.int32)
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(6, (B, S, H, hd), (B, T, K, hd)))
    got = ref.naive_attention(tq, tk, tv, causal=False,
                              kv_len=torch.from_numpy(qoff + 1)).numpy()
    want = jnaive(jq, jk, jv, causal=False, kv_len=jnp.asarray(qoff + 1))
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_cpu_tensors_take_the_plain_versions():
    """Dispatch is by the tensor's device: CPU tensors reach the plain
    versions and never the kernels."""
    ops.reset_counts()
    q, k, v = (torch.from_numpy(a) for a in qkv(7, (1, 8, 4, 16),
                                                (1, 8, 2, 16)))
    ops.prefill_attention(q, k, v)
    ops.decode_attention(q[:, 0], k, v, 8)
    assert ops.counts() == {"flash_prefill_attention": 0,
                            "flash_decode_attention": 0,
                            "chunked_prefill_attention_ref": 1,
                            "decode_attention_ref": 1}
    ops.reset_counts()


def test_counts_lose_nothing_across_threads():
    """The prefill and decode workers bump the counters from two threads;
    every bump is counted."""
    import threading
    from repro_torch.kernels import counts
    ops.reset_counts()
    names = ("flash_prefill_attention", "flash_decode_attention")
    workers = [threading.Thread(target=lambda n=n: [counts.bump(n)
                                                    for _ in range(20000)])
               for n in names for _ in range(2)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    got = ops.counts()
    ops.reset_counts()
    assert [got[n] for n in names] == [40000, 40000]

