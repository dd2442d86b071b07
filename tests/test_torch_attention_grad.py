"""`FlashAttention` (the port's `blocked_attention`) against the JAX
package's on the CPU, in f32: the output and the gradients dq, dk, dv of
the same cotangent against `jax.vjp` of the reference's `blocked_attention`
(its flash custom VJP) and of `naive_attention`, at the reference's kernel
tolerance (tests/test_kernels.py:21). Inputs are drawn from numpy with a
seed.

On the CPU the forward is the prefill kernel's plain version and the
backward `flash_attention_bwd_ref`; on the card the forward is the CUDA
kernel (tests/test_torch_cuda.py). Cases: causal GQA with groups 1, 2 and
4, a local window, non-causal S != T (Whisper's cross-attention), head dims
16, 32 and 64, T not a multiple of the block, blocks of 16 and 32 keys.
The serving path (frozen parameters, no grad) builds no autograd graph.

    PYTHONPATH=src python -m pytest tests/test_torch_attention_grad.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs.base import get_tiny_config
from repro_torch.kernels import counts, ops
from repro_torch.models import layers as TL
from repro_torch.models.model import forward, prefill
from repro_torch.params import init_params

TOL = dict(rtol=2e-5, atol=2e-5)

CASES = [
    # B, S, T, H, K, hd, causal, window, block
    (2, 40, 40, 4, 4, 16, True, 0, 16),       # group 1, T off the block grid
    (1, 64, 64, 4, 2, 32, True, 0, 16),       # group 2
    (2, 48, 48, 8, 2, 64, True, 0, 32),       # group 4
    (1, 50, 50, 4, 2, 32, True, 12, 16),      # a local window
    (2, 24, 70, 4, 4, 64, False, 0, 32),      # cross-attention, S != T
    (1, 33, 33, 8, 4, 16, True, 0, 32),       # one block short of its size
]


def _inputs(case, seed):
    B, S, T, H, K, hd = case[:6]
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, T, K, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v, dout


def _port(q, k, v, dout, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TL.blocked_attention(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(dout))
    return [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


def _jax(fn, q, k, v, dout):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(out), *map(np.asarray, vjp(jnp.asarray(dout)))]


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_blocked_attention(case):
    causal, window, block = case[6:]
    q, k, v, dout = _inputs(case, 0)
    got = _port(q, k, v, dout, causal=causal, local_window=window,
                block=block)
    want = _jax(lambda *a: JL.blocked_attention(
        *a, causal=causal, local_window=window, block=block), q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_naive_attention(case):
    """Every row sees at least one key, where `naive_attention`'s -1e30
    fill and the kernels' zero rows agree."""
    causal, window, block = case[6:]
    q, k, v, dout = _inputs(case, 1)
    got = _port(q, k, v, dout, causal=causal, local_window=window,
                block=block)
    want = _jax(lambda *a: JL.naive_attention(
        *a, causal=causal, local_window=window), q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


def test_run_time_offset_and_length_match_jax():
    """q_offset and kv_len are run-time values, as in the kernels: a chunk
    at q_offset 24 over 40 of 56 keys in a window of 4, whose rows at
    positions 43 and later see no key: zero output and zero dq, as in the
    reference."""
    B, S, T, H, K, hd = 1, 24, 56, 4, 2, 32
    q, k, v, dout = _inputs((B, S, T, H, K, hd), 2)
    kw = dict(q_offset=24, kv_len=40, local_window=4, block=16)
    got = _port(q, k, v, dout, **kw)
    want = _jax(lambda *a: JL.blocked_attention(*a, **kw), q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)
    assert np.all(got[0][:, 19:] == 0.0) and np.all(got[1][:, 19:] == 0.0)
    assert np.any(got[0][:, 18] != 0.0)


def test_backward_counts_its_calls_and_keeps_dtypes():
    """One backward call per attention, in the inputs' dtypes (bf16 in,
    bf16 gradients out, computed in f32)."""
    q, k, v, dout = _inputs((1, 20, 20, 4, 2, 16), 3)
    qt, kt, vt = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    counts.reset()
    TL.blocked_attention(qt, kt, vt).backward(
        torch.from_numpy(dout).bfloat16())
    assert counts.read(["flash_attention_bwd_ref"]) == {
        "flash_attention_bwd_ref": 1}
    assert ops.counts()["chunked_prefill_attention_ref"] == 1
    assert (qt.grad.dtype, kt.grad.dtype, vt.grad.dtype) == (torch.bfloat16,) * 3
    counts.reset()


@pytest.mark.parametrize("arch", ["llama3_2_1b", "whisper_large_v3"])
def test_serving_path_builds_no_graph(arch, monkeypatch):
    """Frozen parameters (the serving default): `forward` and `prefill`
    run the plain forward (the kernel on the card) and never
    `FlashAttention`, so no output has a grad_fn and no backward is
    recorded."""
    cfg = get_tiny_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 12)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    calls = []
    monkeypatch.setattr(TL, "blocked_attention",
                        lambda *a, **kw: calls.append(1))
    logits = forward(params, cfg, batch)
    last, cache = prefill(params, cfg, batch)
    assert calls == []
    assert logits.grad_fn is None and last.grad_fn is None
    assert all(t.grad_fn is None for t in cache.values()
               if isinstance(t, torch.Tensor))
