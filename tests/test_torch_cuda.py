"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA card and `nvcc` (the kernels are built from
`src/repro_torch/kernels/csrc/` at first use); without a card each one skips
inside its fixture. This file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances, per element as atol + rtol*|plain|: in f32 the reference's 2e-5
(tests/test_kernels.py:21), whose products the kernels do with f32 FMA
(never TF32); in bf16 torch.testing's own bf16 pair (atol 1e-5, rtol
1.6e-2), which allows one bf16 rounding step of the output and no more. The
kernels compute in f32 and round only the output, so a larger gap is a
fault.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attn import flash_decode_attention
from repro_torch.kernels.flash_prefill import flash_prefill_attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-5)}

PREFILL_CASES = [
    # B, Sq, T, H, K, hd, q_offset, kv_len, causal, window
    (1, 128, 128, 4, 4, 64, 0, None, True, 0),
    (2, 64, 256, 8, 2, 64, 192, None, True, 0),
    (1, 100, 300, 4, 1, 128, 200, None, True, 0),
    (2, 128, 384, 4, 2, 64, 256, None, True, 128),
    (1, 32, 160, 4, 4, 64, 0, None, False, 0),
    (1, 8, 512, 16, 8, 64, 504, None, True, 0),
    (2, 48, 64, 4, 2, 32, 0, 48, True, 0),
    (1, 40, 96, 4, 2, 16, 56, None, True, 0),
    (1, 16, 64, 4, 2, 32, 40, 48, True, 4),       # rows with no visible key
]

DECODE_CASES = [
    # B, T, H, K, hd, kv_len per row
    (1, 256, 8, 8, 64, [256]),
    (2, 512, 8, 2, 64, [300, 512]),
    (4, 128, 4, 1, 128, [77, 1, 128, 5]),
    (4, 256, 4, 2, 32, [1, 77, 256, 130]),
    (3, 64, 4, 2, 16, [0, 1, 64]),                # a row of length 0 -> 0
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_flash_prefill_matches_plain(card, case, dtype):
    B, Sq, T, H, K, hd, qoff, kv_len, causal, window = case
    gen = torch.Generator(device=card).manual_seed(0)
    q = _randn((B, Sq, H, hd), dtype, gen, card)
    k = _randn((B, T, K, hd), dtype, gen, card)
    v = _randn((B, T, K, hd), dtype, gen, card)
    got = flash_prefill_attention(q, k, v, qoff, kv_len, causal=causal,
                                  local_window=window)
    torch.cuda.synchronize()
    want = ref.chunked_prefill_attention_ref(
        q, k, v, q_offset=qoff, kv_len=T if kv_len is None else kv_len,
        causal=causal, local_window=window)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_matches_plain(card, case, dtype):
    B, T, H, K, hd, lens = case
    gen = torch.Generator(device=card).manual_seed(1)
    q = _randn((B, H, hd), dtype, gen, card)
    k = _randn((B, T, K, hd), dtype, gen, card)
    v = _randn((B, T, K, hd), dtype, gen, card)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=card)
    got = flash_decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_strided_cache_views_and_dispatch(card):
    """The layer view of a (L, B, max_seq, K, hd) cache goes to the kernel
    without a copy, and `ops` dispatches CUDA tensors to the kernels only."""
    gen = torch.Generator(device=card).manual_seed(2)
    cache = _randn((2, 2, 96, 2, 32), torch.float32, gen, card)
    q = _randn((2, 24, 4, 32), torch.float32, gen, card)
    ops.reset_counts()
    got = ops.prefill_attention(q, cache[1], cache[0], q_offset=40,
                                kv_len=64)
    dec = ops.decode_attention(q[:, 0], cache[1], cache[0],
                               torch.tensor([64, 9], device=card))
    counts = ops.counts()
    assert counts == {"flash_prefill_attention": 1,
                      "flash_decode_attention": 1,
                      "chunked_prefill_attention_ref": 0,
                      "decode_attention_ref": 0}
    torch.testing.assert_close(
        got, ref.chunked_prefill_attention_ref(q, cache[1], cache[0],
                                               q_offset=40, kv_len=64),
        rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        dec, ref.decode_attention_ref(q[:, 0], cache[1], cache[0],
                                      kv_len=torch.tensor([64, 9],
                                                          device=card)),
        rtol=2e-5, atol=2e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros((1, 8, 4, 48), device=card)          # head_dim 48
    k = torch.zeros((1, 8, 2, 48), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill_attention(q, k, k)
    q = torch.zeros((1, 8, 4, 32), device=card, dtype=torch.float16)
    k = torch.zeros((1, 8, 2, 32), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_prefill_attention(q, k, k)
    q = torch.zeros((1, 4, 32), device=card)
    k = torch.zeros((1, 8, 32, 2), device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="dense"):
        flash_decode_attention(q, k, k, 8)
