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
kernels sum in f32 and round only the output, so a larger gap is a fault.
The prefill kernel's tensor-core body (bf16, head_dim 64 or 128) and the
split-KV decode/verify body in bf16 feed bf16 operands to the tensor cores
with f32 sums and split P into two bf16 terms, which keeps them inside the
same bf16 limit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.prefixcache import block_keys, chain_extend
from repro_torch.kernels import counts, ops, ref
from repro_torch.kernels.decode_attn import (BODY, MAX_ROWS, SPLIT_KEYS,
                                             flash_decode_attention,
                                             flash_verify_attention)
from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.serving.kvcache import PagedKVCache, raw_bytes

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
    # RecurrentGemma's head_dim 256, one KV head: a window from position 0,
    # and a resumed chunk at q_offset 160 whose window binds
    (1, 256, 256, 4, 1, 256, 0, None, True, 64),
    (1, 40, 300, 4, 1, 256, 160, 200, True, 64),
    # Whisper's encoder (one query head per KV head, no mask, Sq = T off
    # the 128-row tile grid) and its decoder's cross-attention in
    # `forward` (24 queries over 300 encoder keys); Llama4's 5 query heads
    # per KV head
    (1, 300, 300, 4, 4, 64, 0, None, False, 0),
    (2, 24, 300, 4, 4, 64, 0, None, False, 0),
    (1, 200, 260, 10, 2, 128, 60, None, True, 0),
]

# the tensor-core body of the prefill kernel (bf16, head_dim 64/128): the
# cases above at those head dims, and B 2 with two query tiles of 128, Sq
# and T off the 64/128 grids, kv_len < T, a window with and without the
# causal mask, rows with no visible key
TC_PREFILL_CASES = [c for c in PREFILL_CASES if c[5] in (64, 128, 256)] + [
    (1, 16, 64, 4, 2, 64, 40, 48, True, 4),       # rows with no visible key
    (2, 200, 700, 8, 2, 128, 450, 650, True, 0),
    (1, 130, 300, 4, 1, 128, 0, None, False, 96),
    (1, 1, 300, 8, 8, 64, 299, None, True, 0),    # one query row
]

DECODE_CASES = [
    # B, T, H, K, hd, kv_len per row
    (1, 256, 8, 8, 64, [256]),
    (2, 512, 8, 2, 64, [300, 512]),
    (4, 128, 4, 1, 128, [77, 1, 128, 5]),
    (4, 256, 4, 2, 32, [1, 77, 256, 130]),
    (3, 64, 4, 2, 16, [0, 1, 64]),                # a row of length 0 -> 0
    (4, 300, 16, 1, 256, [1, 70, 300, 33]),       # hd 256 MQA ring decode
    (2, 300, 4, 4, 64, [300, 300]),               # Whisper's cross-attention
    (2, 300, 10, 2, 128, [1, 300]),               # Llama4's group 5
]

VERIFY_CASES = [
    # B, S, T, H, K, hd, kv_len per row (T not a multiple of 32; kv_len 0,
    # 1 and T - S; S * H / K up to the kernel's 64 rows)
    (3, 5, 300, 8, 2, 64, [0, 37, 295]),
    (2, 1, 100, 8, 8, 128, [1, 99]),
    (2, 2, 77, 8, 1, 64, [0, 75]),
    (1, 5, 70, 64, 8, 128, [65]),
    (4, 8, 129, 16, 2, 64, [0, 1, 64, 121]),
    (2, 5, 45, 4, 2, 32, [0, 40]),
    (1, 5, 33, 4, 2, 16, [28]),
    (2, 3, 96, 16, 1, 256, [0, 93]),
]


# the split-KV body's edges (splits of SPLIT_KEYS = 128 keys): rows over
# several splits, kv_len on a split boundary and one past it, T not a
# multiple of the split, empty rows, 16 to 64 query rows, every head_dim,
# and B 1 at T 4096. Decode runs at kv_len, verify at min(kv_len, T - S).
SPLIT_CASES = [
    # B, S, T, H, K, hd, kv_len per row
    (4, 5, 700, 32, 8, 128, [0, 128, 129, 695]),
    (3, 4, 520, 16, 2, 64, [127, 256, 384]),
    (2, 8, 300, 16, 2, 64, [255, 257]),
    (2, 3, 260, 8, 4, 32, [1, 257]),
    (2, 2, 200, 4, 2, 16, [0, 129]),
    (1, 5, 4096, 32, 8, 128, [4096]),
    (2, 3, 200, 16, 1, 256, [31, 33]),            # 32-key splits at hd 256
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


@pytest.mark.parametrize("case", TC_PREFILL_CASES)
def test_flash_prefill_tensor_core_body(card, case):
    """bf16 at head_dim 64/128/256 runs a tensor-core body (its own
    counter) and stays inside the bf16 limit of the plain version."""
    B, Sq, T, H, K, hd, qoff, kv_len, causal, window = case
    gen = torch.Generator(device=card).manual_seed(4)
    q = _randn((B, Sq, H, hd), torch.bfloat16, gen, card)
    k = _randn((B, T, K, hd), torch.bfloat16, gen, card)
    v = _randn((B, T, K, hd), torch.bfloat16, gen, card)
    ops.reset_counts()
    got = flash_prefill_attention(q, k, v, qoff, kv_len, causal=causal,
                                  local_window=window)
    torch.cuda.synchronize()
    counts = ops.counts()
    assert counts["flash_prefill_attention"] == 1
    assert counts["flash_prefill_wgmma"] == 1
    want = ref.chunked_prefill_attention_ref(
        q, k, v, q_offset=qoff, kv_len=T if kv_len is None else kv_len,
        causal=causal, local_window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("hd", [64, 128])
def test_tensor_core_body_on_a_cache_layer_view(card, hd):
    """A layer view of a (L, B, max_seq, K, hd) cache with max_seq > kv_len
    and NaN in every slot past kv_len: the keys past kv_len are never read
    (TMA zero-fills them), so the output is finite and matches the plain
    version over the first kv_len keys."""
    L, B, max_seq, K, H, Sq, qoff, kv_len = 3, 2, 512, 2, 8, 100, 200, 300
    gen = torch.Generator(device=card).manual_seed(5)
    kc = _randn((L, B, max_seq, K, hd), torch.bfloat16, gen, card)
    vc = _randn((L, B, max_seq, K, hd), torch.bfloat16, gen, card)
    kc[:, :, kv_len:] = float("nan")
    vc[:, :, kv_len:] = float("nan")
    q = _randn((B, Sq, H, hd), torch.bfloat16, gen, card)
    got = flash_prefill_attention(q, kc[1], vc[1], qoff, kv_len)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = ref.chunked_prefill_attention_ref(
        q, kc[1, :, :kv_len], vc[1, :, :kv_len], q_offset=qoff)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_head_dim_256_prefill_runs_a_tensor_core_body(card):
    """bf16 at head_dim 256 runs its tensor-core body (mma.sync), as
    TENSOR_CORE_HEAD_DIMS declares, and f32 the CUDA-core body."""
    from repro_torch.kernels.flash_prefill import tensor_core_body
    gen = torch.Generator(device=card).manual_seed(5)
    q = _randn((1, 64, 16, 256), torch.bfloat16, gen, card)
    k = _randn((1, 64, 1, 256), torch.bfloat16, gen, card)
    ops.reset_counts()
    flash_prefill_attention(q, k, k, 0, None, local_window=32)
    flash_prefill_attention(q.float(), k.float(), k.float(), 0, None,
                            local_window=32)
    torch.cuda.synchronize()
    assert tensor_core_body(torch.bfloat16, 256)
    assert not tensor_core_body(torch.float32, 256)
    assert ops.counts()["flash_prefill_attention"] == 2
    assert ops.counts()["flash_prefill_wgmma"] == 1


def test_tensor_core_body_is_deterministic(card):
    """Two calls on the same inputs give the same bits (no atomics, a fixed
    order), which the bit-exact resume of a preempted prefill rests on."""
    gen = torch.Generator(device=card).manual_seed(6)
    q = _randn((1, 256, 16, 128), torch.bfloat16, gen, card)
    k = _randn((1, 1024, 4, 128), torch.bfloat16, gen, card)
    v = _randn((1, 1024, 4, 128), torch.bfloat16, gen, card)
    first = flash_prefill_attention(q, k, v, 768, 1024)
    second = flash_prefill_attention(q, k, v, 768, 1024)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_tensor_core_body_refuses_misaligned_operands(card):
    """TMA needs a 16-byte-aligned address and strides in multiples of 16
    bytes; the wrapper raises on anything else rather than falling back."""
    bf16 = torch.bfloat16
    k = torch.zeros((1, 64, 2, 64), dtype=bf16, device=card)
    q = torch.zeros(1 + 64 * 4 * 64, dtype=bf16, device=card)[1:] \
        .view(1, 64, 4, 64)                        # 2 bytes off alignment
    with pytest.raises(ValueError, match="16 bytes"):
        flash_prefill_attention(q, k, k)
    q = torch.zeros((1, 64, 4, 64), dtype=bf16, device=card)
    padded = torch.zeros((1, 64, 2 * 64 + 4), dtype=bf16, device=card)
    k = padded[:, :, :128].unflatten(-1, (2, 64))  # row stride 132 elements
    with pytest.raises(ValueError, match="16 bytes"):
        flash_prefill_attention(q, k, k)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", VERIFY_CASES)
def test_flash_verify_matches_plain(card, case, dtype):
    """The verify kernel against its plain version, and its column 0
    bit-equal to the decode kernel at kv_len + 1 (same tile order and
    arithmetic), which greedy bit-parity of speculative decoding rests on."""
    B, S, T, H, K, hd, lens = case
    gen = torch.Generator(device=card).manual_seed(3)
    q = _randn((B, S, H, hd), dtype, gen, card)
    k = _randn((B, T, K, hd), dtype, gen, card)
    v = _randn((B, T, K, hd), dtype, gen, card)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=card)
    got = flash_verify_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    want = ref.verify_attention_ref(q, k, v, kv_len)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    col0 = flash_decode_attention(q[:, 0].contiguous(), k, v, kv_len + 1)
    assert torch.equal(got[:, 0], col0)


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
    ver = ops.verify_attention(q[:, :5], cache[1], cache[0],
                               torch.tensor([64, 9], device=card))
    counts = ops.counts()
    assert counts == {"flash_prefill_attention": 1,
                      "flash_prefill_wgmma": 0,
                      "flash_decode_attention": 1,
                      "flash_verify_attention": 1,
                      "chunked_prefill_attention_ref": 0,
                      "decode_attention_ref": 0,
                      "verify_attention_ref": 0}
    torch.testing.assert_close(
        got, ref.chunked_prefill_attention_ref(q, cache[1], cache[0],
                                               q_offset=40, kv_len=64),
        rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        dec, ref.decode_attention_ref(q[:, 0], cache[1], cache[0],
                                      kv_len=torch.tensor([64, 9],
                                                          device=card)),
        rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        ver, ref.verify_attention_ref(q[:, :5], cache[1], cache[0],
                                      torch.tensor([64, 9], device=card)),
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
    q = torch.zeros((1, 9, 64, 32), device=card)          # 9 * 8 = 72 rows
    k = torch.zeros((1, 16, 8, 32), device=card)
    with pytest.raises(ValueError, match=str(MAX_ROWS)):
        flash_verify_attention(q, k, k, 4)
    q = torch.zeros((1, 5, 4, 32), device=card, dtype=torch.float16)
    k = torch.zeros((1, 16, 2, 32), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_verify_attention(q, k, k, 4)
    q = torch.zeros((1, 5, 4, 32), device=card)
    with pytest.raises(ValueError, match="dtype"):
        flash_verify_attention(q, k, k, 4)


def _nan_past(x, ends):
    """A copy of k or v (B, T, K, hd) with NaN in every key at or past
    ends[b]: keys no row may read."""
    x = x.clone()
    for b, n in enumerate(ends):
        x[b, n:] = float("nan")
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_kv_edges(card, case, dtype):
    """Decode and verify across split boundaries against their plain
    versions (on the inputs without NaN), with NaN in k/v past each row's
    last visible key kept out of the output; two calls give the same bits;
    verify's column 0 is bit-equal to decode at kv_len + 1."""
    B, S, T, H, K, hd, lens = case
    gen = torch.Generator(device=card).manual_seed(7)
    q = _randn((B, S, H, hd), dtype, gen, card)
    k = _randn((B, T, K, hd), dtype, gen, card)
    v = _randn((B, T, K, hd), dtype, gen, card)
    dec_len = torch.tensor(lens, dtype=torch.int32, device=card)
    ver_len = dec_len.clamp(max=T - S)
    q0 = q[:, 0].contiguous()

    kd, vd = _nan_past(k, lens), _nan_past(v, lens)
    dec = flash_decode_attention(q0, kd, vd, dec_len)
    torch.cuda.synchronize()
    assert torch.equal(dec, flash_decode_attention(q0, kd, vd, dec_len))
    want = ref.decode_attention_ref(q0, k, v, kv_len=dec_len)
    torch.testing.assert_close(dec.float(), want.float(), **TOL[dtype])
    assert not dec[dec_len == 0].float().any()          # empty rows are 0

    ends = (ver_len + S).tolist()
    kv_, vv_ = _nan_past(k, ends), _nan_past(v, ends)
    ver = flash_verify_attention(q, kv_, vv_, ver_len)
    torch.cuda.synchronize()
    assert torch.equal(ver, flash_verify_attention(q, kv_, vv_, ver_len))
    want = ref.verify_attention_ref(q, k, v, ver_len)
    torch.testing.assert_close(ver.float(), want.float(), **TOL[dtype])
    col0 = flash_decode_attention(q0, kv_, vv_, ver_len + 1)
    assert torch.equal(ver[:, 0], col0)


def test_decode_and_verify_launch_one_body(card):
    """Both wrappers launch the split-KV body (its own counter), and the
    wrapper's split size is the body's (the C entry point refuses any
    other)."""
    assert SPLIT_KEYS == 128
    q = torch.zeros((2, 3, 8, 64), device=card, dtype=torch.bfloat16)
    k = torch.zeros((2, 300, 2, 64), device=card, dtype=torch.bfloat16)
    counts.reset()
    flash_decode_attention(q[:, 0].contiguous(), k, k, 200)
    assert counts.read([BODY, "flash_decode_attention"]) == {
        BODY: 1, "flash_decode_attention": 1}
    flash_verify_attention(q, k, k, 200)
    assert counts.read([BODY, "flash_verify_attention"]) == {
        BODY: 2, "flash_verify_attention": 1}
    counts.reset()


# --- prefix sharing and the KV tiers on the card -----------------------------


@pytest.mark.parametrize("case", [(1, 1, 4096, 4095, None),
                                  (1, 512, 4096, 2048, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_resumed_over_a_cached_prefix(card, case, dtype):
    """The attn operator after a prefix hit at Llama3-8B's heads: one query
    row at q_offset n - 1 (a fully cached prompt) and a 512-token chunk at
    a 128-aligned q_offset, against the plain version; bf16 on the
    tensor-core body."""
    B, Sq, T, qoff, kv_len = case
    H, K, hd = 32, 8, 128
    gen = torch.Generator(device=card).manual_seed(7)
    q = _randn((B, Sq, H, hd), dtype, gen, card)
    k = _randn((B, T, K, hd), dtype, gen, card)
    v = _randn((B, T, K, hd), dtype, gen, card)
    ops.reset_counts()
    got = flash_prefill_attention(q, k, v, qoff, kv_len)
    torch.cuda.synchronize()
    assert ops.counts()["flash_prefill_wgmma"] == int(dtype == torch.bfloat16)
    want = ref.chunked_prefill_attention_ref(
        q, k, v, q_offset=qoff, kv_len=T if kv_len is None else kv_len)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _share_ops(device, dtype):
    """Share-mode pool ops on one device: a cached prompt, a second prompt
    that hits its first two blocks and writes its suffix from a
    block-aligned start, copy-on-write through `write` and `write_tokens`,
    and the gathers."""
    cache = PagedKVCache(2, 16, 4, 2, 8, dtype, device=device,
                         prefix_share=True)
    rng = np.random.default_rng(11)

    def kv(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    toks = np.arange(12)
    keys = block_keys(toks, 4)
    cache.allocate(0, 12, keys=keys)
    cache.write_prompt(0, kv(2, 12, 2, 8), kv(2, 12, 2, 8))
    cache.insert(0, keys)
    keys2 = block_keys(np.concatenate([toks[:8], np.arange(50, 60)]), 4)
    assert cache.allocate(1, 18, keys=keys2).length == 8
    cache.write_prompt(1, kv(2, 10, 2, 8), kv(2, 10, 2, 8), start=8)
    cache.allocate(2, 12, keys=keys)
    cache.write(2, 5, kv(2, 2, 8), kv(2, 2, 8))          # copy-on-write
    cache.write_tokens([1, 2], [3, 10], kv(2, 2, 2, 8), kv(2, 2, 2, 8))
    out = [cache.gather(s)[:2] for s in (0, 1, 2)]
    out.append(cache.gather_batch([0, 1, 2])[:2])
    tables = [list(cache.table(s).blocks) for s in (0, 1, 2)]
    return cache, out, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_share_mode_pool_on_the_card_matches_the_cpu(card, dtype):
    gpu, g_out, g_tables = _share_ops(card, dtype)
    cpu, c_out, c_tables = _share_ops("cpu", dtype)
    torch.cuda.synchronize()
    assert g_tables == c_tables
    for g, c in zip(g_out, c_out):
        for a, b in zip(g, c):
            assert torch.equal(a.cpu(), b)
    assert torch.equal(gpu.k_pool.cpu(), cpu.k_pool)
    assert torch.equal(gpu.v_pool.cpu(), cpu.v_pool)
    assert gpu.accounting() == cpu.accounting()


_CHAINS = [chain_extend((), range(8), salt=s) for s in range(4)]


def _cache_prompt(cache, sid, keys, seed):
    t = cache.allocate(sid, 16, keys=keys)
    gen = torch.Generator(device=cache.device).manual_seed(seed)
    with torch.cuda.stream(cache.stream):
        k = _randn((2, 16, 2, 64), cache.k_pool.dtype, gen, cache.device)
        cache.write_prompt(sid, k, k * 2, start=t.length)
    cache.insert(sid, keys)
    cache.free(sid)


def test_bf16_tier_round_trip_on_the_card(card):
    """A bf16 block demoted through host and disk and promoted back is
    `torch.equal` to the block at demotion."""
    cache = PagedKVCache(2, 4, 4, 2, 64, torch.bfloat16, device=card,
                         prefix_share=True, host_cache_blocks=8,
                         disk_cache_blocks=16, stream=torch.cuda.Stream())
    try:
        keys = _CHAINS[0][:4]
        _cache_prompt(cache, 0, keys, seed=1)
        with torch.cuda.stream(cache.stream):
            want = {k: (cache.k_pool[:, b].clone(), cache.v_pool[:, b].clone())
                    for k, b in cache._mgr._trie.items()}
        for i in (1, 2, 3):
            _cache_prompt(cache, i, _CHAINS[i][:4], seed=1 + i)
        assert cache._engine.drain(30.0)
        _, host_t, disk_t = cache.probe_tiers(keys)
        assert host_t + disk_t == 16 and disk_t > 0
        ticket = cache.promote_async(keys)
        assert ticket.wait(30.0)
        assert cache.promote_settle(ticket) == 4
        cache.stream.synchronize()
        for k in keys:
            b = cache._mgr._trie[k]
            assert torch.equal(cache.k_pool[:, b], want[k][0])
            assert torch.equal(cache.v_pool[:, b], want[k][1])
    finally:
        cache.close()


def test_demoted_block_overwritten_at_once_keeps_its_bytes(card):
    """The stale-KV test. The pool's stream is held busy, a prompt's four
    blocks are demoted (a new prompt takes them) and overwritten on that
    stream at once; after the engine drains, each host copy holds the
    block's bytes at demotion. A snapshot that is a view, or a copy that
    does not wait for the pool's stream, stores other bytes."""
    stream = torch.cuda.Stream()
    cache = PagedKVCache(2, 4, 4, 2, 64, torch.bfloat16, device=card,
                         prefix_share=True, host_cache_blocks=8,
                         stream=stream)
    try:
        keys = _CHAINS[0][:4]
        _cache_prompt(cache, 0, keys, seed=1)
        with torch.cuda.stream(stream):
            want = {k: (raw_bytes(cache.k_pool[:, b]).cpu().numpy(),
                        raw_bytes(cache.v_pool[:, b]).cpu().numpy())
                    for k, b in cache._mgr._trie.items()}
            torch.cuda._sleep(100_000_000)     # the clones queue behind it
            cache.allocate(1, 16)              # demotes all four blocks
            cache.write_prompt(1, torch.full((2, 16, 2, 64), 7.0,
                                             device=card),
                               torch.full((2, 16, 2, 64), 9.0,
                                          device=card))
        assert cache._engine.drain(30.0)
        for k, (wk, wv) in want.items():
            k_raw, v_raw, _, dtype = cache._host_store[k]
            assert dtype == "bfloat16"
            assert np.array_equal(k_raw, wk) and np.array_equal(v_raw, wv)
        stream.synchronize()
        assert (cache.k_pool == 7.0).all() and (cache.v_pool == 9.0).all()
    finally:
        cache.close()


def test_hybrid_pool_growth_keeps_queued_writes(card):
    """A `HybridInstance` grows its pool from the submitting thread. Writes
    queued on the instance's stream (here behind a spin of the card) must
    land in the grown pool: a `torch.cat` on another stream would copy the
    blocks before them. The grown instance then decodes the request to the
    same tokens as the port on the CPU."""
    import copy
    import dataclasses
    import time

    from repro_torch.configs.base import get_tiny_config
    from repro_torch.core import Request
    from repro_torch.params import init_params
    from repro_torch.serving.hybrid_instance import HybridInstance

    cfg = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=2,
                              d_model=128, d_ff=256)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, 64)
    out = {}
    for where, params in (("cpu", p_cpu), ("cuda", copy.deepcopy(p_cpu).to(card))):
        # 3 blocks of 16 (one the scratch row's): 64 + 5 + 1 tokens must grow
        inst = HybridInstance(params, cfg, max_seq=128, chunk_tokens=32,
                              token_budget=256, decode_max_batch=4,
                              decode_cadence=0.002, kv_block_size=16,
                              kv_pool_blocks=3, prefix_share=False)
        try:
            if where == "cuda":
                with torch.cuda.stream(inst.stream):
                    torch.cuda._sleep(100_000_000)
                    inst.kv.k_pool.fill_(7.0)
                    inst.kv.v_pool.fill_(9.0)
            req = Request(num_tokens=64, slo=30.0, arrival=time.monotonic(),
                          output_tokens=5, tbt_slo=10.0)
            inst.submit(req, toks)
            assert inst.kv.num_blocks > 3
            assert inst.drain(120.0) and inst.healthy
            if where == "cuda":
                inst.stream.synchronize()
                # blocks 0-2 held the queued fills; the request took the
                # new tail blocks and the scratch row was never written
                assert (inst.kv.k_pool[:, :3] == 7.0).all()
                assert (inst.kv.v_pool[:, :3] == 9.0).all()
        finally:
            inst.shutdown()
        out[where] = inst.finished_jobs[0].emitted
    assert out["cuda"] == out["cpu"]


def _hybrid_prefix_share(params, cfg, prompts):
    """The same prompt twice: the second resumes from the trie-cached
    blocks (the warm path: a gather under the lock seeds `start`)."""
    inst = _tiny_hybrid(params, cfg, prefix_share=True)
    reqs = _serve_in_turn(inst, [prompts[0], prompts[0]])
    assert inst.prefix_hit_tokens == 63
    return _emitted(inst, reqs)


def _hybrid_offload(params, cfg, prompts):
    """Prefills handed off through `_offload` (a gathered buffer and its
    "ready" event) into a `DecodeInstance` on the same device."""
    from repro_torch.serving.decode_instance import DecodeInstance
    dec = DecodeInstance(params, cfg, decode_tokens=5, decode_max_batch=4)
    jobs = []

    def hand(job):
        assert (job.cache["ready"] is None) == (job.cache["k"].is_cpu)
        jobs.append(job)
        dec.submit(job)

    inst = _tiny_hybrid(params, cfg, on_decode_ready=hand)
    try:
        _serve_in_turn(inst, prompts)
        assert dec.drain(120.0) and dec.healthy
    finally:
        dec.shutdown()
    return [dec.outputs[j.request.rid] for j in jobs]


def _hybrid_tier_promotion(params, cfg, prompts):
    """A prompt demoted to the host tier by two others, then resubmitted:
    its blocks are promoted at arrival and settled at its first slice."""
    inst = _tiny_hybrid(params, cfg, prefix_share=True, kv_pool_blocks=11,
                        host_cache_blocks=16)
    reqs = _serve_in_turn(inst, prompts + prompts[:1])
    assert inst.prefix_promotions == 4 and inst.prefix_hit_tokens == 63
    return _emitted(inst, reqs)


def _tiny_hybrid(params, cfg, **kw):
    from repro_torch.serving.hybrid_instance import HybridInstance
    base = dict(max_seq=128, chunk_tokens=32, token_budget=256,
                decode_max_batch=4, decode_cadence=0.002, kv_block_size=16,
                kv_pool_blocks=64, prefix_share=False)
    return HybridInstance(params, cfg, **{**base, **kw})


def _serve_in_turn(inst, prompts):
    """Serve each prompt after the last has drained; the requests."""
    import time

    from repro_torch.core import Request
    reqs = []
    try:
        for toks in prompts:
            reqs.append(Request(num_tokens=len(toks), slo=30.0,
                                arrival=time.monotonic(), output_tokens=5,
                                tbt_slo=10.0))
            inst.submit(reqs[-1], toks)
            assert inst.drain(120.0) and inst.healthy
    finally:
        inst.shutdown()
    free, live, cached, total = inst.kv.accounting()
    assert (free + cached, live) == (total - 1, 1), "the pool leaked"
    return reqs


def _emitted(inst, reqs):
    got = {j.request.rid: j.emitted for j in inst.finished_jobs}
    return [got[r.rid] for r in reqs]


@pytest.mark.parametrize("path", [_hybrid_prefix_share, _hybrid_offload,
                                  _hybrid_tier_promotion],
                         ids=["prefix_share", "offload", "tier_promotion"])
def test_hybrid_path_on_the_card_matches_the_cpu(card, path):
    """The hybrid's stream-ordered paths beyond local decode in plain mode
    (a warm resume from shared blocks, the handoff to a decode instance,
    tier promotion) give the CPU's tokens on the card, through the two
    kernels alone."""
    import copy
    import dataclasses

    from repro_torch.configs.base import get_tiny_config
    from repro_torch.params import init_params

    cfg = dataclasses.replace(get_tiny_config("llama3_8b"), num_layers=2,
                              d_model=128, d_ff=256)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [np.random.default_rng(seed).integers(0, cfg.vocab_size, 64)
               for seed in (40, 41, 42)]
    want = path(p_cpu, cfg, prompts)
    ops.reset_counts()
    got = path(copy.deepcopy(p_cpu).to(card), cfg, prompts)
    launched = ops.counts()
    assert got == want
    assert launched["flash_prefill_attention"] > 0
    assert launched["flash_decode_attention"] > 0
    assert launched["chunked_prefill_attention_ref"] == 0
    assert launched["decode_attention_ref"] == 0


# --- the uniform MoE family on the card ---------------------------------------

MOE_ARCHS = ["qwen3_30b_a3b", "granite_moe_3b"]


def _tiny_moe(arch, card):
    """The tiny MoE config and its seeded f32 weights on the CPU and on
    the card."""
    import copy

    from repro_torch.configs.base import get_tiny_config
    from repro_torch.params import init_params

    cfg = get_tiny_config(arch)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, p_cpu, copy.deepcopy(p_cpu).to(card)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_on_the_card_match_the_cpu(card, arch):
    """The tiny MoE config's chunked prefill logits and one ragged decode
    step over the prefill's cache, card against CPU at 2e-4 in f32 (the
    port's model tolerance), through the two kernels alone."""
    from repro_torch.models.model import decode_step_ragged
    from repro_torch.models.segments import MOE_OPS, SegmentedPrefill

    cfg, p_cpu, p_gpu = _tiny_moe(arch, card)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 72))
    out = {}
    ops.reset_counts()
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        ex = SegmentedPrefill(params, cfg, max_seq=128, chunk_tokens=32)
        assert ex.ops == MOE_OPS
        task = ex.start(toks, lens=[72, 50])
        logits = ex.run_all(task)
        lens = torch.tensor([72, 50], device=params.device)
        dlog, k_new, _ = decode_step_ragged(
            params, cfg, logits.argmax(-1), task.state["k_cache"],
            task.state["v_cache"], lens)
        out[where] = [x.cpu() for x in (logits, dlog, k_new)]
    launched = ops.counts()
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    assert launched["flash_prefill_attention"] > 0
    assert launched["flash_decode_attention"] > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_drops_the_same_pairs_on_the_card(card, arch):
    """At a capacity factor of 0.5 the routed pairs overflow their experts:
    the card's router picks the CPU's experts, keeps and drops the same
    pairs, and its expert output agrees at 2e-5 in f32."""
    from repro_torch.models import layers as L

    cfg, p_cpu, p_gpu = _tiny_moe(arch, card)
    k, E = cfg.experts_per_token, cfg.num_experts
    x = torch.randn(2, 96, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    out = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        p = {key: t[1] for key, t in params["layers"].items()}
        xd = x.to(params.device)
        w, idx, _ = L.moe_router(xd, p["router"], k)
        G, _, cap = L.moe_groups(xd.shape[0] * xd.shape[1], k, E, cfg.d_ff,
                                 capacity_factor=0.5, min_capacity=4)
        _, keep = L.moe_queue(idx, G, E, cap)
        y = L.moe_apply(xd, w, idx, p["wi"], p["wd"], k=k,
                        capacity_factor=0.5, min_capacity=4)
        out[where] = [t.cpu() for t in (idx, keep, w, y)]
    assert not out["cpu"][1].all()
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    for a, b in zip(out["cpu"][2:], out["cuda"][2:]):
        torch.testing.assert_close(b, a, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("op", ["gate", "experts"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_suspend_resume_on_the_card_is_bit_exact(card, op, dtype):
    """A tiny Qwen3-MoE prefill suspended right after the second chunk's
    first `gate` (or `experts`) operator, with another prefill run in
    between, resumes to logits `torch.equal` to an uninterrupted run."""
    from repro_torch.models.segments import SegmentedPrefill

    cfg, _, p_gpu = _tiny_moe("qwen3_30b_a3b", card)
    p_gpu = p_gpu.to(dtype)
    ex = SegmentedPrefill(p_gpu, cfg, max_seq=128, chunk_tokens=32,
                          cache_dtype=dtype)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 96))
    want = ex.run_all(ex.start(toks))
    task = ex.start(toks)
    spc = ex._segments_per_chunk
    stop = spc + ex.ops.index(op) + 1      # the boundary right after `op`
    while task.cursor < stop:
        ex.step(task)
    ex.run_all(ex.start(toks[:1, :40]))
    got = ex.run_all(task)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# --- the recurrent families on the card ---------------------------------------


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b"])
def test_recurrent_prefill_and_decode_on_the_card_match_the_cpu(card, arch):
    """The tiny Mamba2 and RecurrentGemma configs in f32: `prefill` logits
    and 8 `decode_step` logits on the card against the CPU at 2e-4 (the
    port's model tolerance); the tiny hybrid's window of 32 wraps during the
    decode (positions 28 to 35). The hybrid's attention runs the two
    kernels alone."""
    import copy

    from repro_torch.configs.base import get_tiny_config
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.params import init_params

    cfg = get_tiny_config(arch)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(card)
    S = 28
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S + 8))
    out = {}
    ops.reset_counts()
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        t = torch.from_numpy(toks).to(params.device)
        logits, cache = prefill(params, cfg, {"tokens": t[:, :S]},
                                max_seq=S + 8, cache_dtype=torch.float32)
        steps = [logits]
        for i in range(8):
            logits, cache = decode_step(params, cfg, t[:, S + i], cache)
            steps.append(logits)
        out[where] = torch.stack(steps).cpu()
    launched = ops.counts()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=2e-4, atol=2e-4)
    if cfg.family == "hybrid":
        assert launched["flash_prefill_attention"] == 1
        assert launched["flash_decode_attention"] == 8


# --- the remaining families on the card ---------------------------------------


@pytest.mark.parametrize("arch", ["whisper_large_v3", "internvl2_76b",
                                  "llama4_maverick_400b"])
def test_remaining_families_on_the_card_match_the_cpu(card, arch):
    """The tiny Whisper (LayerNorms redrawn), InternVL2 and Llama4 configs
    in f32: `forward` logits, `prefill` logits and every cache leaf, and 3
    `decode_step` logits on the card against the CPU at 2e-4 (the port's
    model tolerance); the card pass launches both kernels and no plain
    version."""
    import copy

    from repro_torch.configs.base import get_tiny_config
    from repro_torch.models.model import decode_step, forward, prefill
    from repro_torch.params import init_params, redraw_norms

    cfg = get_tiny_config(arch)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    if cfg.family == "audio":
        redraw_norms(p_cpu, 1)
    p_gpu = copy.deepcopy(p_cpu).to(card)
    rng = np.random.default_rng(0)
    S = 20
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S + 3))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    out = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        ops.reset_counts()
        b = {k: torch.from_numpy(v).to(params.device)
             for k, v in batch.items()}
        fw = forward(params, cfg, b)
        logits, cache = prefill(params, cfg,
                                dict(b, tokens=b["tokens"][:, :S]),
                                max_seq=S + 3, cache_dtype=torch.float32)
        # a copy: the decode steps write the cache in place
        leaves = {k: v.cpu().clone() for k, v in cache.items()
                  if k != "pos"}
        steps = [logits]
        for i in range(3):
            logits, cache = decode_step(params, cfg, b["tokens"][:, S + i],
                                        cache)
            steps.append(logits)
        out[where] = (fw.cpu(), torch.stack(steps).cpu(), leaves)
    launched = ops.counts()
    for a, b in zip(out["cpu"][:2], out["cuda"][:2]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    for key, leaf in out["cpu"][2].items():
        torch.testing.assert_close(out["cuda"][2][key], leaf, rtol=2e-4,
                                   atol=2e-4)
    assert launched["flash_prefill_attention"] > 0
    assert launched["flash_decode_attention"] > 0
    assert launched["chunked_prefill_attention_ref"] == 0
    assert launched["decode_attention_ref"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vlm_segmented_prefill_on_the_card(card, dtype):
    """The tiny InternVL2 prompt with patch embeddings in 3 chunks on the
    card: within 2e-4 of the CPU in f32, and in both dtypes resumed
    `torch.equal` after a suspension at every operator boundary of chunk 0
    with another prefill in between."""
    import copy

    from repro_torch.configs.base import get_tiny_config
    from repro_torch.models.segments import SegmentedPrefill
    from repro_torch.params import init_params

    cfg = get_tiny_config("internvl2_76b")
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(card).to(dtype)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 40))
    ve = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_patches, cfg.d_model)).astype(np.float32))
    ex = SegmentedPrefill(p_gpu, cfg, max_seq=40, chunk_tokens=16,
                          cache_dtype=dtype)
    want = ex.run_all(ex.start(toks, vision_embeds=ve.to(card, dtype)))
    if dtype == torch.float32:
        cpu = SegmentedPrefill(p_cpu, cfg, max_seq=40, chunk_tokens=16)
        torch.testing.assert_close(
            want.cpu(), cpu.run_all(cpu.start(toks, vision_embeds=ve)),
            rtol=2e-4, atol=2e-4)
    task = ex.start(toks, vision_embeds=ve.to(card, dtype))
    for stop in range(1, ex._segments_per_chunk + 1):
        while task.cursor < stop:
            ex.step(task)
        ex.run_all(ex.start(toks[:1, :12]))
    got = ex.run_all(task)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# --- training: FlashAttention's gradient and a deterministic restart --------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # B, S, H, K, hd, causal, window
    (2, 300, 8, 2, 64, True, 0),
    (1, 200, 4, 4, 128, True, 64),
    (2, 130, 4, 2, 32, False, 0),
])
def test_flash_attention_gradient_on_the_card(card, case, dtype):
    """`FlashAttention` on the card (the CUDA prefill kernel forward, the
    blockwise backward in f32 torch ops) against the plain versions on the
    CPU in f32 on the same inputs: out against the plain forward, dq, dk
    and dv against the plain backward given the kernel's out, within the
    file's limit for the dtype. The forward launches the kernel once and
    its plain version never; the backward runs once."""
    from repro_torch.models.layers import blocked_attention
    B, S, H, K, hd, causal, window = case
    mask = dict(causal=causal, local_window=window, block=128)
    gen = torch.Generator(device=card).manual_seed(11)
    q = _randn((B, S, H, hd), dtype, gen, card)
    k, v = (_randn((B, S, K, hd), dtype, gen, card) for _ in range(2))
    dout = _randn((B, S, H, hd), dtype, gen, card)
    counts.reset()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = blocked_attention(*leaves, **mask)
    out.backward(dout)
    torch.cuda.synchronize()
    launched = {**ops.counts(), **counts.read(["flash_attention_bwd_ref"])}
    assert launched["flash_prefill_attention"] == 1
    assert launched["chunked_prefill_attention_ref"] == 0
    assert launched["flash_attention_bwd_ref"] == 1
    cpu = [x.cpu().float() for x in (q, k, v, out.detach(), dout)]
    want = [ref.chunked_prefill_attention_ref(
        *cpu[:3], causal=causal, local_window=window)]
    want += ref.flash_attention_bwd_ref(*cpu, **mask)
    got = [out] + [x.grad for x in leaves]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.detach().cpu().float(), w,
                                   **TOL[dtype], msg=name)
    counts.reset()


_RESTART = """
import tempfile, torch
from repro_torch.configs.base import get_tiny_config
from repro_torch.params import init_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, data_iterator
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.train import make_train_step
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_tiny_config("llama3_2_1b")
step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=1),
                       remat="full")
data = DataConfig(seq_len=64, global_batch=4, vocab_size=cfg.vocab_size)

def fresh():
    p = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                    dtype=torch.bfloat16, trainable=True)
    return p, init_state(p)

def run(p, s, start, n):
    it = data_iterator(data, start_step=start)
    for _ in range(n):
        p, s, _ = step(p, s, next(it))
    return p, s

p_full, s_full = run(*fresh(), 0, 4)
p, s = run(*fresh(), 0, 2)
with tempfile.TemporaryDirectory() as d:
    ckpt.save(d, 2, {"params": p, "opt_state": s})
    back = ckpt.restore(d, 2, {"params": p, "opt_state": s})
p, s = run(back["params"], back["opt_state"], 2, 2)
same = [torch.equal(a, b) for a, b in zip(
    [*p_full.leaves().values(), *s_full.m.values(), *s_full.v.values()],
    [*p.leaves().values(), *s.m.values(), *s.v.values()])]
print(sum(same), len(same))
"""


def test_restart_on_the_card_is_bit_exact(card):
    """The reference's restart equivalence on the card, in bf16 with f32
    AdamW state and remat full: 4 steps straight against 2 steps, save,
    restore and 2 steps, every parameter and m, v `torch.equal`. It runs
    under `torch.use_deterministic_algorithms` in a process of its own,
    where CUBLAS_WORKSPACE_CONFIG is set before cuBLAS starts."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, "-c", _RESTART], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    same, n = map(int, out.stdout.split()[-2:])
    assert n == 3 * 10 and same == n, out.stdout


_SHARDED = """
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from repro_torch.distributed.sharding import distribute
from repro_torch.kernels import ops

torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("nccl", store=dist.FileStore(sys.argv[1], 1),
                        rank=0, world_size=1)
mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
gen = torch.Generator(device="cuda").manual_seed(0)

def randn(*shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()

out = {}
q, k, v = randn(2, 200, 8, 128), randn(2, 700, 2, 128), randn(2, 700, 2, 128)
heads = [Shard(0), Shard(2)]             # batch on data, heads on model
kw = dict(q_offset=450, kv_len=650, causal=True)
want = ops.prefill_attention(q, k, v, **kw)
ops.reset_counts()
got = ops.prefill_attention(distribute(q, mesh, heads),
                            distribute(k, mesh, heads),
                            distribute(v, mesh, heads), **kw)
out["prefill"] = [ops.counts(), torch.equal(got.full_tensor(), want),
                  [str(p) for p in got.placements]]
qd = randn(4, 32, 128)
kc, vc = randn(4, 4096, 8, 128), randn(4, 4096, 8, 128)
lens = torch.tensor([1, 1000, 2600, 4096], device="cuda", dtype=torch.int32)
want = ops.decode_attention(qd, kc, vc, lens)
ops.reset_counts()
seq = [Shard(0), Shard(1)]               # serve_rules' cache: seq on model
got = ops.decode_attention(distribute(qd, mesh, [Shard(0), Shard(1)]),
                           distribute(kc, mesh, seq),
                           distribute(vc, mesh, seq), lens)
out["decode"] = [ops.counts(), torch.equal(got.full_tensor(), want),
                 [str(p) for p in got.placements]]
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_dtensor_attention_launches_the_kernels(card, tmp_path):
    """On a 1-rank NCCL (data 1, model 1) mesh, DTensors through
    `ops.prefill_attention` and `ops.decode_attention` reach the kernels on
    their local shards (a sequence-sharded cache gathered first), launch
    each once with no plain version, and equal the plain-tensor call. In a
    process of its own: the group is the process's default one."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", _SHARDED,
                          str(tmp_path / "store")],
                         env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name, kernel, plain in (
            ("prefill", "flash_prefill_attention",
             "chunked_prefill_attention_ref"),
            ("decode", "flash_decode_attention", "decode_attention_ref")):
        counts_, equal, place = got[name]
        assert counts_[kernel] == 1 and counts_[plain] == 0, got
        assert equal and place == ["S(0)", "S(1)" if name == "decode"
                                   else "S(2)"], got


def test_quickstart_example_resumes_bit_exact_on_the_card(card):
    """examples/quickstart_torch.py at its tiny config on the card (bf16):
    B preempts A at an operator boundary, and A's resumed first-token
    logits are `torch.equal` to an uninterrupted prefill's, through the
    prefill kernel alone."""
    import importlib.util
    from pathlib import Path

    from repro_torch.launch.serve import draw_params
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    qs = cs.load_example("quickstart_torch")
    cfg = qs.config()
    params = draw_params(cfg, card, 0)
    ex, _, pred = qs.setup(params, cfg)
    ops.reset_counts()
    res = qs.walkthrough(params, cfg, ex, pred)
    got = ops.counts()
    assert res["preemptions"] >= 1
    assert res["bit_exact"]
    assert got["flash_prefill_attention"] > 0
    assert got["chunked_prefill_attention_ref"] == 0


_MIGRATED = """
import json
import numpy as np
import torch
from repro_torch.configs.base import get_tiny_config
from repro_torch.core import Request
from repro_torch.launch.serve import draw_params
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.serving.decode_instance import DecodeInstance, DecodeJob

cfg = get_tiny_config("llama3_8b")
params = draw_params(cfg, "cuda", 0)
ex = SegmentedPrefill(params, cfg, max_seq=256, granularity="op",
                      chunk_tokens=128, cache_dtype=params.dtype)
prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 200))
task = ex.start(prompt)
ex.run_all(task)
torch.cuda.synchronize()
st, first = task.state, int(task.logits.argmax(-1)[0])
done = {"k": st["k_cache"][:, 0:1], "v": st["v_cache"][:, 0:1],
        "pos": int(st["lens"][0])}
src = DecodeInstance(params, cfg, decode_tokens=8, decode_max_batch=4)
dst = DecodeInstance(params, cfg, decode_tokens=8, decode_max_batch=4)
try:
    # the receiver first decodes the finished cache itself: its pool,
    # stream and GEMM handles exist before the migrated job arrives, so no
    # first-use allocation synchronises the card for it
    want = Request(num_tokens=200, slo=60.0, output_tokens=8)
    dst.submit(DecodeJob(request=want, cache=dict(done), first_token=first))
    assert dst.drain(60.0)
    producer = torch.cuda.Stream()
    with torch.cuda.stream(producer):
        # NaN, then ~0.3 s of spin, then the cache: the host waits for none
        # of it
        k = torch.full_like(done["k"], float("nan"))
        v = torch.full_like(done["v"], float("nan"))
        torch.cuda._sleep(int(5e8))
        k.copy_(done["k"])
        v.copy_(done["v"])
        ready = torch.cuda.Event()
        ready.record()
    src.inject_fault(("hang", 1.0))              # keeps the job queued
    req = Request(num_tokens=200, slo=60.0, output_tokens=8)
    src.submit(DecodeJob(request=req, cache={"k": k, "v": v,
                                             "pos": done["pos"],
                                             "ready": ready},
                         first_token=first))
    moved = src.take([req.rid])
    in_flight = len(moved) == 1 and moved[0].cache["ready"] is ready \
        and not ready.query()
    dst.submit(moved[0])
    assert dst.drain(60.0)
    print(json.dumps({"in_flight": in_flight,
                      "got": dst.outputs[req.rid],
                      "want": dst.outputs[want.rid]}))
finally:
    src.shutdown()
    dst.shutdown()
"""


def test_migrated_handoff_waits_for_its_producer_on_the_card(card):
    """A handoff that migrates between decode instances before either
    ingests it (`DecodeInstance.take`, as the Proxy's `rebalance_decodes`
    moves queued jobs) carries its cache and the producing stream's
    `ready` event. Here the producer is still writing the cache (NaN
    behind a spin) when the job moves, so the receiver must wait on that
    event, not on its own stream: its tokens must equal its own decode of
    the finished cache. In a process of its own with 32 hardware queues,
    so that no queue the two streams share orders them anyway."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", _MIGRATED],
                         env=dict(os.environ, PYTHONPATH=str(src),
                                  CUDA_DEVICE_MAX_CONNECTIONS="32"),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["in_flight"], got
    assert got["got"] == got["want"], got
