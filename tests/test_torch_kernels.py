"""The port's attention on the CPU (`kernels.ops`, which takes the plain
PyTorch versions for a CPU tensor) against the JAX package: its Pallas
kernels run in interpret mode and its pure-jnp oracles, on the reference's
own cases and tolerances (tests/test_kernels.py), in f32. The CUDA kernels
themselves are held against the same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py; the bf16 arithmetic of the
prefill kernel's tensor-core body and of the split-KV decode/verify body is
emulated here and held against the Pallas kernels in the port's bf16
limit."""
import math

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
    # RecurrentGemma's head_dim 256 with one KV head: a window from
    # position 0, and a resumed chunk at q_offset 160 whose window binds
    (1, 96, 96, 4, 1, 256, 0, True, 32),
    (1, 40, 200, 4, 1, 256, 160, True, 64),
]

DECODE_CASES = [
    # B, T, H, K, hd, kv_len (tests/test_kernels.py:94)
    (1, 256, 8, 8, 64, 256),
    (2, 512, 8, 2, 64, 300),
    (4, 128, 4, 1, 128, 77),
    (1, 1024, 16, 8, 64, 1000),
    (2, 160, 16, 1, 256, 97),             # RecurrentGemma's MQA at hd 256
]

VERIFY_CASES = [
    # B, S, T, H, K, hd, per-row kv_len: GQA 4/1/8 query heads per KV head,
    # a row of length 0, ragged rows, a row whose last query sees key T - 1
    (3, 5, 300, 8, 2, 64, [0, 37, 295]),
    (2, 1, 128, 4, 4, 32, [5, 127]),
    (2, 3, 96, 8, 1, 16, [0, 93]),
    (2, 3, 96, 4, 1, 256, [0, 93]),
]


# the port's bf16 limit per element, atol + rtol * |reference|
# (chip_smoke.py, tests/test_torch_cuda.py)
BF16_ATOL, BF16_RTOL = 1e-5, 1.6e-2
LOG2E = 1.4426950408889634


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


def tensor_core_emulation(q, k, v, q_offset, kv_len, causal, window, terms,
                          block_q=128, block_k=128):
    """The arithmetic the prefill kernel's tensor-core bodies commit to
    (`csrc/flash_prefill.cu`, `prefill_tc_kernel`, and `prefill_mma_kernel`
    with block_q 64 and block_k 32), in plain PyTorch: bf16
    q/k/v, scores summed in f32 and scaled by log2(e)/sqrt(hd), an online
    softmax over block_k-key tiles from the first tile the query block's
    loop visits (keys past kv_len read as zeros), exp2, p zeroed under the
    mask after the exp, l summed from the f32 p, P fed to the P V product
    as two bf16 terms (P_hi = p cut to its top 16 bits, P_lo = bf16(p -
    P_hi)) or, with `terms` 1, as one (bf16(p)), O in f32, and a bf16
    output. Returns it in f32."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    kv_end = min(kv_len, T)
    scale = torch.tensor(1.0 / math.sqrt(hd)) * torch.tensor(LOG2E)
    q = q.to(torch.bfloat16).float()
    k, v = (x.to(torch.bfloat16).float().repeat_interleave(H // K, dim=2)
            for x in (k, v))
    out = torch.zeros(B, Sq, H, hd)
    fill = torch.tensor(-1e30)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        qpos = q_offset + torch.arange(q0, q1)[:, None]
        k_stop = min(kv_end, q_offset + q1) if causal else kv_end
        k_begin = (max(0, q_offset + q0 - window + 1) // block_k * block_k
                   if window else 0)
        qb = q[:, q0:q1].transpose(1, 2)                  # (B, H, rows, hd)
        m = torch.full((B, H, q1 - q0, 1), -math.inf)
        l = torch.zeros(B, H, q1 - q0, 1)
        acc = torch.zeros(B, H, q1 - q0, hd)
        for k_lo in range(k_begin, k_stop, block_k):
            n = min(k_lo + block_k, kv_end) - k_lo
            kt = torch.zeros(B, H, block_k, hd)
            vt = torch.zeros(B, H, block_k, hd)
            kt[:, :, :n] = k[:, k_lo:k_lo + n].transpose(1, 2)
            vt[:, :, :n] = v[:, k_lo:k_lo + n].transpose(1, 2)
            s = qb @ kt.transpose(2, 3) * scale
            key = k_lo + torch.arange(block_k)[None, :]
            mask = key < kv_end
            if causal:
                mask = mask & (key <= qpos)
            if window:
                mask = mask & (key > qpos - window)
            s = torch.where(mask, s, fill)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(mask, torch.exp2(s - m_new), torch.tensor(0.0))
            l = l * alpha + p.sum(-1, keepdim=True)
            if terms == 2:
                p_hi = (p.view(torch.int32) & -65536).view(torch.float32)
                pv = p_hi @ vt + (p - p_hi).to(torch.bfloat16).float() @ vt
            else:
                pv = p.to(torch.bfloat16).float() @ vt
            acc = acc * alpha + pv
            m = m_new
        o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, q0:q1] = o.to(torch.bfloat16).float().transpose(1, 2)
    return out


def _against_pallas_bf16(case, terms):
    """Worst element of the emulation against the JAX Pallas kernel
    (interpret mode, f32, on the same bf16-rounded inputs), as a multiple
    of the port's bf16 limit. At head_dim 256 the body (mma.sync) takes
    64-query blocks and 32-key tiles."""
    B, Sq, T, H, K, hd, qoff, causal, window = case
    arrays = [a.astype(jnp.bfloat16).astype(np.float32)
              for a in qkv(9, (B, Sq, H, hd), (B, T, K, hd))]
    (tq, tk, tv), (jq, jk, jv) = both(*arrays)
    tiles = dict(block_q=64, block_k=32) if hd == 256 else {}
    got = tensor_core_emulation(tq, tk, tv, qoff, T, causal, window, terms,
                                **tiles)
    want = torch.from_numpy(np.array(jops.prefill_attention(
        jq, jk, jv, q_offset=qoff, causal=causal, local_window=window,
        impl="pallas_interpret", block_q=64, block_k=128)))
    return ((got - want).abs()
            / (BF16_ATOL + BF16_RTOL * want.abs())).max().item()


TENSOR_CORE_CASES = [c for c in PREFILL_CASES if c[5] in (64, 128, 256)]


@pytest.mark.parametrize("case", TENSOR_CORE_CASES)
def test_tensor_core_arithmetic_within_bf16_limit(case):
    """With P as two bf16 terms, the body's arithmetic stays inside the bf16
    limit of the f32 Pallas kernel: what remains is the output's own
    rounding (at most 2^-8 of a value, a quarter of the limit)."""
    assert _against_pallas_bf16(case, terms=2) <= 1.0


@pytest.mark.parametrize("case", TENSOR_CORE_CASES)
def test_one_bf16_p_term_exceeds_bf16_limit(case):
    """Why the body splits P: rounding p to a single bf16 before P V moves
    outputs near zero by ~2^-9 / sqrt(keys), many times the 1e-5 atol."""
    assert _against_pallas_bf16(case, terms=1) > 1.0


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


def test_decode_ragged_head_dim_256():
    """RecurrentGemma's ring decode: 16 query heads on one KV head of 256,
    per-row kv_len from 1 to the whole ring."""
    B, T, H, K, hd = 4, 160, 16, 1, 256
    lens = np.asarray([1, 70, 160, 33], np.int32)
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(12, (B, H, hd), (B, T, K, hd)))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens)).numpy()
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                   impl="pallas_interpret", block_k=128)
    oracle = jref.decode_attention_ref(jq, jk, jv, kv_len=jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)
    np.testing.assert_allclose(got[0], np.repeat(tv.numpy()[0, 0], H, axis=0),
                               **F32)


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_verify_plain_matches_pallas_and_naive(case):
    """The plain verify attention against the JAX Pallas verify kernel in
    interpret mode and the reference's own non-Pallas path
    (naive_attention, causal, q_offset = kv_len); column 0 against the
    plain decode attention at kv_len + 1."""
    from repro.kernels.decode_attn import flash_verify_attention as jverify
    from repro.models.layers import naive_attention as jnaive
    B, S, T, H, K, hd, lens = case
    lens = np.asarray(lens, np.int32)
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(8, (B, S, H, hd), (B, T, K, hd)))
    got = ops.verify_attention(tq, tk, tv, torch.from_numpy(lens)).numpy()
    pallas = jverify(jq, jk, jv, jnp.asarray(lens), block_k=128,
                     interpret=True)
    naive = jnaive(jq, jk, jv, causal=True, q_offset=jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, np.asarray(naive), **F32)
    col0 = ref.decode_attention_ref(tq[:, 0], tk, tv,
                                    kv_len=torch.from_numpy(lens + 1))
    np.testing.assert_allclose(got[:, 0], col0.numpy(), **F32)


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
    ops.verify_attention(q[:, :3], k, v, 4)
    assert ops.counts() == {"flash_prefill_attention": 0,
                            "flash_prefill_wgmma": 0,
                            "flash_decode_attention": 0,
                            "flash_verify_attention": 0,
                            "chunked_prefill_attention_ref": 1,
                            "decode_attention_ref": 1,
                            "verify_attention_ref": 1}
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



# the decode/verify body's fixed split and per-warp key tile
# (`csrc/decode_attn.cu`: split_keys<HD>, WKEYS)
WARP_KEYS = 32


def split_of(hd):
    """Keys per split block: four warps up to head_dim 128, one at 256."""
    return 32 if hd > 128 else 128


def _merge(ms, ls, accs):
    """Combine online-softmax states in list order (m in log2 units), as the
    body merges its warps and the combine kernel its splits."""
    m = torch.stack(ms).amax(0)
    e = [torch.exp2(mi - m) for mi in ms]
    l = e[0] * ls[0]
    acc = e[0] * accs[0]
    for ei, li, ai in zip(e[1:], ls[1:], accs[1:]):
        l = l + ei * li
        acc = acc + ei * ai
    return m, l, acc


def split_kv_emulation(q, k, v, kv_len, shift, terms):
    """The arithmetic the decode/verify body commits to for bf16
    (`csrc/decode_attn.cu`), in plain PyTorch: q (B, S, H, hd), query s of
    row b at position kv_len[b] + shift + s seeing keys [0, min(that + 1,
    T)); bf16 q/k/v, scores summed in f32 and scaled by log2(e)/sqrt(hd);
    each 32-key warp tile of each split (128 keys, 32 at head_dim 256)
    takes its own max, exp2 and
    l from the f32 p; P V with P as two bf16 terms (P_hi = p cut to its top
    16 bits, P_lo = bf16(p - P_hi)) or, with `terms` 1, as one; the warps of
    a split merged in order, then the splits in ascending order, each
    skipping the parts in which the row saw no key; a row that saw no key is
    0; a bf16 output. Returns it in f32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(hd)) * torch.tensor(LOG2E)
    q = q.to(torch.bfloat16).float()
    k, v = (x.to(torch.bfloat16).float().repeat_interleave(H // K, dim=2)
            for x in (k, v))
    out = torch.zeros(B, S, H, hd)
    for b in range(B):
        for s in range(S):
            end = max(0, min(int(kv_len[b]) + shift + s + 1, T))
            splits = []
            for lo in range(0, end, split_of(hd)):
                warps = []
                for w0 in range(lo, min(lo + split_of(hd), end), WARP_KEYS):
                    w1 = min(w0 + WARP_KEYS, end)
                    x = torch.einsum("hd,thd->ht", q[b, s], k[b, w0:w1]) * scale
                    m = x.amax(-1, keepdim=True)
                    p = torch.exp2(x - m)
                    vt = v[b, w0:w1].transpose(0, 1)              # (H, t, hd)
                    if terms == 2:
                        p_hi = (p.view(torch.int32) & -65536).view(
                            torch.float32)
                        p_lo = (p - p_hi).to(torch.bfloat16).float()
                        acc = (torch.einsum("ht,htd->hd", p_hi, vt)
                               + torch.einsum("ht,htd->hd", p_lo, vt))
                    else:
                        acc = torch.einsum("ht,htd->hd",
                                           p.to(torch.bfloat16).float(), vt)
                    warps.append((m, p.sum(-1, keepdim=True), acc))
                splits.append(_merge(*zip(*warps)))
            if splits:
                _, l, acc = _merge(*zip(*splits))
                out[b, s] = (acc / l).to(torch.bfloat16).float()
    return out


SPLIT_KV_CASES = (
    [("decode", B, 1, T, H, K, hd, [n] * B)
     for B, T, H, K, hd, n in DECODE_CASES]
    + [("decode", 4, 1, 256, 8, 2, 32, [1, 77, 256, 130])]
    + [("verify",) + c for c in VERIFY_CASES])


def _split_kv_against_pallas(case, terms):
    """Worst element of the emulation against the JAX Pallas decode or
    verify kernel (interpret mode, f32, on the same bf16-rounded inputs), as
    a multiple of the port's bf16 limit."""
    from repro.kernels.decode_attn import flash_verify_attention as jverify
    kind, B, S, T, H, K, hd, lens = case
    arrays = [a.astype(jnp.bfloat16).astype(np.float32)
              for a in qkv(10, (B, S, H, hd), (B, T, K, hd))]
    (tq, tk, tv), (jq, jk, jv) = both(*arrays)
    jlens = jnp.asarray(lens, jnp.int32)
    if kind == "decode":
        got = split_kv_emulation(tq, tk, tv, lens, -1, terms)[:, 0]
        want = jops.decode_attention(jq[:, 0], jk, jv, jlens,
                                     impl="pallas_interpret", block_k=128)
    else:
        got = split_kv_emulation(tq, tk, tv, lens, 0, terms)
        want = jverify(jq, jk, jv, jlens, block_k=128, interpret=True)
    want = torch.from_numpy(np.array(want))
    return ((got - want).abs()
            / (BF16_ATOL + BF16_RTOL * want.abs())).max().item()


@pytest.mark.parametrize("case", SPLIT_KV_CASES)
def test_split_kv_arithmetic_within_bf16_limit(case):
    """The decode/verify body's bf16 arithmetic (fixed splits, per-warp
    softmax, tensor-core products with P as two bf16 terms, ordered merges)
    stays inside the port's bf16 limit of the f32 Pallas kernels."""
    assert _split_kv_against_pallas(case, terms=2) <= 1.0


@pytest.mark.parametrize("case", SPLIT_KV_CASES)
def test_split_kv_one_bf16_p_term_exceeds_bf16_limit(case):
    """Why the decode/verify body splits P as the prefill body does: one
    bf16 P term puts outputs near zero outside the limit."""
    assert _split_kv_against_pallas(case, terms=1) > 1.0


def test_split_kv_verify_column0_equals_decode():
    """In the emulation, verify's column 0 at S = 5 is bit-equal to decode
    at kv_len + 1: the same splits and warp tiles, per-row sums in a fixed
    order. Rows cross a split boundary (kv_len 127, 128) and one is
    empty."""
    B, S, T, H, K, hd = 4, 5, 300, 8, 2, 64
    lens = [0, 127, 128, 295]
    tq, tk, tv = (torch.from_numpy(a)
                  for a in qkv(11, (B, S, H, hd), (B, T, K, hd)))
    ver = split_kv_emulation(tq, tk, tv, lens, 0, terms=2)
    dec = split_kv_emulation(tq[:, :1], tk, tv, [n + 1 for n in lens], -1,
                             terms=2)
    assert torch.equal(ver[:, 0], dec[:, 0])
    assert torch.count_nonzero(dec) == dec.numel()
