"""Plain PyTorch versions of the attention kernels: the oracles the CPU
tests hold the JAX package against, the path `kernels.ops` takes for a tensor
on the CPU, and what `chip_smoke.py` compares each CUDA kernel with on the
card. Each counts its calls (`kernels.counts`) so a run can show that the
main path on the card never reached them.

Counterparts: `chunked_prefill_attention_ref` and `decode_attention_ref` of
src/repro/kernels/ref.py, `naive_attention` of src/repro/models/layers.py,
`verify_attention_ref`, the reference's own non-Pallas verify path
(src/repro/kernels/ops.py:87-88), and `flash_attention_bwd_ref`, the
backward of the reference's `blocked_attention` (its `_flash_bwd`,
src/repro/models/layers.py:184-217), which no kernel replaces: the TPU
kernel has no backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import counts


def _per_row(x, device) -> torch.Tensor:
    """A scalar or per-row (B,) offset/length as an int64 tensor shaped to
    broadcast over (B or 1, S, T)."""
    return torch.as_tensor(x, device=device).to(torch.int64).reshape(-1, 1, 1)


def _mask(Sq: int, T: int, q_offset, kv_len, causal: bool, local_window: int,
          device, k_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    q_pos = torch.arange(Sq, device=device)[:, None] + _per_row(q_offset, device)
    if k_positions is not None:
        k_pos = k_positions.to(device=device, dtype=torch.int64)[None, None, :]
    else:
        k_pos = torch.arange(T, device=device)[None, None, :]
    mask = torch.ones((1, Sq, T), dtype=torch.bool, device=device)
    if k_positions is not None:
        mask = mask & (k_pos >= 0)                         # unwritten ring slots
    if causal:
        mask = mask & (k_pos <= q_pos)
    if local_window:
        mask = mask & (k_pos > q_pos - local_window)
    if kv_len is not None:
        mask = mask & (k_pos < _per_row(kv_len, device))
    return mask                                            # (B or 1, Sq, T)


def _attention_ref(q, k, v, *, q_offset=0, kv_len=None, causal=True,
                   local_window=0) -> torch.Tensor:
    """Full score matrix in f32; fully masked rows output 0. v may be of
    another width than q and k (latent attention's 128 against 192)."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd).float()
    scores = torch.einsum("bskqh,btkh->bkqst", qg, k.float()) / math.sqrt(hd)
    mask = _mask(Sq, T, q_offset, kv_len, causal, local_window, q.device)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe)
    p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkqst,btkh->bskqh", probs, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def chunked_prefill_attention_ref(
    q: torch.Tensor,            # (B, Sq, H, hd) — current prefill chunk
    k: torch.Tensor,            # (B, T, K, hd)  — all KV up to chunk end
    v: torch.Tensor,            # (B, T, K, hd)
    *,
    q_offset=0,                 # absolute position of q[0]; int or (B,)
    kv_len=None,                # valid keys; int or (B,)
    causal: bool = True,
    local_window: int = 0,
) -> torch.Tensor:
    """Plain version of `flash_prefill_attention`: (B, Sq, H, v's
    width)."""
    counts.bump("chunked_prefill_attention_ref")
    return _attention_ref(q, k, v, q_offset=q_offset, kv_len=kv_len,
                          causal=causal, local_window=local_window)


def decode_attention_ref(
    q: torch.Tensor,            # (B, H, hd) — single new token
    k: torch.Tensor,            # (B, T, K, hd)
    v: torch.Tensor,            # (B, T, K, hd)
    *,
    kv_len,                     # number of valid cache entries; int or (B,)
) -> torch.Tensor:
    """Plain version of `flash_decode_attention`: (B, H, hd)."""
    counts.bump("decode_attention_ref")
    q_off = torch.as_tensor(kv_len, device=q.device).to(torch.int64) - 1
    return _attention_ref(q[:, None], k, v, q_offset=q_off, causal=True)[:, 0]


def verify_attention_ref(
    q: torch.Tensor,            # (B, S, H, hd) — S consecutive positions
    k: torch.Tensor,            # (B, T, K, hd) with the draft K/V written
    v: torch.Tensor,            # (B, T, K, hd)
    kv_len,                     # committed length (query 0's position); int
                                # or (B,)
) -> torch.Tensor:
    """Plain version of `flash_verify_attention`: (B, S, H, hd), query s of
    row b attending to keys [0, kv_len[b] + s]. It is the reference's
    `naive_attention(q, k, v, causal=True, q_offset=kv_len)`, computed in
    f32: key 0 is always visible, so no row is fully masked and the -1e30
    fill of `naive_attention` and the zero rows here never differ."""
    counts.bump("verify_attention_ref")
    return _attention_ref(q, k, v, q_offset=kv_len, causal=True)


def naive_attention(
    q: torch.Tensor,                  # (B, S, H, hd)
    k: torch.Tensor,                  # (B, T, K, hd)
    v: torch.Tensor,                  # (B, T, K, hd)
    *,
    causal: bool = True,
    q_offset=0,                       # absolute position of q[0]; int or (B,)
    local_window: int = 0,
    kv_len=None,                      # valid kv length; int or (B,)
    k_positions: Optional[torch.Tensor] = None,  # (T,) ring-buffer positions
) -> torch.Tensor:
    """Reference attention with the JAX package's -1e30 fill: a fully masked
    row gets a uniform softmax here, where the kernels output 0. Returns
    (B, S, H, hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskqh,btkh->bkqst", qg.float(),
                          k.float()) / math.sqrt(hd)
    mask = _mask(S, T, q_offset, kv_len, causal, local_window, q.device,
                 k_positions)
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkqst,btkh->bskqh", probs.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def _key_blocks(T: int, block: int):
    """[start, end) of each block of `block` keys; the last may be short
    (the reference pads it with zero keys that its mask removes)."""
    return [(t, min(t + block, T)) for t in range(0, T, block)]


def _row_lse(qg, k, mask, scale: float, block: int) -> torch.Tensor:
    """Each query row's log-sum-exp over its visible keys, formed as the
    reference's `_flash_fwd_impl` forms it (src/repro/models/layers.py:
    135-168): an online max and sum over the key blocks, then m + log(l),
    and +inf for a row with no visible key. qg: (B, K, Q*S, hd) f32; k:
    (B, T, K, hd); mask: (B or 1, S, T). Returns (B, K, Q*S, 1)."""
    B, K, QS, _ = qg.shape
    S = mask.shape[1]
    m = torch.full((B, K, QS, 1), float("-inf"), device=qg.device)
    l = torch.zeros((B, K, QS, 1), device=qg.device)
    for t0, t1 in _key_blocks(k.shape[1], block):
        s = (qg @ k[:, t0:t1].float().permute(0, 2, 3, 1)) * scale
        s.view(B, K, -1, S, t1 - t0).masked_fill_(
            ~mask[:, None, None, :, t0:t1], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        # exp(-inf - m_safe) is 0: the masked scores drop out of the sum
        l = l * alpha + s.sub_(m_safe).exp_().sum(dim=-1, keepdim=True)
        m = m_new
        del s
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    return torch.where(l == 0.0, float("inf"),
                       m_safe + torch.log(torch.clamp(l, min=1e-30)))


def flash_attention_bwd_ref(
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, T, K, hd)
    v: torch.Tensor,            # (B, T, K, hd)
    out: torch.Tensor,          # (B, S, H, hd), the forward's output
    dout: torch.Tensor,         # (B, S, H, hd)
    *,
    q_offset=0,                 # absolute position of q[0]; int or (B,)
    kv_len=None,                # valid keys; int or (B,)
    causal: bool = True,
    local_window: int = 0,
    block: int = 1024,
):
    """Gradients (dq, dk, dv) of attention, in the dtypes of q, k and v:
    the reference's flash backward (`_flash_bwd`), in f32 over blocks of
    `block` keys. Each row's log-sum-exp is formed first by one sweep over
    the blocks (`_row_lse`; the kernel that computed `out` keeps none), then
    per block p = exp(s - lse) under the mask recomputes the exact
    probabilities, and dv = p^T dout, dp = dout v^T, ds = p (dp - D) with
    D = rowsum(dout * out), dq += ds k, dk = ds^T q (scaled by 1/sqrt(hd)).
    Every (query, key) pair of a block is computed, visible or not, as in
    the reference. No block state is kept past its own step."""
    counts.bump("flash_attention_bwd_ref")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    Q = H // K
    scale = 1.0 / math.sqrt(hd)
    mask = _mask(S, T, q_offset, T if kv_len is None else kv_len, causal,
                 local_window, q.device)

    def grouped(x):             # (B, S, H, hd) -> (B, K, Q*S, hd) f32
        return x.float().reshape(B, S, K, Q, hd).permute(0, 2, 3, 1, 4) \
            .reshape(B, K, Q * S, hd)

    qg, og, dog = grouped(q), grouped(out), grouped(dout)
    lse = _row_lse(qg, k, mask, scale, block)
    lse_safe = torch.where(torch.isfinite(lse), lse, 0.0)
    d_row = (dog * og).sum(dim=-1, keepdim=True)            # (B,K,QS,1)
    del og
    dq = torch.zeros_like(qg)
    dk, dv = [], []
    for t0, t1 in _key_blocks(T, block):
        kc = k[:, t0:t1].float().transpose(1, 2)            # (B,K,blk,hd)
        vc = v[:, t0:t1].float().transpose(1, 2)
        p = (qg @ kc.transpose(-1, -2)).mul_(scale).sub_(lse_safe).exp_()
        p.view(B, K, Q, S, t1 - t0).masked_fill_(
            ~mask[:, None, None, :, t0:t1], 0.0)            # exact probs
        dv.append((p.transpose(-1, -2) @ dog).to(v.dtype))
        ds = (dog @ vc.transpose(-1, -2)).sub_(d_row).mul_(p)
        del p
        dq += (ds @ kc) * scale
        dk.append(((ds.transpose(-1, -2) @ qg) * scale).to(k.dtype))
        del ds
    dq = dq.reshape(B, K, Q, S, hd).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return (dq.to(q.dtype),
            torch.cat(dk, dim=2).transpose(1, 2).contiguous(),
            torch.cat(dv, dim=2).transpose(1, 2).contiguous())
