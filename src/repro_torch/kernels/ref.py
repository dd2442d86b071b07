"""Plain PyTorch versions of the attention kernels: the oracles the CPU
tests hold the JAX package against, the path `kernels.ops` takes for a tensor
on the CPU, and what `chip_smoke.py` compares each CUDA kernel with on the
card. Each counts its calls (`kernels.counts`) so a run can show that the
main path on the card never reached them.

Counterparts: `chunked_prefill_attention_ref` and `decode_attention_ref` of
src/repro/kernels/ref.py, `naive_attention` of src/repro/models/layers.py.
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
    """Full score matrix in f32; fully masked rows output 0."""
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
    return out.reshape(B, Sq, H, hd).to(q.dtype)


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
    """Plain version of `flash_prefill_attention`: (B, Sq, H, hd)."""
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
