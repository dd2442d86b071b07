"""Attention dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel, and the call raises if the
kernel cannot build or launch; a CPU tensor goes to the plain PyTorch
version. There is no other choice: no `impl` argument, and no fallback from
the card to the plain version.

Counterpart of src/repro/kernels/ops.py. `counts()` and `reset_counts()`
read and clear the kernels' launch counters and the plain versions' call
counters, so a run can show which path it went through.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import counts as _counts
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attn import flash_decode_attention
from repro_torch.kernels.flash_prefill import flash_prefill_attention


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"no attention path for device {x.device}")


def prefill_attention(q, k, v, *, q_offset=0, kv_len=None, causal=True,
                      local_window=0) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,T,K,hd) -> (B,Sq,H,hd)."""
    if _route(q) == "cuda":
        return flash_prefill_attention(q, k, v, q_offset, kv_len,
                                       causal=causal,
                                       local_window=local_window)
    return ref.chunked_prefill_attention_ref(
        q, k, v, q_offset=q_offset, kv_len=kv_len, causal=causal,
        local_window=local_window)


def decode_attention(q, k, v, kv_len) -> torch.Tensor:
    """q: (B,H,hd); k/v: (B,T,K,hd); kv_len int or (B,) -> (B,H,hd)."""
    if _route(q) == "cuda":
        return flash_decode_attention(q, k, v, kv_len)
    return ref.decode_attention_ref(q, k, v, kv_len=kv_len)


_COUNTED = ("flash_prefill_attention", "flash_decode_attention",
            "chunked_prefill_attention_ref", "decode_attention_ref")


def counts() -> Dict[str, int]:
    """Kernel launches and plain-version calls since the last reset."""
    return _counts.read(_COUNTED)


def reset_counts() -> None:
    _counts.reset()
