"""Model building blocks for the dense family: RMSNorm, split-half RoPE,
SwiGLU and the reference attention.

Counterpart of src/repro/models/layers.py (the slice's part of it). Plain
functions on tensors; the large matrix products are `torch.matmul`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import naive_attention

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "swiglu",
           "naive_attention"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 that scales by (1 + w), as the reference does."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotary embedding computed in f32.
    x: (..., S, n_heads, head_dim); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions.to(torch.float32)[..., None] * freqs    # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gate_up(x: torch.Tensor, w_in: torch.Tensor) -> torch.Tensor:
    """silu(x W_gate) * (x W_up) with w_in (D, 2, F) gate|up."""
    D, _, Fd = w_in.shape
    gu = (x @ w_in.reshape(D, 2 * Fd)).unflatten(-1, (2, Fd))
    return F.silu(gu[..., 0, :]) * gu[..., 1, :]


def swiglu(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """w_in: (D, 2, F) gate|up on an explicit axis; w_out: (F, D)."""
    return gate_up(x, w_in) @ w_out
