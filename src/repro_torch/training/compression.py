"""Gradient compression with error feedback, as the reference's
(src/repro/training/compression.py): blockwise symmetric int8 quantisation
of each gradient, with the quantisation residual carried to the next step
(EF-SGD), so that a data-parallel all-reduce could move int8. Rounding is
to the nearest, ties to even (`torch.round`, as `jnp.round`), so the codes
are bit-equal to the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantisation of x flattened and zero-padded
    to whole blocks. Returns (q (n_blocks, block) int8, scales (n_blocks, 1)
    f32), a block's scale max|x| / 127 (1 where the block is all zero)."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, -flat.numel() % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    size: int) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)[:size]
    return flat.reshape(shape)


class ErrorFeedbackCompressor:
    """grads' = Q(grads + residual); residual' = (grads + residual) -
    grads'. The residual is an f32 tensor per gradient, kept beside the
    optimizer state."""

    def __init__(self, block: int = 256):
        self.block = block
        self.residual: Optional[Dict[str, torch.Tensor]] = None

    def init(self, grads_like: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        self.residual = {k: torch.zeros(g.shape, dtype=torch.float32,
                                        device=g.device)
                         for k, g in grads_like.items()}
        return self.residual

    def transform(self, grads: Dict[str, torch.Tensor],
                  residual: Dict[str, torch.Tensor]):
        """Pure: returns (compressed grads in their dtypes, new
        residual)."""
        out, new_res = {}, {}
        for key, g in grads.items():
            x = g.float() + residual[key]
            q, s = quantize_int8(x, self.block)
            deq = dequantize_int8(q, s, g.shape, x.numel())
            out[key], new_res[key] = deq.to(g.dtype), x - deq
        return out, new_res
