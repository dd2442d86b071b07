"""Model building blocks of the dense and uniform MoE families: RMSNorm,
split-half RoPE, SwiGLU, the top-k MoE FFN and the reference attention.

Counterpart of src/repro/models/layers.py (the ported families' part of
it). Plain functions on tensors; the large matrix products are
`torch.matmul` and, for the experts, `torch.bmm`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import naive_attention

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "swiglu", "moe_router",
           "moe_apply", "moe_ffn", "naive_attention"]


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


# ---------------------------------------------------------------------------
# MoE: the reference's GShard-style grouped capacity dispatch, with gathers
# and `bmm` in place of its one-hot einsums
# ---------------------------------------------------------------------------


def moe_router(x: torch.Tensor, w_router: torch.Tensor, k: int):
    """x: (B, S, D) -> (weights (B, S, k) f32, indices (B, S, k) int64,
    logits (B, S, E) f32). The product runs in f32 whatever x's dtype, then
    top-k, then a softmax over the k selected logits only."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        # a TF32 product moves near-tied logits, and a near tie then picks
        # another expert than the f32 reference does
        raise RuntimeError("moe_router needs f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    logits = x.float() @ w_router.float()
    weights, idx = torch.topk(logits, k, dim=-1)
    return torch.softmax(weights, dim=-1), idx, logits


def moe_groups(n_tokens: int, k: int, n_experts: int, d_ff: int, *,
               capacity_factor: float, min_capacity: int,
               group_size: int = 0) -> Tuple[int, int, int]:
    """(groups, tokens per group, capacity per expert and group), exactly
    as the reference derives them from the shapes: groups of 512 tokens
    (4096 for d_ff >= 2048) or `group_size`, one group of all tokens where
    the count does not divide, and cap = int(g * k * cf / E) clamped to
    [max(min_capacity, 1), g]."""
    if group_size:
        g = min(n_tokens, group_size)
    else:
        g = min(n_tokens, 512 if d_ff < 2048 else 4096)
    n_groups = n_tokens // g if n_tokens % g == 0 else 0
    if n_groups == 0:                                   # one group
        g, n_groups = n_tokens, 1
    cap = min(max(int(g * k * capacity_factor / n_experts), min_capacity, 1),
              g)
    return n_groups, g, cap


def moe_queue(idx: torch.Tensor, n_groups: int, n_experts: int,
              cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, slot) pair's position in its expert's queue within its
    group: the running count over the group's pairs, token-major and
    slot-minor. Returns (pos, keep), both (G, g * k); a pair at pos >= cap
    is dropped."""
    ig = idx.reshape(n_groups, -1)                      # (G, g*k)
    experts = torch.arange(n_experts, device=ig.device)[:, None]
    # the count runs along the last axis of (G, E, g*k), which the card
    # scans in parallel; along the middle axis of the reference's (G, g*k,
    # E) one-hot it scans the g*k pairs one after another
    seen = (ig[:, None, :] == experts).cumsum(-1, dtype=torch.int32)
    pos = seen.gather(1, ig[:, None, :])[:, 0] - 1
    return pos, pos < cap


def moe_apply(x: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor,
              w_gate_up: torch.Tensor, w_down: torch.Tensor, *, k: int,
              capacity_factor: float = 1.25, min_capacity: int = 4,
              group_size: int = 0) -> torch.Tensor:
    """The paper's `experts` operator given the routing (`gate` =
    `moe_router`). x: (B, S, D); weights / idx: (B, S, k); w_gate_up: (E, D,
    2F) split on its last axis into [gate | up]; w_down: (E, F, D).

    The reference's semantics exactly: its groups and capacity, its queue
    order, dropped pairs weighted 0 (the residual carries the token), and
    the combine in the activation dtype. The dispatch is a table of token
    indices (E, G * cap) built by scatter (one token per slot), a gather of
    x into it (zeros in empty slots), one `bmm` per expert matrix over all
    groups, and a gather of each token's k slots summed in f32. No float
    atomics and no host sync: every step's order is fixed by the shapes."""
    B, S, D = x.shape
    E, _, F2 = w_gate_up.shape
    n = B * S
    G, g, cap = moe_groups(n, k, E, F2 // 2, capacity_factor=capacity_factor,
                           min_capacity=min_capacity, group_size=group_size)
    dev = x.device
    ig = idx.reshape(G, g * k)
    pos, keep = moe_queue(ig, G, E, cap)

    # slot table: token index per (group, expert, slot), g where empty; a
    # dropped pair writes into a spare column cap that is cut off
    grp = torch.arange(G, device=dev)[:, None]
    tok = torch.arange(g * k, device=dev).div(k, rounding_mode="floor")
    table = torch.full((G, E, cap + 1), g, dtype=torch.int64, device=dev)
    dest = (grp * E + ig) * (cap + 1) + torch.where(keep, pos, cap)
    table.view(-1).scatter_(0, dest.reshape(-1), tok.expand(G, -1).reshape(-1))
    # expert-major rows (E, G * cap), so that each expert's weights are read
    # once per call whatever the number of groups
    src = (grp[..., None] * (g + 1) + table[..., :cap]).transpose(0, 1)
    xpad = torch.cat([x.reshape(G, g, D), x.new_zeros(G, 1, D)], dim=1)
    xe = xpad.reshape(G * (g + 1), D)[src.reshape(E, G * cap)]

    gate, up = torch.bmm(xe, w_gate_up).chunk(2, dim=-1)
    ye = torch.bmm(F.silu(gate) * up, w_down)           # (E, G * cap, D)

    # combine: each pair's slot row times its weight (0 where dropped, cast
    # to the activation dtype as the reference casts it), summed over the
    # k slots in slot order in f32 and rounded once
    row = (ig * G + grp) * cap + pos.clamp(max=cap - 1)
    w = torch.where(keep, weights.reshape(G, g * k), 0.0).to(ye.dtype)
    yk = ye.reshape(E * G * cap, D)[row].float() * w.float()[..., None]
    y = yk.reshape(G, g, k, D).sum(dim=2)
    return y.to(ye.dtype).reshape(B, S, D)


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate_up: torch.Tensor,
            w_down: torch.Tensor, *, k: int, capacity_factor: float = 1.25,
            min_capacity: int = 4, group_size: int = 0) -> torch.Tensor:
    """Top-k MoE FFN = moe_router (`gate`) + moe_apply (`experts`)."""
    weights, idx, _ = moe_router(x, w_router, k)
    return moe_apply(x, weights, idx, w_gate_up, w_down, k=k,
                     capacity_factor=capacity_factor,
                     min_capacity=min_capacity, group_size=group_size)
