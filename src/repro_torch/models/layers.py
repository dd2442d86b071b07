"""Model building blocks of the ported families: RMSNorm and LayerNorm,
split-half RoPE and Whisper's sinusoidal positions, SwiGLU and the GELU
MLP, the top-k MoE FFN, the reference attention and the differentiable
`blocked_attention`, and the recurrent layers (the depthwise causal conv,
RG-LRU and Mamba2's chunked SSD).

Counterpart of src/repro/models/layers.py (the ported families' part of
it). Plain functions on tensors; the large matrix products are
`torch.matmul`, and the experts of an MoE layer run the grouped kernel of
`kernels/moe_grouped.py` on the card (`torch.bmm` in their plain version,
`moe_apply_ref`). Where the reference
scans with `lax.associative_scan`, the port uses a log-depth scan of
tensor ops (RG-LRU) or a loop over chunks (SSD), never a Python loop over
the sequence.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import counts, ops
from repro_torch.kernels.moe_grouped import BLOCK_M, moe_grouped_ffn
from repro_torch.kernels.ref import flash_attention_bwd_ref, naive_attention

__all__ = ["rms_norm", "layer_norm", "rope_freqs", "rope_tables",
           "rope_rotate", "apply_rope",
           "sinusoidal_positions", "swiglu", "gelu_mlp", "moe_router",
           "moe_router_sigmoid", "moe_apply", "moe_apply_ref",
           "moe_route_ref", "moe_ffn", "moe_ffn_shared",
           "naive_attention", "FlashAttention",
           "blocked_attention", "causal_conv1d", "rglru", "rglru_step",
           "ssd_chunked", "ssd_step"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 that scales by (1 + w), as the reference does."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, y * w + b: the weight scales by w itself, not by
    1 + w as `rms_norm` does (the reference's rule)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (..., S, head_dim/2) in f32 of the rotary angles at
    `positions` (..., S)."""
    freqs = rope_freqs(head_dim, theta, positions.device)      # (hd/2,)
    angles = positions.to(torch.float32)[..., None] * freqs    # (..., S, hd/2)
    return torch.cos(angles), torch.sin(angles)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The split-half rotation of x (..., head_dim) by tables that
    broadcast against its halves, in f32, cast to x's dtype (or written
    into `out`, cast to its dtype)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    lo, hi = x1 * cos - x2 * sin, x1 * sin + x2 * cos
    if out is None:
        return torch.cat([lo, hi], dim=-1).to(x.dtype)
    half = x.shape[-1] // 2
    out[..., :half] = lo
    out[..., half:] = hi
    return out


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotary embedding computed in f32.
    x: (..., S, n_heads, head_dim); positions: (..., S)."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return rope_rotate(x, cos[..., None, :], sin[..., None, :])


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed positional embeddings (seq, dim) in f32: sin on
    the even channels, cos on the odd ones."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / (dim // 2)))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class FlashAttention(torch.autograd.Function):
    """Attention with the reference's flash custom VJP (`_flash`,
    src/repro/models/layers.py:171-219). The forward is
    `ops.prefill_attention`: the CUDA prefill kernel for a CUDA tensor, its
    plain version on the CPU. It saves q, k, v and the output, O(S * hd)
    per head. The backward is `flash_attention_bwd_ref`, the reference's
    blockwise algorithm in f32 torch ops, which recomputes the probabilities
    from q, k and each row's log-sum-exp; it returns dq, dk, dv in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, causal, local_window, block):
        out = ops.prefill_attention(q, k, v, q_offset=q_offset, kv_len=kv_len,
                                    causal=causal, local_window=local_window)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = dict(q_offset=q_offset, kv_len=kv_len, causal=causal,
                        local_window=local_window, block=block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, dout, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset=0, local_window: int = 0,
                      kv_len=None, block: int = 1024) -> torch.Tensor:
    """The reference's `blocked_attention` (layers.py:222-253): q (B, S, H,
    hd) over k/v (B, T, K, hd) -> (B, S, H, hd) in q's dtype, with a
    backward of O(S * block) memory. `FlashAttention` with q_offset and
    kv_len as run-time values (training passes 0 and T). DTensor inputs
    (the sharded path) run it on each rank's local shards, forward and
    backward, through `ops.on_local_shards`."""
    def local(q, k, v, q_offset, kv_len):
        return FlashAttention.apply(q, k, v, q_offset, kv_len, causal,
                                    local_window, block)
    return ops.on_local_shards(local, q, k, v, q_offset, kv_len)


def gate_up(x: torch.Tensor, w_in: torch.Tensor) -> torch.Tensor:
    """silu(x W_gate) * (x W_up) with w_in (D, 2, F) gate|up, as one
    product over (D, 2F). A DTensor w_in runs it on each rank's local
    shards (DTensor cannot flatten (2, F) with F sharded): x with its
    leading dims sharded as they are and D gathered, w_in with F sharded as
    it is and D gathered, the output sharded like both; x's gradient sums
    over F's shards and w_in's over x's (Partial)."""
    if not isinstance(w_in, DTensor):
        return _gate_up(x, w_in)
    mesh = w_in.device_mesh
    x = shd.as_dtensor(x, mesh)
    lead = x.dim() - 1
    px, pw, out, gx, gw = [], [], [], [], []
    for a, b in zip(x.placements, w_in.placements):
        a = a if isinstance(a, Shard) and a.dim < lead else Replicate()
        b = b if b == Shard(2) and a == Replicate() else Replicate()
        px.append(a)
        pw.append(b)
        out.append(Shard(lead) if b == Shard(2) else a)
        gx.append(Partial() if b == Shard(2) else a)
        gw.append(Partial() if isinstance(a, Shard) else b)
    return local_map(_gate_up, out_placements=out, in_placements=(px, pw),
                     in_grad_placements=(gx, gw), device_mesh=mesh,
                     redistribute_inputs=True)(x, w_in)


def _gate_up(x: torch.Tensor, w_in: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    D, _, Fd = w_in.shape
    gu = (x @ w_in.reshape(D, 2 * Fd)).unflatten(-1, (2, Fd))
    return torch.mul(F.silu(gu[..., 0, :]), gu[..., 1, :], out=out)


def swiglu(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """w_in: (D, 2, F) gate|up on an explicit axis; w_out: (F, D)."""
    return gate_up(x, w_in) @ w_out


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP: GELU in its tanh form (`jax.nn.gelu`'s default, which
    the reference uses) between two biased projections."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


# ---------------------------------------------------------------------------
# MoE: the reference's GShard-style grouped capacity dispatch; on the card a
# grouped GEMM over the kept pairs, in the plain version gathers and `bmm` in
# place of its one-hot einsums
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


def moe_router_sigmoid(x: torch.Tensor, w_router: torch.Tensor,
                       bias: torch.Tensor, k: int, scale: float):
    """DeepSeek-V3's `noaux_tc` router with one group (Kanana-2): x (B, S,
    D) -> (weights (B, S, k) f32, indices (B, S, k) int64, scores (B, S, E)
    f32). The scores are sigmoid(x W_r) in f32; the experts are the top k
    of score + `bias` (the bias picks, it does not weigh); the weights are
    the chosen scores over their sum, times `scale`."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("moe_router_sigmoid needs f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    scores = torch.sigmoid(x.float() @ w_router.float())
    idx = torch.topk(scores + bias.float(), k, dim=-1).indices
    w = scores.gather(-1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scale, idx, scores


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


def moe_route_ref(idx: torch.Tensor, n_groups: int, n_experts: int,
                  cap: int, *, e0: int = 0, n_local: int = 0,
                  block_m: int = BLOCK_M):
    """The routing of the card's grouped kernel (`kernels/moe_grouped.py`)
    in plain tensor ops, for the tests that hold the kernel to it. The
    pairs kept are `moe_queue`'s (pos < cap) whose expert is one of the
    n_local (default all) experts [e0, e0 + n_local). Local expert el's
    kept pairs take the rows [row_off[el], row_off[el] + counts[el]),
    experts in order, each expert's pairs group-major and then by queue
    position: the order of the slot table's columns in `moe_apply_ref`.
    Its M tiles of `block_m` rows start at tile_off[el], the exclusive scan
    of ceil(counts / block_m). Returns a dict of `pos` and `keep` (G, g * k),
    `rows` (n * k) each pair's row or -1, `counts`, `row_off` and
    `tile_off` (n_local) and `tiles` (T, 3): each M tile's (expert, first
    row, end row)."""
    El = n_local or n_experts
    ig = idx.reshape(n_groups, -1)
    pos, keep = moe_queue(ig, n_groups, n_experts, cap)
    el = ig - e0
    keep = keep & (el >= 0) & (el < El)
    el = el.clamp(0, El - 1)
    cnt = torch.zeros((n_groups, El), dtype=torch.int64, device=idx.device)
    cnt.scatter_add_(1, el, keep.long())
    grp_base = cnt.cumsum(0) - cnt
    tot = cnt.sum(0)
    row_off = tot.cumsum(0) - tot
    n_tiles = (tot + block_m - 1) // block_m
    tile_off = n_tiles.cumsum(0) - n_tiles
    rows = torch.where(keep, row_off[el] + grp_base.gather(1, el) + pos, -1)
    te = torch.repeat_interleave(torch.arange(El, device=idx.device),
                                 n_tiles)
    first = row_off[te] + (torch.arange(len(te), device=idx.device)
                           - tile_off[te]) * block_m
    return {"pos": pos, "keep": keep, "rows": rows.reshape(-1),
            "counts": tot, "row_off": row_off, "tile_off": tile_off,
            "tiles": torch.stack([te, first, row_off[te] + tot[te]], 1)}


def moe_apply(x: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor,
              w_gate_up: torch.Tensor, w_down: torch.Tensor, *, k: int,
              capacity_factor: float = 1.25, min_capacity: int = 4,
              group_size: int = 0,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's `experts` operator given the routing (`gate` =
    `moe_router`). x: (B, S, D); weights / idx: (B, S, k); w_gate_up: (E, D,
    2F) split on its last axis into [gate | up]; w_down: (E, F, D). With
    `residual` ((B, S, D) or (B * S, D), plain tensors only) the result is
    added into it in place and it is returned (a segment's `h += y`).

    The reference's semantics exactly: its groups and capacity, its queue
    order, dropped pairs weighted 0 (the residual carries the token), and
    the combine in the activation dtype. Routed by device:

    - a CUDA tensor runs the grouped kernel (`kernels/moe_grouped.py`),
      which computes only the kept pairs: six launches, no host sync and
      every grid sized from the token count, so the operator can be
      captured in a CUDA graph (the segment graphs leave it eager so far);
    - a CPU or meta tensor runs the plain version, `moe_apply_ref`;
    - a call that needs a gradient runs the plain version on any device:
      it is differentiable through torch ops, and the JAX package has no
      MoE kernel whose backward a kernel could port (its experts are
      einsums that XLA differentiates).

    DTensor inputs (the sharded path) run on each rank's local shards, as
    GSPMD partitions it: the experts stay sharded where both expert weights
    shard them (expert parallelism over `model`), each rank routes every
    pair but runs only its own experts, and the output is the sum of the
    ranks' partial combines (Partial); the batch stays sharded where its
    shards hold whole groups (the same groups and capacity as the global
    batch), else it is gathered, as the routing and the weights' other
    dims are."""
    kw = dict(k=k, capacity_factor=capacity_factor,
              min_capacity=min_capacity, group_size=group_size)
    if isinstance(w_gate_up, DTensor):
        if residual is not None:
            raise ValueError("moe_apply: residual= takes plain tensors")
        return _moe_apply_sharded(x, weights, idx, w_gate_up, w_down, **kw)
    return _moe_apply(x, weights, idx, w_gate_up, w_down, **kw,
                      residual=residual)


def _moe_apply_sharded(x, weights, idx, w_gate_up, w_down, **kw):
    mesh = w_gate_up.device_mesh
    x, weights, idx, w_down = (shd.as_dtensor(t, mesh)
                               for t in (x, weights, idx, w_down))
    B, S, _ = x.shape
    E, _, F2 = w_gate_up.shape
    groups = functools.partial(moe_groups, k=kw["k"], n_experts=E,
                               d_ff=F2 // 2,
                               capacity_factor=kw["capacity_factor"],
                               min_capacity=kw["min_capacity"],
                               group_size=kw["group_size"])
    G, g, cap = groups(B * S)
    px, pw, out, gx, gw = [], [], [], [], []
    n_batch = 1
    for i, (a, w1, w2) in enumerate(zip(x.placements, w_gate_up.placements,
                                        w_down.placements)):
        n = mesh.size(i)
        if w1 == Shard(0) and w2 == Shard(0):           # experts
            px.append(Replicate())
            pw.append(Shard(0))
            out.append(Partial())
            gx.append(Partial())
            gw.append(Shard(0))
        elif a == Shard(0) and B % (n_batch * n) == 0 and \
                groups(B * S // (n_batch * n)) == (G // (n_batch * n), g,
                                                   cap):
            n_batch *= n                                 # whole groups
            px.append(Shard(0))
            pw.append(Replicate())
            out.append(Shard(0))
            gx.append(Shard(0))
            gw.append(Partial())
        else:
            for lst in (px, pw, out, gx, gw):
                lst.append(Replicate())
    _, offset = compute_local_shape_and_global_offset(
        w_gate_up.shape, mesh, pw)
    local = functools.partial(_moe_apply, **kw, e0=offset[0], n_experts=E)
    return local_map(local, out_placements=out,
                     in_placements=(px, px, px, pw, pw),
                     in_grad_placements=(gx, gx, px, gw, gw),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, weights, idx, w_gate_up, w_down)


def _moe_apply(x, weights, idx, w_gate_up, w_down, *, k, capacity_factor,
               min_capacity, group_size, e0=0, n_experts=0,
               residual=None) -> torch.Tensor:
    """`moe_apply` on plain tensors, routed by device. With `n_experts`,
    w_gate_up and w_down hold only experts [e0, e0 + their length) of
    n_experts: every pair is routed, only these experts run, and the other
    experts' pairs weigh 0 in the combine (a partial sum over the
    experts)."""
    kw = dict(k=k, capacity_factor=capacity_factor,
              min_capacity=min_capacity, group_size=group_size, e0=e0,
              n_experts=n_experts)
    dev = x.device.type
    if dev not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no MoE path for device {x.device}")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, weights, w_gate_up, w_down))
    if dev != "cuda" or grad:
        y = moe_apply_ref(x, weights, idx, w_gate_up, w_down, **kw)
        return y if residual is None else residual.add_(
            y.reshape(residual.shape))
    B, S, D = x.shape
    El, _, F2 = w_gate_up.shape
    G, _, cap = moe_groups(B * S, k, n_experts or El, F2 // 2,
                           capacity_factor=capacity_factor,
                           min_capacity=min_capacity, group_size=group_size)
    y = moe_grouped_ffn(
        x.reshape(B * S, D).contiguous(),
        weights.reshape(B * S, k).float().contiguous(),
        idx.reshape(B * S, k).long().contiguous(), w_gate_up.contiguous(),
        w_down.contiguous(), n_groups=G, cap=cap,
        n_experts=n_experts, e0=e0,
        residual=None if residual is None else residual.view(B * S, D))
    return y.view(B, S, D) if residual is None else residual


def moe_apply_ref(x, weights, idx, w_gate_up, w_down, *, k, capacity_factor,
                  min_capacity, group_size=0, e0=0,
                  n_experts=0) -> torch.Tensor:
    """The plain version of `moe_apply` (CPU, meta and gradient calls, and
    the card's yardstick): x (B, S, D) -> (B, S, D), with `_moe_apply`'s
    expert range. The dispatch is a table of token indices (E, G * cap)
    built by scatter (one token per slot), a gather of x into it (zeros in
    empty slots), one `bmm` per expert matrix over all groups, and a
    gather of each token's k slots summed in f32. No float atomics and no
    host sync: every step's order is fixed by the shapes."""
    counts.bump("moe_apply_ref")
    B, S, D = x.shape
    El, _, F2 = w_gate_up.shape
    E = n_experts or El
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
    src = src.reshape(E, G * cap)
    if El < E:
        src = src[e0:e0 + El]
    xpad = torch.cat([x.reshape(G, g, D), x.new_zeros(G, 1, D)], dim=1)
    xe = xpad.reshape(G * (g + 1), D)[src]

    gate, up = torch.bmm(xe, w_gate_up).chunk(2, dim=-1)
    ye = torch.bmm(F.silu(gate) * up, w_down)           # (E, G * cap, D)

    # combine: each pair's slot row times its weight (0 where dropped, cast
    # to the activation dtype as the reference casts it), summed over the
    # k slots in slot order in f32 and rounded once
    row = (ig * G + grp) * cap + pos.clamp(max=cap - 1)
    if El < E:                          # another rank runs the others
        keep = keep & (ig >= e0) & (ig < e0 + El)
        row = ((ig - e0).clamp(0, El - 1) * G + grp) * cap + \
            pos.clamp(max=cap - 1)
    w = torch.where(keep, weights.reshape(G, g * k), 0.0).to(ye.dtype)
    yk = ye.reshape(El * G * cap, D)[row].float() * w.float()[..., None]
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


def moe_ffn_shared(x: torch.Tensor, w_router: torch.Tensor,
                   bias: torch.Tensor, w_gate_up: torch.Tensor,
                   w_down: torch.Tensor, wi_shared: torch.Tensor,
                   wd_shared: torch.Tensor, *, k: int, scale: float,
                   capacity_factor: float, min_capacity: int = 4
                   ) -> torch.Tensor:
    """DeepSeek-V3's MoE FFN: the routed experts of `moe_router_sigmoid`
    (through `moe_apply`) plus the shared experts, one SwiGLU every token
    takes (wi_shared (D, 2, Fs), wd_shared (Fs, D))."""
    weights, idx, _ = moe_router_sigmoid(x, w_router, bias, k, scale)
    return moe_apply(x, weights, idx, w_gate_up, w_down, k=k,
                     capacity_factor=capacity_factor,
                     min_capacity=min_capacity) \
        + swiglu(x, wi_shared, wd_shared)


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (mamba2 / rg-lru)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None):
    """x: (B, S, C); w: (C, W) depthwise; state: (B, W-1, C) trailing
    context (zeros when None). Returns (y (B, S, C), new_state (B, W-1, C)),
    the new state being the last W-1 positions of [state, x].

    The W taps are W shifted slices of [state, x] summed in f32 and rounded
    once to x's dtype; no (B, S, W, C) window tensor is gathered. A decode
    step is the same call at S = 1."""
    B, S, C = x.shape
    W = w.shape[-1]
    if state is None:
        state = x.new_zeros((B, W - 1, C))
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S+W-1, C)
    w32 = w.float()
    y = xp[:, :S].float() * w32[:, 0]
    for j in range(1, W):
        y = y + xp[:, j:j + S].float() * w32[:, j]
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype), xp[:, S:]


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma): a linear recurrence, scanned in log depth
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def _rglru_gates(x32: torch.Tensor, a_param, w_rg, w_ig):
    """(a, sqrt(1 - a^2) * i * x) of the recurrence, in f32."""
    r = torch.sigmoid(x32 @ w_rg.float())
    i = torch.sigmoid(x32 @ w_ig.float())
    log_a = -_RGLRU_C * F.softplus(a_param.float()) * r
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x32)
    return torch.exp(log_a), gated


def _linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """Inclusive scan of the pairs (a_t, b_t) under (a1, b1) then (a2, b2)
    -> (a1 a2, b1 a2 + b2) along `dim`: returns (prod of a up to t, the
    h_t of h_t = a_t h_{t-1} + b_t from h = 0). Hillis-Steele doubling:
    ceil(log2 S) passes of whole-tensor ops (12 at S 4096). Only products
    of a in (0, 1] are formed, so nothing overflows where a cumulative sum
    of log a would (log a_t is about -4.4 a step at a_param 0.7)."""
    S = a.shape[dim]
    d = 1
    while d < S:
        a_hi, b_hi = a.narrow(dim, d, S - d), b.narrow(dim, d, S - d)
        a_lo, b_lo = a.narrow(dim, 0, S - d), b.narrow(dim, 0, S - d)
        b = torch.cat([b.narrow(dim, 0, d), b_lo * a_hi + b_hi], dim=dim)
        a = torch.cat([a.narrow(dim, 0, d), a_lo * a_hi], dim=dim)
        d *= 2
    return a, b


def rglru(x: torch.Tensor, a_param: torch.Tensor, w_rg: torch.Tensor,
          w_ig: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """Real-Gated Linear Recurrent Unit over a sequence:
        r_t = sigmoid(x_t @ w_rg);  i_t = sigmoid(x_t @ w_ig)
        log a_t = -c * softplus(a_param) * r_t
        h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    computed in f32. x: (B, S, C); h0: (B, C) f32 or None. Returns
    (y (B, S, C) in x's dtype, h_last (B, C) f32)."""
    x32 = x.float()
    a, gated = _rglru_gates(x32, a_param, w_rg, w_ig)
    a_cum, h = _linear_scan(a, gated, dim=1)
    if h0 is not None:
        h = h + a_cum * h0.float()[:, None]
    return h.to(x.dtype), h[:, -1]


def rglru_step(x_t: torch.Tensor, a_param, w_rg, w_ig, h: torch.Tensor):
    """One token of the recurrence. x_t: (B, C); h: (B, C) f32. Returns
    (y (B, C) in x_t's dtype, h_new (B, C) f32)."""
    x32 = x_t.float()
    a, gated = _rglru_gates(x32, a_param, w_rg, w_ig)
    h_new = a * h + gated
    return h_new.to(x_t.dtype), h_new


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality), chunked
# ---------------------------------------------------------------------------


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD, y_t = C_t . h_t with h_t = exp(A dt_t) h_{t-1} +
    dt_t B_t x_t^T: the intra-chunk quadratic term plus a recurrence over
    the chunk states. x: (B, S, H, P); dt: (B, S, H) softplus'd steps; A:
    (H,) negative rates; Bm/Cm: (B, S, N) (one group); h0: (B, H, P, N) f32
    or None. Returns (y (B, S, H, P) in x's dtype, h_last (B, H, P, N) f32).

    The products are batched matmuls over (batch, chunk, head); the
    largest intermediates are the (B, nc, H, L, L) f32 decay tensors
    (134 MB each at S 4096, H 32, chunk 256), the (B, nc, H, L, P) values
    and the (B, nc, H, P, N) chunk states (17 MB). The decay is masked in
    the log domain (-inf above the diagonal) before the exp, as in the
    reference: masking after the exp overflows first."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P).float()
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, N).float()

    dA_cs = torch.cumsum(dtc * A.float(), dim=2)            # (B,nc,L,H)
    dA_h = dA_cs.transpose(2, 3)                            # (B,nc,H,L)
    dx = (dtc[..., None] * xc).permute(0, 1, 3, 2, 4)       # (B,nc,H,L,P)

    # intra-chunk: y[l] = sum_{m<=l} C_l.B_m exp(dA_cs[l]-dA_cs[m]) dt_m x_m
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = (dA_h[..., :, None] - dA_h[..., None, :]).masked_fill(
        ~tril, float("-inf"))                               # (B,nc,H,L,L)
    gate = torch.exp(seg)
    del seg
    gate = gate * (Cc @ Bc.transpose(-1, -2))[:, :, None]   # scores (B,nc,L,L)
    y = gate @ dx                                           # (B,nc,H,L,P)
    del gate

    # chunk states: sum_l exp(dA_cs[last]-dA_cs[l]) dt_l x_l B_l^T
    decay_last = torch.exp(dA_h[..., -1:] - dA_h)           # (B,nc,H,L)
    states = (dx * decay_last[..., None]).transpose(-1, -2) @ Bc[:, :, None]

    # the recurrence over the nc chunk boundaries, and the state entering
    # each chunk
    chunk_decay = torch.exp(dA_h[..., -1])                  # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                         # (B,nc,H,P,N)

    # inter-chunk: y[l] += exp(dA_cs[l]) C_l . h_in
    y = y + (Cc[:, :, None] @ h_in.transpose(-1, -2)) * torch.exp(dA_h)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_step(x_t: torch.Tensor, dt_t: torch.Tensor, A: torch.Tensor,
             B_t: torch.Tensor, C_t: torch.Tensor, h: torch.Tensor):
    """One token of the SSD recurrence. x_t: (B, H, P); dt_t: (B, H);
    B_t / C_t: (B, N); h: (B, H, P, N) f32. Returns (y (B, H, P) in x_t's
    dtype, h_new f32)."""
    dt32 = dt_t.float()
    a = torch.exp(dt32 * A.float()[None])                   # (B, H)
    dBx = (dt32[..., None] * x_t.float())[..., None] \
        * B_t.float()[:, None, None, :]                     # (B, H, P, N)
    h_new = h * a[..., None, None] + dBx
    y = (h_new @ C_t.float()[:, None, :, None])[..., 0]     # (B, H, P)
    return y.to(x_t.dtype), h_new
