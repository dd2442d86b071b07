"""Plain float32 forward of a DeepSeek-V3-style decoder (Kanana-2-30B-A3B):
multi-head latent attention without a q LoRA, leading dense SwiGLU layers,
then MoE layers of sigmoid-scored routed experts beside shared experts.

What the port's MLA path is held to in the tests. Plain torch only: it
imports no kernel, cache or batching of the port and nothing of the port at
all. `config` maps the published `config.json` keys (`hidden_size`,
`kv_lora_rank`, `first_k_dense_replace`, ...). The weights are the port's
layout (`models/model.py` `model_shapes`): stacked per layer under
``layers``; each matrix as (in, out), the transpose of the published
`nn.Linear` weight; q per head [nope | rope], W_kv_a's output [c_kv |
k_pe], W_kv_b's per head [k_nope | v]; gate|up as (d, 2, F), or (E, d, 2F)
gate first for the routed experts; RMSNorm weights stored as the offset w
of the scale 1 + w (the published weight is 1 + w). The dense layers' and
the MoE layers' leaves are stacked over those layers alone.

Computed in the published order (`modeling_deepseek_v3`): q = x W_q; [c,
k_pe] = x W_kv_a; c RMS-normed, up-projected by W_kv_b to k_nope and v;
the rotary dims of q and k_pe de-interleaved (even dims first) and rotated
by split halves; k_pe shared by every head; softmax scale 1/sqrt(qk width);
routed experts chosen by top-k of sigmoid(x W_r) + bias, weighted by their
sigmoid scores over the chosen scores' sum times the scaling factor; shared
experts added for every token. Departures from the published code: none in
the mathematics; the published bf16 roundings are not reproduced (all f32).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def strict_f32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The published `apply_rotary_pos_emb_interleave`'s reordering of the
    rotary dims: (x0, y0, x1, y1, ...) -> (x0, x1, ..., y0, y1, ...)."""
    return x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2) \
        .flatten(-2)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotation of x (n, ..., r) at positions pos (n,)."""
    r = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32,
                                       device=x.device) / r)
    ang = pos.float()[:, None] * inv
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (r // 2,)
    cos, sin = ang.cos().reshape(shape), ang.sin().reshape(shape)
    a, b = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wd: torch.Tensor):
    """wi (d, 2, F) gate|up, wd (F, d)."""
    gu = x @ wi.reshape(wi.shape[0], -1)
    Fd = wd.shape[0]
    return (F.silu(gu[:, :Fd]) * gu[:, Fd:]) @ wd


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float, idx: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (n, k), experts (n, k)): top-k of sigmoid score + bias, the
    bias used for the choice only; or the given experts `idx` (n, k),
    weighed by their scores alike."""
    scores = torch.sigmoid(x @ router)
    if idx is None:
        idx = torch.topk(scores + bias, top_k, dim=-1).indices
    idx = idx.to(x.device).long()
    w = scores.gather(1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scale, idx


def moe(x: torch.Tensor, w: Mapping[str, torch.Tensor], top_k: int,
        scale: float, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    gate_w, idx = route(x, w["router"], w["router_bias"], top_k, scale, idx)
    y = swiglu(x, w["wi_shared"], w["wd_shared"])
    E, _, F2 = w["wi"].shape
    Fd = F2 // 2
    for e in range(E):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        gu = x[rows] @ w["wi"][e]
        ye = (F.silu(gu[:, :Fd]) * gu[:, Fd:]) @ w["wd"][e]
        y.index_add_(0, rows, ye * gate_w[rows, slot][:, None])
    return y


def layer(weights: Mapping, l: int, n_dense: int) -> Dict[str, torch.Tensor]:
    """Layer l's leaves in f32: the attention's, and the dense FFN's or the
    MoE's (stacked over their own layers)."""
    lw = weights["layers"]
    out = {}
    for key, val in lw.items():
        if key.endswith("_dense"):
            if l < n_dense:
                out[key[:-len("_dense")]] = val[l].float()
        elif key in ("router", "router_bias", "wi", "wd", "wi_shared",
                     "wd_shared"):
            if l >= n_dense:
                out[key] = val[l - n_dense].float()
        else:
            out[key] = val[l].float()
    return out


def attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal softmax attention, q/k (n, H, dq), v (n, H, dv) -> (n, H*dv)."""
    n = q.shape[0]
    s = torch.einsum("shd,thd->hst", q, k) * scale
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("hst,thd->shd", p, v).reshape(n, -1)


def forward(weights: Mapping, config: Mapping, tokens: torch.Tensor,
            experts: Optional[Sequence[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Logits (S, V) at every position of one prompt `tokens` (S,), and
    each layer's latent cache: (c_kv (S, kv_lora_rank) normed, k_pe (S,
    qk_rope_head_dim) after the rotation). All f32.

    `experts`, where given, replays a choice of routed experts: one (S,
    top_k) index tensor per MoE layer, in order, in place of the top-k of
    the reference's own scores (the weights are still its f32 scores at
    those experts). A bf16 program swaps an expert wherever two scores lie
    within its rounding; replaying its choice holds its deeper layers to
    the f32 arithmetic all the same."""
    strict_f32()
    H = config["num_attention_heads"]
    dn, dr = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, rank = config["v_head_dim"], config["kv_lora_rank"]
    eps, theta = config["rms_norm_eps"], float(config["rope_theta"])
    n_dense = config["first_k_dense_replace"]
    scale = 1.0 / math.sqrt(dn + dr)
    dev = weights["embed"].device
    tokens = tokens.to(dev).long()
    pos = torch.arange(tokens.numel(), device=dev)
    h = weights["embed"][tokens].float()
    cache = []
    for l in range(config["num_hidden_layers"]):
        w = layer(weights, l, n_dense)
        x = rms_norm(h, w["ln1"], eps)
        q = (x @ w["wq"]).unflatten(-1, (H, dn + dr))
        ckv = x @ w["wkv_a"]
        c = rms_norm(ckv[:, :rank], w["kv_norm"], eps)
        kv = (c @ w["wkv_b"]).unflatten(-1, (H, dn + dv))
        k_pe = ckv[:, rank:]
        q = torch.cat([q[..., :dn], rope(deinterleave(q[..., dn:]), pos,
                                         theta)], dim=-1)
        k_pe = rope(deinterleave(k_pe), pos, theta)
        cache.append((c, k_pe))
        k = torch.cat([kv[..., :dn], k_pe[:, None].expand(-1, H, -1)], -1)
        h = h + attention(q, k, kv[..., dn:], scale) @ w["wo"]
        x = rms_norm(h, w["ln2"], eps)
        if l < n_dense:
            h = h + swiglu(x, w["wi"], w["wd"])
        else:
            h = h + moe(x, w, config["num_experts_per_tok"],
                        config["routed_scaling_factor"],
                        None if experts is None else experts[l - n_dense])
    x = rms_norm(h, weights["final_norm"].float(), eps)
    head = weights["embed"].T if config["tie_word_embeddings"] \
        else weights["unembed"]
    return x @ head.float(), cache
