"""The dense and uniform MoE model families: parameter shapes, embedding,
projections, the FFN (SwiGLU or top-k MoE, by the layer's keys), the
language-model head, the two decode steps and the speculative verify step.

Counterpart of src/repro/models/model.py (its single-layer-stack part:
dense, and MoE at moe_layer_freq 1). The reference scans a jitted body over
stacked layer parameters; here the layers are a Python loop of eager
PyTorch ops. Attention goes through `kernels.ops`, which runs the CUDA
decode and verify kernels on the card and the plain versions on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Any          # repro_torch.params.ModelParams (mapping-style access)


def _check_ported(cfg: ModelConfig) -> None:
    """Admit the families with one stack of attention layers: dense, and
    MoE with an MoE FFN in every layer. Interleaved dense/MoE pairs, ssm,
    the recurrent hybrid, audio and vlm are not ported."""
    if cfg.family == "dense" and not cfg.num_experts:
        return
    if cfg.family == "moe" and cfg.num_experts and cfg.moe_layer_freq == 1:
        return
    raise NotImplementedError(
        f"family {cfg.family!r} (num_experts={cfg.num_experts}, "
        f"moe_layer_freq={cfg.moe_layer_freq}) is not ported; only the "
        "dense family and uniform MoE stacks are")


def model_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter shapes of a dense or uniform MoE model, identical to the
    reference's."""
    _check_ported(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K, n = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    layer = {"ln1": (d,), "wq": (d, H * hd), "wk": (d, K * hd),
             "wv": (d, K * hd), "wo": (H * hd, d)}
    if cfg.qkv_bias:
        layer.update(bq=(H * hd,), bk=(K * hd,), bv=(K * hd,))
    if cfg.num_experts:
        # per expert: gate|up concatenated on the last axis, (E, D, 2F)
        E = cfg.num_experts
        layer.update(router=(d, E), wi=(E, d, 2 * cfg.d_ff),
                     wd=(E, cfg.d_ff, d), ln2=(d,))
    else:
        # gate|up as an explicit (2, F) axis, as the reference stores it
        layer.update(ln2=(d,), wi=(d, 2, cfg.d_ff), wd=(cfg.d_ff, d))
    out: Dict[str, Any] = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        out["unembed"] = (d, cfg.vocab_size)
    out["layers"] = {k: (n,) + s for k, s in layer.items()}
    return out


def layer_params(params: Params, l: int) -> Dict[str, torch.Tensor]:
    """Layer `l`'s slice of every stacked leaf (views, no copies)."""
    return {k: v[l] for k, v in params["layers"].items()}


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _project_qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor):
    """Separate q/k/v projections, shaped (B, S, heads, hd)."""
    B, S = x.shape[:2]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, K, hd),
            v.reshape(B, S, K, hd))


def ffn_block(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              h: torch.Tensor) -> torch.Tensor:
    """The FFN variant follows the layer's keys, as the reference's does."""
    x = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if "router" in p:
        return h + L.moe_ffn(x, p["router"], p["wi"], p["wd"],
                             k=cfg.experts_per_token,
                             capacity_factor=cfg.moe_capacity_factor,
                             min_capacity=cfg.moe_min_capacity)
    return h + L.swiglu(x, p["wi"], p["wd"])


def lm_head(cfg: ModelConfig, params: Params, h: torch.Tensor,
            norm_key: str = "final_norm") -> torch.Tensor:
    h = L.rms_norm(h, params[norm_key], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    # the matmul runs in the weights' type (an f32 prefill state casts down)
    return h.to(w.dtype) @ w


def supports_ragged_decode(cfg: ModelConfig) -> bool:
    """Families whose decode cache is a dense per-layer K/V stack with a
    single position pointer (the reference's predicate, unchanged)."""
    if cfg.family in ("ssm", "hybrid", "audio"):
        return False
    if cfg.num_experts and cfg.moe_layer_freq == 2:
        return False
    return True


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Dense single-stream decode. tokens: (B,) — the token generated at
    position cache['pos']; cache: {"k", "v": (L, B, S, K, hd), "pos": int}.

    Unlike the reference, which returns an updated copy of the cache, the
    new K/V are written into cache["k"]/cache["v"] IN PLACE at `pos`; the
    returned dict shares those tensors and carries pos + 1. Attention is
    the decode kernel over keys [0, pos] (kv_len = pos + 1).
    Returns (logits (B, V), cache)."""
    _check_ported(cfg)
    pos = int(cache["pos"])
    B = tokens.shape[0]
    dev = tokens.device
    k_c, v_c = cache["k"], cache["v"]
    h = embed_tokens(cfg, params, tokens[:, None])          # (B, 1, D)
    rp = torch.full((1, 1), pos, dtype=torch.int64, device=dev)
    kv_len = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, p, x)
        q = L.apply_rope(q, rp, cfg.rope_theta)
        k = L.apply_rope(k, rp, cfg.rope_theta)
        k_c[l, :, pos] = k[:, 0].to(k_c.dtype)
        v_c[l, :, pos] = v[:, 0].to(v_c.dtype)
        o = ops.decode_attention(q[:, 0], k_c[l], v_c[l], kv_len)
        h = h + o.reshape(B, 1, -1) @ p["wo"]
        h = ffn_block(cfg, p, h)
    logits = lm_head(cfg, params, h)
    return logits[:, 0], dict(cache, pos=pos + 1)


def _ragged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             kv_lens: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, T, K, hd); kv_lens: (B,) valid key counts.
    Row b attends to keys [0, kv_lens[b]) of its own KV view."""
    return ops.decode_attention(q, k, v, kv_lens)


def decode_step_ragged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                       k_gathered: torch.Tensor, v_gathered: torch.Tensor,
                       kv_lens):
    """One continuous-batching decode step over B resident streams.

    tokens: (B,) — each stream's current token; k_gathered/v_gathered:
    (L, B, T, K, hd) per-stream KV views gathered from the paged pool (the
    caller's copy: each layer's new token is scattered into it IN PLACE at
    position kv_lens[b], so attention sees prefix + self); kv_lens: (B,)
    context lengths (padding rows carry 0 and are discarded by the caller).

    Returns (logits (B, V), k_new (L, B, K, hd), v_new (L, B, K, hd)) for the
    caller to write into the pool (PagedKVCache.write_tokens)."""
    if not supports_ragged_decode(cfg):
        raise NotImplementedError(
            f"batched ragged decode unsupported for family={cfg.family!r} "
            f"(moe_layer_freq={cfg.moe_layer_freq}); use decode_step")
    _check_ported(cfg)
    B = tokens.shape[0]
    dev = tokens.device
    pos = torch.as_tensor(kv_lens, device=dev).to(torch.int64)
    rows = torch.arange(B, device=dev)
    lens_attn = (pos + 1).to(torch.int32)                   # prefix + self
    h = embed_tokens(cfg, params, tokens[:, None])          # (B, 1, D)
    k_new, v_new = [], []
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        k_l, v_l = k_gathered[l], v_gathered[l]             # (B, T, K, hd)
        x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, p, x)                   # (B, 1, ., hd)
        rp = pos[:, None]                                   # (B, 1) positions
        q = L.apply_rope(q, rp, cfg.rope_theta)
        k = L.apply_rope(k, rp, cfg.rope_theta)
        k_l[rows, pos] = k[:, 0].to(k_l.dtype)
        v_l[rows, pos] = v[:, 0].to(v_l.dtype)
        o = _ragged_decode_attention(q[:, 0], k_l, v_l, lens_attn)
        h = h + o.reshape(B, 1, -1) @ p["wo"]
        h = ffn_block(cfg, p, h)
        k_new.append(k[:, 0])
        v_new.append(v[:, 0])
    logits = lm_head(cfg, params, h)
    return logits[:, 0], torch.stack(k_new), torch.stack(v_new)


def _ragged_verify_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             kv_lens: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd) — S consecutive query positions starting at
    kv_lens[b] per row; k/v: (B, T, K, hd) with the S draft K/V already
    scattered in. Query s of row b attends to keys [0, kv_lens[b] + s]."""
    return ops.verify_attention(q, k, v, kv_lens)


def decode_verify_ragged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                         k_gathered: torch.Tensor, v_gathered: torch.Tensor,
                         kv_lens):
    """Speculative-verify sibling of `decode_step_ragged`: score S = k + 1
    consecutive positions per stream in one step.

    tokens: (B, S) — row b holds [current token, draft_0 .. draft_{k-1}]
    (short drafts padded arbitrarily; the caller never accepts the padded
    columns' logits). k_gathered/v_gathered: (L, B, T, K, hd) gathered views
    (the caller's copy: each layer's S-token span is scattered into it IN
    PLACE at positions kv_lens[b] .. kv_lens[b] + S - 1, so T must cover
    kv_lens + S — an index assignment raises where the reference's
    `.at[].set` would drop the write). kv_lens: (B,) committed context
    lengths, the position tokens[b, 0] is written at.

    Returns (logits (B, S, V), k_new (L, B, S, K, hd), v_new (L, B, S, K,
    hd)) for the caller to commit (PagedKVCache.write_token_span).

    Column s attends exactly the keys a plain step at position
    kv_lens[b] + s would see (the committed prefix and the s earlier draft
    keys), so greedy acceptance of the longest draft prefix that matches
    argmax(logits) reproduces plain greedy decoding."""
    if not supports_ragged_decode(cfg):
        raise NotImplementedError(
            f"speculative verify unsupported for family={cfg.family!r} "
            f"(moe_layer_freq={cfg.moe_layer_freq}); use decode_step")
    _check_ported(cfg)
    B, S = tokens.shape
    dev = tokens.device
    pos = torch.as_tensor(kv_lens, device=dev).to(torch.int64)
    rows = torch.arange(B, device=dev)[:, None]
    rp = pos[:, None] + torch.arange(S, device=dev)[None, :]   # (B, S)
    lens_attn = pos.to(torch.int32)                         # query 0's position
    h = embed_tokens(cfg, params, tokens)                   # (B, S, D)
    k_new, v_new = [], []
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        k_l, v_l = k_gathered[l], v_gathered[l]             # (B, T, K, hd)
        x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, p, x)                   # (B, S, ., hd)
        q = L.apply_rope(q, rp, cfg.rope_theta)
        k = L.apply_rope(k, rp, cfg.rope_theta)
        # the whole draft span goes into the view; the per-row causal mask
        # keeps column s blind to the later draft keys
        k_l[rows, rp] = k.to(k_l.dtype)
        v_l[rows, rp] = v.to(v_l.dtype)
        o = _ragged_verify_attention(q, k_l, v_l, lens_attn)
        h = h + o.reshape(B, S, -1) @ p["wo"]
        h = ffn_block(cfg, p, h)
        k_new.append(k)
        v_new.append(v)
    logits = lm_head(cfg, params, h)
    return logits, torch.stack(k_new), torch.stack(v_new)
