"""The dense model family: parameter shapes, embedding, projections, the
language-model head and the two decode steps.

Counterpart of src/repro/models/model.py (its dense, single-layer-stack
part). The reference scans a jitted body over stacked layer parameters; here
the layers are a Python loop of eager PyTorch ops. Attention goes through
`kernels.ops`, which runs the CUDA decode kernel on the card and the plain
version on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Any          # repro_torch.params.ModelParams (mapping-style access)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.num_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} (num_experts={cfg.num_experts}) is not "
            "ported; only the dense family is")


def model_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter shapes of a dense model, identical to the reference's."""
    _check_dense(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K, n = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    layer = {"ln1": (d,), "wq": (d, H * hd), "wk": (d, K * hd),
             "wv": (d, K * hd), "wo": (H * hd, d)}
    if cfg.qkv_bias:
        layer.update(bq=(H * hd,), bk=(K * hd,), bv=(K * hd,))
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
    x = L.rms_norm(h, p["ln2"], cfg.norm_eps)
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
    _check_dense(cfg)
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
    _check_dense(cfg)
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
