"""The model families of the port: parameter shapes, embedding,
projections, the FFN (SwiGLU, top-k MoE or Whisper's GELU MLP, by the
layer's keys), the recurrent blocks, the language-model head, the
full-sequence `forward`, `prefill`, the decode steps and the speculative
verify step.

Counterpart of src/repro/models/model.py for every family of its
`ARCH_IDS`: dense stacks and vlm (a dense stack whose leading positions
are patch embeddings), MoE in every layer or in interleaved (dense, MoE)
pairs, ssm (Mamba2), the recurrent hybrid (RecurrentGemma: (rglru, rglru,
attn) triples and a tail of rglru layers) and audio (Whisper: a
bidirectional encoder and a decoder that cross-attends to it). The
reference scans a jitted body over stacked layer parameters; here the
layers are a Python loop of eager PyTorch ops. Attention goes through
`kernels.ops`, which runs the CUDA prefill, decode and verify kernels on
the card and the plain versions on the CPU; where autograd needs its
backward (trainable parameters under grad), through `layers.FlashAttention`,
whose forward is the same prefill kernel. `forward` is the training
forward too, with the reference's remat policies.

Serving (`SegmentedPrefill`, the ragged decode step, speculation) takes the
dense, vlm and uniform MoE stacks only, as in the reference; the pairs,
ssm, the hybrid and audio are served by `prefill` and `decode_step`.

Beyond the reference's families, a DeepSeek-V3-style decoder (`MLAConfig`,
Kanana-2-30B-A3B): multi-head latent attention, leading dense layers and
MoE layers of sigmoid-routed and shared experts, served through
`SegmentedPrefill` and the ragged decode step (no speculation). Its cache
is the latent: `k` holds c_kv (the normed latent, one head of
kv_lora_rank) and `v` k_pe (the rotated key shared by the heads, one head
of qk_rope_head_dim). A prefill up-projects the latent to per-head keys and
values for the prefill kernel (q/k width 192, v width 128 at published
size); a decode step attends through the latent itself (the absorbed form)
in plain torch ops. It has no sharding rules.

The same functions run sharded on DTensors inside
`distributed.sharding.use_sharding`: `param_axes` and `cache_axes` give
every leaf's logical dims, activations are tagged with `logical` at the
reference's sites, and the cache is written where each rank's block lies
(`sharding.write_seq`). Outside a mesh every tag is the identity.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, _expanded_pattern
from repro_torch.configs.mla import MLAConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import logical
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Any          # repro_torch.params.ModelParams (mapping-style access)

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _check_ported(cfg: ModelConfig) -> None:
    """Admit every family of the reference's `ARCH_IDS`: dense, vlm, ssm,
    the recurrent hybrid and audio, and MoE with an MoE FFN in every layer
    (moe_layer_freq 1) or in every second one (interleaved (dense, MoE)
    pairs, moe_layer_freq 2). Raise for any other family or frequency."""
    if cfg.family not in FAMILIES or \
            (cfg.num_experts and cfg.moe_layer_freq not in (1, 2)):
        raise NotImplementedError(
            f"family {cfg.family!r} (num_experts={cfg.num_experts}, "
            f"moe_layer_freq={cfg.moe_layer_freq}) is not a family of the "
            f"reference: {FAMILIES}, MoE at moe_layer_freq 1 or 2")


def is_mla(cfg: ModelConfig) -> bool:
    """A DeepSeek-V3-style decoder with latent attention (`MLAConfig`)."""
    return isinstance(cfg, MLAConfig)


def _is_pairs(cfg: ModelConfig) -> bool:
    """Interleaved (dense, MoE) layer pairs (Llama4-Maverick)."""
    return bool(cfg.num_experts) and cfg.moe_layer_freq == 2


def _attn_layer_shapes(cfg: ModelConfig, cross: bool = False,
                       moe: Optional[bool] = None
                       ) -> Dict[str, Tuple[int, ...]]:
    """One attention layer and its FFN, as the reference lays it out:
    audio adds the LayerNorm biases, the GELU MLP with its biases and, with
    `cross`, the decoder's cross-attention (`*_x`); `moe` (default: the
    config has experts) picks the MoE FFN, and the dense half of a pair
    takes d_ff_dense."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    if moe is None:
        moe = bool(cfg.num_experts)
    layer = {"ln1": (d,), "wq": (d, H * hd), "wk": (d, K * hd),
             "wv": (d, K * hd), "wo": (H * hd, d)}
    if cfg.qkv_bias:
        layer.update(bq=(H * hd,), bk=(K * hd,), bv=(K * hd,))
    if cfg.family == "audio":
        layer["ln1_b"] = (d,)
    if cross:
        layer.update(ln_x=(d,), ln_x_b=(d,), wq_x=(d, H * hd),
                     wk_x=(d, K * hd), wv_x=(d, K * hd), wo_x=(H * hd, d))
    if moe:
        # per expert: gate|up concatenated on the last axis, (E, D, 2F)
        E = cfg.num_experts
        layer.update(router=(d, E), wi=(E, d, 2 * cfg.d_ff),
                     wd=(E, cfg.d_ff, d), ln2=(d,))
    elif cfg.family == "audio":
        layer.update(ln2=(d,), ln2_b=(d,), wi=(d, cfg.d_ff), bi=(cfg.d_ff,),
                     wd=(cfg.d_ff, d), bd=(d,))
    else:
        # gate|up as an explicit (2, F) axis, as the reference stores it
        ff = cfg.d_ff_dense if (cfg.num_experts and cfg.d_ff_dense) \
            else cfg.d_ff
        layer.update(ln2=(d,), wi=(d, 2, ff), wd=(ff, d))
    return layer


def _rglru_layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, lw = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "ln1": (d,),
        "w_x": (d, lw), "w_gate": (d, lw),
        "conv_w": (lw, cfg.ssm_conv_width), "conv_b": (lw,),
        "a_param": (lw,), "w_rg": (lw, lw), "w_ig": (lw, lw),
        "w_y": (lw, d),
        "ln2": (d,), "wi": (d, 2, cfg.d_ff), "wd": (cfg.d_ff, d),
    }


def _ssm_layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, din, N, nh, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.ssm_heads, cfg.ssm_conv_width)
    return {
        "ln": (d,),
        "in_proj": (d, 2 * din + 2 * N + nh),
        "conv_w": (din + 2 * N, W), "conv_b": (din + 2 * N,),
        "A_log": (nh,), "Dp": (nh,), "dt_bias": (nh,),
        "norm_w": (din,),
        "out_proj": (din, d),
    }


def _stack(shapes: Dict[str, Tuple[int, ...]], n: int):
    return {k: (n,) + s for k, s in shapes.items()}


def _hybrid_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(#(rglru, rglru, attn) triples, #tail rglru layers) such that the
    expanded pattern truncated to num_layers is realised exactly."""
    pat = _expanded_pattern(cfg)
    n_tri = len(pat) // 3
    tail = len(pat) - 3 * n_tri
    assert all(p == "rglru" for p in pat[3 * n_tri:]), "tail must be rglru layers"
    return n_tri, tail


def model_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter shapes, identical to the reference's: a stacked `layers`
    group (dense, vlm, MoE, ssm; audio's decoder, beside `enc_layers` and
    the LayerNorm biases of both final norms); for the pairs `pairs` =
    {dense, moe} stacked over num_layers // 2; for the hybrid `blocks` =
    {r1, r2, attn} stacked over the triples and a stacked `tail`."""
    _check_ported(cfg)
    d = cfg.d_model
    out: Dict[str, Any] = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        out["unembed"] = (d, cfg.vocab_size)
    if cfg.family == "ssm":
        out["layers"] = _stack(_ssm_layer_shapes(cfg), cfg.num_layers)
    elif cfg.family == "hybrid":
        n_tri, tail = _hybrid_counts(cfg)
        out["blocks"] = {"r1": _stack(_rglru_layer_shapes(cfg), n_tri),
                         "r2": _stack(_rglru_layer_shapes(cfg), n_tri),
                         "attn": _stack(_attn_layer_shapes(cfg), n_tri)}
        if tail:
            out["tail"] = _stack(_rglru_layer_shapes(cfg), tail)
    elif cfg.family == "audio":
        out.update(enc_final_norm=(d,), enc_final_norm_b=(d,),
                   final_norm_b=(d,))
        out["enc_layers"] = _stack(_attn_layer_shapes(cfg),
                                   cfg.num_encoder_layers)
        out["layers"] = _stack(_attn_layer_shapes(cfg, cross=True),
                               cfg.num_layers)
    elif is_mla(cfg):
        out["layers"] = _mla_layer_shapes(cfg)
    elif _is_pairs(cfg):
        n_pairs = cfg.num_layers // 2
        out["pairs"] = {
            "dense": _stack(_attn_layer_shapes(cfg, moe=False), n_pairs),
            "moe": _stack(_attn_layer_shapes(cfg, moe=True), n_pairs)}
    else:
        out["layers"] = _stack(_attn_layer_shapes(cfg), cfg.num_layers)
    return out


def _attn_layer_axes(cfg: ModelConfig, cross: bool = False,
                     moe: Optional[bool] = None) -> Dict[str, Tuple]:
    """Logical dims of `_attn_layer_shapes`' leaves (the reference's
    `_attn_layer_axes`): K/V projections replicate (kv_x_hd), the rest
    shards d_model, heads, ff or experts."""
    if moe is None:
        moe = bool(cfg.num_experts)
    ax: Dict[str, Tuple] = {"ln1": (None,), "wq": ("d_model", "heads_x_hd"),
                            "wk": ("d_model", "kv_x_hd"),
                            "wv": ("d_model", "kv_x_hd"),
                            "wo": ("heads_x_hd", "d_model")}
    if cfg.qkv_bias:
        ax.update(bq=("heads_x_hd",), bk=("kv_x_hd",), bv=("kv_x_hd",))
    if cfg.family == "audio":
        ax["ln1_b"] = (None,)
    if cross:
        ax.update(ln_x=(None,), ln_x_b=(None,),
                  wq_x=("d_model", "heads_x_hd"), wk_x=("d_model", "kv_x_hd"),
                  wv_x=("d_model", "kv_x_hd"), wo_x=("heads_x_hd", "d_model"))
    if moe:
        ax.update(router=("d_model", None), wi=("experts", "d_model", "ff"),
                  wd=("experts", "ff", "d_model"), ln2=(None,))
    elif cfg.family == "audio":
        ax.update(ln2=(None,), ln2_b=(None,), wi=("d_model", "ff"),
                  bi=("ff",), wd=("ff", "d_model"), bd=(None,))
    else:
        ax.update(ln2=(None,), wi=("d_model", None, "ff"),
                  wd=("ff", "d_model"))
    return ax


def _rglru_layer_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    return {
        "ln1": (None,),
        "w_x": ("d_model", "lru"), "w_gate": ("d_model", "lru"),
        "conv_w": ("lru", None), "conv_b": ("lru",),
        "a_param": ("lru",), "w_rg": ("lru", "lru"), "w_ig": ("lru", "lru"),
        "w_y": ("lru", "d_model"),
        "ln2": (None,), "wi": ("d_model", None, "ff"), "wd": ("ff", "d_model"),
    }


def _ssm_layer_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    return {
        "ln": (None,),
        "in_proj": ("d_model", "ssm_inner"),
        "conv_w": ("ssm_inner", None), "conv_b": ("ssm_inner",),
        "A_log": (None,), "Dp": (None,), "dt_bias": (None,),
        "norm_w": ("ssm_inner",),
        "out_proj": ("ssm_inner", "d_model"),
    }


def _stack_axes(axes: Dict[str, Tuple]) -> Dict[str, Tuple]:
    return {k: ("layers",) + a for k, a in axes.items()}


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical dims of every leaf of `model_shapes(cfg)`, leaf for leaf the
    reference's `param_axes` (src/repro/models/model.py:224); the stacked
    axis is "layers". `distributed.sharding.tree_placements` maps them to
    placements."""
    _check_ported(cfg)
    if is_mla(cfg):
        raise NotImplementedError("no sharding rules for latent attention")
    out: Dict[str, Any] = {"embed": ("vocab", "d_model"),
                           "final_norm": (None,)}
    if not cfg.tie_embeddings:
        out["unembed"] = ("d_model", "vocab")
    if cfg.family == "ssm":
        out["layers"] = _stack_axes(_ssm_layer_axes(cfg))
    elif cfg.family == "hybrid":
        out["blocks"] = {"r1": _stack_axes(_rglru_layer_axes(cfg)),
                         "r2": _stack_axes(_rglru_layer_axes(cfg)),
                         "attn": _stack_axes(_attn_layer_axes(cfg))}
        if _hybrid_counts(cfg)[1]:
            out["tail"] = _stack_axes(_rglru_layer_axes(cfg))
    elif cfg.family == "audio":
        out.update(enc_final_norm=(None,), enc_final_norm_b=(None,),
                   final_norm_b=(None,))
        out["enc_layers"] = _stack_axes(_attn_layer_axes(cfg))
        out["layers"] = _stack_axes(_attn_layer_axes(cfg, cross=True))
    elif _is_pairs(cfg):
        out["pairs"] = {"dense": _stack_axes(_attn_layer_axes(cfg, moe=False)),
                        "moe": _stack_axes(_attn_layer_axes(cfg, moe=True))}
    else:
        out["layers"] = _stack_axes(_attn_layer_axes(cfg))
    return out


def _at(group, l: int) -> Dict[str, torch.Tensor]:
    """Layer `l`'s slice of every stacked leaf of a group (views)."""
    return {k: v[l] for k, v in group.items()}


def layer_params(params: Params, l: int) -> Dict[str, torch.Tensor]:
    """Layer `l`'s slice of every stacked leaf (views, no copies). In an MLA
    stack the FFN's leaves are stacked over their own layers: a leading
    dense layer gets `wi`/`wd` from `wi_dense`/`wd_dense`, an MoE layer its
    experts and router (`_mla_layer_shapes`)."""
    group = params["layers"]
    if "wkv_b" in group:
        return _mla_at(group, l)
    return _at(group, l)


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    return logical(shd.lookup(params["embed"], tokens), "act_batch",
                   "act_seq", "act_d")


def _project_qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor):
    """Separate q/k/v projections, shaped (B, S, heads, hd)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (shd.unflatten(q, -1, (H, hd)), shd.unflatten(k, -1, (K, hd)),
            shd.unflatten(v, -1, (K, hd)))


LayerParams = Dict[str, torch.Tensor]


def _attn_layers(params: Params, cfg: ModelConfig
                 ) -> Iterator[Tuple[LayerParams, Tuple[int, ...]]]:
    """Each attention layer of a dense, vlm, MoE, pairs or audio (decoder)
    stack in order: its parameters, and its index into the leading axes of
    the k/v cache ((l,), or (pair, 0 | 1) for the pairs' (L/2, 2, ...)
    lead)."""
    if _is_pairs(cfg):
        pairs = params["pairs"]
        for t in range(cfg.num_layers // 2):
            for j, sub in enumerate(("dense", "moe")):
                yield _at(pairs[sub], t), (t, j)
    else:
        for l in range(cfg.num_layers):
            yield layer_params(params, l), (l,)


def _norm(cfg: ModelConfig, p: Dict[str, torch.Tensor], h: torch.Tensor,
          key: str) -> torch.Tensor:
    """The pre-norm `key` of a layer: LayerNorm where the layer has its bias
    (`key + "_b"`, audio), RMSNorm otherwise."""
    if key + "_b" in p:
        return L.layer_norm(h, p[key], p[key + "_b"], cfg.norm_eps)
    return L.rms_norm(h, p[key], cfg.norm_eps)


def ffn_block(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              h: torch.Tensor) -> torch.Tensor:
    """The FFN variant follows the layer's keys, as the reference's does:
    `ln2_b` means LayerNorm and the GELU MLP (audio), `router` the MoE FFN,
    otherwise SwiGLU."""
    x = _norm(cfg, p, h, "ln2")
    if "ln2_b" in p:
        y = L.gelu_mlp(x, p["wi"], p["bi"], p["wd"], p["bd"])
    elif "router_bias" in p:
        y = L.moe_ffn_shared(x, p["router"], p["router_bias"], p["wi"],
                             p["wd"], p["wi_shared"], p["wd_shared"],
                             k=cfg.experts_per_token,
                             scale=cfg.routed_scaling_factor,
                             capacity_factor=cfg.moe_capacity_factor,
                             min_capacity=cfg.moe_min_capacity)
    elif "router" in p:
        y = L.moe_ffn(x, p["router"], p["wi"], p["wd"],
                      k=cfg.experts_per_token,
                      capacity_factor=cfg.moe_capacity_factor,
                      min_capacity=cfg.moe_min_capacity)
    else:
        y = L.swiglu(x, p["wi"], p["wd"])
    return logical(h + y, "act_batch", "act_seq", "act_d")


def lm_head(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """The final norm (`_norm`'s rule: LayerNorm where `final_norm_b` is
    there, audio) and the vocabulary projection."""
    h = _norm(cfg, params, h, "final_norm")
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    # the matmul runs in the weights' type (an f32 prefill state casts down)
    return logical(h.to(w.dtype) @ w, "act_batch", "act_seq", "act_vocab")


def _merge_vision(h: torch.Tensor, vision_embeds: torch.Tensor
                  ) -> torch.Tensor:
    """Replace the leading num_patches positions of h (B, S, D) with the
    patch embeddings (B, P, D)."""
    P = vision_embeds.shape[1]
    return torch.cat([vision_embeds.to(h.dtype), h[:, P:]], dim=1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               **kw) -> torch.Tensor:
    """Whole-sequence attention: `FlashAttention` where autograd will ask
    for its backward (grad enabled and an input requiring grad), else the
    prefill kernel called directly, so serving launches the same kernel and
    builds no graph."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return L.blocked_attention(q, k, v, **kw)
    return ops.prefill_attention(q, k, v, **kw)


def attn_block(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               h: torch.Tensor, *, positions: torch.Tensor,
               use_rope: bool = True, causal: bool = True):
    """Pre-norm self-attention over the whole sequence through the prefill
    kernel: causal (within cfg.local_window when set) or, with
    `causal=False`, bidirectional (Whisper's encoder); RoPE unless
    `use_rope=False` (Whisper's sinusoids are added to the input instead).
    Returns (h, (k, v)), k/v (B, S, K, hd) for the cache."""
    x = _norm(cfg, p, h, "ln1")
    q, k, v = _project_qkv(cfg, p, x)
    if use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    q = logical(q, "act_batch", "act_seq", "act_heads", None)
    k = logical(k, "act_batch", "act_seq", "act_heads", None)
    o = _attention(q, k, v, causal=causal, local_window=cfg.local_window)
    h = h + shd.merge_heads(o) @ p["wo"]
    return logical(h, "act_batch", "act_seq", "act_d"), (k, v)


def _cross_kv(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              enc_out: torch.Tensor):
    """A decoder layer's cross-attention keys and values over the encoder
    output (B, T, D): each (B, T, K, hd)."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return (shd.unflatten(enc_out @ p["wk_x"], -1, (K, hd)),
            shd.unflatten(enc_out @ p["wv_x"], -1, (K, hd)))


def _cross_attn(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                h: torch.Tensor, xk: torch.Tensor,
                xv: torch.Tensor) -> torch.Tensor:
    """Whisper's cross-attention of the decoder positions h (B, S, D) over
    every encoder key: the prefill kernel without a mask, or for one
    position (a decode step) the decode kernel with kv_len = T on every row
    (its query at T - 1 sees all T keys)."""
    S = h.shape[1]
    x = L.layer_norm(h, p["ln_x"], p["ln_x_b"], cfg.norm_eps)
    q = shd.unflatten(x @ p["wq_x"], -1,
                      (cfg.num_heads, cfg.resolved_head_dim))
    if S == 1:
        o = ops.decode_attention(q[:, 0], xk, xv, xk.shape[1])[:, None]
    else:
        o = _attention(q, xk, xv, causal=False)
    return h + shd.merge_heads(o) @ p["wo_x"]


def rglru_block(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                h: torch.Tensor, *, conv_state=None, h_state=None):
    """Griffin recurrent block and its MLP: a GELU gate (JAX's default, the
    tanh form) times the RG-LRU of the causally convolved input. Over S
    tokens with the states from a previous call, or from zero. Returns
    (h, (h_last f32, conv_state))."""
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    xb, conv_state = L.causal_conv1d(x @ p["w_x"], p["conv_w"], p["conv_b"],
                                     conv_state)
    y, h_last = L.rglru(xb, p["a_param"], p["w_rg"], p["w_ig"], h_state)
    h = h + (y * gate) @ p["w_y"]
    h = logical(ffn_block(cfg, p, h), "act_batch", "act_seq", "act_d")
    return h, (h_last, conv_state)


def _ssm_in(cfg: ModelConfig, p: Dict[str, torch.Tensor], h: torch.Tensor,
            conv_state):
    """Mamba2's input side: the projection split z | xBC | dt, the causal
    conv of xBC and its SiLU, softplus'd steps and the decay rates."""
    din, N = cfg.d_inner, cfg.ssm_state
    proj = L.rms_norm(h, p["ln"], cfg.norm_eps) @ p["in_proj"]
    # layout: z (din) | xBC (din + 2N, the conv input x|B|C) | dt (nh)
    z, xBC, dt = proj.split([din, din + 2 * N, cfg.ssm_heads], dim=-1)
    xBC, conv_state = L.causal_conv1d(xBC, p["conv_w"], p["conv_b"],
                                      conv_state)
    xs, Bm, Cm = F.silu(xBC).split([din, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return z, xs, Bm, Cm, dt, A, conv_state


def _ssm_out(cfg: ModelConfig, p: Dict[str, torch.Tensor], h, y, xs, z):
    """The skip through Dp, the gated RMSNorm and the output projection."""
    y = y + xs * p["Dp"][:, None]
    y = y.reshape(*h.shape[:2], cfg.d_inner)
    y = L.rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return h + y @ p["out_proj"]


def ssm_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], h: torch.Tensor,
              *, conv_state=None, ssm_state=None):
    """Mamba2 block over S tokens. Returns (h, (ssm_state f32,
    conv_state))."""
    Bsz, S = h.shape[:2]
    z, xs, Bm, Cm, dt, A, conv_state = _ssm_in(cfg, p, h, conv_state)
    xs = xs.reshape(Bsz, S, cfg.ssm_heads, cfg.ssm_head_dim)
    y, ssm_state = L.ssd_chunked(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                                 h0=ssm_state)
    h = logical(_ssm_out(cfg, p, h, y, xs, z), "act_batch", "act_seq",
                "act_d")
    return h, (ssm_state, conv_state)


# ---------------------------------------------------------------------------
# Latent attention (`MLAConfig`): DeepSeek-V3's layer, as Kanana-2 has it
# ---------------------------------------------------------------------------

# the FFN leaves of an MLA stack's MoE layers, stacked over those layers
_MLA_MOE_KEYS = ("router", "router_bias", "wi", "wd", "wi_shared",
                 "wd_shared")


def _mla_layer_shapes(cfg: MLAConfig) -> Dict[str, Tuple[int, ...]]:
    """The `layers` group of an MLA stack. The attention's leaves and both
    norms are stacked over every layer: wq (d, H * (dn + dr)), each head
    [nope | rope]; wkv_a (d, rank + dr), [c_kv | k_pe]; kv_norm (rank,);
    wkv_b (rank, H * (dn + dv)), each head [k_nope | v]; wo (H * dv, d). The
    leading dense layers' SwiGLU (`wi_dense` (d, 2, F), `wd_dense`) is
    stacked over those layers; the MoE layers' router, its correction bias,
    the routed experts ((E, d, 2F) gate|up, (E, F, d)) and the shared
    experts' SwiGLU over the MoE layers. Every leaf is in `layers`."""
    d, H, E = cfg.d_model, cfg.num_heads, cfg.num_experts
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    out = _stack({"ln1": (d,), "wq": (d, H * (dn + dr)),
                  "wkv_a": (d, r + dr), "kv_norm": (r,),
                  "wkv_b": (r, H * (dn + dv)), "wo": (H * dv, d),
                  "ln2": (d,)}, cfg.num_layers)
    if cfg.first_k_dense:
        out.update(_stack({"wi_dense": (d, 2, cfg.d_ff_dense),
                           "wd_dense": (cfg.d_ff_dense, d)},
                          cfg.first_k_dense))
    out.update(_stack({"router": (d, E), "router_bias": (E,),
                       "wi": (E, d, 2 * cfg.d_ff), "wd": (E, cfg.d_ff, d),
                       "wi_shared": (d, 2, cfg.d_ff_shared),
                       "wd_shared": (cfg.d_ff_shared, d)},
                      cfg.num_moe_layers))
    return out


def _mla_at(group, l: int) -> Dict[str, torch.Tensor]:
    """Layer `l` of an MLA stack: the attention's leaves, and `wi`/`wd` of
    its dense FFN or its MoE layer's leaves."""
    n_dense = len(group["wkv_b"]) - len(group["router"])
    out = {}
    for key, val in group.items():
        if key in _MLA_MOE_KEYS:
            if l >= n_dense:
                out[key] = val[l - n_dense]
        elif key.endswith("_dense"):
            if l < n_dense:
                out[key[:-len("_dense")]] = val[l]
        else:
            out[key] = val[l]
    return out


def rope_dim(cfg: ModelConfig) -> int:
    """The width the rotary tables rotate: MLA's rotary part, else a head."""
    return cfg.qk_rope_head_dim if is_mla(cfg) else cfg.resolved_head_dim


def _mla_rope(cfg: MLAConfig, x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """The rotary dims x (..., dr) de-interleaved (even dims, then odd), as
    the published code does with `rope_interleave` true, then rotated by
    split halves by tables that broadcast against its halves."""
    x = x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2).flatten(-2)
    return L.rope_rotate(x, cos, sin)


def mla_project(cfg: MLAConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor):
    """The per-token part of an MLA layer on its normed input x (..., d):
    q (..., H, dn + dr) with the rotary part rotated, the latent c_kv (...,
    rank) RMS-normed, and k_pe (..., dr) rotated; cos/sin (..., dr / 2) are
    the tokens' rotary tables."""
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = (x @ p["wq"]).unflatten(-1, (cfg.num_heads, -1))
    ckv = x @ p["wkv_a"]
    c = L.rms_norm(ckv[..., :r], p["kv_norm"], cfg.norm_eps)
    q_pe = _mla_rope(cfg, q[..., dn:], cos[..., None, :], sin[..., None, :])
    return (torch.cat([q[..., :dn], q_pe], dim=-1), c,
            _mla_rope(cfg, ckv[..., r:], cos, sin))


def mla_expand(cfg: MLAConfig, p: Dict[str, torch.Tensor], c: torch.Tensor,
               k_pe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent up-projected for the prefill kernel: c (B, T, rank) and
    k_pe (B, T, dr) -> k (B, T, H, dn + dr), [k_nope | k_pe] with k_pe
    shared by the heads, and v (B, T, H, dv), each dense."""
    dn, w = cfg.qk_nope_head_dim, p["wkv_b"]
    kv = (c.to(w.dtype) @ w).unflatten(-1, (cfg.num_heads, -1))
    k = torch.cat([kv[..., :dn], k_pe[..., None, :].to(kv.dtype).expand(
        *kv.shape[:-1], -1)], dim=-1)
    return k, kv[..., dn:].contiguous()


def _mla_layer(cfg: MLAConfig, positions: torch.Tensor,
               p: Dict[str, torch.Tensor], h: torch.Tensor):
    """One MLA layer and its FFN over the whole sequence: (h, (c_kv,
    k_pe)), the latent (B, S, rank) and (B, S, dr) for the cache."""
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    cos, sin = L.rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q, c, k_pe = mla_project(cfg, p, x, cos, sin)
    k, v = mla_expand(cfg, p, c, k_pe)
    h = h + _attention(q, k, v, causal=True).flatten(2) @ p["wo"]
    return ffn_block(cfg, p, h), (c, k_pe)


def _mla_decode_layer(cfg: MLAConfig, p: Dict[str, torch.Tensor],
                      h: torch.Tensor, pos: torch.Tensor, k_l: torch.Tensor,
                      v_l: torch.Tensor, lens: torch.Tensor):
    """One token a row through an MLA layer and its FFN. The row's c_kv and
    k_pe are written into its latent cache k_l (B, T, 1, rank) / v_l (B, T,
    1, dr) at pos[b] in place; row b attends to keys [0, lens[b]) through
    the latent itself (the absorbed form): scores (q_nope W_k) . c_kv + q_pe
    . k_pe over sqrt(dn + dr), output (p . c_kv) W_v, all in f32, plain
    torch ops. Returns (h, c_kv (B, rank), k_pe (B, dr))."""
    B, dn = h.shape[0], cfg.qk_nope_head_dim
    rows = torch.arange(B, device=h.device)
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    cos, sin = L.rope_tables(pos[:, None], cfg.qk_rope_head_dim,
                             cfg.rope_theta)
    q, c, k_pe = mla_project(cfg, p, x, cos, sin)
    k_l[rows, pos, 0] = c[:, 0].to(k_l.dtype)
    v_l[rows, pos, 0] = k_pe[:, 0].to(v_l.dtype)
    w = p["wkv_b"].float().unflatten(-1, (cfg.num_heads, -1))
    q = q[:, 0].float()
    lat, pe = k_l[:, :, 0].float(), v_l[:, :, 0].float()
    s = torch.einsum("bhn,rhn,btr->bht", q[..., :dn], w[..., :dn], lat) \
        + torch.einsum("bhd,btd->bht", q[..., dn:], pe)
    keys = torch.arange(s.shape[-1], device=h.device)
    s = s.masked_fill(keys >= lens[:, None, None], float("-inf"))
    a = torch.softmax(s / cfg.qk_head_dim ** 0.5, dim=-1)
    o = torch.einsum("bht,btr,rhv->bhv", a, lat, w[..., dn:])
    h = h + o.reshape(B, 1, -1).to(h.dtype) @ p["wo"]
    return ffn_block(cfg, p, h), c[:, 0], k_pe[:, 0]


def _decode_mla(params: Params, cfg: MLAConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """`decode_step` of an MLA stack: the ragged step with every row at
    cache["pos"], on the cache itself."""
    pos = int(cache["pos"])
    logits, _, _ = _decode_mla_ragged(params, cfg, tokens, cache["k"],
                                      cache["v"], [pos] * tokens.shape[0])
    return logits, dict(cache, pos=pos + 1)


def _decode_mla_ragged(params: Params, cfg: MLAConfig, tokens: torch.Tensor,
                       k_gathered: torch.Tensor, v_gathered: torch.Tensor,
                       kv_lens):
    """`decode_step_ragged` of an MLA stack: k/v_gathered are the latent
    (L, B, T, 1, rank) / (L, B, T, 1, dr); returns the new latent rows (L,
    B, 1, rank) / (L, B, 1, dr) for the pool."""
    pos = torch.as_tensor(kv_lens, device=tokens.device).to(torch.int64)
    h = embed_tokens(cfg, params, tokens[:, None])
    k_new, v_new = [], []
    for l in range(cfg.num_layers):
        h, c, k_pe = _mla_decode_layer(cfg, layer_params(params, l), h, pos,
                                       k_gathered[l], v_gathered[l], pos + 1)
        k_new.append(c[:, None])
        v_new.append(k_pe[:, None])
    return (lm_head(cfg, params, h)[:, 0], torch.stack(k_new),
            torch.stack(v_new))


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


REMAT_POLICIES = ("none", "full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """`dots` keeps the weight products: `x @ w` reaches the dispatcher as
    an mm, with no batch dimension as in
    `checkpoint_dots_with_no_batch_dims`; attention, the experts' bmm and
    the elementwise work are recomputed."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(policy: str):
    """The reference's `_remat` (src/repro/models/model.py:423-431) as a
    caller of one scanned body: `call(fn, *args)` runs fn as is ("none"),
    under `torch.utils.checkpoint`, which keeps only the body's inputs and
    recomputes everything else in the backward ("full"), or which also
    keeps the weight products ("dots"). Without grad, fn runs as is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat {policy!r} not in {REMAT_POLICIES}")

    def call(fn, *args):
        if policy == "none" or not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return call


class _Unbound(dict):
    """Parameters whose stacked leaves are tuples of per-layer slices, which
    `_at` indexes as it indexes a stacked leaf."""
    device: torch.device


def _unbound(params: Params, cfg: ModelConfig) -> _Unbound:
    """`params` with every stacked leaf sliced once by `torch.unbind`: the
    backward then stacks each leaf's gradient once, where a slice `v[l]` per
    layer scatters every layer's into a zeroed copy of the whole stack."""
    def unbind(group):
        return {k: torch.unbind(v) if isinstance(v, torch.Tensor)
                else unbind(v) for k, v in group.items()}
    out = _Unbound({k: unbind(params[k]) if isinstance(shape, dict)
                    else params[k] for k, shape in model_shapes(cfg).items()})
    out.device = params.device
    return out


def _attn_ffn(cfg: ModelConfig, positions: torch.Tensor,
              p: Dict[str, torch.Tensor], h: torch.Tensor):
    """One attention layer and its FFN: (h, (k, v))."""
    h, kv = attn_block(cfg, p, h, positions=positions)
    return ffn_block(cfg, p, h), kv


def _pair(cfg: ModelConfig, positions: torch.Tensor, p_dense, p_moe,
          h: torch.Tensor):
    """A (dense, MoE) pair: (h, ((k, v) dense, (k, v) MoE))."""
    h, kv_dense = _attn_ffn(cfg, positions, p_dense, h)
    h, kv_moe = _attn_ffn(cfg, positions, p_moe, h)
    return h, (kv_dense, kv_moe)


def _triple(cfg: ModelConfig, positions: torch.Tensor, p_r1, p_r2, p_attn,
            h: torch.Tensor):
    """A hybrid (rglru, rglru, attn) triple: (h, (r1 states, r2 states,
    (k, v)))."""
    h, s1 = rglru_block(cfg, p_r1, h)
    h, s2 = rglru_block(cfg, p_r2, h)
    h, kv = _attn_ffn(cfg, positions, p_attn, h)
    return h, (s1, s2, kv)


def _run_layers(params: Params, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[Dict[str, Any]] = None,
                remat: str = "none") -> torch.Tensor:
    """Every layer of a non-audio model over the whole sequence h (B, S,
    D), each of the reference's scanned bodies (a layer, a hybrid triple or
    tail layer, a (dense, MoE) pair) under `_remat(remat)`. With `cache`
    (the `init_cache` layout), each layer's state goes into it: the SSD and
    conv states for ssm; for the hybrid the RG-LRU and conv states and each
    attention layer's last window of K/V as a ring; for the attention
    stacks the K/V at positions [0, S)."""
    S = h.shape[1]
    unit = _remat(remat)
    if cfg.family == "ssm":
        for l in range(cfg.num_layers):
            h, (ssm_s, conv_s) = unit(functools.partial(ssm_block, cfg),
                                      layer_params(params, l), h)
            if cache is not None:
                cache["ssm"][l] = ssm_s
                cache["conv"][l] = conv_s
    elif cfg.family == "hybrid":
        blocks = params["blocks"]
        n_tri, tail = _hybrid_counts(cfg)
        for t in range(n_tri):
            h, (s1, s2, (k, v)) = unit(
                functools.partial(_triple, cfg, positions),
                _at(blocks["r1"], t), _at(blocks["r2"], t),
                _at(blocks["attn"], t), h)
            if cache is not None:
                for r, (h_s, c_s) in (("1", s1), ("2", s2)):
                    cache["h" + r][t] = h_s
                    cache["conv" + r][t] = c_s
                win = cache["k"].shape[2]
                cache["k"][t] = _last_window(k, win)
                cache["v"][t] = _last_window(v, win)
        for t in range(tail):
            h, (h_s, c_s) = unit(functools.partial(rglru_block, cfg),
                                 _at(params["tail"], t), h)
            if cache is not None:
                cache["h_tail"][t] = h_s
                cache["conv_tail"][t] = c_s
    elif is_mla(cfg):
        for l in range(cfg.num_layers):
            h, (c, k_pe) = unit(functools.partial(_mla_layer, cfg, positions),
                                layer_params(params, l), h)
            if cache is not None:
                shd.write_seq(cache["k"][l], 0, c[:, :, None])
                shd.write_seq(cache["v"][l], 0, k_pe[:, :, None])
    elif _is_pairs(cfg):
        pairs = params["pairs"]
        for t in range(cfg.num_layers // 2):
            h, kvs = unit(functools.partial(_pair, cfg, positions),
                          _at(pairs["dense"], t), _at(pairs["moe"], t), h)
            if cache is not None:
                for j, (k, v) in enumerate(kvs):
                    shd.write_seq(cache["k"][t, j], 0, k)
                    shd.write_seq(cache["v"][t, j], 0, v)
    else:
        for l in range(cfg.num_layers):
            h, (k, v) = unit(functools.partial(_attn_ffn, cfg, positions),
                             layer_params(params, l), h)
            if cache is not None:
                shd.write_seq(cache["k"][l], 0, k)
                shd.write_seq(cache["v"][l], 0, v)
    return h


def _embed(params: Params, cfg: ModelConfig, batch: Dict[str, Any]):
    """The token embeddings of batch["tokens"] (B, S), with the leading
    positions replaced by batch["vision_embeds"] for vlm."""
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    h = embed_tokens(cfg, params, tokens)
    if cfg.family == "vlm":
        h = _merge_vision(h, torch.as_tensor(batch["vision_embeds"],
                                             device=h.device))
    return h


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: str = "none") -> torch.Tensor:
    """Full-sequence forward of every family -> logits (B, S, V), with no
    cache: batch["tokens"] (B, S), and batch["vision_embeds"] (B, P, D) for
    vlm or batch["frames"] (B, encoder_seq, D) for audio. It is the
    training forward: with trainable parameters under grad, attention is
    `FlashAttention` (the prefill kernel on the card, the reference's
    blockwise backward) and `remat` ("none", "full" or "dots", the
    reference's policies) applies to each scanned body: a layer, a hybrid
    triple and each tail layer, a (dense, MoE) pair, each Whisper encoder
    and decoder layer. With frozen parameters it builds no graph and calls
    the prefill kernel directly. Each stacked leaf is sliced once per call
    (`_unbound`)."""
    _check_ported(cfg)
    params = _unbound(params, cfg)
    if cfg.family == "audio":
        return _forward_audio(params, cfg, batch, remat)
    h = _embed(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    return lm_head(cfg, params, _run_layers(params, cfg, h, positions,
                                            remat=remat))


def _encoder_layer(cfg: ModelConfig, positions: torch.Tensor,
                   p: Dict[str, torch.Tensor], h: torch.Tensor):
    h, _ = attn_block(cfg, p, h, positions=positions, use_rope=False,
                      causal=False)
    return ffn_block(cfg, p, h)


def _encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
            remat: str = "none") -> torch.Tensor:
    """Whisper's encoder over the stub frame embeddings (B, T, D), in their
    dtype: sinusoidal positions, bidirectional self-attention through the
    prefill kernel (no RoPE, no mask), the GELU MLP, the final LayerNorm;
    each layer under `_remat(remat)`."""
    T = frames.shape[1]
    h = frames + L.sinusoidal_positions(T, cfg.d_model,
                                        frames.device).to(frames.dtype)
    h = logical(h, "act_batch", "act_seq", "act_d")
    enc_pos = torch.arange(T, device=h.device)[None, :]
    unit = _remat(remat)
    for l in range(cfg.num_encoder_layers):
        h = unit(functools.partial(_encoder_layer, cfg, enc_pos),
                 _at(params["enc_layers"], l), h)
    return _norm(cfg, params, h, "enc_final_norm")


def _decoder_layer(cfg: ModelConfig, positions: torch.Tensor,
                   p: Dict[str, torch.Tensor], enc_out: torch.Tensor,
                   h: torch.Tensor):
    h, _ = attn_block(cfg, p, h, positions=positions, use_rope=False)
    h = _cross_attn(cfg, p, h, *_cross_kv(cfg, p, enc_out))
    return ffn_block(cfg, p, h)


def _forward_audio(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                   remat: str) -> torch.Tensor:
    """Whisper over batch["frames"] and the decoder tokens batch["tokens"]
    (B, S): the encoder, then each decoder layer's causal self-attention,
    cross-attention over the encoder output and GELU MLP."""
    dev = params.device
    enc_out = _encode(params, cfg, torch.as_tensor(batch["frames"],
                                                   device=dev), remat)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    S = tokens.shape[1]
    h = embed_tokens(cfg, params, tokens)
    h = h + L.sinusoidal_positions(S, cfg.d_model, dev).to(h.dtype)
    positions = torch.arange(S, device=dev)[None, :]
    unit = _remat(remat)
    for l in range(cfg.num_layers):
        h = unit(functools.partial(_decoder_layer, cfg, positions),
                 layer_params(params, l), enc_out, h)
    return lm_head(cfg, params, h)


# ---------------------------------------------------------------------------
# Cache and prefill
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                 dtype=torch.bfloat16) -> Dict[str, Tuple]:
    """name -> (shape, dtype), as the reference's. The recurrent states (ssm,
    h*) are f32 whatever `dtype`; the hybrid's k/v are a ring of
    min(local_window or max_seq, max_seq) slots; the pairs' k/v lead with
    (L/2, 2); audio adds each decoder layer's cross K/V `xk`/`xv` over the
    encoder_seq encoder positions; MLA's k/v are its latent, c_kv and k_pe,
    each one head wide. "pos" is a Python int in the port's caches."""
    _check_ported(cfg)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    out: Dict[str, Tuple] = {}
    if is_mla(cfg):
        lead = (cfg.num_layers, batch, max_seq, 1)
        out["k"] = (lead + (cfg.kv_lora_rank,), dtype)
        out["v"] = (lead + (cfg.qk_rope_head_dim,), dtype)
    elif cfg.family == "ssm":
        din, N, nh, W = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_conv_width)
        out["ssm"] = ((cfg.num_layers, batch, nh, cfg.ssm_head_dim, N),
                      torch.float32)
        out["conv"] = ((cfg.num_layers, batch, W - 1, din + 2 * N), dtype)
    elif cfg.family == "hybrid":
        n_tri, tail = _hybrid_counts(cfg)
        lw, W = cfg.lru_width or cfg.d_model, cfg.ssm_conv_width
        win = min(cfg.local_window or max_seq, max_seq)
        out["k"] = ((n_tri, batch, win, K, hd), dtype)
        out["v"] = ((n_tri, batch, win, K, hd), dtype)
        out["h1"] = ((n_tri, batch, lw), torch.float32)
        out["h2"] = ((n_tri, batch, lw), torch.float32)
        out["conv1"] = ((n_tri, batch, W - 1, lw), dtype)
        out["conv2"] = ((n_tri, batch, W - 1, lw), dtype)
        if tail:
            out["h_tail"] = ((tail, batch, lw), torch.float32)
            out["conv_tail"] = ((tail, batch, W - 1, lw), dtype)
    else:
        lead = (cfg.num_layers // 2, 2) if _is_pairs(cfg) \
            else (cfg.num_layers,)
        out["k"] = (lead + (batch, max_seq, K, hd), dtype)
        out["v"] = (lead + (batch, max_seq, K, hd), dtype)
        if cfg.family == "audio":
            x = (cfg.num_layers, batch, cfg.encoder_seq, K, hd)
            out["xk"] = (x, dtype)
            out["xv"] = (x, dtype)
    return out


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical dims of every leaf of `cache_shapes(cfg, ...)`, the
    reference's `cache_axes` (src/repro/models/model.py:570). Its "pos" is
    a Python int here and has no entry."""
    _check_ported(cfg)
    kv = ("layers", "cache_batch", "cache_seq", "cache_kv_heads", None)
    ax: Dict[str, Tuple] = {}
    if cfg.family == "ssm":
        ax["ssm"] = ("layers", "cache_batch", None, "ssm_inner", None)
        ax["conv"] = ("layers", "cache_batch", None, "ssm_inner")
    elif cfg.family == "hybrid":
        ax.update(k=kv, v=kv)
        for k in ("h1", "h2"):
            ax[k] = ("layers", "cache_batch", "lru")
        for k in ("conv1", "conv2"):
            ax[k] = ("layers", "cache_batch", None, "lru")
        if _hybrid_counts(cfg)[1]:
            ax["h_tail"] = ("layers", "cache_batch", "lru")
            ax["conv_tail"] = ("layers", "cache_batch", None, "lru")
    elif cfg.family == "audio":
        ax.update(k=kv, v=kv, xk=kv, xv=kv)
    else:
        lead = ("layers", None) if _is_pairs(cfg) else ("layers",)
        ax.update(k=lead + kv[1:], v=lead + kv[1:])
    return ax


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Zeroed cache tensors of `cache_shapes` on `device`, and pos 0. Inside
    `use_sharding`, each leaf is a DTensor placed by `cache_axes`."""
    dev = resolve_device(device)
    cache: Dict[str, Any] = {
        k: torch.zeros(s, dtype=d, device=dev)
        for k, (s, d) in cache_shapes(cfg, batch, max_seq, dtype).items()}
    if shd.current() is not None:
        cache = shd.distribute_tree(cache, cache_axes(cfg))
    cache["pos"] = 0
    return cache


def _last_window(k: torch.Tensor, win: int) -> torch.Tensor:
    """The trailing `win` positions of k (B, S, ...) as a ring with position
    p at slot p % win; a prompt of S <= win is zero-padded to win slots."""
    S = k.shape[1]
    if S <= win:
        return F.pad(k, (0, 0) * (k.dim() - 2) + (0, win - S))
    return torch.roll(k[:, S - win:], (S - win) % win, dims=1)


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            max_seq: int = 0, cache_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The whole prompt batch["tokens"] (B, S) in one pass (with
    batch["vision_embeds"] for vlm). Returns the last position's logits
    (B, V) and the populated cache (`init_cache` layout, pos = S): for ssm
    the SSD and conv states of every layer, for the hybrid the RG-LRU and
    conv states and each attention layer's last window of K/V as a ring,
    for the attention stacks the K/V padded to max_seq (default S). Audio
    is the reference's encoder pass instead (`_prefill_audio`). Attention
    runs the prefill kernel on the card; serving prefills dense, vlm and
    uniform MoE prompts through `SegmentedPrefill`."""
    _check_ported(cfg)
    if cfg.family == "audio":
        return _prefill_audio(params, cfg, batch, max_seq=max_seq,
                              cache_dtype=cache_dtype)
    h = _embed(params, cfg, batch)
    B, S = h.shape[:2]
    cache = init_cache(cfg, B, max_seq or S, cache_dtype, h.device)
    positions = torch.arange(S, device=h.device)[None, :]
    h = _run_layers(params, cfg, h, positions, cache)
    cache["pos"] = S
    return lm_head(cfg, params, h[:, -1:])[:, 0], cache


def _prefill_audio(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                   *, max_seq: int, cache_dtype) -> Tuple[torch.Tensor, Dict]:
    """Whisper's `prefill` is the reference's: the encoder over
    batch["frames"] and each decoder layer's cross K/V into xk/xv. It is
    not a prompt pass: the decoder's self-attention cache starts empty at
    pos 0 (generation starts from a BOS token) and the logits are zeros
    (B, V) in the frames' dtype. max_seq defaults to batch["tokens"]'s
    length."""
    dev = params.device
    frames = torch.as_tensor(batch["frames"], device=dev)
    B = frames.shape[0]
    S = torch.as_tensor(batch["tokens"]).shape[1]
    enc_out = _encode(params, cfg, frames)
    cache = init_cache(cfg, B, max_seq or S, cache_dtype, dev)
    for l in range(cfg.num_layers):
        cache["xk"][l], cache["xv"][l] = _cross_kv(
            cfg, layer_params(params, l), enc_out)
    return torch.zeros((B, cfg.vocab_size), dtype=frames.dtype,
                       device=dev), cache


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
    """Single-stream decode of every family. tokens: (B,) — the token
    generated at position cache['pos']; cache: the `prefill` /
    `init_cache` layout with an int "pos".

    Unlike the reference, which returns an updated copy of the cache, the
    step writes the cache's tensors IN PLACE (the new K/V at `pos`, or at
    ring slot pos % win for the hybrid; the recurrent and conv states of
    ssm and the hybrid); the returned dict shares them and carries pos + 1.
    Self-attention is the decode kernel over keys [0, pos] (kv_len =
    pos + 1); each half of a pair writes its own slice of the (L/2, 2, ...)
    cache. Audio adds, as the reference does, the position-0 sinusoid
    whatever pos is, and cross-attends on the same kernel over the cached
    encoder K/V. Returns (logits (B, V), cache)."""
    _check_ported(cfg)
    if is_mla(cfg):
        return _decode_mla(params, cfg, tokens, cache)
    if cfg.family == "ssm":
        return _decode_ssm(params, cfg, tokens, cache)
    if cfg.family == "hybrid":
        return _decode_hybrid(params, cfg, tokens, cache)
    pos = int(cache["pos"])
    B = tokens.shape[0]
    dev = tokens.device
    h = embed_tokens(cfg, params, tokens[:, None])          # (B, 1, D)
    if cfg.family == "audio":
        h = h + L.sinusoidal_positions(1, cfg.d_model, dev).to(h.dtype)
    rp = torch.full((1, 1), pos, dtype=torch.int64, device=dev)
    kv_len = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    for p, at in _attn_layers(params, cfg):
        k_l, v_l = cache["k"][at], cache["v"][at]           # (B, T, K, hd)
        x = _norm(cfg, p, h, "ln1")
        q, k, v = _project_qkv(cfg, p, x)
        if cfg.family != "audio":
            q = L.apply_rope(q, rp, cfg.rope_theta)
            k = L.apply_rope(k, rp, cfg.rope_theta)
        shd.write_seq(k_l, pos, k.to(k_l.dtype))
        shd.write_seq(v_l, pos, v.to(v_l.dtype))
        k_l = logical(k_l, "cache_batch", "cache_seq", "cache_kv_heads", None)
        v_l = logical(v_l, "cache_batch", "cache_seq", "cache_kv_heads", None)
        o = ops.decode_attention(q[:, 0], k_l, v_l, kv_len)
        h = h + o.reshape(B, 1, -1) @ p["wo"]
        if "xk" in cache:
            h = _cross_attn(cfg, p, h, cache["xk"][at], cache["xv"][at])
        h = ffn_block(cfg, p, h)
    logits = lm_head(cfg, params, h)
    return logits[:, 0], dict(cache, pos=pos + 1)


def _decode_ssm(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One Mamba2 token per row: the conv over [state, token] (the same
    `causal_conv1d` at S = 1) and one SSD step; both states updated in
    place."""
    B = tokens.shape[0]
    h = embed_tokens(cfg, params, tokens[:, None])          # (B, 1, D)
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        conv_s, ssm_s = cache["conv"][l], cache["ssm"][l]
        z, xs, Bm, Cm, dt, A, new_conv = _ssm_in(cfg, p, h, conv_s)
        xs = xs.reshape(B, cfg.ssm_heads, cfg.ssm_head_dim)
        y, new_ssm = L.ssd_step(xs, dt[:, 0], A, Bm[:, 0], Cm[:, 0], ssm_s)
        h = _ssm_out(cfg, p, h, y, xs, z)
        conv_s.copy_(new_conv)
        ssm_s.copy_(new_ssm)
    logits = lm_head(cfg, params, h)
    return logits[:, 0], dict(cache, pos=int(cache["pos"]) + 1)


def _rglru_step_block(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      h: torch.Tensor, h_s: torch.Tensor,
                      conv_s: torch.Tensor) -> torch.Tensor:
    """One token through a Griffin block and its MLP: `rglru_block` at
    S = 1 from the cached states (the scan of one step is the recurrence's
    step), which it then writes into h_s and conv_s in place."""
    h, (new_h, new_conv) = rglru_block(cfg, p, h, conv_state=conv_s,
                                       h_state=h_s)
    h_s.copy_(new_h)
    conv_s.copy_(new_conv)
    return h


def _decode_hybrid(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One RecurrentGemma token per row. The local attention writes the new
    K/V into ring slot pos % win in place and runs the decode kernel over
    the ring with kv_len = min(pos + 1, win) on every row.

    That is the reference's key set (`naive_attention` over the ring with
    k_positions and the window, src/repro/models/model.py `_decode_hybrid`):
    the reference masks unwritten slots by k_pos >= 0; for pos < win the
    written slots are exactly 0..pos, which is what kv_len = pos + 1 takes
    (the decode kernel puts the query at kv_len - 1 and sees keys
    [0, kv_len)); for pos >= win every slot holds one of the last win
    positions, all inside the window, and kv_len = win takes them all.
    Attention is order-free over its keys, so the ring's rotation changes
    only the order of the sums (hence a tolerance, not bit-equality)."""
    B = tokens.shape[0]
    dev = tokens.device
    pos = int(cache["pos"])
    k_c, v_c = cache["k"], cache["v"]
    win = k_c.shape[2]
    rp = torch.full((1, 1), pos, dtype=torch.int64, device=dev)
    kv_len = torch.full((B,), min(pos + 1, win), dtype=torch.int32,
                        device=dev)
    blocks = params["blocks"]
    h = embed_tokens(cfg, params, tokens[:, None])          # (B, 1, D)
    for t in range(k_c.shape[0]):
        h = _rglru_step_block(cfg, _at(blocks["r1"], t), h, cache["h1"][t],
                              cache["conv1"][t])
        h = _rglru_step_block(cfg, _at(blocks["r2"], t), h, cache["h2"][t],
                              cache["conv2"][t])
        p = _at(blocks["attn"], t)
        x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, p, x)
        q = L.apply_rope(q, rp, cfg.rope_theta)
        k = L.apply_rope(k, rp, cfg.rope_theta)
        shd.write_seq(k_c[t], pos % win, k.to(k_c.dtype))
        shd.write_seq(v_c[t], pos % win, v.to(v_c.dtype))
        o = ops.decode_attention(q[:, 0], k_c[t], v_c[t], kv_len)
        h = h + o.reshape(B, 1, -1) @ p["wo"]
        h = ffn_block(cfg, p, h)
    if "h_tail" in cache:
        for t in range(cache["h_tail"].shape[0]):
            h = _rglru_step_block(cfg, _at(params["tail"], t), h,
                                  cache["h_tail"][t], cache["conv_tail"][t])
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
    if is_mla(cfg):
        return _decode_mla_ragged(params, cfg, tokens, k_gathered,
                                  v_gathered, kv_lens)
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
    if is_mla(cfg):
        raise NotImplementedError("speculative verify of latent attention")
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
