"""DeepSeek-V3-style decoders the benchmark serves (Kanana-2-30B-A3B):
multi-head latent attention without a q LoRA, leading dense SwiGLU layers,
then MoE layers of sigmoid-routed experts (`noaux_tc`, one group) beside
shared experts. What the yardstick needs to know of the architecture; the
module's interface is `arch/decoder.py`'s.

The handed-off cache is the latent: the program's `k_cache` holds c_kv
(the RMS-normed latent, one head of kv_lora_rank) and `v_cache` k_pe (the
rotated key the heads share, one head of qk_rope_head_dim).

The counts are in closed form from the shapes. Attention's least time is
the lesser of two forms, each the larger of its operations over the bf16
peak and its bytes over HBM bandwidth, so that the kernel's roofline share
reads the same work whatever form the program runs:
- up-projected (what the program runs): 2 * (dq + dv) operations a
  visible (query, key) pair and head; q and o once, and the per-head keys
  (dq) and values (dv) once for each visible key;
- absorbed: the scores and the output in the latent, 2 * (rank + dr) +
  2 * rank a pair and head; q in the latent (rank + dr) and o in the latent
  (rank) once a query and head, the latent (rank + dr) once a key.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Tuple

from harness.stats import HBM_BYTES_PER_S, PEAK_BF16_OPS

HANDOFF = ("k_cache", "v_cache")

# the latent-attention body of kernels/csrc/flash_prefill.cu, as the
# profiler names it ("void (anonymous namespace)::tc::prefill_mla_kernel<
# 192, 128>(...)"), and no other body
ATTENTION_KERNELS = re.compile(r"\bprefill_mla_kernel\b")

# published keys whose values the program has no other path for
SUPPORTED = {"q_lora_rank": None, "scoring_func": "sigmoid",
             "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
             "norm_topk_prob": True, "rope_scaling": None,
             "moe_layer_freq": 1, "attention_bias": False,
             "hidden_act": "silu", "rope_interleave": True}


def model_config(spec: dict):
    """The MLAConfig the configuration file describes. Raises where a
    published key takes a value the program has no path for, or where a
    width differs from `repro_torch.configs.get_config(port_arch)`."""
    from repro_torch.configs.base import get_config, get_tiny_config
    from repro_torch.configs.mla import MLAConfig
    for key, want in SUPPORTED.items():
        if spec.get(key, want) != want:
            raise ValueError(f"{spec['name']}: {key}={spec[key]!r}; the "
                             f"port serves {want!r} only")
    port_arch = spec["port_arch"]
    port = get_tiny_config(port_arch) if spec.get("tiny") else \
        get_config(port_arch)
    cfg = MLAConfig(
        name=spec["name"], family="moe",
        num_layers=spec["num_hidden_layers"], d_model=spec["hidden_size"],
        num_heads=spec["num_attention_heads"],
        num_kv_heads=spec["num_key_value_heads"], head_dim=spec["head_dim"],
        d_ff=spec["moe_intermediate_size"],
        d_ff_dense=spec["intermediate_size"], vocab_size=spec["vocab_size"],
        num_experts=spec["n_routed_experts"],
        experts_per_token=spec["num_experts_per_tok"],
        rope_theta=float(spec["rope_theta"]), norm_eps=spec["rms_norm_eps"],
        tie_embeddings=spec["tie_word_embeddings"],
        kv_lora_rank=spec["kv_lora_rank"],
        qk_nope_head_dim=spec["qk_nope_head_dim"],
        qk_rope_head_dim=spec["qk_rope_head_dim"],
        v_head_dim=spec["v_head_dim"],
        first_k_dense=spec["first_k_dense_replace"],
        d_ff_shared=spec["n_shared_experts"] * spec["moe_intermediate_size"],
        routed_scaling_factor=spec["routed_scaling_factor"],
        moe_capacity_factor=spec["deployment"]["moe_capacity_factor"])
    if spec["qk_head_dim"] != cfg.qk_head_dim:
        raise ValueError(f"{spec['name']}: qk_head_dim {spec['qk_head_dim']}"
                         f" is not {cfg.qk_nope_head_dim} + "
                         f"{cfg.qk_rope_head_dim}")
    mine = dataclasses.replace(cfg, name=port.name, source=port.source,
                               moe_capacity_factor=port.moe_capacity_factor)
    if type(port) is not MLAConfig or mine != port:
        diff = {f.name: (getattr(cfg, f.name), getattr(port, f.name, None))
                for f in dataclasses.fields(cfg)
                if getattr(mine, f.name) != getattr(port, f.name, None)}
        raise ValueError(f"{spec['name']}: widths differ from the port's "
                         f"{port_arch} config (file, port): {diff}")
    return cfg


def _pairs(Sq: int, q_offset: int) -> int:
    return Sq * q_offset + Sq * (Sq + 1) // 2


def attention_work(Sq: int, q_offset: int, cfg, es: int, absorbed: bool
                   ) -> Tuple[float, float]:
    """Operations and bytes one causal chunk of Sq queries at q_offset
    needs in one layer, in either form (the module's docstring)."""
    H, r, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv_len = q_offset + Sq
    if absorbed:
        ops = 2.0 * H * (r + dr + r) * _pairs(Sq, q_offset)
        return ops, es * (Sq * H * (r + dr + r) + kv_len * (r + dr))
    dq, dv = cfg.qk_head_dim, cfg.v_head_dim
    ops = 2.0 * H * (dq + dv) * _pairs(Sq, q_offset)
    return ops, es * (Sq * H * (dq + dv) + kv_len * H * (dq + dv))


def prompt_attention_bound(n: int, chunk: int, cfg, spec, es: int) -> float:
    """Least seconds the prefill-attention launches of an n-token prompt
    chunked by `chunk` could take: per chunk and layer the lesser of the
    two forms' max(operations / bf16 peak, bytes / HBM bandwidth)."""
    total = 0.0
    for lo in range(0, n, chunk):
        Sq = min(chunk, n - lo)
        total += min(max(ops / PEAK_BF16_OPS, nbytes / HBM_BYTES_PER_S)
                     for ops, nbytes in (attention_work(Sq, lo, cfg, es, a)
                                         for a in (False, True)))
    return total * cfg.num_layers


def model_flops(n: int, cfg, spec) -> float:
    """Model FLOPs of an n-token prefill: 2 per multiply-add of every matrix
    a token touches, MLA's projections once a token (W_q, W_kv_a, W_kv_b,
    W_o); the dense layers' SwiGLU; each MoE layer's router, its top_k
    routed experts (not all of them) and its shared experts; 2 * H * (dq +
    dv) per visible causal pair and layer; the LM head at the last
    position."""
    d, H, r, dr = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank, \
        cfg.qk_rope_head_dim
    dq, dv = cfg.qk_head_dim, cfg.v_head_dim
    proj = d * H * dq + d * (r + dr) + r * H * (cfg.qk_nope_head_dim + dv) \
        + H * dv * d
    dense = 3 * d * cfg.d_ff_dense
    moe = d * cfg.num_experts + cfg.experts_per_token * 3 * d * cfg.d_ff \
        + 3 * d * cfg.d_ff_shared
    per_token = cfg.num_layers * proj + cfg.first_k_dense * dense \
        + cfg.num_moe_layers * moe
    pairs = n * (n + 1) // 2
    return 2.0 * n * per_token \
        + cfg.num_layers * 2.0 * H * (dq + dv) * pairs \
        + 2.0 * d * cfg.vocab_size
