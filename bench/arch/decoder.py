"""The decoders the benchmark serves, Qwen2 (dense GQA, q/k/v biases) and
Qwen3-MoE (top-k of E experts, every layer MoE): what the yardstick needs
to know of their architecture.

A configuration file names its architecture by its `reference` key: the
harness finds this module as `bench/arch/<reference>.py`, beside the plain
reference `bench/reference/<reference>.py`. Every architecture's module
defines:

- ``model_config(spec)``: the port's `ModelConfig` the file describes;
  raises where a published width differs from the port's own config;
- ``HANDOFF``: the keys of the prefill task's state that hold the caches
  handed off, each indexed ``[layer, row, :n]``; the reference's `forward`
  returns, for each (prompt, layer), a tuple in the same order;
- ``model_flops(n, cfg, spec)``: model FLOPs of an n-token prefill;
- ``prompt_attention_bound(n, chunk, cfg, spec, es)``: the least seconds
  the prefill-attention launches of an n-token prompt could take;
- ``ATTENTION_KERNELS``: a regular expression that finds those launches'
  names in the device trace.

`cfg` is the served `ModelConfig`, `spec` the configuration file (decoders
need no key of it beyond the config), `es` the bytes of the served dtype.
The counts are copied from chip_smoke.py's `prefill_work`, with its pair sum
in closed form, so a later change to the program cannot move them.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Tuple

from harness.stats import HBM_BYTES_PER_S, PEAK_BF16_OPS

# (published key, ModelConfig field) of every width and shape the cell
# serves; each must equal the port's own configuration of the arch
WIDTHS = (("num_hidden_layers", "num_layers"), ("hidden_size", "d_model"),
          ("num_attention_heads", "num_heads"),
          ("num_key_value_heads", "num_kv_heads"),
          ("vocab_size", "vocab_size"), ("rope_theta", "rope_theta"),
          ("tie_word_embeddings", "tie_embeddings"), ("qkv_bias", "qkv_bias"))

HANDOFF = ("k_cache", "v_cache")

# the bodies of kernels/csrc/flash_prefill.cu, as the profiler names them
# ("void (anonymous namespace)::tc::prefill_tc_kernel<128>(...)")
ATTENTION_KERNELS = re.compile(r"\bprefill_(tc_|mma_)?kernel\b")


def model_config(spec: dict, **extra):
    """The ModelConfig the configuration file describes. Raises where a
    width differs from `repro_torch.configs.get_config(port_arch)`.

    `extra`: fields an architecture built on this one sets from its own
    published keys, held to the port's config like the rest."""
    from repro_torch.configs.base import ModelConfig, get_config, get_tiny_config
    port_arch = spec["port_arch"]
    port = get_tiny_config(port_arch) if spec.get("tiny") else \
        get_config(port_arch)
    moe = bool(spec.get("num_experts"))
    fields = {f: spec[k] for k, f in WIDTHS}
    fields.update(
        name=spec["name"], family="moe" if moe else "dense",
        head_dim=spec.get("head_dim",
                          spec["hidden_size"] // spec["num_attention_heads"]),
        d_ff=spec["moe_intermediate_size"] if moe
        else spec["intermediate_size"],
        norm_eps=spec["rms_norm_eps"])
    if moe:
        fields.update(num_experts=spec["num_experts"],
                      experts_per_token=spec["num_experts_per_tok"],
                      moe_capacity_factor=spec["deployment"][
                          "moe_capacity_factor"])
    fields.update(extra)
    cfg = ModelConfig(**fields)
    mine = dataclasses.replace(cfg, name=port.name, norm_eps=port.norm_eps,
                               moe_capacity_factor=port.moe_capacity_factor,
                               source=port.source)
    if mine.resolved_head_dim != port.resolved_head_dim or \
            dataclasses.replace(mine, head_dim=port.head_dim) != port:
        diff = {f.name: (getattr(cfg, f.name), getattr(port, f.name))
                for f in dataclasses.fields(cfg)
                if getattr(mine, f.name) != getattr(port, f.name)}
        raise ValueError(f"{spec['name']}: widths differ from the port's "
                         f"{port_arch} config (file, port): {diff}")
    return cfg


def attention_work(Sq: int, q_offset: int, cfg, spec, es: int
                   ) -> Tuple[float, float]:
    """Operations and bytes one causal chunk of Sq queries at q_offset needs
    in one layer (no window): 4*hd per visible (query, key) pair and head;
    q and o once, and k and v once for each of the q_offset + Sq keys."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kv_len = q_offset + Sq
    pairs = Sq * q_offset + Sq * (Sq + 1) // 2
    return 4.0 * hd * H * pairs, es * (2 * Sq * H * hd + 2 * kv_len * K * hd)


def prompt_attention_bound(n: int, chunk: int, cfg, spec, es: int) -> float:
    """Least seconds the prefill-attention launches of an n-token prompt
    chunked by `chunk` could take: per chunk and layer the larger of its
    operations over the bf16 peak and its bytes over HBM bandwidth."""
    total = 0.0
    for lo in range(0, n, chunk):
        ops, nbytes = attention_work(min(chunk, n - lo), lo, cfg, spec, es)
        total += max(ops / PEAK_BF16_OPS, nbytes / HBM_BYTES_PER_S)
    return total * cfg.num_layers


def model_flops(n: int, cfg, spec) -> float:
    """Model FLOPs of an n-token prefill: 2 per multiply-add of every matrix
    a token touches (q, k, v and o projections; the SwiGLU FFN, or the
    router and the top_k routed experts, not all of them), 4*hd*H per
    visible causal pair and layer, and the LM head at the last position."""
    layers, d, vocab = cfg.num_layers, cfg.d_model, cfg.vocab_size
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    d_ff, experts, top_k = cfg.d_ff, cfg.num_experts, cfg.experts_per_token
    proj = d * (H + 2 * K) * hd + H * hd * d
    ffn = d * experts + top_k * 3 * d * d_ff if experts else 3 * d * d_ff
    pairs = n * (n + 1) // 2
    return layers * (2.0 * n * (proj + ffn) + 4.0 * hd * H * pairs) \
        + 2.0 * d * vocab
