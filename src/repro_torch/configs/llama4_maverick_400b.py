"""Llama4-Maverick-400B-A17B — MoE, early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1,
dense/MoE layers interleaved 1:1 (dense d_ff=16384) as in the published Maverick
config — that interleave is what makes 400B total / 17B active work out.
Per the paper's MoE extension (FlowPrefill §6.5), the FFN introduces two extra
fused operator boundaries: ``gate`` (router) and ``experts``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500000.0,
    num_experts=128,
    experts_per_token=1,
    moe_layer_freq=2,
    d_ff_dense=16384,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llama4-tiny",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        num_experts=8,
        experts_per_token=1,
        moe_layer_freq=2,
        d_ff_dense=128,
        moe_capacity_factor=8.0,   # = E/k -> provably drop-free (exactness tests)
    )
