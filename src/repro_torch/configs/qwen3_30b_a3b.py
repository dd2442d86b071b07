"""Qwen3-30B-A3B — the paper's MoE generality model (FlowPrefill §6.5).

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1000000.0,
    source="[arXiv:2505.09388; hf]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-tiny",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=32,
        vocab_size=256,
        num_experts=8,
        experts_per_token=2,
        moe_capacity_factor=4.0,   # = E/k -> provably drop-free (exactness tests)
    )
