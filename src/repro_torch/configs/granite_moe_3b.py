"""Granite-MoE-3B-A800M — 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-tiny",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=32,
        vocab_size=256,
        num_experts=8,
        experts_per_token=4,
        moe_capacity_factor=2.0,   # = E/k -> provably drop-free (exactness tests)
        tie_embeddings=True,
    )
