"""Qwen2.5-3B — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-tiny",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        tie_embeddings=True,
    )
