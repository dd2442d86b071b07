"""Qwen2-1.5B — GQA with QKV bias. [arXiv:2407.10671; hf]

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="[arXiv:2407.10671; hf]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen2-tiny",
        family="dense",
        num_layers=2,
        d_model=48,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        qkv_bias=True,
        tie_embeddings=True,
    )
