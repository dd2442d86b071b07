"""Llama-3.2-1B — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-tiny",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        tie_embeddings=True,
    )
