"""Llama3-8B — the paper's primary evaluation model (FlowPrefill §6).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    source="[arXiv:2407.21783; hf]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-tiny",
        family="dense",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
    )
