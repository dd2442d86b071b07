"""Minitron-4B — pruned Nemotron. [arXiv:2407.14679; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    source="[arXiv:2407.14679; hf]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="minitron-tiny",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
    )
