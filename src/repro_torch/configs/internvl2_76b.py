"""InternVL2-76B — InternViT + InternLM2 backbone. [arXiv:2404.16821; unverified]

VLM: the vision frontend is a STUB; ``input_specs()`` provides precomputed patch
embeddings (num_patches x d_model) that replace the leading token positions.
Backbone below is the 76B-class LM: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    num_patches=256,
    source="[arXiv:2404.16821; unverified]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="internvl2-tiny",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        num_patches=8,
    )
