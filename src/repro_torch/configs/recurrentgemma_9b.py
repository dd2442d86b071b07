"""RecurrentGemma-9B — RG-LRU + local attention, 1:2 pattern. [arXiv:2402.19427; unverified]

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000. Layer pattern is
(rglru, rglru, attn) repeating, truncated to 38 layers; attention layers use a
2048-token sliding window, so the arch is sub-quadratic (runs long_500k).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    local_window=2048,
    layer_pattern=("rglru", "rglru", "attn"),
    lru_width=4096,
    tie_embeddings=True,
    source="[arXiv:2402.19427; unverified]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-tiny",
        family="hybrid",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        local_window=32,
        layer_pattern=("rglru", "rglru", "attn"),
        lru_width=64,
        tie_embeddings=True,
    )
