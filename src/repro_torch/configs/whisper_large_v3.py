"""Whisper-large-v3 — encoder-decoder, conv audio frontend (STUB). [arXiv:2212.04356; unverified]

32 encoder + 32 decoder layers, d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
The audio frontend (mel + conv downsampling) is a stub: ``input_specs()`` provides
precomputed frame embeddings (B, 1500, d_model). Decoder cross-attends to the
encoder output; decode_32k is lowered structurally (config-driven positions) even
though the real model caps target length at 448 — noted in EXPERIMENTS.md.
long_500k is skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    num_encoder_layers=32,
    encoder_seq=1500,
    source="[arXiv:2212.04356; unverified]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        is_encoder_decoder=True,
        num_encoder_layers=2,
        encoder_seq=32,
    )
