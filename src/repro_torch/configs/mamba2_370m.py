"""Mamba2-370M — SSD (state-space duality), attention-free. [arXiv:2405.21060; unverified]

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128. Decode carries O(1) recurrent
state (conv window + SSM state), so the arch runs long_500k.

FlowPrefill arch-applicability note (DESIGN.md §4): the paper's operator list is
attention-specific; for SSDs the operator boundaries become
in_proj / conv / ssd / out_proj — the mechanism transfers unchanged.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="mamba2-tiny",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_conv_width=4,
        ssm_chunk=16,
        tie_embeddings=True,
    )
