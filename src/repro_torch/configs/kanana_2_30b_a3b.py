"""Kanana-2-30B-A3B (kakaocorp, `model_type` deepseek_v3).

48L d_model=2048 32H, MLA (kv_lora_rank 512, q/k 128 + 64 rotary, v 128, no
q LoRA), layer 0 dense SwiGLU 6144, layers 1-47 MoE: 128 routed experts of
768 top-6 by sigmoid score + correction bias, weights normalised and scaled
by 2.448, 2 shared experts (one SwiGLU of 1536). vocab 128256, untied.
[hf:kakaocorp/kanana-2-30b-a3b-instruct-2601 config.json]

The rotary dims are stored interleaved (`rope_interleave`): the port
de-interleaves them at run time, as the published code does, so the weight
layout is the published one.
"""
from repro_torch.configs.mla import MLAConfig

CONFIG = MLAConfig(
    name="kanana-2-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=768,
    d_ff_dense=6144,
    vocab_size=128256,
    num_experts=128,
    experts_per_token=6,
    rope_theta=1000000.0,
    norm_eps=1e-6,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    d_ff_shared=1536,
    routed_scaling_factor=2.448,
    # E/k = 21.33 truncates to a capacity one pair short of a group; 22
    # clamps to the group and drops none
    moe_capacity_factor=22.0,
    source="[hf:kakaocorp/kanana-2-30b-a3b-instruct-2601; hf]",
)


def tiny() -> MLAConfig:
    return MLAConfig(
        name="kanana-tiny",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=8,
        d_ff=32,
        d_ff_dense=96,
        vocab_size=256,
        num_experts=8,
        experts_per_token=3,
        rope_theta=1000000.0,
        norm_eps=1e-6,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        first_k_dense=1,
        d_ff_shared=64,
        routed_scaling_factor=2.448,
        moe_capacity_factor=4.0,   # > E/k: drop-free at every group size
    )
