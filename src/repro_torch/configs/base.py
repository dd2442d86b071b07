"""Model / serving / shape configuration dataclasses and the arch registry.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (the exact published configuration) and ``tiny()`` (a reduced
same-family configuration for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- attention variants -------------------------------------------------
    local_window: int = 0            # >0 -> sliding-window (local) attention
    # hybrid layer pattern, e.g. ("rglru", "rglru", "attn") repeating
    layer_pattern: Tuple[str, ...] = ()

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_layer_freq: int = 1          # 2 -> alternate (dense, moe) layers (llama4)
    d_ff_dense: int = 0              # d_ff of interleaved dense layers (freq=2)
    moe_capacity_factor: float = 1.25
    moe_min_capacity: int = 4

    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0               # N (state size per head)
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256             # SSD chunk length

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # whisper: 1500 frames after conv stub

    # --- multimodal stub ------------------------------------------------------
    num_patches: int = 0             # vlm: vision patch embeddings per request

    # --- rg-lru (recurrentgemma) ----------------------------------------------
    lru_width: int = 0               # 0 -> d_model

    source: str = ""                 # provenance note, e.g. "[arXiv:...; tier]"

    @property
    def resolved_head_dim(self) -> int:
        if self.num_heads == 0:          # attention-free (ssm)
            return self.head_dim
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token context without O(S^2) attention
        or an unbounded KV cache (SSM state / bounded local window)."""
        if self.family == "ssm":
            return True
        if self.layer_pattern and all(
            op == "rglru" or (op == "attn" and self.local_window > 0)
            for op in self.layer_pattern
        ):
            return True
        return False

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        qkv = d * (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.qkv_bias:
            qkv += (self.num_heads + 2 * self.num_kv_heads) * hd
        o = self.num_heads * hd * d
        attn = qkv + o
        if self.num_experts:
            n_moe = self.num_layers // self.moe_layer_freq
            n_dense = self.num_layers - n_moe
            per_moe = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            per_dense = 3 * d * (self.d_ff_dense or self.d_ff)
            # amortized per-layer ffn
            ffn = (n_moe * per_moe + n_dense * per_dense) // self.num_layers
        else:
            ffn = 3 * d * self.d_ff
        norms = 2 * d

        if self.family == "ssm":
            din = self.d_inner
            nh = self.ssm_heads
            in_proj = d * (2 * din + 2 * self.ssm_state + nh)
            conv = (din + 2 * self.ssm_state) * self.ssm_conv_width
            out_proj = din * d
            per_layer = in_proj + conv + out_proj + nh + nh + d  # A, D, norm
            layers = self.num_layers * per_layer
        elif self.layer_pattern:
            pat = _expanded_pattern(self)
            lw = self.lru_width or d
            rglru_layer = (
                d * 2 * lw + lw * d      # in (x,gate) + out proj
                + 4 * lw                 # conv1d width-4 depthwise (approx)
                + 2 * lw                 # recurrent gates a_param, input gate
                + ffn + 2 * d + d
            )
            attn_layer = attn + ffn + norms + d
            layers = sum(
                rglru_layer if op == "rglru" else attn_layer for op in pat
            )
        else:
            layers = self.num_layers * (attn + ffn + norms)
            if self.is_encoder_decoder:
                # encoder layers + decoder cross-attention
                enc = self.num_encoder_layers * (attn + ffn + norms)
                cross = self.num_layers * (attn + d)
                layers += enc + cross

        embed = self.vocab_size * d
        unembed = 0 if self.tie_embeddings else self.vocab_size * d
        return layers + embed + unembed + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        n_moe = self.num_layers // self.moe_layer_freq
        ffn_all = n_moe * self.num_experts * 3 * d * self.d_ff
        ffn_active = n_moe * self.experts_per_token * 3 * d * self.d_ff
        return total - ffn_all + ffn_active


def _expanded_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    """Expand layer_pattern repeating + truncated to num_layers."""
    if not cfg.layer_pattern:
        return tuple(["attn"] * cfg.num_layers)
    reps = (cfg.num_layers + len(cfg.layer_pattern) - 1) // len(cfg.layer_pattern)
    return tuple((cfg.layer_pattern * reps)[: cfg.num_layers])


# ---------------------------------------------------------------------------
# Input shapes (the four assigned shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "internvl2_76b",
    "recurrentgemma_9b",
    "llama4_maverick_400b",
    "granite_moe_3b",
    "llama3_2_1b",
    "qwen2_5_3b",
    "qwen2_1_5b",
    "minitron_4b",
    "mamba2_370m",
    "whisper_large_v3",
    # the paper's own evaluation models
    "llama3_8b",
    "qwen3_30b_a3b",
]


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    return mod.CONFIG


def get_tiny_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    return mod.tiny()


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and if not, why (DESIGN.md §skips)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; full-attention arch"
    return True, ""
