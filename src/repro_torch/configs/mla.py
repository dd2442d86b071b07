"""The configuration type of a DeepSeek-V3-style decoder: multi-head latent
attention (MLA) without a q LoRA, leading dense layers, then MoE layers of
sigmoid-scored routed experts beside shared experts.

A port-only subclass of `ModelConfig` (`configs/base.py` is the JAX
package's copy and carries no latent-attention keys). The inherited fields
keep their meaning where the architecture has them: `num_heads` the query
heads, `d_ff` one routed expert's width, `d_ff_dense` the leading dense
layers' width, `num_experts` / `experts_per_token` the routed experts.
`num_kv_heads` is the published count of heads the latent is up-projected
to (equal to `num_heads`), and `head_dim` the published key of that name,
which in these configs is the rotary width.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class MLAConfig(ModelConfig):
    kv_lora_rank: int = 0            # latent width c_kv
    qk_nope_head_dim: int = 0        # per-head q/k width without rotary
    qk_rope_head_dim: int = 0        # rotary width, one key shared by heads
    v_head_dim: int = 0              # per-head value width
    first_k_dense: int = 0           # leading dense layers (width d_ff_dense)
    d_ff_shared: int = 0             # shared experts' summed width
    routed_scaling_factor: float = 1.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token and layer the cache holds: c_kv and k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense

    def _attn_params(self) -> int:
        d, H = self.d_model, self.num_heads
        return (d * H * self.qk_head_dim + d * self.latent_dim
                + self.kv_lora_rank
                + self.kv_lora_rank * H * (self.qk_nope_head_dim
                                           + self.v_head_dim)
                + H * self.v_head_dim * d)

    def _moe_params(self, experts: int) -> int:
        d = self.d_model
        return (experts * 3 * d * self.d_ff + d * self.num_experts
                + self.num_experts + 3 * d * self.d_ff_shared)

    def param_count(self) -> int:
        d = self.d_model
        layers = self.num_layers * (self._attn_params() + 2 * d) \
            + self.first_k_dense * 3 * d * self.d_ff_dense \
            + self.num_moe_layers * self._moe_params(self.num_experts)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return layers + embed + d

    def active_param_count(self) -> int:
        return self.param_count() - self.num_moe_layers * (
            self._moe_params(self.num_experts)
            - self._moe_params(self.experts_per_token))
