"""Analytic prefill cost model for the discrete-event simulator.

Per-operator durations from first principles: t_op = max(compute, memory)
+ launch overhead, with
  compute = FLOPs / (peak_flops * eff_c)
  memory  = bytes_touched / (hbm_bw * eff_b)   (weights re-read per chunk,
                                                KV prefix re-read by attention)
This reproduces the paper's motivating observations without fitting:
  * Fig. 3 — small chunks collapse throughput (per-chunk weight re-reads +
    launch overheads), large chunks recover it;
  * Fig. 4 — short prefills are memory-bound (batching ~free), long prefills
    compute-bound (batching inflates latency linearly).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float                  # bf16 FLOP/s
    hbm_bw: float                      # bytes/s
    eff_c: float = 0.7                 # achievable compute fraction (saturated)
    eff_b: float = 0.8                 # achievable bandwidth fraction
    launch_overhead: float = 20e-6     # per fused-operator dispatch
    sat_tokens: int = 600              # tokens to reach ~50% of eff_c
                                       # (kernel tails / wave quantization:
                                       # small batches underutilize — Fig. 4a)
    kv_link_bw: float = 50e9           # inter-instance KV transfer bytes/s
                                       # (PCIe4 x16-class; prices decode
                                       # migration and PD handoff)
    kv_link_latency: float = 2e-3      # per-transfer setup latency (seconds)
    # tiered KV offload: device <-> host-memory staging link (H2D for
    # promotions; PCIe-class, typically ~half the raw link for pageable
    # copies) and host <-> local-disk spill (NVMe-class). Price promotion
    # of demoted prefix blocks back into HBM (PrefillCostModel.promote_time)
    host_bw: float = 25e9              # bytes/s host->device
    host_latency: float = 5e-4         # per-promotion setup (seconds)
    disk_bw: float = 3e9               # bytes/s disk->host->device
    disk_latency: float = 5e-3         # per-promotion disk setup (seconds)

    def eff_c_at(self, tokens: float) -> float:
        return self.eff_c * tokens / (tokens + self.sat_tokens)


A100 = HardwareSpec("A100-SXM4", peak_flops=312e12, hbm_bw=1.555e12)
A800 = HardwareSpec("A800-SXM4-80G", peak_flops=312e12, hbm_bw=2.0e12)
TPU_V5E = HardwareSpec("TPUv5e", peak_flops=197e12, hbm_bw=819e9)

# name -> spec lookup for CLI flags / hetero pool configs
HARDWARE_SPECS = {hw.name: hw for hw in (A100, A800, TPU_V5E)}
HARDWARE_ALIASES = {"a100": A100, "a800": A800, "tpu-v5e": TPU_V5E,
                    "tpu_v5e": TPU_V5E}


def resolve_hardware(hw) -> HardwareSpec:
    """Accept a HardwareSpec or a name/alias string ("a800", "A100-SXM4")."""
    if isinstance(hw, HardwareSpec):
        return hw
    key = str(hw)
    if key in HARDWARE_SPECS:
        return HARDWARE_SPECS[key]
    try:
        return HARDWARE_ALIASES[key.lower()]
    except KeyError:
        raise ValueError(
            f"unknown hardware {hw!r}; known: "
            f"{sorted(HARDWARE_SPECS) + sorted(HARDWARE_ALIASES)}") from None


@dataclass(frozen=True)
class ModelSpec:
    """The numbers the cost model needs, derived from a ModelConfig."""
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    num_experts: int = 0
    experts_per_token: int = 0
    tp: int = 1                         # tensor parallel degree

    @classmethod
    def from_config(cls, cfg: ModelConfig, tp: int = 1) -> "ModelSpec":
        return cls(name=cfg.name, num_layers=cfg.num_layers,
                   d_model=cfg.d_model, num_heads=cfg.num_heads,
                   num_kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
                   num_experts=cfg.num_experts,
                   experts_per_token=cfg.experts_per_token, tp=tp)

    @property
    def op_names(self) -> Tuple[str, ...]:
        if self.num_experts:
            return ("qkv_proj", "attn", "o_proj", "gate", "experts")
        return ("qkv_proj", "attn", "o_proj", "gate_up_proj", "down_proj")


# published evaluation models (paper §6.1)
LLAMA3_8B = ModelSpec("llama3-8b", 32, 4096, 32, 8, 128, 14336)
QWEN25_14B = ModelSpec("qwen2.5-14b", 48, 5120, 40, 8, 128, 13824)
LLAMA3_70B = ModelSpec("llama3-70b", 80, 8192, 64, 8, 128, 28672)
QWEN3_30B_A3B = ModelSpec("qwen3-30b-a3b", 48, 2048, 32, 4, 128, 768,
                          num_experts=128, experts_per_token=8)

MODEL_SPECS = {m.name: m for m in
               (LLAMA3_8B, QWEN25_14B, LLAMA3_70B, QWEN3_30B_A3B)}
MODEL_TP = {"llama3-8b": 1, "qwen2.5-14b": 2, "llama3-70b": 4,
            "qwen3-30b-a3b": 2}


def kv_bytes_per_token(m: ModelSpec) -> float:
    """bf16 K and V bytes one token's cache occupies — shared by decode
    migration pricing and tiered-KV promotion pricing."""
    return 2.0 * 2 * m.num_layers * m.num_kv_heads * m.head_dim


class PrefillCostModel:
    def __init__(self, model: ModelSpec, hw: HardwareSpec = A800):
        self.m = model
        self.hw = hw

    # --- per-operator FLOPs/bytes for a chunk of c tokens at prefix offset o ---
    def _op_cost(self, name: str, c: int, o: int) -> Tuple[float, float]:
        m = self.m
        d, H, K, hd, f = (m.d_model, m.num_heads, m.num_kv_heads,
                          m.head_dim, m.d_ff)
        if name == "qkv_proj":
            fl = 2 * c * d * (H + 2 * K) * hd
            by = 2 * d * (H + 2 * K) * hd
        elif name == "attn":
            fl = 4 * c * (o + c / 2) * H * hd
            by = 2 * 2 * (o + c) * K * hd + 2 * 2 * c * K * hd
        elif name == "o_proj":
            fl = 2 * c * H * hd * d
            by = 2 * H * hd * d
        elif name == "gate_up_proj":
            fl = 4 * c * d * f
            by = 2 * d * 2 * f
        elif name == "down_proj":
            fl = 2 * c * f * d
            by = 2 * f * d
        elif name == "gate":
            fl = 2 * c * d * m.num_experts
            by = 2 * d * m.num_experts
        elif name == "experts":
            k = m.experts_per_token
            fl = 6 * c * k * d * f
            touched = min(c * k, m.num_experts)
            by = 2 * 3 * d * f * touched
        else:
            raise ValueError(name)
        return fl, by

    # --- vectorized counterpart: c, o are float64 arrays over all chunks.
    # Formulas and evaluation order mirror `_op_cost` exactly — every
    # intermediate is an integer-valued float64 < 2^53, so the batched path is
    # bit-identical to the scalar one (pinned by tests/test_costmodel_vec.py).
    def _op_cost_vec(self, name: str, c: np.ndarray,
                     o: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        m = self.m
        d, H, K, hd, f = (m.d_model, m.num_heads, m.num_kv_heads,
                          m.head_dim, m.d_ff)
        one = np.ones_like(c)             # broadcast helper for constant bytes
        if name == "qkv_proj":
            fl = 2 * c * d * (H + 2 * K) * hd
            by = (2 * d * (H + 2 * K) * hd) * one
        elif name == "attn":
            fl = 4 * c * (o + c / 2) * H * hd
            by = 2 * 2 * (o + c) * K * hd + 2 * 2 * c * K * hd
        elif name == "o_proj":
            fl = 2 * c * H * hd * d
            by = (2 * H * hd * d) * one
        elif name == "gate_up_proj":
            fl = 4 * c * d * f
            by = (2 * d * 2 * f) * one
        elif name == "down_proj":
            fl = 2 * c * f * d
            by = (2 * f * d) * one
        elif name == "gate":
            fl = 2 * c * d * m.num_experts
            by = (2 * d * m.num_experts) * one
        elif name == "experts":
            k = m.experts_per_token
            fl = 6 * c * k * d * f
            touched = np.minimum(c * k, float(m.num_experts))
            by = 2 * 3 * d * f * touched
        else:
            raise ValueError(name)
        return fl, by

    def op_duration(self, name: str, c: int, o: int) -> float:
        fl, by = self._op_cost(name, c, o)
        tp = self.m.tp
        t = max(fl / tp / (self.hw.peak_flops * self.hw.eff_c_at(c)),
                by / tp / (self.hw.hbm_bw * self.hw.eff_b))
        return t + self.hw.launch_overhead

    def _op_duration_vec(self, name: str, c: np.ndarray,
                         o: np.ndarray) -> np.ndarray:
        fl, by = self._op_cost_vec(name, c, o)
        tp = self.m.tp
        eff_c = self.hw.eff_c * c / (c + self.hw.sat_tokens)
        t = np.maximum(fl / tp / (self.hw.peak_flops * eff_c),
                       by / tp / (self.hw.hbm_bw * self.hw.eff_b))
        return t + self.hw.launch_overhead

    def _chunk_grid(self, tokens: int, chunk_tokens: int,
                    prefix: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(sizes, offsets) of every chunk of a `tokens`-long prefill whose
        first `prefix` tokens are served from a prefix cache: chunks cover
        only [prefix, tokens), each at its true KV offset — the attention
        term still reads the cached prefix (o grows from `prefix`), but its
        compute/weight traffic is skipped entirely."""
        chunk = chunk_tokens or (tokens - prefix)
        o = np.arange(prefix, tokens, chunk, dtype=np.float64)
        c = np.minimum(float(chunk), tokens - o)
        return c, o

    def op_durations(self, tokens: int, chunk_tokens: int = 0,
                     prefix: int = 0) -> np.ndarray:
        """Per-operator durations for a prefill (all layers x all chunks),
        in execution order. Shape: (n_chunks * L * n_ops,).

        Batched over all (chunk, layer, op) triples — the simulator hot path
        (every SUBMIT builds one of these arrays); bit-identical to the scalar
        reference `op_durations_scalar`. ``prefix`` > 0 prices a
        prefix-cache hit: the first `prefix` tokens' chunks vanish and the
        suffix chunks run at their cached-KV offsets (`_chunk_grid`).
        ``prefix=0`` (default) is the exact original path."""
        m = self.m
        prefix = min(max(int(prefix), 0), max(tokens - 1, 0))
        c, o = self._chunk_grid(tokens, chunk_tokens, prefix)
        if c.size <= 1:
            # numpy overhead loses on a single chunk (the unchunked presets):
            # the scalar reference is bit-identical and faster there
            return self.op_durations_scalar(tokens, chunk_tokens, prefix)
        # (n_chunks, n_ops): one column per operator, rows in chunk order
        per_chunk = np.stack(
            [self._op_duration_vec(nm, c, o) for nm in m.op_names], axis=1)
        # execution order = chunk-major, the op row repeated once per layer
        return np.tile(per_chunk[:, None, :],
                       (1, m.num_layers, 1)).reshape(-1)

    def op_durations_scalar(self, tokens: int, chunk_tokens: int = 0,
                            prefix: int = 0) -> np.ndarray:
        """Reference implementation (per-chunk Python loop) kept as the ground
        truth the vectorized `op_durations` is pinned against."""
        m = self.m
        prefix = min(max(int(prefix), 0), max(tokens - 1, 0))
        chunk = chunk_tokens or (tokens - prefix)
        out: List[float] = []
        o = prefix
        while o < tokens:
            c = min(chunk, tokens - o)
            per_layer = [self.op_duration(nm, c, o) for nm in m.op_names]
            out.extend(per_layer * m.num_layers)
            o += c
        return np.asarray(out)

    def prefill_time(self, tokens: int, chunk_tokens: int = 0,
                     prefix: int = 0) -> float:
        return float(self.op_durations(tokens, chunk_tokens, prefix).sum())

    def throughput(self, tokens: int, chunk_tokens: int = 0) -> float:
        return tokens / self.prefill_time(tokens, chunk_tokens)

    def promote_time(self, host_tokens: float,
                     disk_tokens: float = 0.0) -> float:
        """Seconds to promote that many cold prefix tokens back into HBM
        from the host (and disk) tier — the copy side of the tiered-KV
        promote-vs-recompute gate. The recompute side is the prefill time
        the hit saves (`op_durations` with/without the cold prefix), so
        the sim's gating decision matches the runtime's
        `PagedKVCache.promote_seconds` in structure: per-tier setup latency
        plus bytes over the staging link, divided by tensor parallelism
        (each shard moves its own KV slice)."""
        t = 0.0
        bpt = kv_bytes_per_token(self.m) / self.m.tp
        if host_tokens > 0:
            t += self.hw.host_latency + host_tokens * bpt / self.hw.host_bw
        if disk_tokens > 0:
            t += self.hw.disk_latency + disk_tokens * bpt / self.hw.disk_bw
        return t


class DecodeCostModel:
    """Analytic decode-step latency for the cluster simulator's decode phase.

    Decode is memory-bound: every step streams the full weight set once
    (continuous batching amortizes it over the batch) plus each request's KV
    prefix. Step latency for a batch of B requests with mean context C:

        t_step = (W_bytes + B * C * kv_bytes_per_token) / (tp * bw * eff_b)
                 + L * n_ops * launch_overhead

    which yields the familiar shape: near-flat latency at small B (weights
    dominate), linear growth once aggregate KV reads take over — i.e. TBT
    degrades as a decode instance's batch grows, which is exactly the signal
    the cluster-level TPOT/TBT SLO accounting needs.
    """

    def __init__(self, model: ModelSpec, hw: HardwareSpec = A800):
        self.m = model
        self.hw = hw

    @property
    def weight_bytes(self) -> float:
        m = self.m
        attn = m.d_model * (m.num_heads + 2 * m.num_kv_heads) * m.head_dim \
            + m.num_heads * m.head_dim * m.d_model
        if m.num_experts:
            ffn = m.d_model * m.num_experts \
                + 3 * m.d_model * m.d_ff * m.experts_per_token
        else:
            ffn = 3 * m.d_model * m.d_ff
        return 2.0 * m.num_layers * (attn + ffn)       # bf16

    @property
    def kv_bytes_per_token(self) -> float:
        return kv_bytes_per_token(self.m)              # bf16 K and V

    def step_time(self, batch_size: int, mean_context: float) -> float:
        if batch_size <= 0:
            return 0.0
        by = self.weight_bytes + batch_size * mean_context \
            * self.kv_bytes_per_token
        t = by / self.m.tp / (self.hw.hbm_bw * self.hw.eff_b)
        return t + self.m.num_layers * len(self.m.op_names) \
            * self.hw.launch_overhead

    def kv_transfer_time(self, context_tokens: float) -> float:
        """Seconds to hand a stream's KV cache to another instance over the
        inter-instance link — the price of a decode migration (and of the PD
        prefill->decode handoff, which the fluid sim folds into step times).
        KV bytes scale with the context; the fixed setup latency keeps tiny
        transfers from looking free."""
        by = max(context_tokens, 0.0) * self.kv_bytes_per_token
        return self.hw.kv_link_latency + by / self.hw.kv_link_bw
