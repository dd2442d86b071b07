"""Synthetic token data: a deterministic, seeded, host-shardable stream of
(tokens, labels) batches, the same step index giving the same global batch
whatever the number of data-parallel hosts (each host takes its rows).
Counterpart of src/repro/training/data.py with the same numpy draws, so
its batches are bit-equal to the reference's; they come back as tensors on
the caller's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


def make_batch(cfg: DataConfig, step: int,
               model_cfg: Optional[ModelConfig] = None, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic global batch for `step`, this host's rows only, on
    `device`: Zipf-ish token streams whose labels are the inputs shifted by
    one (int32), and for vlm / audio N(0,1) `vision_embeds` / `frames` in
    f32 drawn after them from the same generator."""
    dev = resolve_device(device)
    rng = np.random.default_rng((cfg.seed, step))
    per_host = cfg.global_batch // cfg.num_hosts
    lo = cfg.host_id * per_host
    # the whole global batch is drawn, and this host's rows are sliced
    zipf = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
    rows = np.minimum(zipf, cfg.vocab_size - 1).astype(np.int32)[
        lo:lo + per_host]
    arrays = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    if model_cfg is not None and model_cfg.family == "vlm":
        arrays["vision_embeds"] = rng.standard_normal(
            (per_host, model_cfg.num_patches, model_cfg.d_model)
        ).astype(np.float32)
    if model_cfg is not None and model_cfg.family == "audio":
        arrays["frames"] = rng.standard_normal(
            (per_host, model_cfg.encoder_seq, model_cfg.d_model)
        ).astype(np.float32)
    return {k: torch.from_numpy(a).to(dev) for k, a in arrays.items()}


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  model_cfg: Optional[ModelConfig] = None, *,
                  device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(cfg, step, model_cfg, device=device)
        step += 1
