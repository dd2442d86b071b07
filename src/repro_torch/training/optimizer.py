"""AdamW written out, as the reference's (src/repro/training/optimizer.py):
linear warmup and cosine decay, global-norm clipping, bias corrections and
decoupled weight decay on an f32 copy of each parameter, then a cast back
to the parameter's dtype. The state keeps m and v in f32 for every leaf,
keyed by the reference's paths (`ModelParams.leaves`), and a step counter.

Unlike the reference, which returns new arrays, `apply_updates` writes the
parameters and m, v IN PLACE under `torch.no_grad()`: a full-width model
then holds one copy of each.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32 scalar on the params' device
    m: Dict[str, torch.Tensor]          # f32, keyed like ModelParams.leaves
    v: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> AdamWState:
    """Zero m and v in f32 for every leaf of `params` (a `ModelParams`),
    and step 0, on the params' device; a DTensor leaf's m and v take its
    placements."""
    leaves = params.leaves()
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in leaves.items()}
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=params.device),
        m=zeros, v={k: z.clone() for k, z in zeros.items()})


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves (in the dict's order) of each leaf's sum
    of squares in f32."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree.values()))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads: Dict[str, torch.Tensor],
                  state: AdamWState) -> Tuple[object, AdamWState, Dict]:
    """One AdamW step with global-norm clipping on `params` (a
    `ModelParams`) from `grads` (keyed like `params.leaves()`). Writes the
    parameters and m, v in place and returns (params, state', metrics):
    metrics are the pre-clip gradient norm and the step's learning rate,
    as 0-d tensors (no host sync)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    for key, p in params.leaves().items():
        g = grads[key].float() * scale
        m, v = state.m[key], state.v[key]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm, "lr": lr}


def opt_state_axes(params_axes: Mapping[str, Any]) -> AdamWState:
    """Logical axes of `AdamWState` given the params' axes (`param_axes`):
    m and v keyed by leaf path as the state keys them, each with its
    parameter's dims (ZeRO: the same layout as the params), and the step a
    scalar. The reference's `opt_state_axes`
    (src/repro/training/optimizer.py:88)."""
    def flat(tree, prefix=""):
        out = {}
        for k in sorted(tree):
            path = f"{prefix}/{k}" if prefix else k
            out.update(flat(tree[k], path) if isinstance(tree[k], Mapping)
                       else {path: tree[k]})
        return out
    axes = flat(params_axes)
    return AdamWState(step=(), m=axes, v=dict(axes))
