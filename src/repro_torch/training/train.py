"""The loss, the train step and the fault-tolerant training loop
(checkpoints with auto-resume, a straggler watchdog, optional gradient
compression). Counterpart of src/repro/training/train.py: the step runs
eagerly where the reference jits it, and takes the gradient by autograd
through `forward` (attention by `FlashAttention`, remat by
`torch.utils.checkpoint`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward
from repro_torch.training import optimizer as opt
from repro_torch.training.optimizer import AdamWConfig, AdamWState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of `labels` under `logits` (B, S, V),
    computed in f32; with `mask`, the mean over its weight."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.take_along_dim(logp, labels.long()[..., None], dim=-1)[..., 0]
    if mask is not None:
        mask = mask.to(ll.dtype)
        return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return -torch.mean(ll)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: str = "dots") -> torch.Tensor:
    logits = forward(params, cfg, batch, remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
    return cross_entropy_loss(logits, labels, mask)


def grads_of(loss: torch.Tensor, params) -> Dict[str, torch.Tensor]:
    """d loss / d leaf for every leaf of `params` (trainable), keyed like
    `params.leaves()`; zeros for a leaf the loss does not reach, as
    `jax.grad` gives."""
    leaves = params.leaves()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return dict(zip(leaves, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: str = "dots", compress=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state',
    metrics) for trainable `params` (a `ModelParams`), which it updates in
    place. `compress` (optional) transforms the gradients between the
    backward and the optimizer (training/compression.py). The metrics are
    0-d tensors: the loss, the pre-clip gradient norm and the lr."""

    def train_step(params, opt_state: AdamWState, batch):
        loss = loss_fn(params, cfg, batch, remat=remat)
        grads = grads_of(loss, params)
        if compress is not None:
            grads = compress(grads)
        params, opt_state, metrics = opt.apply_updates(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss.detach())

    return train_step


# ---------------------------------------------------------------------------
# Fault-tolerant loop
# ---------------------------------------------------------------------------


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    log_every: int = 10
    # straggler mitigation: a step slower than watchdog_factor x the rolling
    # median is logged and counted; at cluster scale the same hook triggers
    # re-sharding away from the slow host (here: observable metric + callback)
    watchdog_factor: float = 3.0
    on_straggler: Optional[Callable[[int, float, float], None]] = None


def train_loop(cfg: ModelConfig, params, opt_state, train_step, data_iter,
               loop: LoopConfig, *, start_step: int = 0,
               log: Callable[[str], None] = print) -> Tuple[Any, Any, Dict]:
    """Runs steps [start_step, total_steps). Each step's time ends when its
    loss reaches the host (`.item()`, a synchronise). Checkpoints
    atomically; on restart, `checkpoint.latest_step` + `restore` resume
    bit-identically (tests/test_torch_training.py)."""
    from repro_torch.training import checkpoint as ckpt

    step_times = []
    stragglers = 0
    metrics = {}
    loss = float("nan")
    t_first = None
    for step in range(start_step, loop.total_steps):
        batch = next(data_iter)
        t0 = time.monotonic()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = metrics["loss"].item()
        dt = time.monotonic() - t0
        if t_first is None:
            t_first = dt                       # the first step warms up
        else:
            step_times.append(dt)
            if len(step_times) >= 5:
                med = sorted(step_times)[len(step_times) // 2]
                if dt > loop.watchdog_factor * med:
                    stragglers += 1
                    log(f"[watchdog] step {step} took {dt:.3f}s "
                        f"(median {med:.3f}s) — straggler")
                    if loop.on_straggler is not None:
                        loop.on_straggler(step, dt, med)
        if step % loop.log_every == 0:
            log(f"step {step}: loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} dt={dt*1e3:.0f}ms")
        if (step + 1) % loop.checkpoint_every == 0 or \
                step + 1 == loop.total_steps:
            ckpt.save(loop.checkpoint_dir, step + 1,
                      {"params": params, "opt_state": opt_state},
                      keep=loop.keep)
    info = {"stragglers": stragglers,
            "median_step_time": (sorted(step_times)[len(step_times) // 2]
                                 if step_times else 0.0),
            "final_loss": loss}
    return params, opt_state, info
