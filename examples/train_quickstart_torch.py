"""Train a small llama-family model with the PyTorch port's training
substrate: AdamW, cosine schedule, atomic checkpointing with auto-resume,
and the straggler watchdog. Kill it mid-run and re-run — it resumes from
the latest checkpoint bit-identically.

    PYTHONPATH=src python examples/train_quickstart_torch.py --device cpu \
        [--steps 60] [--big]
    PYTHONPATH=src python examples/train_quickstart_torch.py --big

The counterpart of examples/train_quickstart.py, on `repro_torch.training`:
the same configs (the tiny Llama3-8B, or ~100M parameters with --big), f32
parameters drawn from seed 0, remat off. It runs on the card unless
``--device cpu``, with TF32 off so that f32 products stay f32, and on
deterministic kernels, without which a resume is not bit-identical. Each
step's time ends when its loss reaches the host.
"""
import argparse
import dataclasses
import os

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_tiny_config
from repro_torch.params import init_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, data_iterator
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.train import LoopConfig, make_train_step, train_loop


def config(big: bool = False):
    cfg = get_tiny_config("llama3_8b")
    if big:
        cfg = dataclasses.replace(cfg, num_layers=8, d_model=512, d_ff=2048,
                                  num_heads=8, num_kv_heads=4,
                                  vocab_size=32768)
    return cfg


def draw(cfg, device="cuda"):
    """The example's weights: f32, trainable, drawn from seed 0."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # f32 stays f32 (no TF32), as the reference computes it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev, trainable=True)


def train(cfg, params, *, steps=60, seq=64, batch=8,
          ckpt_dir="/tmp/repro_train_quickstart", checkpoint_every=20,
          log_every=10, log=print):
    """`train_loop` from step 0, or from the newest checkpoint in
    `ckpt_dir` below `steps` (auto-resume). Returns (params, opt_state,
    info)."""
    dev = params["embed"].device
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps)
    opt_state = init_state(params)
    step = make_train_step(cfg, opt_cfg, remat="none")
    data = DataConfig(seq_len=seq, global_batch=batch,
                      vocab_size=cfg.vocab_size)

    start = 0
    last = ckpt.latest_step(ckpt_dir)
    if last is not None and last < steps:
        restored = ckpt.restore(ckpt_dir, last,
                                {"params": params, "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]
        start = last
        log(f"auto-resumed from checkpoint step {last}")

    loop = LoopConfig(total_steps=steps, checkpoint_every=checkpoint_every,
                      checkpoint_dir=ckpt_dir, log_every=log_every)
    return train_loop(cfg, params, opt_state, step,
                      data_iterator(data, start_step=start, device=dev),
                      loop, start_step=start, log=log)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_quickstart")
    ap.add_argument("--big", action="store_true",
                    help="~100M-param model (slower per step on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # a resume is bit-identical only on deterministic kernels: the
    # embedding gradient's accumulation order (CPU) and cuBLAS's workspace
    # (card) vary otherwise; cuBLAS reads the variable when it starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    cfg = config(args.big)
    params = draw(cfg, args.device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"== training {cfg.name}: {n_params/1e6:.1f}M params on "
          f"{params['embed'].device} ==")
    params, opt_state, info = train(cfg, params, steps=args.steps,
                                    seq=args.seq, batch=args.batch,
                                    ckpt_dir=args.ckpt_dir)
    print(f"done: final loss {info['final_loss']:.4f}, "
          f"median step {info['median_step_time']*1e3:.0f} ms, "
          f"stragglers {info['stragglers']}")
    return params, opt_state, info


if __name__ == "__main__":
    main()
