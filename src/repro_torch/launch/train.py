"""Training launcher: fault-tolerant training of any assigned architecture,
the counterpart of src/repro/launch/train.py with its flags and its
auto-resume from the newest checkpoint in --ckpt-dir.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
        --steps 50 --device cpu                  # the tiny config, on the host
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
        --full-config --seq 4096 --batch 2 --remat full   # one card

It runs on the card unless --device cpu. --full-config takes the published
width with bf16 parameters and f32 AdamW state, as the reference's train_4k
cell has them (--dtype overrides the parameters' dtype).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, get_tiny_config
from repro_torch.models import REMAT_POLICIES
from repro_torch.params import init_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, data_iterator
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.train import LoopConfig, make_train_step, train_loop

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", default="none", choices=REMAT_POLICIES)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="parameters' dtype (default: bfloat16 with "
                         "--full-config, else float32)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # f32 stays f32 (no TF32), as the reference computes it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch) if args.full_config \
        else get_tiny_config(args.arch)
    dtype = DTYPES[args.dtype or ("bfloat16" if args.full_config
                                  else "float32")]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=dtype, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"training {cfg.name}: {n_params/1e6:.1f}M params in {dtype} on "
          f"{dev}, seq={args.seq} batch={args.batch} remat={args.remat}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    opt_state = init_state(params)
    step = make_train_step(cfg, opt_cfg, remat=args.remat)
    data = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size)

    start = 0
    last = ckpt.latest_step(args.ckpt_dir)
    if last is not None and last < args.steps:
        restored = ckpt.restore(args.ckpt_dir, last,
                                {"params": params, "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]
        start = last
        print(f"auto-resumed from step {last}")

    loop = LoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                      checkpoint_dir=args.ckpt_dir)
    _, _, info = train_loop(
        cfg, params, opt_state, step,
        data_iterator(data, start_step=start, model_cfg=cfg, device=dev),
        loop, start_step=start)
    print(f"done: {info}")
    return info


if __name__ == "__main__":
    main()
