"""The port's sharded path across four cards: a (data 2, model 2) NCCL mesh.

Each of four ranks (one process a card) draws the same random weights from
seed 0 and keeps its own shards (`params.distribute_params`). Rank 0 also
runs every computation unsharded on its own card, as the reference result.

- Serve, Llama3-8B at published width in bf16 under `serve_rules`: a
  `prefill` of two 4096-token prompts (one a `data` rank) and 16
  `decode_step`s teacher-forced with rank 0's greedy tokens. Every step's
  logits are held to the unsharded ones within four bf16 steps at
  max|logit| (chip_smoke's phase 9 bound): the sharded sums run in another
  order across the `model` shards, so bit-equality is not expected.
- Train, Llama3.2-1B at chip_smoke phase 14's shape (seq 4096, batch 2,
  bf16 params, f32 AdamW, remat full) under `train_rules`: one step; the
  loss held to the unsharded step within the same bound, and each leaf's
  first AdamW moment m (the clipped gradient times 1 - b1) no more than
  twice as far (relative Frobenius distance) from an f32 step's as the
  unsharded bf16 step's m is: the sharded gradients are reduced in bf16
  across the shards, in another order, so elementwise equality to the
  unsharded bf16 is not the yardstick; both are printed.
- Times on rank 0, synchronised across the ranks: a warm prefill and the
  decode step's median, sharded beside unsharded on one card, the train
  step, and a profiler breakdown of one sharded decode step (device time
  by kernel, NCCL's share, the idle share).

    python3 tools/sharded_mesh.py          # four cards of one host
    python3 tools/sharded_mesh.py --cpu    # rehearsal: gloo, tiny configs

The rehearsal runs in f32, where the unsharded step is the f32 step and
the gradient check has no yardstick; tests/test_torch_distributed.py holds
the f32 numerics on the same kind of mesh.

Prints the cards' names and power limits first and one JSON line of the
results last; exits non-zero when a rank fails or a check does not hold.
"""
from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
WORLD = 4
N_STEPS = 16


def bound_err(got, want) -> float:
    """max |got - want| over four bf16 steps at max|want| (<= 1 holds)."""
    err = (got.float() - want.float()).abs().max().item()
    return err / (4 * 2.0 ** -7 * want.float().abs().max().item() + 1e-30)


def rel_fro(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor."""
    d = (got.float() - want.float()).norm().item()
    return d / (want.float().norm().item() + 1e-30)


def rank_main(rank: int, store: str, cpu: bool) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from chip_smoke import breakdown, full
    from repro_torch.configs.base import get_config, get_tiny_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.params import (ModelParams, distribute_params,
                                    init_params, nested)
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train import make_train_step

    if cpu:
        torch.set_num_threads(1)
        dev, backend, dtype, S = torch.device("cpu"), "gloo", \
            torch.float32, 64
        config = get_tiny_config
    else:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev, backend, dtype, S = torch.device("cuda", rank), "nccl", \
            torch.bfloat16, 4096
        config = get_config
    # a collective that waits 5 minutes fails its rank instead of hanging
    dist.init_process_group(backend, store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            device_id=None if cpu else dev,
                            timeout=datetime.timedelta(minutes=5))
    mesh = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("data", "model"))
    sizes = shd.axis_sizes(mesh)
    out: dict = {}

    def sync():
        if not cpu:
            torch.cuda.synchronize()
        dist.barrier()

    def put(t, rules):
        dims = ("act_batch",) + (None,) * (t.dim() - 1)
        return shd.distribute(t, mesh, shd.placements(tuple(t.shape), dims,
                                                      sizes, rules))

    def timed(fn):
        sync()
        t0 = time.monotonic()
        r = fn()
        sync()
        return r, time.monotonic() - t0

    # --- serve: Llama3-8B prefill + teacher-forced decode --------------------
    cfg = config("llama3_8b")
    rules = shd.serve_rules()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev, dtype=dtype)
    sharded = distribute_params(params, cfg, mesh, rules)
    toks = torch.as_tensor(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (2, S)), device=dev)
    forced = [None] * N_STEPS
    if rank == 0:
        ref_logits, step_s = [], []
        for _ in range(2):                       # the second is timed
            t0 = time.monotonic()
            logits, cache = M.prefill(params, cfg, {"tokens": toks},
                                      max_seq=S + N_STEPS + 1,
                                      cache_dtype=dtype)
            if not cpu:
                torch.cuda.synchronize()
            prefill_s = time.monotonic() - t0
        ref_logits.append(logits)
        for i in range(N_STEPS):
            forced[i] = ref_logits[-1].argmax(-1).tolist()
            t0 = time.monotonic()
            logits, cache = M.decode_step(params, cfg, torch.as_tensor(
                forced[i], device=dev), cache)
            if not cpu:
                torch.cuda.synchronize()
            step_s.append(time.monotonic() - t0)
            ref_logits.append(logits)
        out["plain"] = {"prefill_s": prefill_s,
                        "decode_step_ms": 1e3 * sorted(step_s)[N_STEPS // 2]}
    dist.broadcast_object_list(forced, src=0)
    del params
    with shd.use_sharding(mesh, rules):
        for _ in range(2):
            (logits, cache), prefill_s = timed(lambda: M.prefill(
                sharded, cfg, {"tokens": put(toks, rules)},
                max_seq=S + N_STEPS + 1, cache_dtype=dtype))
        seen, step_s = [full(logits)], []
        for i in range(N_STEPS):
            tok = put(torch.as_tensor(forced[i], device=dev), rules)
            (logits, cache), dt = timed(
                lambda: M.decode_step(sharded, cfg, tok, cache))
            step_s.append(dt)
            seen.append(full(logits))
        # a warm-up and a profiled step on every rank (their collectives
        # pair up); rank 0 profiles its own
        profile = {}
        if rank == 0 and not cpu:
            profile = breakdown(
                torch, "sharded decode_step (rank 0)",
                lambda: M.decode_step(sharded, cfg, tok, cache),
                cpu_ops=("_c10d_functional::all_reduce",
                         "_c10d_functional::all_gather_into_tensor"))
        else:
            M.decode_step(sharded, cfg, tok, cache)
            M.decode_step(sharded, cfg, tok, cache)
    out["sharded"] = {"prefill_s": prefill_s,
                      "decode_step_ms": 1e3 * sorted(step_s)[N_STEPS // 2]}
    if rank == 0:
        out["serve_bound"] = [bound_err(g, w)
                              for g, w in zip(seen, ref_logits)]
        out["profile_ms_under"] = profile
    del sharded, cache, logits, seen
    gc_collect(torch, cpu)

    # --- train: Llama3.2-1B, one step ----------------------------------------
    cfg = config("llama3_2_1b")
    rules = shd.train_rules()
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=8)
    step = make_train_step(cfg, opt, remat="full")
    data = DataConfig(seq_len=S, global_batch=2, vocab_size=cfg.vocab_size)
    batch = make_batch(data, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev, dtype=dtype, trainable=True)
    init = {k: t.detach().clone() for k, t in params.leaves().items()}
    if rank == 0:
        state = init_state(params)
        (params, state, met0), out["plain"]["train_step_s"] = timed_local(
            torch, cpu, lambda: step(params, state, batch))
        ref_m = {k: v.clone() for k, v in state.m.items()}
        del params, state
        # the same step in f32, the yardstick of both bf16 steps
        p32 = ModelParams(nested({k: t.float() for k, t in init.items()}),
                          trainable=True)
        s32 = init_state(p32)
        p32, s32, _ = step(p32, s32, batch)
        m32 = dict(s32.m)
        del p32, s32
    else:
        del params
    gc_collect(torch, cpu)
    p1 = distribute_params(ModelParams(nested(init), trainable=True), cfg,
                           mesh, rules)
    del init
    s1 = init_state(p1)
    b1 = {k: put(t, rules) for k, t in batch.items()}
    with shd.use_sharding(mesh, rules):
        (p1, s1, met1), out["sharded"]["train_step_s"] = timed(
            lambda: step(p1, s1, b1))
    m1 = {k: full(v) for k, v in s1.m.items()}
    loss1 = full(met1["loss"])
    if rank == 0:
        out["train_loss"] = [met0["loss"].item(), loss1.item()]
        out["train_loss_bound"] = bound_err(loss1, met0["loss"])
        # per leaf: the bf16 bound between the two bf16 steps, and each
        # one's relative distance from the f32 step's m
        out["train_m_by_leaf"] = {
            k: {"bound": bound_err(m1[k], ref_m[k]),
                "sharded_vs_f32": rel_fro(m1[k], m32[k]),
                "plain_vs_f32": rel_fro(ref_m[k], m32[k])} for k in ref_m}
    dist.barrier()
    dist.destroy_process_group()
    return out


def timed_local(torch, cpu, fn):
    if not cpu:
        torch.cuda.synchronize()
    t0 = time.monotonic()
    r = fn()
    if not cpu:
        torch.cuda.synchronize()
    return r, time.monotonic() - t0


def gc_collect(torch, cpu):
    import gc
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the host at the tiny configs")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        out = rank_main(args.rank, args.store, args.cpu)
        if args.rank == 0:
            print("RESULT " + json.dumps(out), flush=True)
        return
    if not args.cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build"
                                     if (ROOT / "build").is_dir()
                                     else None) as tmp:
        cmd = [sys.executable, __file__, "--store", f"{tmp}/store"] + \
            (["--cpu"] if args.cpu else [])
        procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(WORLD)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(text[-4000:], file=sys.stderr)
            sys.exit(f"rank {r} failed (rc {p.returncode})")
    lines = outs[0].splitlines()
    print("\n".join(x for x in lines if not x.startswith("RESULT ")))
    res = json.loads(next(x for x in lines if x.startswith("RESULT "))[7:])
    print(json.dumps(res), flush=True)
    worst = max(max(res["serve_bound"]), res["train_loss_bound"])
    if not worst <= 1.0:
        sys.exit(f"a sharded result is {worst:.3f} times its bf16 bound")
    far = {k: v for k, v in res["train_m_by_leaf"].items()
           if v["sharded_vs_f32"] > 2 * v["plain_vs_f32"]}
    if far and not args.cpu:
        sys.exit(f"the sharded bf16 gradients of {sorted(far)} are more "
                 "than twice as far from the f32 step as the unsharded")


if __name__ == "__main__":
    main()
