"""Serving launcher: bring up a FlowPrefill PD-disaggregated deployment on
one device and serve the reference launcher's request mix.

    PYTHONPATH=src python -m repro_torch.launch.serve --full-config \
        --requests 6 --policy s-edf [--granularity op] [--chunk 512]

`--full-config` serves Llama3-8B at its published width in bf16 with random
weights drawn from `--seed`; without it, the tiny config. `--device`
defaults to `cuda`; `--device cpu` runs the same path on the host (tiny
config only in practice). Counterpart of src/repro/launch/serve.py, split
into `build` and `serve_trace` so that `chip_smoke.py` can drive it.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config, get_tiny_config
from repro_torch.core import Request, SchedulerCore, TTFTPredictor
from repro_torch.core.metrics import attainment_by_task, ttft_stats
from repro_torch.models.model import supports_ragged_decode
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.params import init_params
from repro_torch.serving.decode_instance import DecodeInstance
from repro_torch.serving.prefill_instance import PrefillInstance
from repro_torch.serving.proxy import Proxy


@dataclass
class Deployment:
    cfg: ModelConfig
    params: object
    executor: SegmentedPrefill
    profile: Dict[int, float]          # prompt tokens -> measured TTFT (s)
    prefill: PrefillInstance
    decode: DecodeInstance
    proxy: Proxy

    def shutdown(self) -> None:
        self.proxy.shutdown()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ttft_profile(executor: SegmentedPrefill, lengths: Sequence[int]
                 ) -> Dict[int, float]:
    """Offline TTFT profile (paper §6.4): each length prefilled once to warm
    up, then timed, with the device synchronised before each clock read."""
    dev = executor.device
    out = {}
    for n in lengths:
        toks = np.zeros((1, n), np.int64)
        executor.run_all(executor.start(toks))
        _sync(dev)
        t0 = time.monotonic()
        executor.run_all(executor.start(toks))
        _sync(dev)
        out[n] = time.monotonic() - t0
    return out


def build(*, arch: str = "llama3_8b", full_config: bool = False,
          policy: str = "s-edf", granularity: str = "op", chunk: int = 512,
          batch_budget: int = 4096, max_seq: int = 4096,
          decode_tokens: int = 4, decode_max_batch: int = 4, seed: int = 0,
          device="cuda", dtype: Optional[torch.dtype] = None) -> Deployment:
    """Random weights, the TTFT profile and predictor, one prefill and one
    decode instance behind a Proxy. ``dtype`` defaults to bf16 on the card
    and f32 on the CPU."""
    dev = resolve_device(device)
    cfg = get_config(arch) if full_config else get_tiny_config(arch)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, device=dev, dtype=dtype)
    executor = SegmentedPrefill(params, cfg, max_seq=max_seq,
                                granularity=granularity, chunk_tokens=chunk,
                                cache_dtype=dtype)
    profile = ttft_profile(
        executor, sorted({n for n in (256, 1024, max_seq) if n <= max_seq}))
    pred = TTFTPredictor.fit(list(profile), list(profile.values()))
    core = SchedulerCore(predictor=pred, policy=policy,
                         batch_budget=batch_budget)
    inst = PrefillInstance(params, cfg, core, max_seq=max_seq,
                           executor=executor)
    dmb = decode_max_batch if supports_ragged_decode(cfg) else 1
    dec = DecodeInstance(params, cfg, decode_tokens=decode_tokens,
                         decode_max_batch=dmb)
    return Deployment(cfg=cfg, params=params, executor=executor,
                      profile=profile, prefill=inst,
                      decode=dec, proxy=Proxy([inst], [dec]))


def serve_trace(dep: Deployment, *, requests: int = 12, seed: int = 0,
                arrival_mean_s: float = 0.5,
                drain_timeout: float = 600.0) -> dict:
    """Submit `requests` prompts from the reference launcher's mix (70%
    256-token text at a 1.5 s TTFT SLO, 20% max_seq/2-token search at 15 s,
    10% max_seq-token file at 25 s) with exponential inter-arrival gaps,
    drain, and return `Proxy.report()` plus the decoded count."""
    cfg, proxy = dep.cfg, dep.proxy
    max_seq = dep.executor.max_seq
    rng = np.random.default_rng(seed)
    mix = [(256, 1.5, "text", 0.7), (max_seq // 2, 15.0, "search", 0.2),
           (max_seq, 25.0, "file", 0.1)]
    for _ in range(requests):
        r = rng.random()
        acc = 0.0
        for tokens, slo, task, p in mix:
            acc += p
            if r <= acc:
                break
        req = Request(num_tokens=tokens, slo=slo, task_type=task,
                      arrival=time.monotonic())
        proxy.submit(req, rng.integers(0, cfg.vocab_size, tokens))
        time.sleep(float(rng.exponential(arrival_mean_s)))
    if not proxy.drain(drain_timeout):
        raise RuntimeError(f"drain timed out after {drain_timeout}s: "
                           f"{proxy.report()['stranded_rids']}")
    time.sleep(0.5)
    rep = proxy.report()
    rep["decoded"] = len(dep.decode.finished)
    rep["attainment_by_task"] = attainment_by_task(proxy.requests)
    rep["preemptions"] = len(dep.prefill.blocking_stats.samples)
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config (Llama3-8B: 32 layers, "
                    "d_model 4096)")
    ap.add_argument("--policy", default="s-edf",
                    choices=["s-edf", "d-edf", "edf", "fcfs"])
    ap.add_argument("--granularity", default="op")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--batch-budget", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--decode-tokens", type=int, default=4)
    ap.add_argument("--decode-max-batch", type=int, default=4,
                    help="continuous-batching decode slot cap (families "
                    "without a dense per-layer KV cache fall back to 1)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="prefix-sharing prompt KV cache (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.prefix_share:
        ap.error("--prefix-share: prefix sharing is not ported yet")

    dep = build(arch=args.arch, full_config=args.full_config,
                policy=args.policy, granularity=args.granularity,
                chunk=args.chunk, batch_budget=args.batch_budget,
                max_seq=args.max_seq, decode_tokens=args.decode_tokens,
                decode_max_batch=args.decode_max_batch, seed=args.seed,
                device=args.device)
    dev = dep.executor.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"serving {dep.cfg.name} ({dep.cfg.family}) on {name} "
          f"dtype={dep.params.dtype} granularity={args.granularity} "
          f"chunk={args.chunk}")
    print("TTFT profile:",
          {n: f"{y * 1e3:.1f}ms" for n, y in dep.profile.items()})
    try:
        rep = serve_trace(dep, requests=args.requests, seed=args.seed)
        print(f"\nattainment={rep['slo_attainment']:.2f} by_task="
              f"{ {k: round(v, 2) for k, v in rep['attainment_by_task'].items()} }")
        print(f"ttft={ttft_stats(dep.proxy.requests)}")
        print(f"rounds={rep['scheduling_rounds']} "
              f"blocking_mean={rep['blocking_mean'] * 1e3:.1f}ms "
              f"preemptions={rep['preemptions']} decoded={rep['decoded']}")
    finally:
        dep.shutdown()


if __name__ == "__main__":
    main()
