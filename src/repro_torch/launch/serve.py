"""Serving launcher: bring up a FlowPrefill PD-disaggregated deployment on
one device and serve the reference launcher's request mix.

    PYTHONPATH=src python -m repro_torch.launch.serve --full-config \
        --requests 6 --policy s-edf [--granularity op] [--chunk 512] \
        [--spec-decode --draft-k 4] [--prefix-share] \
        [--arch qwen3_30b_a3b]

`--full-config` serves `--arch` (Llama3-8B by default; Qwen3-30B-A3B, the
uniform MoE family, fits one 80 GB card) at its published width in bf16
with random weights drawn from `--seed`; without it, the arch's tiny
config. `--device`
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


def draw_params(cfg: ModelConfig, device="cuda", seed: int = 0,
                dtype: Optional[torch.dtype] = None):
    """Random weights for `cfg` drawn from `seed` on `device`, in bf16 on
    the card and f32 on the CPU unless `dtype` says otherwise."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(cfg, gen, device=dev, dtype=dtype)


def build(*, arch: str = "llama3_8b", full_config: bool = False,
          policy: str = "s-edf", granularity: str = "op", chunk: int = 512,
          batch_budget: int = 4096, max_seq: int = 4096,
          decode_tokens: int = 4, decode_max_batch: int = 4, seed: int = 0,
          device="cuda", dtype: Optional[torch.dtype] = None,
          spec_decode: bool = False, draft_k: int = 4,
          prefix_share: bool = False,
          prefix_cache_blocks: int = 512) -> Deployment:
    """Random weights, the TTFT profile and predictor, one prefill and one
    decode instance behind a Proxy. ``dtype`` defaults to bf16 on the card
    and f32 on the CPU. ``spec_decode``/``draft_k`` go to the decode
    instance (the self-drafting n-gram drafter); ``prefix_share`` /
    ``prefix_cache_blocks`` give the prefill instance its prefix-sharing
    KV cache of that many 128-token blocks."""
    cfg = get_config(arch) if full_config else get_tiny_config(arch)
    params = draw_params(cfg, device, seed, dtype)
    executor = SegmentedPrefill(params, cfg, max_seq=max_seq,
                                granularity=granularity, chunk_tokens=chunk,
                                cache_dtype=params.dtype)
    profile = ttft_profile(
        executor, sorted({n for n in (256, 1024, max_seq) if n <= max_seq}))
    pred = TTFTPredictor.fit(list(profile), list(profile.values()))
    core = SchedulerCore(predictor=pred, policy=policy,
                         batch_budget=batch_budget)
    inst = PrefillInstance(params, cfg, core, max_seq=max_seq,
                           executor=executor, prefix_share=prefix_share,
                           prefix_cache_blocks=prefix_cache_blocks)
    dmb = decode_max_batch if supports_ragged_decode(cfg) else 1
    dec = DecodeInstance(params, cfg, decode_tokens=decode_tokens,
                         decode_max_batch=dmb, spec_decode=spec_decode,
                         draft_k=draft_k)
    return Deployment(cfg=cfg, params=params, executor=executor,
                      profile=profile, prefill=inst,
                      decode=dec, proxy=Proxy([inst], [dec]))


def serve_trace(dep: Deployment, *, requests: int = 12, seed: int = 0,
                arrival_mean_s: float = 0.5,
                drain_timeout: float = 600.0) -> dict:
    """Submit `requests` prompts from the reference launcher's mix (70%
    256-token text at a 1.5 s TTFT SLO, 20% max_seq/2-token search at 15 s,
    10% max_seq-token file at 25 s) with exponential inter-arrival gaps,
    drain, and return `Proxy.report()` plus the decoded count. With a
    prefix-sharing prefill instance, each task class first gets a template
    of half its tokens, and each prompt is its class's template plus a
    random tail, so repeat submissions hit the prefix cache."""
    cfg, proxy = dep.cfg, dep.proxy
    max_seq = dep.executor.max_seq
    rng = np.random.default_rng(seed)
    mix = [(256, 1.5, "text", 0.7), (max_seq // 2, 15.0, "search", 0.2),
           (max_seq, 25.0, "file", 0.1)]
    templates = {task: rng.integers(0, cfg.vocab_size, tokens // 2)
                 for tokens, _, task, _ in mix} \
        if dep.prefill.kv is not None else {}
    for _ in range(requests):
        r = rng.random()
        acc = 0.0
        for tokens, slo, task, p in mix:
            acc += p
            if r <= acc:
                break
        req = Request(num_tokens=tokens, slo=slo, task_type=task,
                      arrival=time.monotonic())
        template = templates.get(task, np.zeros(0, np.int64))
        tail = rng.integers(0, cfg.vocab_size, tokens - len(template))
        proxy.submit(req, np.concatenate([template, tail]))
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
                    help="use the arch's published config (Llama3-8B: 32 "
                    "layers, d_model 4096; qwen3_30b_a3b: 48 layers, 128 "
                    "experts top-8)")
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
                    help="prefix-sharing prompt KV cache: each task class's "
                    "prompts share a template of half their tokens, which "
                    "is served from cache after the first and prefilled "
                    "suffix-only")
    ap.add_argument("--prefix-cache-blocks", type=int, default=512,
                    help="prefix cache capacity in 128-token KV blocks "
                    "(with --prefix-share)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: the self-drafting n-gram "
                    "drafter and one batched k+1-position verify pass per "
                    "step (greedy output bit-equal to plain decoding in "
                    "f32; in bf16 it may part at near-tied logits)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per speculative step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dep = build(arch=args.arch, full_config=args.full_config,
                policy=args.policy, granularity=args.granularity,
                chunk=args.chunk, batch_budget=args.batch_budget,
                max_seq=args.max_seq, decode_tokens=args.decode_tokens,
                decode_max_batch=args.decode_max_batch, seed=args.seed,
                device=args.device, spec_decode=args.spec_decode,
                draft_k=args.draft_k, prefix_share=args.prefix_share,
                prefix_cache_blocks=args.prefix_cache_blocks)
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
        if args.spec_decode:
            sp = rep["spec"]
            print(f"spec: steps={sp['spec_steps']} "
                  f"accept_rate={sp['accept_rate']:.2f} "
                  f"tokens/step={sp['tokens_per_step']:.2f} "
                  f"(drafted {sp['draft_proposed']}, "
                  f"accepted {sp['draft_accepted']})")
        if args.prefix_share:
            print(f"prefix hits={rep['prefix_hits']} "
                  f"({rep['prefix_hit_tokens']} prompt tokens served "
                  f"from cache)")
    finally:
        dep.shutdown()


if __name__ == "__main__":
    main()
