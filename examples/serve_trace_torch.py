"""End-to-end serving example on the PyTorch port: a QwenTrace-statistics
workload served by the full FlowPrefill stack — Proxy -> PrefillInstance
(event-driven scheduler, operator-level preemption, SLO-aware batching) ->
DecodeInstance — with a REAL model. Compares S-EDF against FCFS on the same
trace.

    PYTHONPATH=src python examples/serve_trace_torch.py --device cpu \
        [--requests 12] [--policy both]
    PYTHONPATH=src python examples/serve_trace_torch.py --full-config

The counterpart of examples/serve_trace.py. It runs on the card unless
``--device cpu``; without ``--full-config`` it serves that example's tiny
config (f32 on the CPU, bf16 on the card), with it the published width of
``--arch`` in bf16, random weights from ``--seed`` either way. The TTFT
profile is timed with the device synchronised before each clock read.
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.base import get_config, get_tiny_config
from repro_torch.core import Request, SchedulerCore, TTFTPredictor
from repro_torch.core.metrics import attainment_by_task
from repro_torch.launch.serve import draw_params, ttft_profile
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.serving.decode_instance import DecodeInstance
from repro_torch.serving.prefill_instance import PrefillInstance
from repro_torch.serving.proxy import Proxy

CFG = dataclasses.replace(get_tiny_config("llama3_8b"),
                          num_layers=2, d_model=128, d_ff=256)
MAX_SEQ = 4096
PROFILE = (256, 1024, 2048, 4096)
# scaled-down QwenTrace mix: (task, tokens, slo_seconds, probability)
MIX = [("text", 256, 1.5, 0.60), ("image", 256, 3.0, 0.08),
       ("search", 2048, 15.0, 0.24), ("file", 4096, 25.0, 0.08)]


def config(full_config: bool = False, arch: str = "llama3_8b"):
    return get_config(arch) if full_config else CFG


def setup(params, cfg):
    """The executor the instances share, its TTFT profile and the
    predictor fitted to it."""
    ex = SegmentedPrefill(params, cfg, max_seq=MAX_SEQ, granularity="op",
                          chunk_tokens=512, cache_dtype=params.dtype)
    profile = ttft_profile(ex, PROFILE)
    pred = TTFTPredictor.fit(list(profile), list(profile.values()))
    return ex, profile, pred


def build(params, cfg, pred, ex, policy):
    core = SchedulerCore(predictor=pred, policy=policy, batch_budget=512,
                         enable_batching=False)
    inst = PrefillInstance(params, cfg, core, max_seq=MAX_SEQ, executor=ex)
    dec = DecodeInstance(params, cfg, decode_tokens=2)
    return Proxy([inst], [dec]), inst, dec


def run(policy, params, cfg, pred, ex, n_requests, seed=0):
    """`n_requests` prompts of MIX at exponential gaps of mean 0.6 s,
    drained; `Proxy.report()` with attainment by task, the decoded count
    and the preemptions."""
    proxy, inst, dec = build(params, cfg, pred, ex, policy)
    rng = np.random.default_rng(seed)
    reqs = []
    try:
        for i in range(n_requests):
            r = rng.random()
            acc = 0.0
            for task, tokens, slo, p in MIX:
                acc += p
                if r <= acc:
                    break
            req = Request(num_tokens=tokens, slo=slo, task_type=task,
                          arrival=time.monotonic())
            proxy.submit(req, rng.integers(0, cfg.vocab_size, tokens))
            reqs.append(req)
            time.sleep(float(rng.exponential(0.6)))
        if not proxy.drain(300.0):
            raise RuntimeError("drain timed out after 300 s: "
                               f"{proxy.report()['stranded_rids']}")
        time.sleep(0.5)
        rep = proxy.report()
        rep["by_task"] = attainment_by_task(reqs)
        rep["decoded"] = len(dec.finished)
        rep["preemptions"] = len(inst.blocking_stats.samples)
        return rep
    finally:
        proxy.shutdown()


def print_report(policy, rep):
    print(f"\n--- policy={policy} ---")
    print(f"  requests={rep['n_requests']} decoded={rep['decoded']}")
    print(f"  SLO attainment={rep['slo_attainment']:.2f} "
          f"by task={ {k: round(v, 2) for k, v in rep['by_task'].items()} }")
    print(f"  TTFT mean={rep['ttft']['mean']:.3f}s "
          f"p99={rep['ttft']['p99']:.3f}s")
    print(f"  scheduling rounds={rep['scheduling_rounds']}, "
          f"mean blocking={rep['blocking_mean']*1e3:.1f}ms "
          f"({rep['preemptions']} preemption(s))")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--policy", default="both",
                    choices=["both", "s-edf", "fcfs"])
    ap.add_argument("--full-config", action="store_true",
                    help="--arch at its published width in bf16")
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== end-to-end FlowPrefill serving (real execution) ==")
    cfg = config(args.full_config, args.arch)
    params = draw_params(cfg, args.device, args.seed)
    ex, profile, pred = setup(params, cfg)
    print("  TTFT profile: " + ", ".join(
        f"{n} tokens {t*1e3:.1f} ms" for n, t in profile.items()))
    policies = ["s-edf", "fcfs"] if args.policy == "both" else [args.policy]
    reports = {}
    for policy in policies:
        reports[policy] = run(policy, params, cfg, pred, ex, args.requests)
        print_report(policy, reports[policy])
    return reports


if __name__ == "__main__":
    main()
