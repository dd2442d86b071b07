"""Quickstart: FlowPrefill's operator-level preemption, on the PyTorch port.

Reproduces the paper's Fig. 8 walk-through with real execution: request A
(long, relaxed SLO) starts prefilling; request B (short, strict SLO)
arrives mid-flight; the event-driven scheduler preempts A at an operator
boundary, serves B, then resumes A — and A's result is bit-identical to an
uninterrupted run.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py --full-config

The counterpart of examples/quickstart.py. It runs on the card unless
``--device cpu``; without ``--full-config`` it serves that example's tiny
config (f32 on the CPU, bf16 on the card), with it the published width of
``--arch`` in bf16, random weights from ``--seed`` either way. B arrives
0.3 s after A starts running, as in that example, or after a third of A's
predicted TTFT where that is shorter, so that it lands while A runs on any
device. Times are read after synchronising the device.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_tiny_config
from repro_torch.core import Request, RequestState, SchedulerCore, TTFTPredictor
from repro_torch.launch.serve import draw_params, ttft_profile
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.serving.prefill_instance import PrefillInstance

CFG = dataclasses.replace(get_tiny_config("llama3_8b"),
                          num_layers=2, d_model=128, d_ff=256)
MAX_SEQ, LONG, SHORT = 4096, 4096, 128
PROFILE = (128, 512, 1024, 2048, 4096)
B_AFTER = 0.3            # seconds of A's run before B arrives (at most)
TIMEOUT = 300.0


def config(full_config: bool = False, arch: str = "llama3_8b"):
    return get_config(arch) if full_config else CFG


def setup(params, cfg):
    """The shared executor, its offline TTFT profile (paper §6.4; each
    length warmed up, then timed) and the polynomial predictor fitted to
    it."""
    ex = SegmentedPrefill(params, cfg, max_seq=MAX_SEQ, granularity="op",
                          chunk_tokens=512, cache_dtype=params.dtype)
    profile = ttft_profile(ex, PROFILE)
    pred = TTFTPredictor.fit(list(profile), list(profile.values()))
    return ex, profile, pred


def walkthrough(params, cfg, ex, pred) -> dict:
    """A (LONG tokens, SLO 60 s), then B (SHORT tokens, SLO 1 s) once A
    has run for B_AFTER seconds (capped at a third of A's predicted TTFT),
    on one S-EDF `PrefillInstance`; then A's first-token logits against an
    uninterrupted prefill of the same tokens."""
    core = SchedulerCore(predictor=pred, policy="s-edf",
                         enable_batching=False)
    inst = PrefillInstance(params, cfg, core, max_seq=MAX_SEQ, executor=ex)
    rng = np.random.default_rng(0)
    a_tokens = rng.integers(0, cfg.vocab_size, LONG)
    delay = min(B_AFTER, float(pred.predict(LONG)) / 3.0)
    try:
        A = Request(num_tokens=LONG, slo=60.0, task_type="file",
                    arrival=time.monotonic())
        inst.submit_request(A, a_tokens)
        deadline = time.monotonic() + TIMEOUT
        while A.state != RequestState.RUNNING and A.first_token_time is None:
            if time.monotonic() > deadline:
                raise RuntimeError("request A never started")
            time.sleep(0.001)
        time.sleep(delay)
        B = Request(num_tokens=SHORT, slo=1.0, task_type="text",
                    arrival=time.monotonic())
        inst.submit_request(B, rng.integers(0, cfg.vocab_size, SHORT))
        if not inst.drain(TIMEOUT):
            raise RuntimeError(f"drain timed out after {TIMEOUT} s")
        done = {t.head.rid: t for t in inst.completed_tasks}
        a_task = done[A.rid].prefill_task
        # exactness: preempted-and-resumed A == uninterrupted run
        solo = ex.run_all(ex.start(a_tokens[None]))
        return {
            "a": A, "b": B, "delay": delay,
            "blocking_mean": inst.blocking_stats.mean,
            "blocking_max": inst.blocking_stats.max,
            "preemptions": len(inst.blocking_stats.samples),
            "rounds": inst.scheduling_rounds,
            "segments": a_task.total_segments,
            "a_logits": a_task.logits, "solo_logits": solo,
            "bit_exact": torch.equal(a_task.logits, solo),
        }
    finally:
        inst.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-config", action="store_true",
                    help="--arch at its published width in bf16")
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== FlowPrefill quickstart (operator-level preemption) ==")
    cfg = config(args.full_config, args.arch)
    params = draw_params(cfg, args.device, args.seed)
    ex, profile, pred = setup(params, cfg)
    for n, t in profile.items():
        print(f"  profile: {n:5d} tokens -> {t*1e3:7.1f} ms")
    res = walkthrough(params, cfg, ex, pred)
    A, B = res["a"], res["b"]
    print(f"\n  A (file, {LONG} tok, SLO 60s) submitted; "
          f"B (text, {SHORT} tok, SLO 1s) arrives {res['delay']:.3f}s "
          f"after A starts")
    print(f"  B TTFT = {B.ttft:.3f}s  (SLO met: {B.slo_met})")
    print(f"  A TTFT = {A.ttft:.3f}s  (SLO met: {A.slo_met})")
    print(f"  preemption blocking time = {res['blocking_mean']*1e3:.1f} ms "
          f"(max {res['blocking_max']*1e3:.1f} ms, "
          f"{res['preemptions']} preemption(s))")
    print(f"  scheduling rounds = {res['rounds']} "
          f"(<= 2 per request: event-driven)")
    print(f"  preempt/resume bit-exact vs uninterrupted: {res['bit_exact']}")
    return res


if __name__ == "__main__":
    main()
