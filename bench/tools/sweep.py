"""Find a cell's knee on the card: one deployment, then a window at each
rate in turn, with the cell's end-to-end numbers at each.

    python3 bench/tools/sweep.py --workload qwen2.5-3b.qwentrace \
        --rates 2,4,6,8 --seconds 30 --seed 5

A rate is sustained where ttft_slo_ratio_p90 <= 1, no request went without
a first token, and the backlog did not grow (the last first token within
the mix's largest SLO of the window's close). The knee is the highest such
rate; a cell runs at 0.8 x knee (bench/cells/<cell>.json). One JSON line
per rate.
"""
import argparse
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import torch  # noqa: E402

from harness import deploy, files, serve, stats, traffic  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = files.load(ROOT, args.workload)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = deploy.model_config(cell.config)
    params = deploy.draw_weights(cfg, args.seed, dev,
                                 getattr(torch, cell.config["torch_dtype"]))
    dep = deploy.build(cfg, params, cell.config, cell.mix["max_seq"])
    serve.attach(dep, serve.Capture(want=set(), kv_layers=()))
    print(json.dumps({"profile": dep.profile}), flush=True)
    slos = cell.config["ttft_slo_s"]
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            items = traffic.schedule(cell.traffic_dir, cell.mix, rate,
                                     args.seconds, args.seed, slos,
                                     cfg.vocab_size)
            cap = 4.0 * max(slos[it.task] for it in items)
            reqs = serve.requests(items)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            pre = len(dep.prefill.blocking_stats.samples)
            win = serve.offer(dep, items, reqs, args.seconds, cap,
                              time.monotonic())
            dep.proxy.drain(timeout=max(cap, 10.0))
            ttft = [r.ttft if r.ttft is not None else math.inf for r in reqs]
            ratio = stats.percentile(
                [t / r.slo for t, r in zip(ttft, reqs)], 90)
            failed = sum(1 for t in ttft if not math.isfinite(t))
            drain = win.t_end - win.t_close
            print(json.dumps({
                "rate_rps": rate, "requests": len(reqs), "failed": failed,
                "goodput_rps": stats.goodput(ttft, [r.slo for r in reqs],
                                             args.seconds),
                "ttft_slo_ratio_p90": ratio if math.isfinite(ratio) else None,
                "ttft_p50_ms": stats.percentile(ttft, 50) * 1e3
                if math.isfinite(stats.percentile(ttft, 50)) else None,
                "drain_s": drain,
                "preemptions": len(dep.prefill.blocking_stats.samples) - pre,
                "sustained": bool(failed == 0 and ratio <= 1.0
                                  and drain <= max(slos[it.task]
                                                   for it in items)),
                "memory_peak_gib": torch.cuda.max_memory_allocated(dev)
                / 2 ** 30 if dev.type == "cuda" else 0.0}), flush=True)
    finally:
        dep.shutdown()


if __name__ == "__main__":
    main()
