"""What the program's span tracer costs on the card, in two modes.

A window: one untraced run of a cell (`harness.main.run`, as `--trace 0`
runs it) with the program's tracer off, or on from the window's opening to
its drain, enabled by this tool and not by the harness. Prints the cell's
end-to-end metrics, and with the tracer on the spans recorded by name and
the bytes they hold:

    python3 bench/tools/tracer_cost.py --workload qwen2.5-3b.sharegpt \\
        --seed 7 --seconds 51 --tracer 1

Segments: the host time of one operator segment of the cell's model,
tracer off and on in turns, 8 prefills each (a lone prefill of `--tokens`
tokens, stepped from Python and timed on the host clock, so a short prompt
times the host alone), and the time of one `tracing.record` call and of
the clock and thread-id calls it could make:

    python3 bench/tools/tracer_cost.py --workload qwen2.5-3b.sharegpt \\
        --seed 7 --segments --tokens 64

Run from the root of a checkout, on the card. One JSON line on standard
output.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parents[2]
# the kernels' build caches of bench/run.py
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def _bytes(span) -> int:
    """The memory one span holds: the object, its fields and attributes."""
    parts = [span, span.__dict__, span.attrs, span.name]
    parts += list(span.attrs.keys()) + list(span.attrs.values())
    return sum(sys.getsizeof(p) for p in parts)


def window(args) -> dict:
    from harness import main, serve
    from repro_torch import tracing
    recorded = {}
    if args.tracer:
        offer = serve.offer

        def traced(*a, **k):
            tracing.enable()
            t0 = time.monotonic()
            try:
                return offer(*a, **k)
            finally:
                got = tracing.take()
                recorded.update(spans=got, seconds=time.monotonic() - t0)
        serve.offer = traced
    out = main.run(ROOT, args.workload, args.seed, args.seconds, False,
                   args.device, T_START)
    res = {"tracer": args.tracer, "correct": out["correct"],
           "attempted": out["attempted"], "failed": out["failed"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
    if args.tracer:
        got = recorded["spans"]
        by = {}
        for s in got:
            by[s.name] = by.get(s.name, 0) + 1
        size = sum(_bytes(s) for s in got)
        res.update(spans=len(got), by_name=by, span_bytes=size,
                   bytes_per_span=size / max(len(got), 1),
                   recorded_s=recorded["seconds"])
    return res


def segments(args) -> dict:
    import numpy as np
    import torch

    from harness import deploy, files
    from repro_torch import tracing
    from repro_torch.models.segments import SegmentedPrefill
    cell = files.load(ROOT, args.workload)
    spec = cell.config
    cfg = deploy.model_config(spec)
    dtype = getattr(torch, spec["torch_dtype"])
    dev = torch.device(args.device)
    params = deploy.draw_weights(cfg, args.seed, dev, dtype)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dep = spec["deployment"]
    ex = SegmentedPrefill(params, cfg, max_seq=args.tokens,
                          granularity=dep["granularity"],
                          chunk_tokens=dep["chunk_tokens"], cache_dtype=dtype)
    prompt = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, args.tokens)[None]

    def host_us_per_segment() -> float:
        task = ex.start(prompt)
        sync()
        t0 = time.perf_counter()
        while not task.done:
            ex.step(task)
        t = time.perf_counter() - t0
        sync()
        return t / task.total_segments * 1e6

    for _ in range(3):
        host_us_per_segment()                         # builds and warms
    off, on, spans = [], [], []
    for i in range(16):
        if i % 4 in (1, 2):                           # off, on, on, off
            tracing.enable()
            on.append(host_us_per_segment())
            spans += tracing.take()
        else:
            off.append(host_us_per_segment())
    n = 100000

    def per_call_us(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6
    prims = {"monotonic_us": per_call_us(time.monotonic),
             "native_id_us": per_call_us(threading.get_native_id),
             "ident_us": per_call_us(threading.get_ident)}
    tracing.enable()
    t0 = time.perf_counter()
    for _ in range(n):
        tracing.record("segment", t0, t0, cause=1, op="attn", layer=0,
                       chunk=0)
    record_us = (time.perf_counter() - t0) / n * 1e6
    tracing.take()
    t0 = time.perf_counter()
    for _ in range(n):
        if tracing.on:
            pass
    t1 = time.perf_counter()
    for _ in range(n):
        pass
    check_us = ((t1 - t0) - (time.perf_counter() - t1)) / n * 1e6
    seg = [s.end - s.start for s in spans if s.name == "segment"]
    return {"tokens": args.tokens, "segments": ex.segments_for(args.tokens),
            "host_us_per_segment_off": off, "host_us_per_segment_on": on,
            "median_off": statistics.median(off),
            "median_on": statistics.median(on),
            "segment_span_us_p50": statistics.median(seg) * 1e6,
            "record_us": record_us, "off_check_us": check_us, **prims,
            "device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu"}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=0)
    ap.add_argument("--segments", action="store_true")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = segments(args) if args.segments else window(args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
