"""One run of one cell: set-up, the measured window, the metrics, the
correctness check, and the result line.

`run` takes the device it is given (the tests drive it on the CPU); `main`
is the command line, which insists on the cards the cell asks for.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from harness import check, deploy, files, serve, stats, traffic
from harness.trace import Profile, Trace

# top-level module names that may not be loaded in the process that prints
# a result: JAX and the JAX package of this repository
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What the metric readers read (bench/metrics/*.py)."""
    seconds: float                    # the window's length
    setup_s: float
    cfg: object                       # the port's ModelConfig
    config: dict                      # the configuration file
    arch: object                      # its architecture's module
    chunk: int                        # prefill chunk, tokens
    es: int                           # bytes per element of the served dtype
    n: List[int]                      # prompt tokens of each request due
    slo: List[float]
    ttft: List[float]                 # +inf where no first token came
    busy: List[Tuple[float, float]]   # union of [due time, first token]
    blocking: List[float]             # preemption signal to suspension, s
    trace: Optional[Trace]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> dict:
    cell = files.load(root, workload)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # the router's products
    arch = files.arch(cell.arch_dir, cell.config["reference"])
    cfg = deploy.model_config(cell.config, arch)
    dtype = getattr(torch, cell.config["torch_dtype"])
    params = deploy.draw_weights(cfg, seed, dev, dtype)
    slos = cell.config["ttft_slo_s"]
    items = traffic.schedule(cell.traffic_dir, cell.mix,
                             cell.cell["rate_rps"], seconds, seed, slos,
                             cfg.vocab_size)
    budget = cell.cell["check"]
    picked = check.sample([it.n for it in items], seed,
                          budget["requests"], budget["tokens"])
    reqs = serve.requests(items)
    want = {reqs[i].rid for i in picked}
    capture = serve.Capture(want=want, kv_layers=check.kv_layers(
        cfg.num_layers), handoff=arch.HANDOFF)
    dep = deploy.build(cfg, params, cell.config, cell.mix["max_seq"])
    serve.attach(dep, capture)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof = Profile() if trace else None
    t_open = time.monotonic()
    setup_s = t_open - t_start
    tasks = {it.task for it in items}
    wait_cap = 4.0 * max(slos[t] for t in tasks)
    win = serve.offer(dep, items, reqs, seconds, wait_cap, t_open)
    dep.proxy.drain(timeout=max(wait_cap, 10.0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    device_info = _device_info(dev, cell.chips)
    tr = prof.stop() if prof is not None else None
    if tr is not None:
        log(f"trace: {len(tr.ops_name)} device operations, "
            f"{len(tr.host_name)} host-side events")
    blocking = list(dep.prefill.blocking_stats.samples)
    served = {r.rid: dep.decode.outputs[r.rid][0]
              for r in win.requests if r.rid in dep.decode.outputs}
    dep.shutdown()
    del dep
    gc.collect()

    late = np.asarray(win.lateness)
    log(f"generator lateness: max {late.max():.6f} s, p99 "
        f"{np.percentile(late, 99):.6f} s, mean {late.mean():.6f} s over "
        f"{len(late)} submits")
    ttft = [r.ttft if r.ttft is not None else math.inf for r in win.requests]
    waited = [t if math.isfinite(t) else win.t_end - r.arrival
              for t, r in zip(ttft, win.requests)]
    busy = stats.union((r.arrival, r.arrival + w)
                       for r, w in zip(win.requests, waited))
    run_ = Run(seconds=seconds, setup_s=setup_s, cfg=cfg, config=cell.config,
               arch=arch, chunk=cell.config["deployment"]["chunk_tokens"],
               es=dtype.itemsize, n=[r.num_tokens for r in win.requests],
               slo=[r.slo for r in win.requests], ttft=ttft, busy=busy,
               blocking=blocking, trace=tr)
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = files.reader(cell.metrics_dir, m["name"])(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for t in ttft if not math.isfinite(t))
    log(f"{len(items)} requests due in {seconds} s, {failed} without a first "
        f"token {wait_cap} s past the close; last first token "
        f"{win.t_end - win.t_close:.3f} s past the close; preemptions "
        f"{len(blocking)}")

    # --- correctness: the sampled requests that were served -------------
    t_ref = time.monotonic()
    done = [i for i in picked if reqs[i].rid in served
            and reqs[i].rid in capture.logits]
    values = {name: None for name in check.NUMBERS}
    if done:
        forward = files.reference(cell)
        prompts = [torch.as_tensor(items[i].tokens) for i in done]
        ref_logits, ref_kv = forward(deploy.plain_weights(params), cell.config,
                                     prompts, kv_layers=capture.kv_layers)
        values = check.readings(
            ref_logits, ref_kv, [served[reqs[i].rid] for i in done],
            [capture.logits[reqs[i].rid] for i in done],
            [capture.kv[reqs[i].rid] for i in done],
            each=cell.cell.get("each"))
        diag = values.pop("diagnostics")
        log(f"check readings {json.dumps(values)} {json.dumps(diag)}")
    limits = cell.cell["limits"]
    correct = bool(done) and check.judge(values, limits)
    log(f"reference over {len(done)} of {len(picked)} sampled requests "
        f"({sum(items[i].n for i in done)} prompt tokens) in "
        f"{time.monotonic() - t_ref:.1f} s")
    out = {"correct": correct, "attempted": len(items), "failed": failed,
           "metrics": metrics, "device": device_info}
    if tr is not None:
        out["device"]["busy_s"] = stats.length(tr.busy())
        out["device"]["window_s"] = tr.t_stop - tr.t_start
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(busy, 10)}
    out["checks"] = {k: {"value": values[k], "limit": limits[k]}
                     for k in limits}
    return out


def main(argv, t_start: float, root: Path) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = files.load(root, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run(root, args.workload, args.seed, args.seconds, bool(args.trace),
              "cuda", t_start)
    found = forbidden_modules()
    if found:
        log(f"loaded in the process that measured: {found}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0
