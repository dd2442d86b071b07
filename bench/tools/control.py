"""The control of a cell's correctness limits, read on the card: the plain
reference the configuration names (bench/reference/), in float8
(fp8=True), put in the program's place, on the prompts a run of that seed
samples, against the float32 reference.

    python3 bench/tools/control.py --workload qwen2.5-3b.qwentrace \
        --seeds 101,102,103 --seconds 51

For each seed, one JSON line with every number harness/check.py reads of
the program (token_gap of the token the float8 logits put first), and each
prompt's logit error. A limit lies below the least of these over the
seeds.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import torch  # noqa: E402

from harness import check, deploy, files, traffic  # noqa: E402


def readings(cell, seed: int, seconds: float, device) -> dict:
    """The control's numbers for one seed, on that seed's weights and
    sampled prompts."""
    cfg = deploy.model_config(cell.config)
    params = deploy.draw_weights(cfg, seed, device,
                                 getattr(torch, cell.config["torch_dtype"]))
    items = traffic.schedule(cell.traffic_dir, cell.mix,
                             cell.cell["rate_rps"], seconds, seed,
                             cell.config["ttft_slo_s"], cfg.vocab_size)
    budget = cell.cell["check"]
    picked = check.sample([it.n for it in items], seed, budget["requests"],
                          budget["tokens"])
    prompts = [torch.as_tensor(items[i].tokens) for i in picked]
    layers = check.kv_layers(cfg.num_layers)
    weights = deploy.plain_weights(params)
    forward = files.reference(cell)
    ref_logits, ref_kv = forward(weights, cell.config, prompts,
                                 kv_layers=layers)
    low_logits, low_kv = forward(weights, cell.config, prompts,
                                 kv_layers=layers, fp8=True)
    out = check.readings(
        ref_logits, ref_kv, low_logits.argmax(-1).tolist(), list(low_logits),
        [{l: low_kv[(p, l)] for l in layers} for p in range(len(prompts))],
        each=cell.cell.get("each"))
    out.update(out.pop("diagnostics"))
    out.update(seed=seed, prompts=len(prompts),
               tokens=sum(items[i].n for i in picked))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = files.load(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        out = readings(cell, seed, args.seconds, torch.device(args.device))
        out["seconds"] = time.monotonic() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
