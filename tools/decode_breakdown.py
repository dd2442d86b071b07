"""Where the time of the split-KV decode/verify body goes on the card.

Runs `flash_decode_attention` and `flash_verify_attention` at the Llama3-8B
main-path shapes (H 32, K 8, hd 128, T 4096, bf16), L2-cold: the calls
rotate over distinct K/V sets that together read at least twice the 50 MB
L2. For each shape it prints the mean time per call from CUDA events (50
calls queued behind a spin of the card, after 5 warm-up calls) and, from
`torch.profiler` over the same calls, the device time per call of each of
the two kernels (the split body and its combine kernel); the rest is the
gap between them and between calls.

    python3 tools/decode_breakdown.py        # needs a CUDA card and nvcc

Prints the card's name and power limit first.
"""
from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

H, K, HD, T = 32, 8, 128, 4096
SHAPES = [  # label, S (0: decode), per-row kv_len
    ("decode B1len1", 0, [1]),
    ("decode B1", 0, [3000]),
    ("decode B4ragged", 0, [1, 1000, 2600, 4096]),
    ("verify B4S5ragged", 5, [1, 1000, 2600, 4091]),
]
ITERS = 50


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attn import (flash_decode_attention,
                                                 flash_verify_attention)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, S, lens in SHAPES:
        B = len(lens)
        keys = sum(min(n + S, T) for n in lens) if S else sum(lens)
        nbytes = 2 * keys * K * HD * 2
        n_sets = max(2, math.ceil(2 * 50e6 / nbytes))
        n_sets = min(n_sets, ITERS)
        shape = (B, T, K, HD)
        sets = [(torch.randn(shape, generator=gen, device=dev,
                             dtype=torch.bfloat16),
                 torch.randn(shape, generator=gen, device=dev,
                             dtype=torch.bfloat16)) for _ in range(n_sets)]
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        if S:
            q = torch.randn((B, S, H, HD), generator=gen, device=dev,
                            dtype=torch.bfloat16)

            def call(k, v):
                return flash_verify_attention(q, k, v, lens_t)
        else:
            q = torch.randn((B, H, HD), generator=gen, device=dev,
                            dtype=torch.bfloat16)

            def call(k, v):
                return flash_decode_attention(q, k, v, lens_t)

        def run(n):
            for i in range(n):
                call(*sets[i % n_sets])

        run(5)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        run(ITERS)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / ITERS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(20_000_000)
            run(ITERS)
            torch.cuda.synchronize()
        parts = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = next((n for n in ("split_kernel", "combine_kernel")
                         if n in e.key), None)
            if name:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                parts.append(f"{name} {us / 1e3 / e.count:.5f} ms x{e.count}")
        print(f"{label}: {ms:.5f} ms a call over {n_sets} K/V sets "
              f"({n_sets * nbytes / 1e6:.1f} MB a pass); "
              f"{'; '.join(parts) or 'device time not measured'}",
              flush=True)
        del sets


if __name__ == "__main__":
    main()
