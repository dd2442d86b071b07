#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # phases 1-3 only (build, kernels, model)
    python3 chip_smoke.py --ptxas    # also print nvcc's per-kernel resources

Phases; the first failure exits non-zero and prints no result:

 1. device: the card's name and power limit (nvidia-smi); build both CUDA
    kernels from `src/repro_torch/kernels/csrc/` with nvcc (timed).
 2. kernels: each kernel against its plain PyTorch version on the card, on the
    reference's test shapes and the Llama3-8B main-path shapes, in f32 (every
    element within 2e-5) and bf16 (every element within 1e-5 + 1.6e-2 times
    the plain value); at the main-path shapes in bf16 the kernel, the plain
    version and one `F.scaled_dot_product_attention` call (a yardstick the
    port never calls) are timed with CUDA events, beside the least time the
    card could take (bytes over 3.35 TB/s or operations over 989 TFLOP/s,
    the larger).
 3. model: the tiny Llama3-8B config in f32, prefill logits and a ragged
    decode step on the card against the same functions on the CPU (2e-4).
 4. deployment: `repro_torch.launch.serve.build` at Llama3-8B's published
    width in bf16 with random weights, and its TTFT profile.
 5. preemption: a 2048-token prompt at operator granularity, suspended at
    three operator boundaries with another prefill run in between, resumed;
    the first-token logits must be bit-equal to an uninterrupted run.
 6. serve: `serve_trace` over the launcher's mix (6 requests, 8 decode tokens
    each, decode batch 4); launch counters are zeroed just before, and both
    kernels must have launched while no plain version ran. If the mix did not
    make the scheduler preempt, one long and then one short request force it.
 7. time breakdown (measurement, no check): `torch.profiler` over one
    4096-token prefill and one batched decode step, device time by kernel
    and the device's idle share.

The line before the last holds the kernels' record; the last line is
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA's data sheet
PEAK_BF16_OPS = 989e12                    # dense bf16 tensor-core rate
# per-element limit atol + rtol*|plain|: f32 at the reference's 2e-5
# (tests/test_kernels.py:21) held as an absolute bound; bf16 at
# torch.testing's bf16 pair, which allows one bf16 rounding step of the
# output (2^-7 relative) and no more
TOL = {"torch.float32": (2e-5, 0.0), "torch.bfloat16": (1e-5, 1.6e-2)}

# the reference's kernel test shapes (tests/test_kernels.py:26,94) and the
# tiny configs' head dims
PREFILL_CASES = [
    # B, Sq, T, H, K, hd, q_offset, kv_len, causal, window
    (1, 128, 128, 4, 4, 64, 0, 128, True, 0),
    (2, 64, 256, 8, 2, 64, 192, 256, True, 0),
    (1, 100, 300, 4, 1, 128, 200, 300, True, 0),
    (2, 128, 384, 4, 2, 64, 256, 384, True, 128),
    (1, 32, 160, 4, 4, 64, 0, 160, False, 0),
    (1, 8, 512, 16, 8, 64, 504, 512, True, 0),
    (2, 48, 64, 4, 2, 32, 0, 48, True, 0),
    (1, 40, 96, 4, 2, 16, 56, 96, True, 0),
]
DECODE_CASES = [
    # B, T, H, K, hd, per-row kv_len
    (1, 256, 8, 8, 64, [256]),
    (2, 512, 8, 2, 64, [300, 300]),
    (4, 128, 4, 1, 128, [77, 77, 77, 77]),
    (1, 1024, 16, 8, 64, [1000]),
    (4, 256, 4, 2, 32, [1, 77, 256, 130]),
]
# Llama3-8B main path: H 32, K 8, hd 128, a 4096-token cache per layer
LLAMA_PREFILL = [
    # label, Sq, q_offset, kv_len
    ("chunk512@0", 512, 0, 512),
    ("chunk512@3584", 512, 3584, 4096),
    ("tail100@2048", 100, 2048, 2148),
]
LLAMA_DECODE = [
    # label, per-row kv_len
    ("B1", [3000]),
    ("B1len1", [1]),
    ("B4ragged", [1, 1000, 2600, 4096]),
]
MAIN_PREFILL, MAIN_DECODE = "chunk512@3584", "B4ragged"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of `fn` on the card from CUDA events around `iters` calls
    (after `warmup` calls; the inputs stay in L2 where they fit)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops_count: float, nbytes: float):
    """Least time (ms) of a bf16 call, and which of bytes or operations
    sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_count / PEAK_BF16_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def breakdown(torch, label, fn, top: int = 6) -> None:
    """Profile one call of `fn` (after a warm-up call): wall time to a
    synchronise, device time summed over the CUDA kernels, the device's idle
    share of the wall time, and the kernels that took the most device time.
    Prints "not measured" where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    kern = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kern.append((us, e.count, e.key))
    busy = sum(us for us, _, _ in kern)
    print(f"{label}: wall {wall_us / 1e3:.2f} ms under the profiler")
    if busy <= 0:
        print("  device time not measured: the profiler recorded no kernel")
        return
    print(f"  kernels {busy / 1e3:.2f} ms, device idle share "
          f"{max(0.0, 1 - busy / wall_us):.3f}")
    for us, n, key in sorted(kern, reverse=True)[:top]:
        print(f"  {us / 1e3:9.2f} ms {100 * us / busy:5.1f}% x{n:<5} "
              f"{key[:90]}")


def prefill_work(B, Sq, H, K, hd, q_offset, kv_len, es):
    """Operations and bytes a causal chunk needs: 4*hd per visible (query,
    key) pair and head; q and o once, the keys below the last visible one
    of k and v once."""
    pairs = sum(max(0, min(kv_len, q_offset + i + 1)) for i in range(Sq))
    keys = min(kv_len, q_offset + Sq)
    ops_count = 4.0 * hd * H * B * pairs
    nbytes = es * B * (2 * Sq * H * hd + 2 * keys * K * hd)
    return ops_count, nbytes


def decode_work(H, K, hd, lens, es):
    ops_count = 4.0 * hd * H * sum(lens)
    nbytes = es * (2 * len(lens) * H * hd + 2 * sum(lens) * K * hd)
    return ops_count, nbytes


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the model phase (no result line)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v resource usage")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs.base import get_tiny_config
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.decode_attn import flash_decode_attention
        from repro_torch.kernels.flash_prefill import flash_prefill_attention
        from repro_torch.launch.serve import build as build_deployment
        from repro_torch.launch.serve import serve_trace
        from repro_torch.models.model import decode_step_ragged
        from repro_torch.models.segments import SegmentedPrefill
        from repro_torch.params import init_params
    except ImportError as exc:
        fail(f"the port is not importable from {ROOT / 'src'}: {exc}")
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core import Request, RequestState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.monotonic()

    # --- 1. device and build ------------------------------------------------
    phase("1. device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.monotonic()
    try:
        libs = build.build(verbose=args.ptxas)
    except RuntimeError as exc:
        fail(f"kernel build: {exc}")
    print(f"built {sorted(libs)} in {time.monotonic() - t0:.1f} s "
          f"into {build.BUILD_DIR}", flush=True)

    # --- 2. kernels against their plain versions ----------------------------
    phase("2. kernels against their plain versions on the card")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(name, dtype, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name}: {tuple(got.shape)} {got.dtype} vs plain "
                 f"{tuple(want.shape)} {want.dtype}")
        if not torch.isfinite(got.float()).all():
            fail(f"{name}: non-finite output")
        atol, rtol = TOL[str(dtype)]
        diff = (got.float() - want.float()).abs()
        limit = atol + rtol * want.float().abs()
        err = diff.max().item()
        worst = (diff / limit).max().item()    # <= 1: every element inside
        ok = worst <= 1.0
        print(f"{name:<44} {str(dtype)[6:]:>8} max_abs_err {err:.3e} "
              f"max|plain| {want.float().abs().max().item():.3e} limit "
              f"{atol:.0e}+{rtol:.1e}*|plain| worst/limit {worst:.3f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name}: an element is {worst:.3f} times its limit "
                 f"{atol}+{rtol}*|plain| (max abs error {err})")
        return err

    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in PREFILL_CASES:
            B, Sq, T, H, K, hd, qoff, kv_len, causal, window = case
            q, k, v = randn((B, Sq, H, hd), dtype), randn((B, T, K, hd), dtype), \
                randn((B, T, K, hd), dtype)
            got = flash_prefill_attention(q, k, v, qoff, kv_len,
                                          causal=causal, local_window=window)
            want = ref.chunked_prefill_attention_ref(
                q, k, v, q_offset=qoff, kv_len=kv_len, causal=causal,
                local_window=window)
            check(f"prefill {case}", dtype, got, want)
        for case in DECODE_CASES:
            B, T, H, K, hd, lens = case
            q, k, v = randn((B, H, hd), dtype), randn((B, T, K, hd), dtype), \
                randn((B, T, K, hd), dtype)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            check(f"decode {case}", dtype,
                  flash_decode_attention(q, k, v, lens_t),
                  ref.decode_attention_ref(q, k, v, kv_len=lens_t))

    H, K, hd, T = 32, 8, 128, 4096
    print("\nLlama3-8B main-path shapes (H 32, K 8, hd 128, T 4096); "
          "times in ms, CUDA events, 20 calls after 3 warm-up calls")
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        for label, Sq, qoff, kv_len in LLAMA_PREFILL:
            q = randn((1, Sq, H, hd), dtype)
            k, v = randn((1, T, K, hd), dtype), randn((1, T, K, hd), dtype)
            name = f"flash_prefill_attention {label}"
            err = check(name, dtype,
                        flash_prefill_attention(q, k, v, qoff, kv_len),
                        ref.chunked_prefill_attention_ref(
                            q, k, v, q_offset=qoff, kv_len=kv_len))
            if dtype != torch.bfloat16:
                continue
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            qpos = qoff + torch.arange(Sq, device=dev)[:, None]
            kpos = torch.arange(T, device=dev)[None, :]
            mask = (kpos <= qpos) & (kpos < kv_len)
            row = dict(
                ms=cuda_ms(torch, lambda: flash_prefill_attention(
                    q, k, v, qoff, kv_len)),
                plain_ms=cuda_ms(torch, lambda: ref.chunked_prefill_attention_ref(
                    q, k, v, q_offset=qoff, kv_len=kv_len), iters=5),
                library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)),
                max_abs_err=err)
            row["bound_ms"], row["bound_by"] = bound(
                *prefill_work(1, Sq, H, K, hd, qoff, kv_len, es))
            record[name] = row
            print(f"  {name}: {json.dumps(row)}", flush=True)
        for label, lens in LLAMA_DECODE:
            B = len(lens)
            q = randn((B, H, hd), dtype)
            k, v = randn((B, T, K, hd), dtype), randn((B, T, K, hd), dtype)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            name = f"flash_decode_attention {label}"
            err = check(name, dtype, flash_decode_attention(q, k, v, lens_t),
                        ref.decode_attention_ref(q, k, v, kv_len=lens_t))
            if dtype != torch.bfloat16:
                continue
            qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            mask = (torch.arange(T, device=dev)[None, :]
                    < lens_t[:, None])[:, None, None, :]
            row = dict(
                ms=cuda_ms(torch, lambda: flash_decode_attention(
                    q, k, v, lens_t)),
                plain_ms=cuda_ms(torch, lambda: ref.decode_attention_ref(
                    q, k, v, kv_len=lens_t), iters=5),
                library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)),
                max_abs_err=err)
            row["bound_ms"], row["bound_by"] = bound(
                *decode_work(H, K, hd, lens, es))
            record[name] = row
            print(f"  {name}: {json.dumps(row)}", flush=True)

    # --- 3. tiny model, card against CPU -------------------------------------
    phase("3. tiny Llama3-8B config in f32: card against CPU")
    cfg = get_tiny_config("llama3_8b")
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 72))
    out = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        ex = SegmentedPrefill(params, cfg, max_seq=128, chunk_tokens=32)
        task = ex.start(toks, lens=[72, 50])
        logits = ex.run_all(task)
        kc, vc = task.state["k_cache"], task.state["v_cache"]
        lens = torch.tensor([72, 50], device=params.device)
        dlog, k_new, _ = decode_step_ragged(
            params, cfg, logits.argmax(-1), kc, vc, lens)
        out[where] = [x.detach().cpu() for x in (logits, dlog, k_new)]
    for name, a, b in zip(("prefill logits", "decode logits", "decode k_new"),
                          out["cpu"], out["cuda"]):
        err = (a - b).abs().max().item()
        print(f"{name:<16} card vs cpu max_abs_err {err:.3e} tol 2e-4")
        if not err <= 2e-4:
            fail(f"tiny model {name}: card and CPU differ by {err}")
    del p_cpu, p_gpu
    if args.quick:
        print(f"\n--quick: stopped after phase 3 "
              f"({time.monotonic() - t_start:.1f} s)")
        return

    # --- 4. deployment at full width -----------------------------------------
    phase("4. deployment: Llama3-8B, published width, bf16, random weights")
    t0 = time.monotonic()
    dep = build_deployment(full_config=True, max_seq=4096, chunk=512,
                           decode_tokens=8, decode_max_batch=4, seed=0,
                           device="cuda")
    cfg = dep.cfg
    n_params = sum(p.numel() for p in dep.params.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B params in {dep.params.dtype}")
    print("TTFT profile (s, synchronised):",
          json.dumps({n: round(t, 4) for n, t in dep.profile.items()}))
    print(f"build + profile {time.monotonic() - t0:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    try:
        # --- 5. operator-level preemption, bit-exact -------------------------
        phase("5. suspend/resume at operator boundaries, full width")
        ex = dep.executor
        prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                   (1, 2048))
        other = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                  (1, 300))
        want = ex.run_all(ex.start(prompt))
        task = ex.start(prompt)
        stops = [int(task.total_segments * f) for f in (0.1, 0.45, 0.8)]
        for stop in stops:
            while task.cursor < stop:
                ex.step(task)
            ex.run_all(ex.start(other))          # another prefill meanwhile
        got = ex.run_all(task)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        print(f"{task.total_segments} segments, suspended at {stops}: "
              f"logits {tuple(got.shape)} finite "
              f"{bool(torch.isfinite(got.float()).all())} bit-equal {equal}")
        if not equal:
            fail("resumed prefill differs from the uninterrupted run: max "
                 f"abs diff {(got.float() - want.float()).abs().max().item()}")

        # --- 6. serve ---------------------------------------------------------
        phase("6. serve the launcher's mix")
        ops.reset_counts()
        rep = serve_trace(dep, requests=6, seed=0)
        forced = False
        if rep["preemptions"] == 0:
            forced = True
            rng = np.random.default_rng(3)
            long_req = Request(num_tokens=4096, slo=25.0, task_type="file",
                               arrival=time.monotonic())
            dep.proxy.submit(long_req, rng.integers(0, cfg.vocab_size, 4096))
            deadline = time.monotonic() + 120.0
            while long_req.state != RequestState.RUNNING \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            short_req = Request(num_tokens=256, slo=1.5, task_type="text",
                                arrival=time.monotonic())
            dep.proxy.submit(short_req, rng.integers(0, cfg.vocab_size, 256))
            if not dep.proxy.drain(600.0):
                fail("drain timed out after the forced preemption pair")
        counts = ops.counts()
        report = dep.proxy.report()
        n_req = len(dep.proxy.requests)
        decoded = len(dep.decode.finished)
        preemptions = len(dep.prefill.blocking_stats.samples)
        ttft = [r.ttft for r in dep.proxy.requests if r.ttft is not None]
        print(f"requests {n_req} (forced preemption pair: {forced}) "
              f"decoded {decoded} attainment {report['slo_attainment']:.3f} "
              f"by_task {json.dumps(rep['attainment_by_task'])}")
        print(f"TTFT s: mean {np.mean(ttft):.4f} p50 {np.median(ttft):.4f} "
              f"max {np.max(ttft):.4f}; rounds {report['scheduling_rounds']} "
              f"blocking_mean {report['blocking_mean'] * 1e3:.2f} ms "
              f"preemptions {preemptions} decode steps {dep.decode.steps} "
              f"shapes {dep.decode.compile_cache_size()}")
        steps = np.asarray(dep.decode.step_samples) * 1e3
        print(f"decode step ms (synchronised): p50 {np.median(steps):.2f} "
              f"p90 {np.percentile(steps, 90):.2f} max {steps.max():.2f}")
        print(f"launches since reset: {json.dumps(counts)}", flush=True)
        if decoded != n_req:
            fail(f"decoded {decoded} of {n_req} requests")
        for rid, toks_out in dep.decode.outputs.items():
            if len(toks_out) != 8 + 1 or not all(
                    0 <= t < cfg.vocab_size for t in toks_out):
                fail(f"request {rid}: bad decode output {toks_out}")
        if preemptions < 1:
            fail("the scheduler never preempted a prefill")
        for name in ("flash_prefill_attention", "flash_decode_attention"):
            if counts[name] <= 0:
                fail(f"{name} was not launched by the serve phase")
        for name in ("chunked_prefill_attention_ref", "decode_attention_ref"):
            if counts[name] != 0:
                fail(f"the plain {name} ran {counts[name]} times on the "
                     "serve path")

        # --- 7. where the time goes (measurement only) ------------------------
        phase("7. device time by kernel: one 4096-token prefill, one decode "
              "step (B 4)")
        toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 4096))
        breakdown(torch, "prefill 4096 (chunk 512, op granularity)",
                  lambda: ex.run_all(ex.start(toks)))
        L_, K_, hd_ = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        k_g = torch.zeros((L_, 4, 4096, K_, hd_), dtype=dep.params.dtype,
                          device=dev)
        v_g = torch.zeros_like(k_g)
        lens_t = torch.tensor([263, 1031, 2055, 4095], device=dev)
        step_toks = torch.tensor([1, 2, 3, 4], device=dev)
        breakdown(torch, "decode_step_ragged B 4, kv_len 263..4095",
                  lambda: decode_step_ragged(dep.params, cfg, step_toks,
                                             k_g, v_g, lens_t))
    finally:
        dep.shutdown()

    kernels = []
    for name, route, src, replaces, main in (
            ("flash_prefill_attention", "cuda",
             "src/repro_torch/kernels/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_prefill.py:105", MAIN_PREFILL),
            ("flash_decode_attention", "cuda",
             "src/repro_torch/kernels/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:207", MAIN_DECODE)):
        row = record[f"{name} {main}"]
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(f"\nall phases passed in {time.monotonic() - t_start:.1f} s")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
