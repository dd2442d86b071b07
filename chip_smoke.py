#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # phases 1-3 only (build, kernels, model)
    python3 chip_smoke.py --ptxas    # also print nvcc's per-kernel resources

Phases; the first failure exits non-zero and prints no result:

 1. device: the card's name and power limit (nvidia-smi); build the CUDA
    sources of `src/repro_torch/kernels/csrc/` with nvcc, one process each,
    in parallel (timed). From the SASS (cuobjdump): the prefill kernel's
    tensor-core body must hold wgmma (HGMMA) and TMA load (UTMALDG)
    instructions; `decode_attn.cu` must hold the split-KV body and its
    combine kernel alone, every body with cp.async (LDGSTS), the bf16 ones
    with mma.sync (HMMA) and the f32 ones without. With --ptxas, the
    registers, spills and shared memory of those bodies.
 2. kernels: each of the three kernels (prefill, decode, speculative verify)
    against its plain PyTorch version on the card, on the reference's test
    shapes and the Llama3-8B main-path shapes, in f32 (every element within
    2e-5) and bf16 (every element within 1e-5 + 1.6e-2 times the plain
    value); each prefill call must run the body its dtype and head_dim
    select (the tensor-core body for bf16 at head_dim 64 or 128, by its
    launch counter); the verify kernel's column 0 must be bit-equal to the
    decode kernel at kv_len + 1; both wrappers must launch the one split-KV
    body (its counter). At the main-path shapes in bf16 the kernel, the
    plain version and one `F.scaled_dot_product_attention` call (a
    yardstick the port never calls) are timed with CUDA events (the calls
    queued behind a spin of the card, so host launch gaps are not timed),
    beside the least time the card could take (bytes over 3.35 TB/s or
    operations over 989 TFLOP/s, the larger). Decode, verify and the prefill
    of a fully cached prompt (one query row at q_offset 4095) are timed
    L2-cold: the calls rotate over distinct K/V sets that together read at
    least twice the 50 MB L2, and a reading under 0.95 of the bound fails
    as a measurement fault.
 3. model: the tiny Llama3-8B config in f32, prefill logits and a ragged
    decode step on the card against the same functions on the CPU (2e-4),
    one speculative-decoding run on the card whose tokens must equal the
    CPU's, and three concurrent requests through a `HybridInstance`
    (prefill and local decode on one worker) whose tokens must equal the
    CPU's, through the two kernels alone.
 4. deployment: `repro_torch.launch.serve.build` at Llama3-8B's published
    width in bf16 with random weights, and its TTFT profile.
 5. preemption: a 2048-token prompt at operator granularity, suspended at
    three operator boundaries with another prefill run in between, resumed;
    the first-token logits must be bit-equal to an uninterrupted run.
 6. serve: `serve_trace` over the launcher's mix (6 requests, 8 decode tokens
    each, decode batch 4); launch counters are zeroed just before, and both
    kernels must have launched while no plain version ran, every prefill
    launch on the tensor-core body and every decode launch on the split-KV
    body. If the mix did not
    make the scheduler preempt, one long and then one short request force it.
 7. time breakdown (measurement, no check): `torch.profiler` over one
    4096-token prefill and one batched decode step, device time by kernel
    and the device's idle share.
 8. speculative decoding at full width: four prefilled handoffs decode 16
    tokens each with the plain batched instance (the reference
    trajectories), then with `spec_decode=True, draft_k=4` under an oracle
    drafter (accepts everything), an adversarial one (accepts nothing and
    throttles) and the default n-gram drafter. Counters are zeroed before
    and read after each run: the verify kernel must launch once per layer
    and verify step, no plain version may run, the oracle must accept
    drafts, and every spec trajectory must equal the plain one unless the
    first differing token is an explained near-tie. For that, both runs
    are repeated with their logits recorded and must reproduce themselves;
    at that token the verify column may differ from the plain step by at
    most four bf16 steps at the logits' magnitude (4 * 2^-7 * max|logit|),
    and the plain step's top-2 gap may be no larger than that difference.
    Then, with the counters zeroed, `build(..., spec_decode=True)` serves a
    short run of the launcher's mix (the n-gram drafter), and must have run
    verify steps and launched the verify kernel once per layer and step;
    those launches are the verify kernel's count in the kernels' record.
 9. prefix sharing and KV tiers at full width: a `build(prefix_share=True)`
    deployment, and beside it a tiered `PrefillInstance` on its executor
    (64 HBM blocks of 128 tokens, 64 host, 64 disk). A 4096-token prompt A
    cold, then again: a hit of 4095 whose one-row prefill runs the
    tensor-core body once per layer, logits within 4 * 2^-7 * max|logit|
    of the cold run. A prompt sharing A's first 2048 tokens hits 2048 and
    resumes at q_offset 2048, within the same bound of its own cold run.
    A's 32 blocks are snapshotted, three fresh prompts push them into host
    and disk (none dropped) and reuse their HBM blocks; after the copy
    engine drains, every stored copy must equal the snapshot bit for bit
    (a view taken at demotion would hold the flood's KV). A again: the
    promoted blocks and the logits must be `torch.equal` to the snapshot
    and to the first full hit's. A corrupted host copy of the last flood's
    block 5: the promotion aborts with a drop, the prompt hits 640 and
    recomputes the rest within the bf16 bound of its cold run. It prints
    the copy jobs' times per block beside `promote_seconds`, `tier_stats`
    and `accounting()` (which must balance), then serves 6 requests of the
    launcher's mix through the deployment (templated prompts): prefix hits
    > 0, every prefill launch on the tensor-core body, no plain version;
    those launches are the prefill kernel's count in the kernels' record.
10. colocation at full width (fig24's real panel,
    benchmarks/fig24_colocation.py:110-197), on phase 9's weights: first
    `profile_step_times` at B 1/2/4, ctx 1024. A dedicated `DecodeInstance`
    decodes 4 streams x 32 tokens from 1024-token handoffs twice (warm-up,
    then measured); its median step sets the TBT SLO (5x) and the weave
    cadence (2x). A `HybridInstance` (chunk 512, budget 2048, decode batch
    4, no prefix sharing, a 128-block pool) prefills the same 4 prompts
    itself and decodes them; once all 4 are resident it takes 6
    prefill-only requests of 2048 tokens. Three such passes: a warm-up, one
    under `torch.profiler` (the device's idle share), one measured with the
    launch counters zeroed before it. Prints TBT p50/p90/max and SLO
    attainment of both instances and their ratio, the hybrid's rounds,
    decode steps, preemptions and the prefill-only TTFTs. Fails if the
    flood does not grow the pool or a block from before a growth differs
    from its snapshot, if `prefill_tc_kernel` (every prefill launch) or the
    split-KV body did not launch in the measured pass or a plain version
    ran, or if a stream's tokens differ from the dedicated instance's on
    the same prompt, unless phase 8's near-tie rule explains it (both
    runs' step logits are recorded as they run).

The line before the last holds the kernels' record: each kernel's launches
by path (each path's counters zeroed just before it ran) and their sum; the
last line is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA's data sheet
PEAK_BF16_OPS = 989e12                    # dense bf16 tensor-core rate
L2_BYTES = 50e6                           # H100 L2 cache
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
    ("resume1@4095", 1, 4095, 4096),            # a fully cached prompt
]
# timed L2-cold like decode: one query row reads the whole 16.8 MB of K/V
COLD_PREFILL = {"resume1@4095"}
LLAMA_DECODE = [
    # label, per-row kv_len
    ("B1", [3000]),
    ("B1len1", [1]),
    ("B4ragged", [1, 1000, 2600, 4096]),
]
VERIFY_CASES = [
    # B, S, T, H, K, hd, per-row kv_len (S 1/2/5/8, Qg 1/4/8, T % 32 != 0)
    (3, 5, 300, 8, 2, 64, [0, 37, 295]),
    (2, 1, 100, 8, 8, 128, [1, 99]),
    (2, 2, 77, 8, 1, 64, [0, 75]),
    (1, 5, 70, 64, 8, 128, [65]),
    (2, 5, 1100, 32, 8, 128, [1, 1000]),
    (4, 8, 129, 16, 2, 64, [0, 1, 64, 121]),    # 64 rows, the kernel's cap
    (2, 5, 45, 4, 2, 32, [0, 40]),
    (1, 5, 33, 4, 2, 16, [28]),
]
# label, per-row kv_len (B 4, S 5 = draft_k 4 + 1)
LLAMA_VERIFY = [("B4S5ragged", [1, 1000, 2600, 4091])]
MAIN_PREFILL, MAIN_DECODE, MAIN_VERIFY = \
    "chunk512@3584", "B4ragged", "B4S5ragged"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3, sets=None) -> float:
    """Mean time of `fn` on the card from CUDA events around `iters` calls
    (after `warmup` calls). Without `sets` the inputs stay in L2 where they
    fit; with them, call i is `fn(*sets[i % len(sets)])`. The card first
    spins for ~10 ms, so every call is queued before the first one runs and
    the events time the card, not the host's launch rate."""
    args = sets or [()]
    for i in range(warmup):
        fn(*args[i % len(args)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for i in range(iters):
        fn(*args[i % len(args)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotation(pool_k, pool_v, shape, nbytes):
    """Distinct K/V sets of `shape` carved from the two pools: enough that
    one pass over them reads twice the L2 (`nbytes` a call), or as many as
    the pools hold. Returns the sets and whether a pass reads that much."""
    n_el = math.prod(shape)
    n = min(pool_k.numel() // n_el, max(2, math.ceil(2 * L2_BYTES / nbytes)))
    sets = [(pool_k[i * n_el:(i + 1) * n_el].view(shape),
             pool_v[i * n_el:(i + 1) * n_el].view(shape)) for i in range(n)]
    return sets, n * nbytes >= 2 * L2_BYTES


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


BODIES = ("prefill_tc_kernel", "split_kernel", "combine_kernel")


def kernel_label(fn: str):
    """(body, dtype, head_dim) of a mangled kernel name of BODIES."""
    body = next(b for b in BODIES if b in fn)
    dtype = "f32" if re.search(r"IfLi\d+E", fn) else "bf16"
    return body, dtype, int(re.search(r"Li(\d+)E", fn).group(1))


def sass_counts(build, lib_path: str, ops_):
    """{kernel: {instruction: count}} over the SASS of a built library."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", lib_path],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()}")
    fn, counts = None, {}
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(ops_, 0)
        elif fn:
            for op in ops_:
                if op in line:
                    counts[fn][op] += 1
    return counts


def sass_report(build, libs) -> None:
    """The prefill kernel's tensor-core bodies must hold wgmma (HGMMA) and
    TMA loads (UTMALDG); `decode_attn.cu` must hold the split-KV body and
    its combine kernel alone (2 dtypes x 4 head dims each), every body with
    cp.async (LDGSTS), the bf16 bodies with mma.sync (HMMA) and the f32
    bodies without (no TF32)."""
    pre = {fn: c for fn, c in sass_counts(
        build, libs["flash_prefill"], ("HGMMA", "UTMALDG")).items()
        if "prefill_tc_kernel" in fn}
    for fn, c in sorted(pre.items()):
        print(f"SASS {kernel_label(fn)}: {json.dumps(c)}")
    if len(pre) != 2 or not all(n > 0 for c in pre.values()
                                for n in c.values()):
        fail("the tensor-core prefill bodies (hd 64, 128) lack HGMMA or "
             "UTMALDG instructions in their SASS")
    dec = sass_counts(build, libs["decode_attn"], ("HMMA", "LDGSTS"))
    for fn, c in sorted(dec.items(), key=lambda kv: kernel_label(kv[0])):
        print(f"SASS {kernel_label(fn)}: {json.dumps(c)}")
    split = [fn for fn in dec if "split_kernel" in fn]
    if len(split) != 8 or len(dec) != 16 or \
            sum("combine_kernel" in fn for fn in dec) != 8:
        fail(f"decode_attn.cu holds {sorted(dec)}, not the split body and "
             "its combine kernel alone")
    for fn in split:
        bf16 = kernel_label(fn)[1] == "bf16"
        if dec[fn]["LDGSTS"] == 0 or (dec[fn]["HMMA"] > 0) != bf16:
            fail(f"{kernel_label(fn)}: SASS {dec[fn]}; every body loads by "
                 "cp.async, and only the bf16 ones use mma.sync")


def ptxas_report(log: str, smem_bytes) -> None:
    """Registers, spills and dynamic shared memory of the bodies in BODIES,
    from nvcc's -Xptxas -v output; `smem_bytes(body, dtype, hd)` says the
    last."""
    fn, spills = None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            fn = fn if any(b in fn for b in BODIES) else None
        elif fn and "spill stores" in line:
            spills = line.strip()
        elif fn and "Used" in line:
            body, dtype, hd = kernel_label(fn)
            print(f"ptxas {body}<{dtype},{hd}>: "
                  f"{line.split(':', 1)[1].strip()}; {spills}; dynamic smem "
                  f"{smem_bytes(body, dtype, hd)}")


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


def verify_work(S, T, H, K, hd, lens, es):
    """Query s of row b sees keys [0, min(kv_len + s + 1, T)); q and o are
    read and written once, and each row's keys up to kv_len + S once."""
    pairs = sum(min(n + s + 1, T) for n in lens for s in range(S))
    keys = sum(min(n + S, T) for n in lens)
    ops_count = 4.0 * hd * H * pairs
    nbytes = es * (2 * len(lens) * S * H * hd + 2 * keys * K * hd)
    return ops_count, nbytes


def run_decode(port, params, cfg, handoffs, n_tokens, draft=None, **kw):
    """Decode `n_tokens` after each (first token, cache) handoff in one
    `DecodeInstance` (slot cap = number of handoffs). `draft(i, history, k)`
    drafts for handoff i. Every stream is submitted under the instance's
    condition variable, so all are admitted before the first step: each
    step then runs at the full batch, and a run's schedule and shapes do not
    depend on thread timing. Returns the instance and each stream's output
    record (first token, then the decoded tokens)."""
    reqs = [port.Request(num_tokens=int(c["pos"]), slo=100.0,
                         arrival=time.monotonic(), output_tokens=n_tokens,
                         tbt_slo=100.0) for _, c in handoffs]
    if draft is not None:
        index = {r.rid: i for i, r in enumerate(reqs)}
        kw["draft_fn"] = lambda rid, hist, k: draft(index[rid], hist, k)
    inst = port.DecodeInstance(params, cfg, decode_tokens=n_tokens,
                               decode_max_batch=len(handoffs), **kw)
    try:
        with inst._cv:
            for r, (first, cache) in zip(reqs, handoffs):
                inst.submit(port.DecodeJob(request=r, cache=dict(cache),
                                           first_token=first))
        drained = inst.drain(600.0)
    finally:
        inst.shutdown()
    if not inst.healthy:
        fail(f"decode worker failed: {inst.last_error!r}")
    if not drained:
        fail("decode instance did not drain in 600 s")
    return inst, [inst.outputs[r.rid] for r in reqs]


def oracle_drafter(trajectories):
    """Drafts the reference trajectory's next tokens: accepts everything."""
    def draft(i, history, k):
        done = len(history)                 # history starts at the first token
        return trajectories[i][done:done + k]
    return draft


def adversarial_drafter(trajectories, vocab):
    """Drafts one token that is never the greedy one: accepts nothing."""
    def draft(i, history, k):
        done = len(history)
        seq = trajectories[i]
        return [(seq[done] + 1) % vocab] if done < len(seq) else []
    return draft


def recorded_run(port, *args, **kw):
    """`run_decode` with the batched steps' logits recorded: returns the
    outputs and, per step, (kv_lens, logits (B, S, V)). The step functions
    are wrapped in the decode instance's module for this run only."""
    calls = []
    saved = port.decode_step_ragged, port.decode_verify_ragged

    def wrap(fn):
        def step(params, cfg, tokens, k_g, v_g, kv_lens):
            out = fn(params, cfg, tokens, k_g, v_g, kv_lens)
            lg = out[0] if out[0].dim() == 3 else out[0][:, None]
            calls.append((kv_lens.tolist(), lg))
            return out
        return step

    port.decode_step_ragged, port.decode_verify_ragged = map(wrap, saved)
    try:
        _, out = run_decode(port, *args, **kw)
    finally:
        port.decode_step_ragged, port.decode_verify_ragged = saved
    return out, calls


def logits_of(calls, pos, t):
    """Logits that produced output token t of the stream whose input token
    t - 1 sits at absolute position `pos`: the last step (in time) with a
    row whose span [start, start + S) holds pos, at column pos - start. The
    streams' prompt lengths lie far apart, so only one stream's row can."""
    for lens, lg in reversed(calls):
        for row, start in enumerate(lens):
            if start <= pos < start + lg.shape[1]:
                return lg[row, pos - start].float()
    raise LookupError(f"no step covered position {pos}")


def spec_phase(torch, np, port, ops, dep, cfg):
    """Phase 8's instance runs on the deployment's weights."""
    ex = dep.executor
    rng = np.random.default_rng(8)
    handoffs = []
    # longest first: the pool is sized on the first stream admitted, so all
    # four fit at once and every step runs at B = 4
    for n in (3000, 2000, 1000, 300):
        task = ex.start(rng.integers(0, cfg.vocab_size, (1, n)))
        first = int(ex.run_all(task).argmax(-1)[0])
        handoffs.append((first, {"k": task.state["k_cache"],
                                 "v": task.state["v_cache"], "pos": n}))
    n_tok = 16
    plain_inst, plain = run_decode(port, dep.params, cfg, handoffs, n_tok)
    steps = np.asarray(plain_inst.step_samples) * 1e3
    print(f"plain: {plain_inst.steps} steps, step p50 {np.median(steps):.2f} "
          f"ms, time per committed token {steps.sum() / n_tok:.2f} ms")
    near_ties = []
    for label, draft in (
            ("oracle", oracle_drafter(plain)),
            ("adversarial", adversarial_drafter(plain, cfg.vocab_size)),
            ("ngram", None)):
        kw = dict(draft=draft, spec_decode=True, draft_k=4)
        ops.reset_counts()
        inst, out = run_decode(port, dep.params, cfg, handoffs, n_tok, **kw)
        counts = ops.counts()
        steps = np.asarray(inst.step_samples) * 1e3
        rate = inst.draft_accepted / max(inst.draft_proposed, 1)
        print(f"{label}: spec_steps {inst.spec_steps} of {inst.steps} steps, "
              f"accept rate {rate:.3f} ({inst.draft_accepted}/"
              f"{inst.draft_proposed}), tokens per step "
              f"{len(inst.tbt_samples) / inst.row_steps:.3f}, step p50 "
              f"{np.median(steps):.2f} ms, time per committed token "
              f"{steps.sum() / n_tok:.2f} ms")
        print(f"  launches {json.dumps(counts)}", flush=True)
        for name in ("chunked_prefill_attention_ref", "decode_attention_ref",
                     "verify_attention_ref"):
            if counts[name]:
                fail(f"{label}: the plain {name} ran {counts[name]} times")
        if counts["flash_verify_attention"] != cfg.num_layers * inst.spec_steps:
            fail(f"{label}: {counts['flash_verify_attention']} verify launches "
                 f"for {inst.spec_steps} verify steps of {cfg.num_layers} "
                 f"layers")
        if label != "ngram" and inst.spec_steps == 0:
            fail(f"{label}: no verify step ran")
        if label == "oracle" and inst.draft_accepted == 0:
            fail("the oracle drafter's drafts were never accepted")
        differ = [i for i in range(len(plain)) if out[i] != plain[i]]
        if not differ:
            continue
        # near-tie check: rerun both with the steps' logits recorded (the
        # schedules are deterministic) and compare, at the first differing
        # token, the plain step's logits with the verify column's
        plain_again, plain_calls = recorded_run(
            port, dep.params, cfg, handoffs, n_tok)
        out_again, spec_calls = recorded_run(
            port, dep.params, cfg, handoffs, n_tok, **kw)
        same = plain_again == plain and out_again == out
        print(f"  {label}: streams {differ} differ from plain; recorded "
              f"reruns reproduce both runs: {same}")
        if not same:
            fail(f"{label}: the recorded reruns did not reproduce the runs "
                 "they are to explain")
        for i in differ:
            t = next(j for j, (a, b) in enumerate(zip(plain[i], out[i]))
                     if a != b)
            pos = int(handoffs[i][1]["pos"]) + t - 1
            lp = logits_of(plain_calls, pos, t)
            lv = logits_of(spec_calls, pos, t)
            top2 = lp.topk(2).values
            gap = (top2[0] - top2[1]).item()
            diff = (lv - lp).abs().max().item()
            # four bf16 rounding steps at the largest logit: a fault that
            # moves logits by whole units is not excused by a wide diff
            limit = 4 * 2.0 ** -7 * lp.abs().max().item()
            print(f"  {label} stream {i} differs at token {t} (plain "
                  f"{plain[i][t]}, spec {out[i][t]}): plain top-2 gap "
                  f"{gap:.4e}, verify column vs plain step max |logit "
                  f"diff| {diff:.4e}, limit {limit:.4e}")
            if gap > diff or diff > limit \
                    or int(lp.argmax()) != plain[i][t] \
                    or int(lv.argmax()) != out[i][t]:
                fail(f"{label} stream {i}: spec trajectory differs from the "
                     f"plain one at token {t}, not an explained near-tie")
            near_ties.append((label, i, t, gap, diff, limit))
        del plain_calls, spec_calls
    print(f"explained near-ties: {len(near_ties)} {near_ties}")


def timed_copy_jobs(engine):
    """Record each copy-engine job's duration by kind ("demote", "spill",
    "promote", "drop"), wrapping the engine's submit for this run."""
    times = {}
    submit = engine.submit

    def timed_submit(kind, key, fn):
        def run():
            t0 = time.monotonic()
            out = fn()
            times.setdefault(kind, []).append(time.monotonic() - t0)
            return out
        return submit(kind, key, run)

    engine.submit = timed_submit
    return times


def prefix_phase(torch, np, ops, dep, cfg):
    """Phase 9: prefix sharing and the KV tiers at full width. Returns the
    launch counts of the serve through `build(prefix_share=True)`."""
    from repro_torch.core import SchedulerCore
    from repro_torch.core.prefixcache import block_keys
    from repro_torch.models.segments import on_stream
    from repro_torch.serving.kvcache import raw_bytes
    from repro_torch.serving.prefill_instance import PrefillInstance
    from repro_torch.launch.serve import serve_trace

    ex, bs = dep.executor, 128
    pred = dep.prefill.scheduler.predictor
    # 64 HBM blocks hold A (32) and the shared-half prompt's suffix (16);
    # three fresh 4096-token prompts then push A's blocks into host (64)
    # and disk (64), and no later step drops a key of A
    inst = PrefillInstance(
        dep.params, cfg, SchedulerCore(predictor=pred, batch_budget=4096),
        max_seq=4096, executor=ex, prefix_share=True,
        prefix_cache_blocks=64, kv_block_size=bs, host_cache_blocks=64,
        disk_cache_blocks=64, promote_wait_s=300.0)
    kv = inst.kv
    job_times = timed_copy_jobs(kv._engine)
    rng = np.random.default_rng(9)
    vocab = cfg.vocab_size
    block_mb = 2 * cfg.num_layers * bs * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 2 / 1e6

    def run(toks, label):
        req = port_request(len(toks))
        inst.submit_request(req, toks)
        if not inst.drain(600.0) or not inst.healthy:
            fail(f"{label}: the prefix-sharing instance did not drain "
                 f"({inst.last_error!r})")
        task = inst.completed_tasks[-1].prefill_task
        torch.cuda.synchronize()
        print(f"{label}: {len(toks)} tokens, hit {req.prefix_hit}, resumed "
              f"at q_offset {task.start_offset}, TTFT {req.ttft:.4f} s",
              flush=True)
        return req, task

    def bf16_gap(a, b, label):
        """max |a - b| against four bf16 steps at max|b|."""
        gap = (a.float() - b.float()).abs().max().item()
        limit = 4 * 2.0 ** -7 * b.float().abs().max().item()
        print(f"  {label}: max |logit diff| {gap:.4e}, limit {limit:.4e}")
        if not gap <= limit:
            fail(f"{label}: logits differ by {gap}, over {limit}")

    def blocks_of(keys):
        with inst._kv_lock:
            return [kv._mgr._trie.get(k) for k in keys]

    try:
        # 1. cold, then a full hit: one query row over 4095 cached keys
        A = rng.integers(0, vocab, 4096)
        cold, cold_task = run(A, "A cold")
        ops.reset_counts()
        warm, warm_task = run(A, "A full hit")
        counts = ops.counts()
        print(f"  launches in the full-hit prefill: {json.dumps(counts)}")
        if warm.prefix_hit != 4095 or warm_task.start_offset != 4095:
            fail(f"A's full hit is {warm.prefix_hit}, not 4095")
        if counts["flash_prefill_wgmma"] != cfg.num_layers or \
                counts["flash_prefill_attention"] != cfg.num_layers or \
                counts["chunked_prefill_attention_ref"]:
            fail("the full-hit prefill did not run the tensor-core body "
                 "once per layer alone")
        bf16_gap(warm_task.logits, cold_task.logits, "full hit vs cold")
        print(f"  TTFT cold {cold.ttft:.4f} s, full hit {warm.ttft:.4f} s: "
              f"{cold.ttft / warm.ttft:.2f}x")
        breakdown(torch, "  a full hit through the instance (pool gather, "
                  "seeding, 160 one-row segments)", lambda: run(A, "  A"))

        # 2. a prompt sharing A's first half
        B = np.concatenate([A[:2048], rng.integers(0, vocab, 2048)])
        half, half_task = run(B, "B shares 2048")
        if half.prefix_hit != 2048 or half_task.start_offset != 2048:
            fail(f"B's hit is {half.prefix_hit} at q_offset "
                 f"{half_task.start_offset}, not 2048")
        with on_stream(inst.stream):
            want = ex.run_all(ex.start(B[None]))
        torch.cuda.synchronize()          # made on the instance's stream
        bf16_gap(half_task.logits, want, "shared half vs cold B")

        # 3. demotion: A's blocks, snapshot, then reused by a flood
        keys_a = block_keys(A, bs)
        with on_stream(inst.stream):
            snap = {k: (kv.k_pool[:, b].clone(), kv.v_pool[:, b].clone())
                    for k, b in zip(keys_a, blocks_of(keys_a))}
        torch.cuda.synchronize()
        floods = [rng.integers(0, vocab, 4096) for _ in range(3)]
        flood_logits = []
        for i, F in enumerate(floods):
            flood_logits.append(run(F, f"flood {i}")[1].logits)
        if not kv._engine.drain(300.0):
            fail("the copy engine did not drain after the flood")
        stats = kv.tier_stats()
        print(f"  tier census after the flood: {json.dumps(stats)}")
        where = {"host": 0, "disk": 0}
        for k, (wk, wv) in snap.items():
            with kv._store_lock:
                entry = kv._host_store.get(k)
                path = kv._disk_index.get(k)
            if entry is not None:
                k_raw, v_raw, crc, dtype = entry
                where["host"] += 1
            elif path is not None:
                with np.load(path) as z:
                    k_raw, v_raw = z["k"], z["v"]
                    crc, dtype = int(z["crc"]), str(z["dtype"])
                where["disk"] += 1
            else:
                fail(f"A's key {k:#x} was dropped, not demoted")
            if dtype != str(kv.k_pool.dtype).removeprefix("torch.") or \
                    not np.array_equal(k_raw, raw_bytes(wk).cpu().numpy()) \
                    or not np.array_equal(v_raw,
                                          raw_bytes(wv).cpu().numpy()):
                fail(f"stale KV: the stored copy of A's key {k:#x} differs "
                     "from the block at demotion")
        print(f"  A's 32 blocks: {json.dumps(where)}, every stored copy "
              "bit-equal to the snapshot taken before the flood reused "
              "their HBM blocks", flush=True)
        if where["host"] == 0 or where["disk"] == 0:
            fail(f"A's blocks are not in both cold tiers: {where}")

        # 4. promotion: A again
        with inst._kv_lock:
            tiers = kv.probe_tiers(keys_a)
        print(f"  probe_tiers(A) before: warm/host/disk {tiers}")
        if tiers[1] <= 0 or tiers[2] <= 0:
            fail(f"A's chain is not in host and disk: {tiers}")
        n_promote = len(job_times.get("promote", ()))
        again, again_task = run(A, "A promoted")
        promote_s = job_times.get("promote", [])[n_promote:]
        if again.prefix_hit != 4095:
            fail(f"A after promotion hits {again.prefix_hit}, not 4095")
        with on_stream(inst.stream):
            same = all(torch.equal(kv.k_pool[:, b], snap[k][0])
                       and torch.equal(kv.v_pool[:, b], snap[k][1])
                       for k, b in zip(keys_a, blocks_of(keys_a)))
        equal = torch.equal(again_task.logits, warm_task.logits)
        print(f"  promoted blocks torch.equal the snapshot: {same}; logits "
              f"torch.equal the full hit's: {equal}; {inst.prefix_promotions}"
              f" blocks promoted, {inst.prefix_promoted_tokens} tokens")
        if not same or not equal:
            fail("promotion did not restore A's KV bit for bit")

        # 5. a corrupt host copy: the last flood's chain is on host
        keys_f = block_keys(floods[2], bs)
        if not kv._engine.drain(300.0):
            fail("the copy engine did not drain before the corruption")
        victim = keys_f[5]
        with kv._store_lock:
            if victim not in kv._host_store:
                fail("the last flood's block 5 has no host copy")
            k_raw, v_raw, crc, dtype = kv._host_store[victim]
            k_bad = k_raw.copy()
            k_bad.ravel()[0] ^= 1
            kv._host_store[victim] = (k_bad, v_raw, crc, dtype)
        before = kv.tier_stats()
        rec, rec_task = run(floods[2], "flood 2 with a corrupt copy")
        after = kv.tier_stats()
        print(f"  promote_aborts {before['promote_aborts']} -> "
              f"{after['promote_aborts']}, tier_drops {before['tier_drops']}"
              f" -> {after['tier_drops']}, copies_failed "
              f"{before['copies_failed']} -> {after['copies_failed']}")
        if rec.prefix_hit != 5 * bs or \
                after["promote_aborts"] <= before["promote_aborts"] or \
                victim in kv._mgr._host or victim in kv._mgr._disk:
            fail(f"the corrupt copy was not dropped and recomputed (hit "
                 f"{rec.prefix_hit})")
        bf16_gap(rec_task.logits, flood_logits[2], "recomputed vs cold")

        # 6. copy times against promote_seconds, and the census
        for kind in ("demote", "spill", "promote"):
            ts = np.asarray(job_times.get(kind, [0.0])) * 1e3
            print(f"  {kind}: {len(job_times.get(kind, []))} blocks of "
                  f"{block_mb:.1f} MB, ms per block p50 {np.median(ts):.2f} "
                  f"mean {ts.mean():.2f} max {ts.max():.2f}")
        print(f"  promote_seconds per block (host_bw 25e9, disk_bw 3e9, "
              f"without the per-call latency): host "
              f"{kv.promote_seconds(bs) * 1e3 - kv.host_latency * 1e3:.3f} ms"
              f", disk {kv.promote_seconds(0, bs) * 1e3 - kv.disk_latency * 1e3:.3f}"
              f" ms; A's promotion predicted "
              f"{kv.promote_seconds(tiers[1], tiers[2]) * 1e3:.1f} ms, its "
              f"{len(promote_s)} copy jobs took "
              f"{sum(promote_s) * 1e3:.1f} ms in all")
        if not kv._engine.drain(300.0):
            fail("the copy engine did not drain")
        acct = kv.accounting()
        print(f"  tier_stats {json.dumps(kv.tier_stats())}; accounting "
              f"(free, live, cached, total) {acct}", flush=True)
        if acct[0] + acct[1] + acct[2] != acct[3] or acct[1] != 0 \
                or kv.tier_stats()["in_flight"]:
            fail(f"the tiered pool does not balance: {acct}")
    finally:
        inst.shutdown()
    del inst, kv, snap

    # 7. serve the launcher's mix through build(prefix_share=True)
    ops.reset_counts()
    rep = serve_trace(dep, requests=6, seed=0)
    counts = ops.counts()
    print(f"serve through build(prefix_share=True): {rep['n_requests']} "
          f"requests, decoded {rep['decoded']}, attainment "
          f"{rep['slo_attainment']:.3f}; prefix hits={rep['prefix_hits']} "
          f"({rep['prefix_hit_tokens']} prompt tokens served from cache)")
    print(f"launches since reset: {json.dumps(counts)}", flush=True)
    if rep["decoded"] != rep["n_requests"]:
        fail(f"prefix serve decoded {rep['decoded']} of {rep['n_requests']}")
    if rep["prefix_hits"] <= 0:
        fail("the prefix serve had no prefix hit")
    if counts["flash_prefill_attention"] <= 0 or \
            counts["flash_prefill_wgmma"] != counts["flash_prefill_attention"]:
        fail(f"{counts['flash_prefill_attention']} prefill launches in the "
             f"prefix serve, {counts['flash_prefill_wgmma']} on the "
             "tensor-core body")
    for name in ("chunked_prefill_attention_ref", "decode_attention_ref",
                 "verify_attention_ref"):
        if counts[name]:
            fail(f"the plain {name} ran on the prefix serve path")
    return counts


def run_hybrid(params, cfg, prompts, out_tokens, **kw):
    """Serve every prompt at once through a `HybridInstance` (prefill and
    local decode of `out_tokens` tokens); returns the instance and each
    prompt's emitted tokens (first token, then the decoded ones)."""
    from repro_torch.core import Request
    from repro_torch.serving.hybrid_instance import HybridInstance
    inst = HybridInstance(params, cfg, **kw)
    try:
        reqs = []
        for toks in prompts:
            reqs.append(Request(num_tokens=len(toks), slo=600.0,
                                arrival=time.monotonic(),
                                output_tokens=out_tokens, tbt_slo=100.0))
            inst.submit(reqs[-1], toks)
        drained = inst.drain(600.0)
    finally:
        inst.shutdown()
    if not inst.healthy or not drained:
        fail(f"the hybrid instance did not drain ({inst.last_error!r})")
    got = {j.request.rid: j.emitted for j in inst.finished_jobs}
    return inst, [got[r.rid] for r in reqs]


def tbt_summary(np, samples, slo):
    """p50 / p90 / max (ms) of inter-token gaps and the share within `slo`."""
    ms = np.asarray(samples) * 1e3
    return {"n": len(ms), "p50_ms": float(np.median(ms)),
            "p90_ms": float(np.percentile(ms, 90)), "max_ms": float(ms.max()),
            "attainment": float(np.mean(ms <= slo * 1e3))}


def colocation_phase(torch, np, ops, dep, cfg):
    """Phase 10: fig24's real panel (benchmarks/fig24_colocation.py:110-197)
    at full width. Returns the launch counts of the measured hybrid run."""
    from repro_torch.core import Request
    from repro_torch.kernels import counts as kcounts
    from repro_torch.kernels.decode_attn import BODY
    from repro_torch.models.segments import on_stream
    from repro_torch.serving import decode_instance as dmod
    from repro_torch.serving import hybrid_instance as hmod

    n_streams, prompt, out_tokens = 4, 1024, 32
    n_prefills, prefill_len = 6, 2048
    ex, vocab = dep.executor, cfg.vocab_size
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, vocab, prompt) for _ in range(n_streams)]
    floods = [rng.integers(0, vocab, prefill_len) for _ in range(n_prefills)]

    print("profile_step_times (B, mean ctx, s per step), bf16 pool: "
          + json.dumps(dmod.profile_step_times(
              dep.params, cfg, batch_sizes=(1, 2, 4), ctx=1024)),
          flush=True)

    # every batched step's logits with the request ids of its rows, so a
    # stream's t-th decoded token is read from the t-th step holding it
    rows, log = {"rids": []}, []

    def recording(fn):
        def step(params, cfg_, tokens, k_g, v_g, kv_lens):
            out = fn(params, cfg_, tokens, k_g, v_g, kv_lens)
            log.append((list(rows["rids"]), out[0]))
            return out
        return step

    def tracking(method, live):
        def step(jobs):
            rows["rids"] = [j.request.rid for j in jobs if live(j)]
            return method(jobs)
        return step

    saved = dmod.decode_step_ragged, hmod.decode_step_ragged
    dmod.decode_step_ragged = recording(saved[0])
    hmod.decode_step_ragged = recording(saved[1])
    try:
        # 1. a dedicated decode instance on 1024-token handoffs, warmed up
        handoffs = []
        for toks in prompts:
            task = ex.start(toks[None])
            handoffs.append((int(ex.run_all(task).argmax(-1)[0]), {
                "k": task.state["k_cache"], "v": task.state["v_cache"],
                "pos": prompt}))
        torch.cuda.synchronize()
        ded = dmod.DecodeInstance(dep.params, cfg, decode_max_batch=n_streams,
                                  decode_tokens=out_tokens)
        ded._step_batch = tracking(ded._step_batch, lambda j: True)
        try:
            for _ in ("warm-up", "measure"):
                mark = len(ded.tbt_samples)
                log.clear()
                reqs = [Request(num_tokens=prompt, slo=60.0,
                                arrival=time.monotonic(),
                                output_tokens=out_tokens, tbt_slo=60.0)
                        for _ in prompts]
                with ded._cv:     # all admitted before the first step
                    for r, (first, cache) in zip(reqs, handoffs):
                        ded.submit(dmod.DecodeJob(request=r, cache=dict(cache),
                                                  first_token=first))
                if not ded.drain(600.0) or not ded.healthy:
                    fail(f"the dedicated decode instance did not drain "
                         f"({ded.last_error!r})")
        finally:
            ded.shutdown()
        ded_tbt = ded.tbt_samples[mark:]
        ded_out = [ded.outputs[r.rid] for r in reqs]
        ded_rids, ded_log = [r.rid for r in reqs], list(log)
        log.clear()
        del handoffs
        median = float(np.median(ded_tbt))
        slo = 5 * median
        print(f"dedicated: {n_streams} streams x {out_tokens} tokens from "
              f"{prompt}-token handoffs, median step {median * 1e3:.2f} ms; "
              f"TBT SLO {slo * 1e3:.2f} ms (5x), weave cadence "
              f"{2 * median * 1e3:.2f} ms (2x)", flush=True)

        # 2. the hybrid: the same decode requests, then a prefill flood
        hyb = hmod.HybridInstance(
            dep.params, cfg, max_seq=ex.max_seq, chunk_tokens=512,
            token_budget=2048, decode_max_batch=n_streams,
            decode_cadence=2 * median, kv_pool_blocks=128,
            prefix_share=False, executor=ex)
        hyb._decode_step = tracking(hyb._decode_step,
                                    lambda j: j.tokens_done < j.target)
        kv, grow, growths = hyb.kv, hyb.kv.grow, []

        def checked_grow(extra):
            # called under the pool lock on the pool's stream: the blocks
            # from before the growth must reach the new pool unchanged
            n = kv.num_blocks
            with on_stream(kv.stream):
                snap = kv.k_pool.clone(), kv.v_pool.clone()
                grow(extra)
                same = torch.equal(kv.k_pool[:, :n], snap[0]) and \
                    torch.equal(kv.v_pool[:, :n], snap[1])
            growths.append((n, kv.num_blocks, same))

        kv.grow = checked_grow
        state = {}

        def colocated_pass():
            stats0 = hyb.rounds, hyb.steps, hyb.preemptions
            reqs = [Request(num_tokens=prompt, slo=60.0,
                            arrival=time.monotonic(),
                            output_tokens=out_tokens, tbt_slo=slo)
                    for _ in prompts]
            for r, toks in zip(reqs, prompts):
                hyb.submit(r, toks)
            deadline = time.monotonic() + 600.0
            while hyb.resident() < n_streams and time.monotonic() < deadline:
                time.sleep(0.002)
            if hyb.resident() < n_streams:
                fail(f"only {hyb.resident()} hybrid streams became resident")
            mark = len(hyb.tbt_samples)
            flood = [Request(num_tokens=prefill_len, slo=60.0,
                             arrival=time.monotonic(), output_tokens=0,
                             tbt_slo=slo) for _ in floods]
            for r, toks in zip(flood, floods):
                hyb.submit(r, toks)
            if not hyb.drain(600.0) or not hyb.healthy:
                fail(f"the hybrid instance did not drain ({hyb.last_error!r})")
            torch.cuda.synchronize()
            state.update(reqs=reqs, flood=flood, mark=mark, stats0=stats0)

        try:
            breakdown(torch, "hybrid pass (4 decode streams, then 6 "
                      "prefill-only requests of 2048 tokens)",
                      colocated_pass, top=8)
            log.clear()
            ops.reset_counts()
            colocated_pass()
            counts = ops.counts()
            counts[BODY] = kcounts.read([BODY])[BODY]
        finally:
            hyb.shutdown()
        got = {j.request.rid: j.emitted for j in hyb.finished_jobs}
        hyb_out = [got[r.rid] for r in state["reqs"]]
        hyb_rids, hyb_log = [r.rid for r in state["reqs"]], list(log)
    finally:
        dmod.decode_step_ragged, hmod.decode_step_ragged = saved
    torch.cuda.synchronize()

    hyb_tbt = hyb.tbt_samples[state["mark"]:]
    d, h = tbt_summary(np, ded_tbt, slo), tbt_summary(np, hyb_tbt, slo)
    print(f"TBT dedicated {json.dumps(d)}")
    print(f"TBT hybrid under the flood {json.dumps(h)}")
    print(f"attainment hybrid / dedicated: "
          f"{h['attainment'] / max(d['attainment'], 1e-9):.3f}; hybrid p90 "
          f"{h['p90_ms'] / d['p50_ms']:.2f}x the dedicated median step")
    r0, s0, p0 = state["stats0"]
    ttft = [r.ttft for r in state["flood"]]
    print(f"hybrid measured pass: rounds {hyb.rounds - r0}, decode steps "
          f"{hyb.steps - s0}, preemptions {hyb.preemptions - p0}; "
          f"prefill-only TTFT s {json.dumps([round(t, 4) for t in ttft])}; "
          f"pool growths (blocks before, after, old blocks equal) "
          f"{growths}")
    print(f"launches in the measured hybrid pass: {json.dumps(counts)}",
          flush=True)
    if not growths or not all(g[2] for g in growths):
        fail(f"pool growth: {growths} (the flood must grow the 128-block "
             "pool, and every old block must survive it)")
    for name in ("chunked_prefill_attention_ref", "decode_attention_ref",
                 "verify_attention_ref"):
        if counts[name]:
            fail(f"the plain {name} ran {counts[name]} times in the hybrid")
    if counts["flash_prefill_wgmma"] <= 0 or counts[BODY] <= 0 or \
            counts["flash_prefill_wgmma"] != counts["flash_prefill_attention"]:
        fail(f"the hybrid ran prefill_tc_kernel {counts['flash_prefill_wgmma']}"
             f" of {counts['flash_prefill_attention']} prefill launches and "
             f"the split-KV body {counts[BODY]} times")

    # 3. the measured streams against the dedicated instance's
    def logits_at(steps, rid, t):
        """Logits that produced decoded token t (>= 1) of stream rid."""
        seen = 0
        for rids, lg in steps:
            if rid in rids:
                seen += 1
                if seen == t:
                    return lg[rids.index(rid)].float()
        raise LookupError(f"stream {rid} has no step {t}")

    near_ties = []
    for i, (a, b) in enumerate(zip(ded_out, hyb_out)):
        if a == b:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        if t == 0:
            fail(f"stream {i}: the hybrid's first token {b[0]} differs from "
                 f"the dedicated prefill's {a[0]}")
        lp = logits_at(ded_log, ded_rids[i], t)
        lh = logits_at(hyb_log, hyb_rids[i], t)
        top2 = lp.topk(2).values
        gap = (top2[0] - top2[1]).item()
        diff = (lh - lp).abs().max().item()
        limit = 4 * 2.0 ** -7 * lp.abs().max().item()
        print(f"  stream {i} differs at token {t} (dedicated {a[t]}, hybrid "
              f"{b[t]}): dedicated top-2 gap {gap:.4e}, max |logit diff| "
              f"{diff:.4e}, limit {limit:.4e}")
        if gap > diff or diff > limit or int(lp.argmax()) != a[t] \
                or int(lh.argmax()) != b[t]:
            fail(f"stream {i}: the hybrid's trajectory differs from the "
                 f"dedicated one at token {t}, not an explained near-tie")
        near_ties.append((i, t, gap, diff, limit))
    print(f"hybrid trajectories equal the dedicated instance's on "
          f"{sum(a == b for a, b in zip(ded_out, hyb_out))} of {n_streams} "
          f"streams; explained near-ties {near_ties}", flush=True)
    return counts


def port_request(n):
    from repro_torch.core import Request
    return Request(num_tokens=n, slo=600.0, arrival=time.monotonic())


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
        from repro_torch.kernels import counts as kcounts
        from repro_torch.kernels.decode_attn import (BODY,
                                                     flash_decode_attention,
                                                     flash_verify_attention)
        from repro_torch.kernels.flash_prefill import (flash_prefill_attention,
                                                       tensor_core_body)
        from repro_torch.launch.serve import build as build_deployment
        from repro_torch.launch.serve import serve_trace
        from repro_torch.models.model import decode_step_ragged
        from repro_torch.models.segments import SegmentedPrefill
        from repro_torch.params import init_params
        from repro_torch.serving import decode_instance as port
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
    sass_report(build, libs)
    if args.ptxas:
        pre_smem = build.load("flash_prefill").flash_prefill_tc_smem_bytes
        dec_smem = build.load("decode_attn").decode_split_smem_bytes

        def smem(body, dtype, hd):
            if body == "prefill_tc_kernel":
                return f"{pre_smem(hd)} bytes"
            if body == "combine_kernel":
                return "0 bytes"
            return " / ".join(str(dec_smem(int(dtype == "bf16"), hd, t))
                              for t in (1, 2)) + " bytes (1 / 2+ query tiles)"
        for name in ("flash_prefill", "decode_attn"):
            ptxas_report(build.LOGS.get(name, ""), smem)

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

    def prefill(q, k, v, *args, **kw):
        """flash_prefill_attention, failing unless it ran the body that the
        dtype and head_dim select; returns the output and the body's name."""
        ops.reset_counts()
        out = flash_prefill_attention(q, k, v, *args, **kw)
        tc = tensor_core_body(q.dtype, q.shape[-1])
        if ops.counts()["flash_prefill_wgmma"] != int(tc):
            fail(f"prefill {tuple(q.shape)} {q.dtype}: the tensor-core body "
                 f"{'did not run' if tc else 'ran'}")
        return out, ("wgmma" if tc else "cuda cores")

    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in PREFILL_CASES:
            B, Sq, T, H, K, hd, qoff, kv_len, causal, window = case
            q, k, v = randn((B, Sq, H, hd), dtype), randn((B, T, K, hd), dtype), \
                randn((B, T, K, hd), dtype)
            got, body = prefill(q, k, v, qoff, kv_len, causal=causal,
                                local_window=window)
            want = ref.chunked_prefill_attention_ref(
                q, k, v, q_offset=qoff, kv_len=kv_len, causal=causal,
                local_window=window)
            check(f"prefill {case} {body}", dtype, got, want)
        for case in DECODE_CASES:
            B, T, H, K, hd, lens = case
            q, k, v = randn((B, H, hd), dtype), randn((B, T, K, hd), dtype), \
                randn((B, T, K, hd), dtype)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            check(f"decode {case}", dtype,
                  flash_decode_attention(q, k, v, lens_t),
                  ref.decode_attention_ref(q, k, v, kv_len=lens_t))
        for case in VERIFY_CASES:
            B, S, T, H, K, hd, lens = case
            q = randn((B, S, H, hd), dtype)
            k, v = randn((B, T, K, hd), dtype), randn((B, T, K, hd), dtype)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = flash_verify_attention(q, k, v, lens_t)
            check(f"verify {case}", dtype, got,
                  ref.verify_attention_ref(q, k, v, lens_t))
            col0 = flash_decode_attention(q[:, 0].contiguous(), k, v,
                                          lens_t + 1)
            check("  column 0 vs flash_decode_attention", dtype, got[:, 0],
                  col0)
            same = torch.equal(got[:, 0], col0)
            print(f"  column 0 torch.equal decode at kv_len + 1: {same}",
                  flush=True)
            if not same:
                fail(f"verify {case} {dtype}: column 0 differs from decode "
                     "at kv_len + 1")

    H, K, hd, T = 32, 8, 128, 4096
    print("\nLlama3-8B main-path shapes (H 32, K 8, hd 128, T 4096); "
          "times in ms, CUDA events, 20 calls after 3 warm-up calls")
    # 1 GiB of bf16 K and of V, carved into the L2-cold rotations
    pool_k = torch.randn(2 ** 29, generator=gen, device=dev,
                         dtype=torch.bfloat16)
    pool_v = torch.randn(2 ** 29, generator=gen, device=dev,
                         dtype=torch.bfloat16)

    def timed(name, shape, work, **fns):
        """The kernel, plain version and library call, each timed over one
        rotation of K/V sets of `shape` (L2-cold where the rotation reads
        twice the L2), beside the bound; fails on a reading under 0.95 of
        the bound (a measurement fault, such as inputs left in L2)."""
        sets, cold = rotation(pool_k, pool_v, shape, work[1])
        row = {"cold": cold, "sets": len(sets)}
        row["bound_ms"], row["bound_by"] = bound(*work)
        for key, fn in fns.items():
            # every set once where there are few; 20 calls at most, so the
            # host's enqueueing stays inside the spin ahead of them
            ms = cuda_ms(torch, fn, iters=min(20, max(
                5 if key == "plain" else 20, len(sets))), sets=sets)
            row["ms" if key == "kernel" else f"{key}_ms"] = ms
            if ms < 0.95 * row["bound_ms"]:
                fail(f"{name}: {key} took {ms:.5f} ms, under 0.95 of its "
                     f"bound {row['bound_ms']:.5f} ms: a measurement fault")
        shares = {key: round(row["bound_ms"] / row["ms" if key == "kernel"
                                                   else f"{key}_ms"], 4)
                  for key in fns}
        print(f"  {name}: {json.dumps(row)} {'L2-cold' if cold else 'L2-warm'}"
              f" over {len(sets)} K/V sets; share of the bound "
              f"{json.dumps(shares)}", flush=True)
        return row
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        for label, Sq, qoff, kv_len in LLAMA_PREFILL:
            q = randn((1, Sq, H, hd), dtype)
            k, v = randn((1, T, K, hd), dtype), randn((1, T, K, hd), dtype)
            name = f"flash_prefill_attention {label}"
            got, body = prefill(q, k, v, qoff, kv_len)
            err = check(f"{name} {body}", dtype, got,
                        ref.chunked_prefill_attention_ref(
                            q, k, v, q_offset=qoff, kv_len=kv_len))
            if dtype != torch.bfloat16:
                continue
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            qpos = qoff + torch.arange(Sq, device=dev)[:, None]
            kpos = torch.arange(T, device=dev)[None, :]
            mask = (kpos <= qpos) & (kpos < kv_len)
            if label in COLD_PREFILL:
                row = timed(
                    name, (1, T, K, hd),
                    prefill_work(1, Sq, H, K, hd, qoff, kv_len, es),
                    kernel=lambda k, v: flash_prefill_attention(
                        q, k, v, qoff, kv_len),
                    plain=lambda k, v: ref.chunked_prefill_attention_ref(
                        q, k, v, q_offset=qoff, kv_len=kv_len),
                    library=lambda k, v: F.scaled_dot_product_attention(
                        qt, k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=mask, enable_gqa=True))
                row["max_abs_err"] = err
                record[name] = row
                continue
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
            mask = (torch.arange(T, device=dev)[None, :]
                    < lens_t[:, None])[:, None, None, :]
            row = timed(
                name, (B, T, K, hd), decode_work(H, K, hd, lens, es),
                kernel=lambda k, v: flash_decode_attention(q, k, v, lens_t),
                plain=lambda k, v: ref.decode_attention_ref(
                    q, k, v, kv_len=lens_t),
                library=lambda k, v: F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True))
            row["max_abs_err"] = err
            record[name] = row
            if label == MAIN_DECODE:
                # one body: decode at kv_len is verify at S 1 from kv_len - 1
                kcounts.reset()
                dec = flash_decode_attention(q, k, v, lens_t)
                ver = flash_verify_attention(q[:, None], k, v, lens_t - 1)
                launched = kcounts.read([BODY, "flash_decode_attention",
                                         "flash_verify_attention"])
                same = torch.equal(ver[:, 0], dec)
                print(f"  one body: launches {json.dumps(launched)}; verify "
                      f"at S 1 from kv_len - 1 torch.equal decode: {same}",
                      flush=True)
                if launched != {BODY: 2, "flash_decode_attention": 1,
                                "flash_verify_attention": 1} or not same:
                    fail("decode and verify did not run the one split-KV "
                         "body")
        S = 5
        for label, lens in LLAMA_VERIFY:
            B = len(lens)
            q = randn((B, S, H, hd), dtype)
            k, v = randn((B, T, K, hd), dtype), randn((B, T, K, hd), dtype)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            name = f"flash_verify_attention {label}"
            got = flash_verify_attention(q, k, v, lens_t)
            err = check(name, dtype, got,
                        ref.verify_attention_ref(q, k, v, lens_t))
            col0 = flash_decode_attention(q[:, 0].contiguous(), k, v,
                                          lens_t + 1)
            same = torch.equal(got[:, 0], col0)
            print(f"  column 0 torch.equal decode at kv_len + 1: {same}",
                  flush=True)
            if not same:
                fail(f"{name} {dtype}: column 0 differs from decode at "
                     "kv_len + 1")
            if dtype != torch.bfloat16:
                continue
            qt = q.transpose(1, 2)
            qpos = lens_t[:, None, None] + torch.arange(S, device=dev)[:, None]
            mask = (torch.arange(T, device=dev)[None, None, :]
                    <= qpos)[:, None]                       # (B, 1, S, T)
            row = timed(
                name, (B, T, K, hd), verify_work(S, T, H, K, hd, lens, es),
                kernel=lambda k, v: flash_verify_attention(q, k, v, lens_t),
                plain=lambda k, v: ref.verify_attention_ref(q, k, v, lens_t),
                library=lambda k, v: F.scaled_dot_product_attention(
                    qt, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                    enable_gqa=True))
            row["max_abs_err"] = err
            record[name] = row
    del pool_k, pool_v
    torch.cuda.empty_cache()

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
    # speculative decoding on the card, drafting the CPU's plain tokens
    handoffs = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        ex = SegmentedPrefill(params, cfg, max_seq=128, chunk_tokens=32)
        handoffs[where] = []
        for i, n in enumerate((40, 72)):
            task = ex.start(toks[i:i + 1, :n])
            first = int(ex.run_all(task).argmax(-1)[0])
            handoffs[where].append((first, {
                "k": task.state["k_cache"], "v": task.state["v_cache"],
                "pos": n}))
    _, cpu_tokens = run_decode(port, p_cpu, cfg, handoffs["cpu"], 12,
                               kv_block_size=16)
    ops.reset_counts()
    inst, gpu_tokens = run_decode(
        port, p_gpu, cfg, handoffs["cuda"], 12,
        draft=oracle_drafter(cpu_tokens), kv_block_size=16,
        spec_decode=True, draft_k=4)
    counts = ops.counts()
    print(f"spec decode on the card (oracle drafts of the CPU tokens): "
          f"{inst.spec_steps} verify steps, {inst.draft_accepted}/"
          f"{inst.draft_proposed} drafts accepted; tokens equal to the "
          f"CPU's: {gpu_tokens == cpu_tokens}; launches {json.dumps(counts)}")
    if gpu_tokens != cpu_tokens:
        fail(f"spec tokens on the card {gpu_tokens} differ from the CPU's "
             f"{cpu_tokens}")
    if counts["flash_verify_attention"] <= 0 or counts["verify_attention_ref"]:
        fail("the tiny spec run did not go through the verify kernel alone")
    # the colocated instance: three concurrent requests prefill and decode
    # on one worker, on the card and on the CPU
    hyb_prompts = [np.random.default_rng(seed).integers(0, cfg.vocab_size, 64)
                   for seed in (0, 1, 2)]
    hyb_kw = dict(max_seq=128, token_budget=256, chunk_tokens=32,
                  decode_max_batch=4, decode_cadence=0.002, kv_block_size=16,
                  kv_pool_blocks=64, prefix_share=False)
    _, cpu_tokens = run_hybrid(p_cpu, cfg, hyb_prompts, 5, **hyb_kw)
    ops.reset_counts()
    inst, gpu_tokens = run_hybrid(p_gpu, cfg, hyb_prompts, 5, **hyb_kw)
    counts = ops.counts()
    print(f"hybrid on the card: {inst.rounds} rounds, {inst.steps} decode "
          f"steps; tokens equal to the CPU's: {gpu_tokens == cpu_tokens}; "
          f"launches {json.dumps(counts)}")
    if gpu_tokens != cpu_tokens:
        fail(f"hybrid tokens on the card {gpu_tokens} differ from the CPU's "
             f"{cpu_tokens}")
    if counts["flash_prefill_attention"] <= 0 or \
            counts["flash_decode_attention"] <= 0 or \
            counts["chunked_prefill_attention_ref"] or \
            counts["decode_attention_ref"]:
        fail("the tiny hybrid did not go through the two kernels alone")
    del p_cpu, p_gpu, handoffs
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
        if counts["flash_prefill_wgmma"] != counts["flash_prefill_attention"]:
            fail(f"{counts['flash_prefill_attention']} prefill launches in "
                 f"the serve phase, {counts['flash_prefill_wgmma']} of them "
                 "on the tensor-core body")
        body = kcounts.read([BODY])[BODY]
        if body != counts["flash_decode_attention"] + \
                counts["flash_verify_attention"]:
            fail(f"{body} launches of the split-KV body for "
                 f"{counts['flash_decode_attention']} decode and "
                 f"{counts['flash_verify_attention']} verify launches")

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
        del k_g, v_g

        # --- 8. speculative decoding at full width ---------------------------
        phase("8. speculative decoding: Llama3-8B, bf16, draft_k 4")
        spec_phase(torch, np, port, ops, dep, cfg)
    finally:
        dep.shutdown()
    del dep, ex
    torch.cuda.empty_cache()
    ops.reset_counts()
    dep = build_deployment(full_config=True, max_seq=4096, chunk=512,
                           decode_tokens=32, decode_max_batch=4, seed=0,
                           device="cuda", spec_decode=True, draft_k=4)
    try:
        rep = serve_trace(dep, requests=4, seed=1)
    finally:
        dep.shutdown()
    serve_counts = ops.counts()
    print(f"serve through build(spec_decode=True): {rep['n_requests']} "
          f"requests, decoded {rep['decoded']}, attainment "
          f"{rep['slo_attainment']:.3f}; spec report {json.dumps(rep['spec'])}")
    print(f"launches since reset: {json.dumps(serve_counts)}", flush=True)
    if rep["decoded"] != rep["n_requests"]:
        fail(f"spec serve decoded {rep['decoded']} of {rep['n_requests']}")
    for name in ("chunked_prefill_attention_ref", "decode_attention_ref",
                 "verify_attention_ref"):
        if serve_counts[name]:
            fail(f"the plain {name} ran on the spec serve path")
    n_verify = serve_counts["flash_verify_attention"]
    if rep["spec"]["spec_steps"] <= 0 or n_verify <= 0:
        fail(f"the spec serve ran {rep['spec']['spec_steps']} verify steps "
             f"and launched the verify kernel {n_verify} times")
    if n_verify != cfg.num_layers * rep["spec"]["spec_steps"]:
        fail(f"the spec serve launched the verify kernel {n_verify} times "
             f"in {rep['spec']['spec_steps']} verify steps")

    # --- 9. prefix sharing and KV tiers at full width ------------------------
    del dep
    torch.cuda.empty_cache()
    phase("9. prefix sharing and KV tiers: Llama3-8B, published width, bf16")
    dep = build_deployment(full_config=True, max_seq=4096, chunk=512,
                           decode_tokens=8, decode_max_batch=4, seed=0,
                           device="cuda", prefix_share=True)
    try:
        prefix_counts = prefix_phase(torch, np, ops, dep, dep.cfg)
        # --- 10. colocation at full width --------------------------------
        phase("10. colocation: decode TBT while prefills share the card")
        hybrid_counts = colocation_phase(torch, np, ops, dep, dep.cfg)
    finally:
        dep.shutdown()

    kernels = []
    for name, route, src, replaces, main in (
            ("flash_prefill_attention", "cuda",
             "src/repro_torch/kernels/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_prefill.py:105", MAIN_PREFILL),
            ("flash_decode_attention", "cuda",
             "src/repro_torch/kernels/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:207", MAIN_DECODE),
            ("flash_verify_attention", "cuda",
             "src/repro_torch/kernels/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:129", MAIN_VERIFY)):
        row = record[f"{name} {main}"]
        # each path's launches, counted from zero just before it ran
        by_path = {
            "flash_prefill_attention": {"prefix serve (phase 9)":
                                        prefix_counts[name]},
            "flash_decode_attention": {"serve (phase 6)": counts[name]},
            "flash_verify_attention": {"spec serve (phase 8)":
                                       serve_counts[name]},
        }[name]
        by_path["colocation (phase 10)"] = hybrid_counts[name]
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
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
