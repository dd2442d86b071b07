#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # phases 1-3 only (build, kernels, model)
    python3 chip_smoke.py --ptxas    # also print nvcc's per-kernel resources

Phases; the first failure exits non-zero and prints no result:

 1. device: the card's name and power limit (nvidia-smi); build the CUDA
    sources of `src/repro_torch/kernels/csrc/` with nvcc, one process each,
    in parallel (timed). From the SASS (cuobjdump): the prefill kernel's
    wgmma bodies (head_dim 64 and 128, and the q/k 192, v 128 latent
    attention body) must hold wgmma (HGMMA) and TMA load (UTMALDG)
    instructions, its head_dim 256 body mma.sync (HMMA) and cp.async
    (LDGSTS); `decode_attn.cu` must hold the split-KV body and its
    combine kernel alone, every body with cp.async (LDGSTS), the bf16 ones
    with mma.sync (HMMA) and the f32 ones without. With --ptxas, the
    registers, spills and shared memory of those bodies.
 2. kernels: each of the three kernels (prefill, decode, speculative verify)
    against its plain PyTorch version on the card, on the reference's test
    shapes and the Llama3-8B main-path shapes, in f32 (every element within
    2e-5) and bf16 (every element within 1e-5 + 1.6e-2 times the plain
    value); each prefill call must run the body its dtype and head_dim
    select (a tensor-core body for bf16 at head_dim 64, 128 or 256, by its
    launch counter); the verify kernel's column 0 must be bit-equal to the
    decode kernel at kv_len + 1; both wrappers must launch the one split-KV
    body (its counter). The main-path shapes are Llama3-8B's (K 8) and, for
    the prefill chunk512@3584 and the decode B4ragged, also Qwen3-30B-A3B's
    (K 4: 8 query heads per KV head), and RecurrentGemma-9B's head_dim 256
    with one KV head (a 4096-token prefill in a 2048 window, a resumed
    chunk, a ragged ring decode, a verify case; timed: the prefill
    `win2048@4096 hd256 K1` and the decode `B1ring2048 hd256`), and
    Kanana-2-30B-A3B's up-projected latent attention (32 heads of q/k 192,
    v 128; the chunks of 512 at q_offset 0, 3584 and 15872, each of which
    must launch the 192/128 body once). At them in bf16 the kernel, the
    plain version and one `F.scaled_dot_product_attention` call (a
    yardstick the port never calls) are timed with CUDA events (the calls
    queued behind a spin of the card, so host launch gaps are not timed),
    beside the least time the card could take (bytes over 3.35 TB/s or
    operations over 989 TFLOP/s, the larger). Decode, verify and the prefill
    of a fully cached prompt (one query row at q_offset 4095) are timed
    L2-cold: the calls rotate over distinct K/V sets that together read at
    least twice the 50 MB L2, and a reading under 0.95 of the bound fails
    as a measurement fault.
 3. model: the tiny Qwen3-MoE config in f32, prefill logits and a ragged
    decode step on the card against the CPU (2e-4), and its experts at a
    capacity that drops pairs (the card must route to the CPU's experts,
    keep and drop the same pairs, and agree within 2e-5); then the tiny
    Llama3-8B config likewise,
    one speculative-decoding run on the card whose tokens must equal the
    CPU's, and three concurrent requests through a `HybridInstance`
    (prefill and local decode on one worker) whose tokens must equal the
    CPU's, through the two kernels alone; and the tiny Mamba2 and
    RecurrentGemma configs in f32, `prefill` logits and 8 `decode_step`
    logits on the card against the CPU (2e-4), the hybrid's window of 32
    wrapping during the decode.
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
11. MoE at full width: the Llama3-8B deployments released, Qwen3-30B-A3B
    built through `build(arch="qwen3_30b_a3b", full_config=True)` in bf16
    with random weights (61.1 GB; `torch.cuda.memory_allocated` printed
    before and after), its TTFT profile; a 2048-token prompt suspended
    after a `gate`, after an `experts` and at a third operator boundary
    with another prefill in between, whose first-token logits must be
    bit-equal to an uninterrupted run; phase 6's serve and checks on it
    (both kernels at K 4 on their Hopper bodies, no plain version, a
    preemption forced if the mix made none); and `torch.profiler` over one
    4096-token prefill and one B 4 decode step: the device time under
    `aten::bmm` (the expert products) and the idle share, beside the bytes
    bound of reading every expert.
12. recurrent families at full width: Qwen3 released, Mamba2-370M and
    RecurrentGemma-9B drawn at published width with random weights
    (`torch.cuda.memory_allocated` before and after). Each prompt (4096
    tokens; and 2040 for RecurrentGemma, whose decode then crosses position
    2048) is prefilled and decoded 32 / 16 steps teacher-forced; at steps
    {0, 1, 7, 31} / {0, 7, 8, 15} the decode logits must lie within 4 *
    2^-7 * max|logit| of the last logits of a `prefill` of the prompt and
    the next i + 1 tokens: Mamba2 in bf16; RecurrentGemma first in f32
    (37.6 GB of weights), then in bf16, where the same comparison is
    printed beside both paths' distance from the f32 logits (bf16 rounding
    across its 38 layers exceeds the bound on random weights). In bf16
    RecurrentGemma must launch the prefill kernel 12 times per prefill on
    the body `TENSOR_CORE_HEAD_DIMS` declares and the decode kernel 12
    times per step, no plain version. Prints prefill and median step times
    and a profiler breakdown of one 4096-token prefill and one step of each.
13. the remaining families at published width in bf16 with random
    weights, one model at a time: Whisper-large-v3 whole (32 + 32 layers;
    its LayerNorm weights redrawn as 1 + 0.1 N(0,1) and biases as
    0.1 N(0,1), since the reference's init makes it output zero): `prefill`
    over 1500 N(0,1) stub frames, 16 greedy `decode_step`s from a BOS
    token and `forward` over the 17 tokens; step 0 within 4 * 2^-7 *
    max|logit| of forward's position 0 (its logits' std must be at least
    1e-3), layer 0's attention calls of both paths kernel against plain.
    InternVL2-76B at 8 of its 80 layers: a 4096-token prompt whose first
    256 positions are patch embeddings, in 512-token chunks through
    `SegmentedPrefill`, suspended at every operator boundary of chunk 3
    and resumed `torch.equal`, within the bound of the fused `prefill`,
    `torch.equal` when only the tokens under the patches change; then 16
    ragged decode steps at B 4. Llama4-Maverick at one (dense, MoE) pair:
    a 2048-token `prefill` and 16 teacher-forced steps, each held to a
    `prefill` of the same tokens where that prefill kept the last token's
    expert pair (a one-token step is never over capacity). Llama3.2-1B,
    Qwen2-1.5B, Qwen2.5-3B and Minitron-4B whole: a 1024-token `prefill`
    and 8 steps, each held to a `prefill`. Each path must launch both
    kernels (every prefill launch on a tensor-core body) and no plain
    version; profiler breakdowns of a Whisper and a Llama4 step (beside
    the bytes of the Llama4 step's routed experts). Phase 2 also times
    Whisper's `enc1500 nc hd64 K20` (non-causal) and `xattn B1 T1500 hd64
    K20`, InternVL2's `chunk512@3584 H64 K8` and `B4ragged H40 K8`
    (Llama4's heads); phase 3 also runs the tiny Whisper, InternVL2 and
    Llama4 configs card vs CPU (2e-4).
14. training at full width: Llama3.2-1B whole (16 layers, d 2048, 32 heads
    of 64 on 8 KV heads, tied head) drawn from seed 0 with bf16 parameters
    (trainable) and f32 AdamW state, `remat="full"`, sequence 4096 at batch
    2 (the reference's train_4k batch of 256 cut to one card; the reference
    has no gradient accumulation), synthetic Zipf batches
    (`training/data.py`), AdamW lr 3e-4 with one warmup step, 8 steps
    through `make_train_step`. Prints each step's loss (the first must lie
    within 1 of ln(vocab), the last below the first), the median
    synchronised step time, tokens per second and the peak memory, and a
    profiler breakdown of one step (the attention forward kernel, the
    backward's bmm, the GEMMs, AdamW, the log-softmax, any select_backward
    / fill_, the idle share). The step must launch `flash_prefill_attention`
    32 times (16 layers, each again under remat), all on the tensor-core
    body, the attention backward 16 times and the plain prefill version
    never. Layer 0's attention inputs of step 0 go through `FlashAttention`
    on the card against the plain versions on the CPU in f32: out against
    the plain forward, and dq, dk, dv against the plain backward on the
    same inputs (the kernel's out), within phase 2's bf16 limit; dq, dk, dv
    against the plain forward and backward within 4 * 2^-7 * max|grad|
    (the plain forward's f32 out moves D = rowsum(dout * out) by more than
    an element near 0 can hold). The forward kernel, its
    plain version and SDPA are timed at the training shape
    (`train4096 hd64 H32 K8`, causal, B 2), and so are the plain attention
    backward and SDPA's backward. Then, in a process of its own under
    `torch.use_deterministic_algorithms` with CUBLAS_WORKSPACE_CONFIG set
    before cuBLAS starts: one step's gradients at remat none, dots and full
    within phase 2's bf16 limit of each other, with the memory each needs
    ordered none > dots > full; and the reference's restart equivalence at
    full width: 4 steps straight against 2 steps, `save`, `restore` and 2
    steps, every parameter and m, v `torch.equal`.
15. the sharded path (`distributed/sharding.py`): a 1-rank NCCL group
    (from a `FileStore` under build/) and a (data 1, model 1) CUDA mesh.
    Under `train_rules`, one phase-14 Llama3.2-1B train step with the
    parameters and AdamW state as DTensors; under `serve_rules`, one
    Llama3-8B `prefill` of 4096 tokens and 16 greedy `decode_step`s over a
    sequence-sharded cache. Each against the same run outside the mesh on
    the same weights: on a size-1 mesh every redistribute is the identity,
    so the loss, every updated leaf and the logits are expected
    `torch.equal` (any that is not is held to phase 9's bf16 bound and
    counted), the tokens must be equal, the prefill and decode kernels
    must launch (through `local_map`) with no plain version, and the times
    are printed sharded beside unsharded (a second train step each, after
    DTensor's first-call propagation; a profile of one decode step each).
    NCCL failing to start fails the phase.
16. the dry-run, in a subprocess (its `fake` group cannot share a process
    with phase 15's NCCL one): `repro_torch.launch.dryrun` for llama3_2_1b
    on pod1 (train_4k, prefill_32k, decode_32k; long_500k is skipped) and
    train_4k on pod2, at published width on meta tensors; prints the
    per-device bytes, FLOPs and collective bytes, and fails on an `error`.
17. the simulator against the card (prints only): the cost model's TTFT
    of a lone Llama3-8B prompt on `sim.hardware.H100` at phase 4's lengths
    beside phase 4's measured TTFT, with the ratio.
18. the examples (`examples/*_torch.py`, through their own functions) at
    Llama3-8B's published width in bf16, random weights from seed 0, drawn
    again after phase 11 released them, launch counters zeroed before each
    run and read after its drain. (a) quickstart: A (4096 tokens) is
    preempted by B at least once and its resumed logits are `torch.equal`
    to a solo run; the blocking time beside one operator's mean time from
    the profile. (b) serve_trace: S-EDF and FCFS, 12 requests each, both
    reports; both kernels on their Hopper bodies, no plain version. (c)
    serve_cluster --real with 4 prefill instances (least-loaded), 2 decode
    instances with migration, decode batch 4, prompts from seed 3: a
    fault-free run under the hang watchdog (8x the slowest profiled
    prompt for each of the 6 instances) must fire it zero times; the
    same prompts under a plan of churn's crash moved to prefill[0]
    (which holds its first request until then, so the crash strands it
    with its segment still to run on the instance's stream) and gray's
    hang moved to decode[0] must lose no request, retry at least once,
    fire the watchdog at least once, and give every request's first-token
    logits `torch.equal` to the fault-free run's (any that is not is
    counted and held to phase 9's bf16 bound, its token equal); a
    --spec-decode run of 8 requests must launch the verify kernel; each
    prints decode_migrations and the per-instance dispatch counts. (d) train_quickstart --big, in a
    process of its own under deterministic algorithms: 40 steps straight
    against 20, a kill, and a rerun that resumes from the step-20
    checkpoint, every parameter and m, v `torch.equal`.
    `--examples-only` builds the kernels and runs this phase alone.

The line before the last holds the kernels' record: each kernel's launches
by path (each path's counters zeroed just before it ran) and their sum, the
times at Llama3-8B's main-path shape and, under "k4", at Qwen3-30B-A3B's,
under "hd256" at RecurrentGemma-9B's, under "phase13" at phase 13's
(phase 18's runs are among the paths); the last line is `{"ok": true,
"device": {...}}`.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import re
import statistics
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
    # RecurrentGemma-9B's attention (head_dim 256, 16 query heads on one KV
    # head, window 2048): a whole 4096-token prompt, and a resumed chunk at
    # q_offset 3584 whose window binds
    (1, 4096, 4096, 16, 1, 256, 0, 4096, True, 2048),
    (1, 512, 4096, 16, 1, 256, 3584, 4096, True, 2048),
]
DECODE_CASES = [
    # B, T, H, K, hd, per-row kv_len
    (1, 256, 8, 8, 64, [256]),
    (2, 512, 8, 2, 64, [300, 300]),
    (4, 128, 4, 1, 128, [77, 77, 77, 77]),
    (1, 1024, 16, 8, 64, [1000]),
    (4, 256, 4, 2, 32, [1, 77, 256, 130]),
    (4, 2048, 16, 1, 256, [1, 700, 2048, 1500]),  # the hd 256 ring, ragged
]
# the main paths: H 32, hd 128, a 4096-token cache per layer; K 8 is
# Llama3-8B's, K 4 (8 query heads per KV head) Qwen3-30B-A3B's
MAIN_PATH_PREFILL = [
    # label, Sq, q_offset, kv_len, K
    ("chunk512@0", 512, 0, 512, 8),
    ("chunk512@3584", 512, 3584, 4096, 8),
    ("tail100@2048", 100, 2048, 2148, 8),
    ("resume1@4095", 1, 4095, 4096, 8),         # a fully cached prompt
    ("chunk512@3584 K4", 512, 3584, 4096, 4),
]
# timed L2-cold like decode: one query row reads the whole 16.8 MB of K/V
COLD_PREFILL = {"resume1@4095"}
# Kanana-2-30B-A3B's up-projected latent attention, 32 heads of q/k 192 and
# v 128, at the served chunk of 512: label, q_offset (kv_len q_offset + 512)
MLA_PREFILL = [("chunk512@0", 0), ("chunk512@3584", 3584),
               ("chunk512@15872", 15872)]
MAIN_PATH_DECODE = [
    # label, per-row kv_len, K
    ("B1", [3000], 8),
    ("B1len1", [1], 8),
    ("B4ragged", [1, 1000, 2600, 4096], 8),
    ("B4ragged K4", [1, 1000, 2600, 4096], 4),
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
    (2, 3, 2048, 16, 1, 256, [0, 2000]),        # hd 256, 48 rows
]
# label, per-row kv_len (B 4, S 5 = draft_k 4 + 1)
LLAMA_VERIFY = [("B4S5ragged", [1, 1000, 2600, 4091])]
MAIN_PREFILL, MAIN_DECODE, MAIN_VERIFY = \
    "chunk512@3584", "B4ragged", "B4S5ragged"
K4 = " K4"                                # the Qwen3-30B-A3B rows' suffix
# RecurrentGemma-9B's main-path shapes (H 16, K 1, hd 256, window 2048): a
# 4096-token prompt's prefill, and one decode row over a full 2048-slot ring
HD256 = dict(H=16, K=1, hd=256, window=2048)
MAIN_PREFILL_HD256, MAIN_DECODE_HD256 = \
    "win2048@4096 hd256 K1", "B1ring2048 hd256"
# phase 13's kernel shapes (bf16), timed in phase 2: Whisper's encoder
# (non-causal, one query head per KV head, Sq = T = 1500 off the 128-row
# tile grid) and its cross-attention decode over 1500 keys, InternVL2's
# chunk (H 64, K 8) and a ragged decode at Llama4-Maverick's H 40, K 8
PHASE13_PREFILL = [
    # label, Sq, T, H, K, hd, q_offset, kv_len, causal
    ("enc1500 nc hd64 K20", 1500, 1500, 20, 20, 64, 0, 1500, False),
    ("chunk512@3584 H64 K8", 512, 4096, 64, 8, 128, 3584, 4096, True),
]
PHASE13_DECODE = [
    # label, per-row kv_len, T, H, K, hd
    ("xattn B1 T1500 hd64 K20", [1500], 1500, 20, 20, 64),
    ("B4ragged H40 K8", [1, 1000, 2600, 4096], 4096, 40, 8, 128),
]
PHASE13_ROWS = {"flash_prefill_attention": [r[0] for r in PHASE13_PREFILL],
                "flash_decode_attention": [r[0] for r in PHASE13_DECODE]}
# teacher-forced decode checks of phase 12: the steps checked per prompt
RECURRENT_CHECKS = {4096: (0, 1, 7, 31), 2040: (0, 7, 8, 15)}
# phase 14: Llama3.2-1B at train_4k's sequence, the batch cut to one card
TRAIN = dict(arch="llama3_2_1b", seq=4096, batch=2, steps=8, lr=3e-4)
TRAIN_SHAPE = "train4096 hd64 H32 K8"


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


def breakdown(torch, label, fn, top: int = 6, cpu_ops=()) -> None:
    """Profile one call of `fn` (after a warm-up call): wall time to a
    synchronise, device time summed over the CUDA kernels, the device's idle
    share of the wall time, the kernels that took the most device time, and
    the device time of the kernels launched under each operator of
    `cpu_ops` (such as "aten::bmm") with its share. Prints "not measured"
    where the profiler recorded no device time. Returns {operator of
    `cpu_ops`: device ms under it}, empty where nothing was measured."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    kern, under = [], {}
    for e in prof.key_averages():
        if e.key in cpu_ops:
            us = getattr(e, "device_time_total", None)
            under[e.key] = (e.cuda_time_total if us is None else us, e.count)
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
        return {}
    print(f"  kernels {busy / 1e3:.2f} ms, device idle share "
          f"{max(0.0, 1 - busy / wall_us):.3f}")
    for us, n, key in sorted(kern, reverse=True)[:top]:
        print(f"  {us / 1e3:9.2f} ms {100 * us / busy:5.1f}% x{n:<5} "
              f"{key[:90]}")
    for key in cpu_ops:
        us, n = under.get(key, (0.0, 0))
        print(f"  under {key}: {us / 1e3:.2f} ms of kernels, "
              f"{100 * us / busy:.1f}% of the device time, x{n}")
    return {key: under.get(key, (0.0, 0))[0] / 1e3 for key in cpu_ops}


BODIES = ("prefill_tc_kernel", "prefill_mla_kernel", "prefill_mma_kernel",
          "prefill_kernel", "split_kernel", "combine_kernel")


def kernel_label(fn: str):
    """(body, dtype, head_dim) of a mangled kernel name of BODIES."""
    body = next(b for b in BODIES if b in fn)
    if body == "prefill_mma_kernel":            # not a template: bf16, 256
        return body, "bf16", 256
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
    """The grouped expert kernel's two GEMMs (gate|up and down) must hold
    wgmma (HGMMA) and TMA loads (UTMALDG). The prefill kernel's wgmma bodies (hd 64, 128 and q/k 192, v 128)
    must hold wgmma (HGMMA) and TMA loads (UTMALDG), its head_dim 256 body mma.sync (HMMA) and cp.async
    (LDGSTS); `decode_attn.cu` must hold the split-KV body and
    its combine kernel alone (2 dtypes x 5 head dims each), every body with
    cp.async (LDGSTS), the bf16 bodies with mma.sync (HMMA) and the f32
    bodies without (no TF32)."""
    pre = {fn: c for fn, c in sass_counts(
        build, libs["flash_prefill"], ("HGMMA", "UTMALDG")).items()
        if "prefill_tc_kernel" in fn or "prefill_mla_kernel" in fn}
    for fn, c in sorted(pre.items()):
        print(f"SASS {kernel_label(fn)}: {json.dumps(c)}")
    if len(pre) != 3 or sum("prefill_mla_kernel" in fn for fn in pre) != 1 \
            or not all(n > 0 for c in pre.values() for n in c.values()):
        fail("the tensor-core prefill bodies (hd 64, 128, q/k 192 v 128) "
             "lack HGMMA or UTMALDG instructions in their SASS")
    mma = {fn: c for fn, c in sass_counts(
        build, libs["flash_prefill"], ("HMMA", "LDGSTS", "HGMMA")).items()
        if "prefill_mma_kernel" in fn}
    for fn, c in mma.items():
        print(f"SASS {kernel_label(fn)}: {json.dumps(c)}")
    if len(mma) != 1 or not all(c["HMMA"] and c["LDGSTS"] and not c["HGMMA"]
                                for c in mma.values()):
        fail("the head_dim 256 prefill body lacks mma.sync (HMMA) or "
             "cp.async (LDGSTS) instructions in its SASS")
    dec = sass_counts(build, libs["decode_attn"], ("HMMA", "LDGSTS"))
    for fn, c in sorted(dec.items(), key=lambda kv: kernel_label(kv[0])):
        print(f"SASS {kernel_label(fn)}: {json.dumps(c)}")
    split = [fn for fn in dec if "split_kernel" in fn]
    if len(split) != 10 or len(dec) != 20 or \
            sum("combine_kernel" in fn for fn in dec) != 10:
        fail(f"decode_attn.cu holds {sorted(dec)}, not the split body and "
             "its combine kernel alone")
    for fn in split:
        bf16 = kernel_label(fn)[1] == "bf16"
        if dec[fn]["LDGSTS"] == 0 or (dec[fn]["HMMA"] > 0) != bf16:
            fail(f"{kernel_label(fn)}: SASS {dec[fn]}; every body loads by "
                 "cp.async, and only the bf16 ones use mma.sync")
    moe = {fn: c for fn, c in sass_counts(
        build, libs["moe_grouped"], ("HGMMA", "UTMALDG")).items()
        if "grouped_gemm_tc_kernel" in fn}
    for fn, c in sorted(moe.items()):
        print(f"SASS grouped_gemm_tc_kernel<"
              f"{'gate_up' if 'ILi0E' in fn else 'down'}>: {json.dumps(c)}")
    if len(moe) != 2 or not all(n > 0 for c in moe.values()
                                for n in c.values()):
        fail("the grouped expert GEMMs lack HGMMA or UTMALDG instructions "
             "in their SASS")


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


def mla_prefill_work(Sq, H, q_offset, es, dq=192, dv=128):
    """Operations and bytes of a causal chunk of Sq queries at q_offset
    with per-head keys of width dq and values of dv (the up-projected
    latent attention): 2 * (dq + dv) per visible pair and head; q and o
    once, each key and value once."""
    pairs = Sq * q_offset + Sq * (Sq + 1) // 2
    return (2.0 * (dq + dv) * H * pairs,
            es * H * (Sq * (dq + dv) + (q_offset + Sq) * (dq + dv)))


def prefill_work(B, Sq, H, K, hd, q_offset, kv_len, es, window=0,
                 causal=True):
    """Operations and bytes a causal chunk needs: 4*hd per visible (query,
    key) pair and head; q and o once, and of k and v once each key that
    some query sees (below the last visible one, and inside the first
    query's window). Without the causal mask every query sees all kv_len
    keys."""
    if not causal:
        return (4.0 * hd * H * B * Sq * kv_len,
                es * B * (2 * Sq * H * hd + 2 * kv_len * K * hd))

    def first(i):
        return max(0, q_offset + i - window + 1) if window else 0
    pairs = sum(max(0, min(kv_len, q_offset + i + 1) - first(i))
                for i in range(Sq))
    keys = min(kv_len, q_offset + Sq) - first(0)
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
    instance, the outputs and, per step, (kv_lens, logits (B, S, V)). The
    step functions are wrapped in the decode instance's module for this run
    only."""
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
        inst, out = run_decode(port, *args, **kw)
    finally:
        port.decode_step_ragged, port.decode_verify_ragged = saved
    return inst, out, calls


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
        _, plain_again, plain_calls = recorded_run(
            port, dep.params, cfg, handoffs, n_tok)
        _, out_again, spec_calls = recorded_run(
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


def serve_phase(np, ops, kcounts, dep, cfg, seed):
    """`serve_trace` over 6 requests of the launcher's mix with the launch
    counters zeroed just before; if the mix made the scheduler preempt no
    prefill, one long and then one short request force it (their prompts
    drawn from `seed`). Fails unless every request decoded, a prefill was
    preempted, both kernels launched on their Hopper bodies (every prefill
    launch on the tensor-core body, every decode launch on the split-KV
    body) and no plain version ran. Returns the launch counts."""
    from repro_torch.core import Request, RequestState
    from repro_torch.kernels.decode_attn import BODY
    from repro_torch.launch.serve import serve_trace
    ops.reset_counts()
    rep = serve_trace(dep, requests=6, seed=0)
    forced = False
    if rep["preemptions"] == 0:
        forced = True
        rng = np.random.default_rng(seed)
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
    n_out = dep.decode.decode_tokens + 1
    for rid, toks_out in dep.decode.outputs.items():
        if len(toks_out) != n_out or not all(
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
    return counts


# (label, experts per token, capacity factor, B, S) of the grouped expert
# kernel's phase-2 rows: Qwen3-30B-A3B and Kanana-2-30B-A3B (E 128, D 2048,
# F 768) at the cells' drop-free capacities
MOE_SHAPES = (("chunk512 qwen3", 8, 16.0, 1, 512),
              ("chunk512 kanana", 6, 22.0, 1, 512),
              ("n330 qwen3", 8, 16.0, 1, 330),
              ("n4096 qwen3", 8, 16.0, 8, 512))
MAIN_MOE = "chunk512 qwen3"


def moe_kernel_rows(torch, dev, kcounts) -> dict:
    """Phase 2's rows of the grouped expert kernel (`moe_grouped_ffn`) at
    the MoE cells' shapes, with uniform routing over all 128 experts: its
    output and its plain version's (`moe_apply_ref`) each against the same
    computation in f32 (the kernel may not be less precise: relative norm
    within 1.25x, largest element within 2x the plain version's), one
    launch a call and no plain call, and the kernel's time (device time,
    CUDA events) beside its bound, the plain version's and, as
    `library_ms`, `torch._grouped_mm` on the rows already gathered and
    sorted (gate|up, SiLU x up, down: no routing, gather or combine), which
    the port never calls. The weights (1.21 GB) outweigh the L2, so every
    call reads them from device memory. Bound: the routed products over
    989 TFLOP/s, or the weights of the experts that have rows and x, h in
    and out over 3.35 TB/s, the larger."""
    from repro_torch.models import layers as L
    E, D, Fd = 128, 2048, 768
    gen = torch.Generator(device=dev).manual_seed(29)
    wi = (torch.randn((E, D, 2 * Fd), generator=gen, device=dev)
          / D ** 0.5).bfloat16()
    wd = (torch.randn((E, Fd, D), generator=gen, device=dev)
          / Fd ** 0.5).bfloat16()
    rows = {}
    for label, k, cf, B, S in MOE_SHAPES:
        n = B * S
        idx = torch.rand((n, E), generator=gen, device=dev).topk(
            k, -1).indices.view(B, S, k)
        x = torch.randn((B, S, D), generator=gen, device=dev).bfloat16()
        w = torch.softmax(torch.randn((B, S, k), generator=gen, device=dev),
                          -1)
        kw = dict(k=k, capacity_factor=cf, min_capacity=4)
        kcounts.reset()
        got = L.moe_apply(x, w, idx, wi, wd, **kw)
        launched = kcounts.read(["moe_grouped_gemm", "moe_grouped_wgmma",
                                 "moe_apply_ref"])
        want = L.moe_apply_ref(x, w, idx, wi, wd, **kw)
        truth = L.moe_apply_ref(x.float(), w, idx, wi.float(), wd.float(),
                                **kw)
        t = truth.float()
        (kn, km), (rn, rm) = [
            (float((y.float() - t).norm() / t.norm()),
             float((y.float() - t).abs().max())) for y in (got, want)]
        name = f"moe_grouped_ffn {label}"
        print(f"{name:<44} bf16 vs f32: kernel {kn:.3e} (max {km:.3e}), "
              f"plain {rn:.3e} (max {rm:.3e})", flush=True)
        if launched != {"moe_grouped_gemm": 1, "moe_grouped_wgmma": 1,
                        "moe_apply_ref": 0}:
            fail(f"{name}: launches {launched}")
        if not (kn <= 1.25 * rn and km <= 2 * rm):
            fail(f"{name}: the kernel is further from f32 than the plain "
                 "version")
        used = int(torch.unique(idx).numel())
        ops_count = 2 * n * k * D * 3 * Fd
        nbytes = used * 3 * D * Fd * 2 + 3 * n * D * 2
        h = torch.randn((n, D), generator=gen, device=dev).bfloat16()
        order = idx.view(-1).argsort(stable=True)
        offs = torch.bincount(idx.view(-1), minlength=E).cumsum(0).to(
            torch.int32)
        xg = x.view(n, D).repeat_interleave(k, 0)[order].contiguous()
        # _grouped_mm takes its (E, K, N) operand column-major
        wi_t = wi.transpose(1, 2).contiguous().transpose(1, 2)
        wd_t = wd.transpose(1, 2).contiguous().transpose(1, 2)

        def library():
            g, u = torch._grouped_mm(xg, wi_t, offs=offs).chunk(2, -1)
            return torch._grouped_mm(torch.nn.functional.silu(g) * u, wd_t,
                                     offs=offs)
        row = dict(
            ms=cuda_ms(torch, lambda: L.moe_apply(x, w, idx, wi, wd, **kw,
                                                  residual=h)),
            plain_ms=cuda_ms(torch, lambda: L.moe_apply_ref(
                x, w, idx, wi, wd, **kw), iters=5),
            library_ms=cuda_ms(torch, library),
            max_abs_err=km, plain_max_abs_err=rm, experts_used=used)
        del wi_t, wd_t, xg
        row["bound_ms"], row["bound_by"] = bound(ops_count, nbytes)
        if row["ms"] < 0.95 * row["bound_ms"]:
            fail(f"{name}: {row['ms']:.5f} ms, under 0.95 of its bound: a "
                 "measurement fault")
        rows[name] = row
        print(f"  {name}: {json.dumps(row)}; share of the bound "
              f"{row['bound_ms'] / row['ms']:.4f}", flush=True)
    del wi, wd
    torch.cuda.empty_cache()
    return rows


def moe_phase(torch, np, ops, kcounts, build_deployment):
    """Phase 11: Qwen3-30B-A3B at its published width in bf16 with random
    weights (61.1 GB), on a card the earlier phases have released. Returns
    the serve's launch counts."""
    from repro_torch.kernels import moe_grouped as MG
    from repro_torch.models import layers as L
    from repro_torch.models.model import decode_step_ragged
    gib = 2 ** 30
    print(f"memory allocated before build "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / gib:.2f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    dep = build_deployment(arch="qwen3_30b_a3b", full_config=True,
                           max_seq=4096, chunk=512, decode_tokens=8,
                           decode_max_batch=4, seed=0, device="cuda")
    cfg, ex = dep.cfg, dep.executor
    n_params = sum(p.numel() for p in dep.params.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token} of d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params "
          f"(param_count {cfg.param_count() / 1e9:.3f} B) in "
          f"{dep.params.dtype}; operators {'/'.join(ex.ops)}")
    print(f"memory allocated after build "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB, peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    print("TTFT profile (s, synchronised):",
          json.dumps({n: round(t, 4) for n, t in dep.profile.items()}))
    print(f"build + profile {time.monotonic() - t0:.1f} s", flush=True)
    # a chunk that routes to every expert reads all E experts' matrices
    es = dep.params.dtype.itemsize
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    expert_bytes = cfg.num_layers * E * 3 * D * Fd * es
    try:
        # --- suspend/resume at MoE operator boundaries ----------------------
        prompt = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                                    (1, 2048))
        other = np.random.default_rng(12).integers(0, cfg.vocab_size,
                                                   (1, 300))
        want = ex.run_all(ex.start(prompt))
        task = ex.start(prompt)
        total, spc = task.total_segments, ex._segments_per_chunk

        def after(op, frac):
            """The first boundary past frac of the segments that follows
            an `op` segment."""
            c = int(total * frac)
            while ex.ops[(c - 1) % spc % len(ex.ops)] != op:
                c += 1
            return c
        stops = [after("gate", 0.1), after("experts", 0.45), int(0.8 * total)]
        ops_at = [ex.ops[(c - 1) % spc % len(ex.ops)] for c in stops]
        for stop in stops:
            while task.cursor < stop:
                ex.step(task)
            ex.run_all(ex.start(other))          # another prefill meanwhile
        got = ex.run_all(task)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        print(f"{total} segments, suspended at {stops} (after "
              f"{'/'.join(ops_at)}): logits {tuple(got.shape)} finite "
              f"{bool(torch.isfinite(got.float()).all())} bit-equal {equal}",
              flush=True)
        if not equal or ops_at[:2] != ["gate", "experts"]:
            fail("the MoE prefill resumed at its gate / experts boundaries "
                 "differs from the uninterrupted run: max abs diff "
                 f"{(got.float() - want.float()).abs().max().item()}")

        # --- serve the launcher's mix ---------------------------------------
        counts = serve_phase(np, ops, kcounts, dep, cfg, seed=13)
        counts.update(MG.counts())               # since the serve's reset
        print(f"experts in the serve: moe_grouped_gemm "
              f"{counts['moe_grouped_gemm']} calls, moe_apply_ref "
              f"{counts['moe_apply_ref']}", flush=True)
        if counts["moe_grouped_gemm"] == 0 or counts["moe_apply_ref"]:
            fail("the served Qwen3 prefill did not run every `experts` step "
                 "on the grouped kernel")

        # --- where the time goes --------------------------------------------
        chunk_ops = 2 * 512 * cfg.experts_per_token * D * 3 * Fd \
            * cfg.num_layers
        print(f"expert bytes bound per pass over the layers (a prefill "
              f"chunk that routes to every expert; bf16): "
              f"{expert_bytes / 1e9:.2f} GB, "
              f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms; a 512-token "
              f"chunk's routed products "
              f"{chunk_ops / PEAK_BF16_OPS * 1e3:.2f} ms of operations")
        toks = np.random.default_rng(14).integers(0, cfg.vocab_size,
                                                  (1, 4096))
        ops.reset_counts()
        ex.run_all(ex.start(toks))
        torch.cuda.synchronize()
        c = MG.counts()
        steps = 4096 // 512 * cfg.num_layers
        print(f"prefill 4096: {c['moe_grouped_gemm']} grouped expert calls "
              f"for {steps} `experts` steps, moe_apply_ref "
              f"{c['moe_apply_ref']}", flush=True)
        if c["moe_grouped_gemm"] != steps or c["moe_apply_ref"]:
            fail("a Qwen3 prefill did not launch the grouped kernel once per "
                 "`experts` step")
        breakdown(torch, "prefill 4096 (chunk 512, op granularity)",
                  lambda: ex.run_all(ex.start(toks)))
        L_, K_, hd_ = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        k_g = torch.zeros((L_, 4, 4096, K_, hd_), dtype=dep.params.dtype,
                          device="cuda")
        v_g = torch.zeros_like(k_g)
        lens_t = torch.tensor([263, 1031, 2055, 4095], device="cuda")
        step_toks = torch.tensor([1, 2, 3, 4], device="cuda")
        breakdown(torch, "decode_step_ragged B 4, kv_len 263..4095",
                  lambda: decode_step_ragged(dep.params, cfg, step_toks,
                                             k_g, v_g, lens_t))
        del k_g, v_g
    finally:
        dep.shutdown()
    return counts


def tiny_family_card_vs_cpu(torch, np, ops, arch) -> None:
    """Phase 3's ssm, hybrid, audio, vlm and pairs: the tiny config in f32
    (Whisper's norms and biases redrawn), `forward` logits, `prefill`
    logits and 8 `decode_step` logits on the card against the CPU (2e-4).
    No plain attention version may run on the card: ssm launches no
    attention, the hybrid each kernel once a triple per call (its window of
    32 wraps during the decode, positions 28 to 35), the others both
    kernels."""
    from repro_torch.configs.base import get_tiny_config
    from repro_torch.models.model import (_hybrid_counts, decode_step,
                                          forward, prefill)
    from repro_torch.params import init_params, redraw_norms
    cfg = get_tiny_config(arch)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    if cfg.family == "audio":
        redraw_norms(p_cpu, 1)
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    rng = np.random.default_rng(0)
    S, n = 28, 8
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S + n))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    out = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        ops.reset_counts()
        b = {k: torch.from_numpy(v).to(params.device)
             for k, v in batch.items()}
        fw = forward(params, cfg, b)
        logits, cache = prefill(params, cfg,
                                dict(b, tokens=b["tokens"][:, :S]),
                                max_seq=S + n, cache_dtype=torch.float32)
        steps = [logits]
        for i in range(n):
            logits, cache = decode_step(params, cfg, b["tokens"][:, S + i],
                                        cache)
            steps.append(logits)
        out[where] = [fw.cpu(), torch.stack(steps).cpu()]
    counts = ops.counts()
    err = max((a - b).abs().max().item()
              for a, b in zip(out["cpu"], out["cuda"]))
    print(f"{cfg.name}: forward, prefill + {n} decode steps, card vs cpu "
          f"max_abs_err {err:.3e} tol 2e-4; launches {json.dumps(counts)}",
          flush=True)
    if not err <= 2e-4:
        fail(f"tiny {cfg.name}: card and CPU differ by {err}")
    got = (counts["flash_prefill_attention"],
           counts["flash_decode_attention"])
    if cfg.family == "ssm":
        want = (0, 0)
    elif cfg.family == "hybrid":
        n_tri = _hybrid_counts(cfg)[0]
        want = (2 * n_tri, n * n_tri)
    else:
        want = got if min(got) > 0 else "both kernels"
    if got != want or counts["chunked_prefill_attention_ref"] or \
            counts["decode_attention_ref"]:
        fail(f"tiny {cfg.name}: attention launches {got}, not {want}, or a "
             "plain version ran on the card")


def model_run(torch, np, ops, cfg, params, S, n_steps, checks, seed,
              reference=None, cmp_cfg=None, check=None):
    """One prompt of S tokens through `prefill` and `n_steps` teacher-forced
    `decode_step`s in the weights' dtype, counters zeroed before each of
    the two. At each step i of `checks`, decode step i's logits are held
    against the last logits of a `prefill` of the prompt and the next i + 1
    tokens, within 4 * 2^-7 * max|logit| (phase 9's bound, four bf16 steps
    at the logits' magnitude): a failure unless `reference` is given. With
    `reference` ({i: the f32 prefill logits of the same tokens}) the
    comparison is printed beside each path's RMS distance from the f32
    logits, and not checked: the bf16 rounding of both paths is then what
    it measures. `cmp_cfg`, where given, is the config of the comparison
    prefills. With `check` (phase 2's comparison), layer 0's attention
    inputs of the prefill, of decode step 0 and of the last step are kept
    and run through each kernel against its plain version once the counts
    are read. Returns (prefill s, median step s, prefill launches, decode
    launches, {i: f32 prefill logits})."""
    from repro_torch.models.model import decode_step, prefill
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, S + n_steps))).to(params.device)
    dtype = params.dtype
    first = (lambda name, i: i == 0) if check else None
    kept = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.monotonic()
    with kernel_calls(ops, kept, first):
        logits, cache = prefill(params, cfg, {"tokens": toks[:, :S]},
                                max_seq=S + n_steps, cache_dtype=dtype)
    torch.cuda.synchronize()
    t_prefill = time.monotonic() - t0
    print(f"  {cfg.name} {str(dtype)[6:]} prompt {S}: prefill peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f} GiB "
          "above what was allocated before it (activations, intermediates "
          "and cache)",
          flush=True)
    pre_counts = ops.counts()
    ops.reset_counts()
    steps, times = {}, []
    for i in range(n_steps):
        t0 = time.monotonic()
        with kernel_calls(ops, kept, first if i in (0, n_steps - 1)
                          else None):
            logits, cache = decode_step(params, cfg, toks[:, S + i], cache)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        if i in checks:
            steps[i] = logits.float()
    dec_counts = ops.counts()
    if check:
        check_calls(check, f"{cfg.name} layer 0", kept)
    if not torch.isfinite(logits.float()).all():
        fail(f"{cfg.name}: non-finite decode logits")

    def rms_from(x, ref):
        return ((x - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
    worst, prefilled = 0.0, {}
    for i, got in steps.items():
        want, _ = prefill(params, cmp_cfg or cfg,
                          {"tokens": toks[:, :S + i + 1]}, cache_dtype=dtype)
        want = want.float()
        prefilled[i] = want
        err = (got - want).abs().max().item()
        limit = 4 * 2 ** -7 * want.abs().max().item()
        worst = max(worst, err / limit)
        line = (f"  {cfg.name} {str(dtype)[6:]} prompt {S}: step {i} "
                f"(position {S + i}) "
                f"against prefill of {S + i + 1} tokens: max_abs_err "
                f"{err:.4e}, {err / limit:.4f} of 4*2^-7*max|logit| = "
                f"{limit:.4f}; argmax equal "
                f"{bool((got.argmax(-1) == want.argmax(-1)).all())}")
        if reference is not None:
            line += (f"; RMS distance from the f32 logits: decode "
                     f"{rms_from(got, reference[i]):.4f}, prefill "
                     f"{rms_from(want, reference[i]):.4f} (measured, not "
                     "checked)")
        print(line, flush=True)
        if reference is None and not err <= limit:
            fail(f"{cfg.name}: decode step {i} after a {S}-token prompt "
                 f"differs from the prefill of {S + i + 1} tokens by {err} "
                 f"(limit {limit})")
    med = sorted(times)[len(times) // 2]
    print(f"  {cfg.name} {str(dtype)[6:]} prompt {S}: prefill "
          f"{t_prefill:.4f} s, decode "
          f"step median {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}) over {n_steps} steps, synchronised; "
          f"worst step {worst:.4f} of its bound", flush=True)
    return t_prefill, med, pre_counts, dec_counts, prefilled


def recurrent_phase(torch, np, ops):
    """Phase 12: Mamba2-370M and RecurrentGemma-9B at published width in
    bf16 with random weights, on a card the earlier phases have released.
    RecurrentGemma's teacher-forced checks run first with f32 weights and
    caches (37.6 GB), where the bound tests the decode's semantics with
    rounding out of the way; its bf16 run then prints the same comparison
    beside both paths' distance from those f32 logits. Returns
    RecurrentGemma's launches by path."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_prefill import tensor_core_body
    from repro_torch.models.model import _hybrid_counts, decode_step, prefill
    from repro_torch.params import init_params
    gib = 2 ** 30
    prompts = {"ssm": ((4096, 32),), "hybrid": ((4096, 32), (2040, 16))}
    by_path = {}
    for arch in ("mamba2_370m", "recurrentgemma_9b"):
        cfg = get_config(arch)
        reference = {}
        if cfg.family == "hybrid":
            params = init_params(cfg, torch.Generator(
                device="cuda").manual_seed(0), device="cuda",
                dtype=torch.float32)
            for S, n_steps in prompts[cfg.family]:
                reference[S] = model_run(
                    torch, np, ops, cfg, params, S, n_steps,
                    RECURRENT_CHECKS[S], seed=22 + S)[4]
            del params
            gc.collect()
            torch.cuda.empty_cache()
        print(f"\n{cfg.name}: memory allocated before build "
              f"{torch.cuda.memory_allocated() / gib:.2f} GiB", flush=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B params "
              f"(param_count {cfg.param_count() / 1e9:.3f} B) in bf16, built "
              f"in {time.monotonic() - t0:.1f} s; memory allocated after "
              f"build {torch.cuda.memory_allocated() / gib:.2f} GiB, peak "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB", flush=True)
        if cfg.family == "ssm":
            print(f"  ssm: d_inner {cfg.d_inner}, state {cfg.ssm_state}, "
                  f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, chunk "
                  f"{cfg.ssm_chunk}")
        else:
            n_tri, tail = _hybrid_counts(cfg)
            hd = cfg.resolved_head_dim
            tc = tensor_core_body(torch.bfloat16, hd)
            print(f"  hybrid: {n_tri} (rglru, rglru, attn) triples + {tail} "
                  f"rglru; {cfg.num_heads} heads on {cfg.num_kv_heads} KV "
                  f"head of {hd}, window {cfg.local_window}; prefill body "
                  f"{'tensor cores' if tc else 'CUDA cores'} "
                  "(TENSOR_CORE_HEAD_DIMS)")
        for S, n_steps in prompts[cfg.family]:
            _, _, pre, dec, _ = model_run(
                torch, np, ops, cfg, params, S, n_steps, RECURRENT_CHECKS[S],
                seed=22 + S, reference=reference.get(S))
            if cfg.family == "ssm":
                continue
            print(f"  prompt {S}: prefill launches {json.dumps(pre)}; "
                  f"decode launches {json.dumps(dec)}", flush=True)
            if pre["flash_prefill_attention"] != n_tri or \
                    pre["flash_prefill_wgmma"] != (n_tri if tc else 0):
                fail(f"{cfg.name}: the prefill launched the prefill kernel "
                     f"{pre['flash_prefill_attention']} times "
                     f"({pre['flash_prefill_wgmma']} on the tensor-core "
                     f"body), not {n_tri} on the declared body")
            if dec["flash_decode_attention"] != n_tri * n_steps:
                fail(f"{cfg.name}: {n_steps} decode steps launched the decode "
                     f"kernel {dec['flash_decode_attention']} times, not "
                     f"{n_tri} per step")
            for c in (pre, dec):
                if c["chunked_prefill_attention_ref"] or \
                        c["decode_attention_ref"]:
                    fail(f"{cfg.name}: a plain attention version ran")
            by_path[f"recurrentgemma prompt {S} (phase 12)"] = {
                "flash_prefill_attention": pre["flash_prefill_attention"],
                "flash_decode_attention": dec["flash_decode_attention"]}
        toks = torch.from_numpy(np.random.default_rng(30).integers(
            0, cfg.vocab_size, (1, 4096))).to("cuda")
        breakdown(torch, f"{cfg.name} prefill 4096",
                  lambda: prefill(params, cfg, {"tokens": toks}))
        _, cache = prefill(params, cfg, {"tokens": toks})
        step_tok = toks[:, -1]
        breakdown(torch, f"{cfg.name} decode_step at position 4096",
                  lambda: decode_step(params, cfg, step_tok, dict(cache)))
        del params, cache, toks
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def bf16_bound(got, want, label) -> None:
    """max |got - want| against four bf16 steps at max|want| (phase 9's
    bound); fails beyond it."""
    err = (got.float() - want.float()).abs().max().item()
    limit = 4 * 2.0 ** -7 * want.float().abs().max().item()
    print(f"  {label}: max_abs_err {err:.4e}, {err / limit:.4f} of "
          f"4*2^-7*max|logit| = {limit:.4f}", flush=True)
    if not err <= limit:
        fail(f"{label}: logits differ by {err}, over {limit}")


def path_launches(label, counts, need) -> dict:
    """Fail unless each kernel of `need` launched in the path, every
    prefill launch ran the tensor-core body and no plain version ran.
    Returns the path's two kernel counts for the kernels' record."""
    print(f"  {label} launches {json.dumps(counts)}", flush=True)
    for name in need:
        if counts[name] <= 0:
            fail(f"{label}: {name} was not launched")
    if counts["flash_prefill_wgmma"] != counts["flash_prefill_attention"]:
        fail(f"{label}: {counts['flash_prefill_attention']} prefill "
             f"launches, {counts['flash_prefill_wgmma']} on a tensor-core "
             "body")
    for name in ("chunked_prefill_attention_ref", "decode_attention_ref",
                 "verify_attention_ref"):
        if counts[name]:
            fail(f"{label}: the plain {name} ran {counts[name]} times")
    return {name: counts[name] for name in ("flash_prefill_attention",
                                            "flash_decode_attention")}


def run_launches(cfg, pre, dec) -> dict:
    """`path_launches` of a `model_run`'s prefill and decode counts: the
    prefill kernel's launches from the first, the decode kernel's from the
    second."""
    return {"flash_prefill_attention": path_launches(
                f"{cfg.name} prefill", pre, ("flash_prefill_attention",)
            )["flash_prefill_attention"],
            "flash_decode_attention": path_launches(
                f"{cfg.name} decode", dec, ("flash_decode_attention",)
            )["flash_decode_attention"]}


@contextlib.contextmanager
def kernel_calls(ops, kept, pick):
    """Within the block, keep the inputs of each `ops.prefill_attention`
    and `ops.decode_attention` call that `pick(name, i)` accepts (i counts
    that function's calls in the block from 0) in `kept`, as (name, args,
    kw) with the tensors cloned: a cache written after the call cannot
    change what is checked. With `pick` None nothing is wrapped."""
    if pick is None:
        yield kept
        return

    def cloned(x):
        return x.clone() if hasattr(x, "clone") else x

    def wrap(name, fn):
        n = [0]

        def spy(*args, **kw):
            if pick(name, n[0]):
                kept.append((name, tuple(map(cloned, args)),
                             {k: cloned(x) for k, x in kw.items()}))
            n[0] += 1
            return fn(*args, **kw)
        return spy
    saved = {name: getattr(ops, name)
             for name in ("prefill_attention", "decode_attention")}
    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield kept
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def check_calls(check, label, kept) -> None:
    """Each call `kernel_calls` kept, through its kernel's wrapper against
    the plain version, with phase 2's `check`."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import flash_decode_attention
    from repro_torch.kernels.flash_prefill import flash_prefill_attention
    for name, args, kw in kept:
        q, k, v = args[:3]
        if name == "prefill_attention":
            got = flash_prefill_attention(
                q, k, v, kw.get("q_offset", 0), kw.get("kv_len"),
                causal=kw.get("causal", True),
                local_window=kw.get("local_window", 0))
            # the static-buffer path passes its output buffer as `out`
            want = ref.chunked_prefill_attention_ref(
                q, k, v, **{a: x for a, x in kw.items() if a != "out"})
            what = (f"prefill q {tuple(q.shape)} T {k.shape[1]} q_offset "
                    f"{kw.get('q_offset', 0)} kv_len {kw.get('kv_len')} "
                    f"causal {kw.get('causal', True)}")
        else:
            kv_len = args[3]
            got = flash_decode_attention(q, k, v, kv_len)
            want = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
            lens = kv_len.tolist() if hasattr(kv_len, "tolist") else kv_len
            what = f"decode q {tuple(q.shape)} T {k.shape[1]} kv_len {lens}"
        check(f"{label} {what}", q.dtype, got, want)


def whisper_run(torch, np, ops, cfg, params, check, n_steps=16, seed=40):
    """Phase 13 (a): Whisper's `prefill` (the encoder over N(0,1) stub
    frames and every decoder layer's cross K/V), `n_steps` greedy
    `decode_step`s from a BOS token, then `forward` over the emitted
    tokens. Step 0's logits against forward's position 0 (the reference's
    decode adds the position-0 sinusoid at every step, so only step 0
    matches) within the bf16 bound. Layer 0's attention inputs on both
    paths (the encoder's in the prefill, self- and cross-attention in decode
    steps 0 and n_steps - 1 and in forward's decoder) are run through each
    kernel against its plain version. Returns the launches by path."""
    from repro_torch.models import model as M
    dev, dtype = params.device, params.dtype
    nE, last = cfg.num_encoder_layers, 2 * cfg.num_layers * (n_steps - 1)
    kept = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev).to(dtype)
    bos = torch.full((1, 1), min(50258, cfg.vocab_size - 1), device=dev)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.monotonic()
    with kernel_calls(ops, kept, lambda name, i: i == 0):
        _, cache = M.prefill(params, cfg, {"tokens": bos, "frames": frames},
                             max_seq=n_steps + 2, cache_dtype=dtype)
    torch.cuda.synchronize()
    t_prefill = time.monotonic() - t0
    toks, times = [bos[:, 0]], []
    # decode calls run (self, cross) per layer: layer 0's of steps 0 and
    # n_steps - 1
    with kernel_calls(ops, kept,
                      lambda name, i: i in (0, 1, last, last + 1)):
        for i in range(n_steps):
            t0 = time.monotonic()
            lg, cache = M.decode_step(params, cfg, toks[-1], cache)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            if i == 0:
                step0 = lg.float()
            toks.append(lg.argmax(-1))
    main = path_launches(f"{cfg.name} prefill + {n_steps} decode steps",
                         ops.counts(), ("flash_prefill_attention",
                                        "flash_decode_attention"))
    med = sorted(times)[len(times) // 2]
    print(f"  {cfg.name}: prefill (encoder over {cfg.encoder_seq} frames "
          f"and {cfg.num_layers} layers' cross K/V) {t_prefill:.4f} s; "
          f"decode step median {med * 1e3:.2f} ms (min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) over "
          f"{n_steps} steps, synchronised; tokens "
          f"{[int(t[0]) for t in toks]}", flush=True)

    # forward over the emitted tokens: after the nE encoder layers, the
    # decoder's layer 0 self- and cross-attention
    ops.reset_counts()
    with kernel_calls(ops, kept, lambda name, i: i in (nE, nE + 1)):
        fw = M.forward(params, cfg, {"tokens": torch.stack(toks, 1),
                                     "frames": frames})
    fwd = path_launches(f"{cfg.name} forward over {len(toks)} tokens",
                        ops.counts(), ("flash_prefill_attention",))
    std = step0.std().item()
    print(f"  {cfg.name}: step-0 logits std {std:.4f} (a zero model gives "
          f"0), forward logits {tuple(fw.shape)}", flush=True)
    if not std >= 1e-3 or not torch.isfinite(fw.float()).all():
        fail(f"{cfg.name}: step-0 logits std {std}: the model is about "
             "zero or not finite")
    bf16_bound(step0, fw[:, 0], f"{cfg.name} decode step 0 vs forward "
               "position 0")
    check_calls(check, f"{cfg.name} layer 0", kept)
    breakdown(torch, f"{cfg.name} decode_step ({2 * cfg.num_layers} "
              "attention launches)",
              lambda: M.decode_step(params, cfg, toks[-1],
                                    dict(cache, pos=n_steps)), top=8)
    return {"whisper prefill + decode (phase 13)": main,
            "whisper forward (phase 13)": fwd}


def vlm_run(torch, np, ops, port, cfg, params, check, S=4096, chunk=512,
            stop_chunk=3, n_dec=16, seed=41):
    """Phase 13 (b): an S-token prompt whose first num_patches positions
    are patch embeddings, in `chunk`-token chunks through
    `SegmentedPrefill`; suspended at every operator boundary of chunk
    `stop_chunk` (another prefill in between each time) and resumed
    `torch.equal` to an uninterrupted run; within the bf16 bound of the
    fused `prefill`; unchanged (`torch.equal`) when only the tokens under
    the patches differ. Then `n_dec` ragged decode steps at B 4 through a
    `DecodeInstance`; each row's first step is held to the fused `prefill`
    of its prompt and first token within the bf16 bound. Layer 0's
    attention inputs of the first and last chunk and of the first and last
    decode step run through each kernel against its plain version. Returns
    the launches by path."""
    from repro_torch.models.model import prefill
    from repro_torch.models.segments import SegmentedPrefill
    dev, dtype, P = params.device, params.dtype, cfg.num_patches
    L, n_chunks = cfg.num_layers, -(-S // chunk)
    kept = []
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ve = torch.randn((1, P, cfg.d_model), generator=gen, device=dev).to(dtype)
    toks = rng.integers(0, cfg.vocab_size, (1, S))
    ex = SegmentedPrefill(params, cfg, max_seq=S, chunk_tokens=chunk,
                          cache_dtype=dtype)
    ex.run_all(ex.start(toks[:, :chunk], vision_embeds=ve))     # warm-up
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.monotonic()
    with kernel_calls(ops, kept,
                      lambda name, i: i in (0, (n_chunks - 1) * L)):
        task0 = ex.start(toks, vision_embeds=ve)
        want = ex.run_all(task0)
    torch.cuda.synchronize()
    t_seg = time.monotonic() - t0
    seg = path_launches(f"{cfg.name} segmented prefill of {S}",
                        ops.counts(), ("flash_prefill_attention",))
    spc = ex._segments_per_chunk
    print(f"  {cfg.name}: {S} tokens ({P} patch positions) in "
          f"{task0.n_chunks} chunks of {chunk}, {task0.total_segments} "
          f"segments ({'/'.join(ex.ops)}), {t_seg:.4f} s synchronised",
          flush=True)

    other = rng.integers(0, cfg.vocab_size, (1, min(300, S // 4)))
    task = ex.start(toks, vision_embeds=ve)
    stops = range(stop_chunk * spc + 1, (stop_chunk + 1) * spc + 1)
    for stop in stops:
        while task.cursor < stop:
            ex.step(task)
        ex.run_all(ex.start(other))             # another prefill meanwhile
    got = ex.run_all(task)
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    print(f"  suspended at the {len(stops)} operator boundaries of chunk "
          f"{stop_chunk} (segments {stops[0]}..{stops[-1]}): resumed logits "
          f"torch.equal the uninterrupted run: {equal}", flush=True)
    if not equal:
        fail(f"{cfg.name}: the resumed prefill differs by "
             f"{(got.float() - want.float()).abs().max().item()}")
    fused, _ = prefill(params, cfg, {"tokens": torch.from_numpy(toks).to(dev),
                                     "vision_embeds": ve}, cache_dtype=dtype)
    bf16_bound(want, fused, f"{cfg.name} segmented vs fused prefill")
    toks2 = toks.copy()
    toks2[:, :P] = rng.integers(0, cfg.vocab_size, (1, P))
    same = torch.equal(ex.run_all(ex.start(toks2, vision_embeds=ve)), want)
    print(f"  other tokens under the {P} patches: logits torch.equal: "
          f"{same}", flush=True)
    if not same:
        fail(f"{cfg.name}: the tokens under the patch embeddings changed "
             "the logits")

    prompts = [toks]
    handoffs = [(int(want.argmax(-1)[0]), {
        "k": task0.state["k_cache"], "v": task0.state["v_cache"], "pos": S})]
    for n in (S * 3 // 4, S // 2, S // 4):
        prompts.append(rng.integers(0, cfg.vocab_size, (1, n)))
        t = ex.start(prompts[-1], vision_embeds=ve)
        handoffs.append((int(ex.run_all(t).argmax(-1)[0]), {
            "k": t.state["k_cache"], "v": t.state["v_cache"], "pos": n}))
    torch.cuda.synchronize()
    ops.reset_counts()
    # every row is admitted before the first step: n_dec steps at B 4
    with kernel_calls(ops, kept, lambda name, i: i in (0, (n_dec - 1) * L)):
        inst, out, calls = recorded_run(port, params, cfg, handoffs, n_dec)
    dec = path_launches(f"{cfg.name} ragged decode B {len(handoffs)}",
                        ops.counts(), ("flash_decode_attention",))
    check_calls(check, f"{cfg.name} layer 0", kept)
    for (first, cache), p in zip(handoffs, prompts):
        n = cache["pos"]
        fused, _ = prefill(params, cfg, {
            "tokens": torch.from_numpy(np.append(p, [[first]], 1)).to(dev),
            "vision_embeds": ve}, cache_dtype=dtype)
        bf16_bound(logits_of(calls, n, 1), fused[0],
                   f"{cfg.name} ragged step 0 of the {n}-token row vs fused "
                   f"prefill of {n + 1} tokens")
    steps = np.asarray(inst.step_samples) * 1e3
    print(f"  {cfg.name}: {inst.steps} ragged decode steps at B "
          f"{len(handoffs)} (prompts {[c['pos'] for _, c in handoffs]}), "
          f"step p50 {np.median(steps):.2f} ms max {steps.max():.2f} ms",
          flush=True)
    if any(len(o) != n_dec + 1 or not all(0 <= x < cfg.vocab_size
                                          for x in o) for o in out):
        fail(f"{cfg.name}: bad decode outputs {out}")
    return {"internvl2 segmented prefill + ragged decode (phase 13)":
            {"flash_prefill_attention": seg["flash_prefill_attention"],
             "flash_decode_attention": dec["flash_decode_attention"]}}


def pairs_run(torch, np, ops, cfg, params, check, S=2048, n_steps=16,
              seed=42):
    """Phase 13 (c): Llama4-Maverick's (dense, MoE) pairs through `prefill`
    of S tokens and `n_steps` teacher-forced `decode_step`s, each held to a
    `prefill` of the same tokens within the bf16 bound. The comparison
    prefills run drop-free (capacity factor E/k, as the reference's own MoE
    decode tests do): a one-token decode step never drops an expert pair,
    and with one pair the K/V of both layers come before any MoE output, so
    the published capacity's drops in the first prefill change nothing the
    steps read. Then a profiler breakdown of one step beside the bytes of
    its routed experts. Returns the launches by path."""
    import dataclasses

    from repro_torch.models.model import decode_step, prefill
    drop_free = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    _, _, pre, dec, _ = model_run(
        torch, np, ops, cfg, params, S, n_steps, range(n_steps), seed,
        cmp_cfg=drop_free, check=check)
    main = run_launches(cfg, pre, dec)
    es = params.dtype.itemsize
    n_moe = cfg.num_layers // 2
    expert_bytes = n_moe * cfg.experts_per_token * 3 * cfg.d_model \
        * cfg.d_ff * es
    print(f"  expert bytes per decode step (the grouped kernel reads the "
          f"{cfg.experts_per_token} routed expert(s) of each of {n_moe} MoE "
          f"layer(s)): {expert_bytes / 1e9:.3f} GB, "
          f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s",
          flush=True)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, S + 1))).to(params.device)
    _, cache = prefill(params, cfg, {"tokens": toks[:, :S]}, max_seq=S + 1,
                       cache_dtype=params.dtype)
    breakdown(torch, f"{cfg.name} decode_step at position {S}",
              lambda: decode_step(params, cfg, toks[:, S], dict(cache)),
              top=8)
    return {"llama4 pair prefill + decode (phase 13)": main}


def families_phase(torch, np, ops, port, check):
    """Phase 13: Whisper-large-v3 whole, InternVL2-76B at 8 of its 80
    layers, Llama4-Maverick at one (dense, MoE) pair, and Llama3.2-1B,
    Qwen2-1.5B, Qwen2.5-3B and Minitron-4B whole, each at published width
    in bf16 with random weights, one at a time on a card the earlier phases
    released. Returns the launches by path."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.params import init_params, redraw_norms
    gib = 2 ** 30

    def draw(cfg, cut=""):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda",
                             dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in params.parameters())
        print(f"\n{cfg.name}: {cfg.num_layers} layers{cut}, d_model "
              f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
              f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}; "
              f"{n / 1e9:.3f} B params in bf16, drawn in "
              f"{time.monotonic() - t0:.1f} s; memory allocated "
              f"{torch.cuda.memory_allocated() / gib:.2f} GiB", flush=True)
        return params

    by_path = {}
    cfg = get_config("whisper_large_v3")
    params = draw(cfg, f" + {cfg.num_encoder_layers} encoder layers")
    redraw_norms(params, seed=1)
    by_path.update(whisper_run(torch, np, ops, cfg, params, check))
    del params

    full = get_config("internvl2_76b")
    cfg = dataclasses.replace(full, num_layers=8)
    params = draw(cfg, f" of {full.num_layers}")
    by_path.update(vlm_run(torch, np, ops, port, cfg, params, check))
    del params

    full = get_config("llama4_maverick_400b")
    cfg = dataclasses.replace(full, num_layers=2)
    params = draw(cfg, f" (one dense/MoE pair) of {full.num_layers}, "
                  f"{cfg.num_experts} experts top-{cfg.experts_per_token} "
                  f"of d_ff {cfg.d_ff}, dense d_ff {cfg.d_ff_dense}")
    by_path.update(pairs_run(torch, np, ops, cfg, params, check))
    del params

    for arch in ("llama3_2_1b", "qwen2_1_5b", "qwen2_5_3b", "minitron_4b"):
        cfg = get_config(arch)
        params = draw(cfg)
        _, _, pre, dec, _ = model_run(torch, np, ops, cfg, params, 1024, 8,
                                      range(8), seed=43, check=check)
        by_path[f"{arch} prefill + decode (phase 13)"] = \
            run_launches(cfg, pre, dec)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def train_setup(torch, remat="full"):
    """Phase 14's model, AdamW state, train step and data: Llama3.2-1B at
    published width, bf16 trainable parameters from seed 0, f32 m and v."""
    from repro_torch.configs.base import get_config
    from repro_torch.params import init_params
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train import make_train_step
    cfg = get_config(TRAIN["arch"])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=torch.bfloat16, trainable=True)
    opt_cfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=1,
                          total_steps=TRAIN["steps"])
    data = DataConfig(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
                      vocab_size=cfg.vocab_size)
    return (cfg, params, init_state(params),
            make_train_step(cfg, opt_cfg, remat=remat), opt_cfg, data)


def attention_grads(torch, q, k, v, dout):
    """out, dq, dk, dv of `FlashAttention` (causal) on q, k, v's device."""
    from repro_torch.models.layers import blocked_attention
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = blocked_attention(*leaves)
    out.backward(dout)
    return [out.detach()] + [x.grad for x in leaves]


def train_attention(torch, ops, check, kept) -> dict:
    """Layer 0's attention inputs of the first training step through
    `FlashAttention` on the card against the plain forward and backward on
    the CPU in f32, then the times at that shape: the kernel, its plain
    version and SDPA; the plain backward and SDPA's backward. Returns the
    kernel's record at the training shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill_attention
    if len(kept) != 1:
        fail(f"phase 14 kept {len(kept)} attention calls of layer 0")
    _, (q, k, v), kw = kept[0]
    if kw.get("q_offset", 0) != 0 or kw.get("kv_len") is not None \
            or not kw.get("causal", True):
        fail(f"phase 14: layer 0's attention ran with {kw}")
    q, k, v = (x.detach() for x in (q, k, v))
    B, S, H, hd = q.shape
    K = k.shape[2]
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda")
                       .manual_seed(14), device="cuda").to(q.dtype)
    got = attention_grads(torch, q, k, v, dout)
    t0 = time.monotonic()
    cpu = [x.float().cpu() for x in (q, k, v, dout)]
    want = attention_grads(torch, *cpu)
    # the backward on the same inputs as the card's: the kernel's bf16 out
    same = ref.flash_attention_bwd_ref(*cpu[:3], got[0].float().cpu(), cpu[3])
    print(f"  layer 0 attention {tuple(q.shape)} over {tuple(k.shape)}: "
          f"the CPU's f32 plain forward and backwards took "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    errs = {"out": check("train attention out: kernel vs plain",
                         torch.bfloat16, got[0].float(), want[0].to("cuda"))}
    for name, g, w, w_same in zip(("dq", "dk", "dv"), got[1:], want[1:],
                                  same):
        errs[name] = check(f"train attention {name}: card vs plain, same "
                           "inputs", torch.bfloat16, g.float(),
                           w_same.to("cuda"))
        # end to end the backward's D = rowsum(dout * out) takes the
        # kernel's bf16 out where the plain forward's is f32: an absolute
        # error that an element near 0 cannot hold within one bf16 step of
        # itself, so this comparison takes phase 9's bound
        bf16_bound(g, w.to("cuda"), f"train attention {name}: card vs "
                   "plain forward + backward in f32")
    del got, want, same

    es = q.element_size()
    work = prefill_work(B, S, H, K, hd, 0, S, es)
    row = {"shape": TRAIN_SHAPE, "max_abs_err": errs["out"]}
    row["bound_ms"], row["bound_by"] = bound(*work)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row["ms"] = cuda_ms(torch, lambda: flash_prefill_attention(q, k, v, 0,
                                                               None))
    row["plain_ms"] = cuda_ms(torch, lambda: ref.chunked_prefill_attention_ref(
        q, k, v), iters=3, warmup=1)
    row["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    print(f"  flash_prefill_attention {TRAIN_SHAPE}: {json.dumps(row)}; "
          f"share of the bound {row['bound_ms'] / row['ms']:.4f}",
          flush=True)

    # the backward: 5 products (s again, dp, dv, dq, dk) of 2*hd operations
    # per visible pair and query head, on bf16 tensor cores; bytes: q, k, v,
    # out, dout read and dq, dk, dv written once
    out = flash_prefill_attention(q, k, v, 0, None)
    pairs = work[0] / (4.0 * hd * H)
    bwd = {"max_abs_err": max(errs[n] for n in ("dq", "dk", "dv"))}
    bwd["bound_ms"], bwd["bound_by"] = bound(
        10.0 * hd * H * pairs, es * B * S * hd * (4 * H + 4 * K))
    bwd["plain_ms"] = cuda_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, dout), iters=3, warmup=1)
    leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
    o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                            enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    bwd["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        o_sdpa, leaves, dout_t, retain_graph=True))
    print(f"  attention backward per layer (not a TPU kernel: plain torch, "
          f"f32) {TRAIN_SHAPE}: {json.dumps(bwd)}; share of the bound "
          f"{bwd['bound_ms'] / bwd['plain_ms']:.4f}", flush=True)
    row["backward_plain"] = bwd
    return row


def train_phase(torch, np, ops, kcounts, check):
    """Phase 14: Llama3.2-1B trained at published width on the card (see the
    module docstring). Returns (the prefill kernel's launches on the path,
    its record at the training shape)."""
    from torch.profiler import record_function

    from repro_torch.training.data import data_iterator
    from repro_torch.training.optimizer import apply_updates
    from repro_torch.training.train import grads_of, loss_fn
    gib = 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, state, step, opt_cfg, data = train_setup(torch)
    n = sum(p.numel() for p in params.parameters())
    steps, tokens = TRAIN["steps"], TRAIN["batch"] * TRAIN["seq"]
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}; {n / 1e9:.3f} B "
          f"params in bf16, AdamW m and v in f32; seq {TRAIN['seq']}, batch "
          f"{TRAIN['batch']} (train_4k's 256 cut to one card), remat full, "
          f"lr {TRAIN['lr']}, {steps} steps; memory allocated "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB", flush=True)
    it = data_iterator(data)
    losses, times, kept = [], [], []
    ops.reset_counts()
    with kernel_calls(ops, kept, lambda name, i: i == 0):
        for i in range(steps):
            batch = next(it)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            params, state, met = step(params, state, batch)
            losses.append(met["loss"].item())
            times.append(time.monotonic() - t0)
            print(f"  step {i}: loss {losses[-1]:.4f} grad_norm "
                  f"{float(met['grad_norm']):.4f} lr {float(met['lr']):.3e} "
                  f"{times[-1] * 1e3:.1f} ms", flush=True)
    counts = {**ops.counts(), **kcounts.read(["flash_attention_bwd_ref"])}
    peak = torch.cuda.max_memory_allocated()
    med = sorted(times[1:])[len(times[1:]) // 2]
    print(f"  median step {med * 1e3:.1f} ms (steps 1-{steps - 1}, "
          f"synchronised), {tokens / med:.0f} tokens/s, peak memory "
          f"allocated {peak / gib:.2f} GiB", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 14: non-finite loss {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"phase 14: first loss {losses[0]:.4f} not near "
             f"ln({cfg.vocab_size}) = {math.log(cfg.vocab_size):.4f}")
    if not losses[-1] < losses[0]:
        fail(f"phase 14: the loss did not fall: {losses}")
    per_step = 2 * cfg.num_layers * steps       # forward + remat recompute
    print(f"  launches {json.dumps(counts)}", flush=True)
    want = {"flash_prefill_attention": per_step, "flash_prefill_wgmma":
            per_step, "chunked_prefill_attention_ref": 0,
            "flash_attention_bwd_ref": cfg.num_layers * steps}
    for name, c in want.items():
        if counts[name] != c:
            fail(f"phase 14: {name} ran {counts[name]} times, not {c}")

    row = train_attention(torch, ops, check, kept)
    del kept

    def one_step():
        loss = loss_fn(params, cfg, batch, remat="full")
        grads = grads_of(loss, params)
        with record_function("adamw"):
            apply_updates(opt_cfg, params, grads, state)
    breakdown(torch, "one train step (remat full)", one_step, top=10,
              cpu_ops=("FlashAttention", "FlashAttentionBackward",
                       "aten::bmm", "aten::mm", "adamw",
                       "aten::_log_softmax",
                       "aten::_log_softmax_backward_data",
                       "aten::select_backward", "aten::fill_"))
    del params, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # remat and restart under deterministic algorithms, in a process whose
    # cuBLAS starts with CUBLAS_WORKSPACE_CONFIG set
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-determinism"],
        env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
        capture_output=True, text=True, timeout=900)
    print(out.stdout, end="", flush=True)
    if out.returncode != 0:
        fail(f"phase 14 determinism checks (rc {out.returncode}): "
             f"{out.stderr[-4000:]}")
    print(f"  determinism checks took {time.monotonic() - t0:.1f} s",
          flush=True)
    return {"train (phase 14)": counts["flash_prefill_attention"]}, row


def train_determinism(torch) -> None:
    """Phase 14's checks that need deterministic kernels (run by phase 14
    in a process of its own): the remat policies' gradients and memory, and
    the bit-exact restart through a checkpoint."""
    import shutil

    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import data_iterator, make_batch
    from repro_torch.training.train import grads_of, loss_fn
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gib = 2 ** 30
    atol, rtol = TOL["torch.bfloat16"]

    cfg, params, state, _, _, data = train_setup(torch)
    batch = make_batch(data, 0)
    grads, used = {}, {}
    for remat in ("none", "dots", "full"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads[remat] = grads_of(loss_fn(params, cfg, batch, remat=remat),
                                params)
        torch.cuda.synchronize()
        used[remat] = torch.cuda.max_memory_allocated() - base
        print(f"  remat {remat}: one step's forward and backward peak "
              f"{used[remat] / gib:.2f} GiB above the "
              f"{base / gib:.2f} GiB held before it", flush=True)
    for remat in ("dots", "full"):
        equal, worst = 0, 0.0
        for key, want in grads["none"].items():
            got = grads[remat][key]
            equal += torch.equal(got, want)
            diff = (got.float() - want.float()).abs()
            worst = max(worst, (diff / (atol + rtol * want.float().abs()))
                        .max().item())
        print(f"  grads at remat {remat} vs none: {equal} of "
              f"{len(grads['none'])} leaves torch.equal, worst/limit "
              f"{worst:.4f}", flush=True)
        if worst > 1.0:
            fail(f"remat {remat}: a gradient element is {worst:.3f} times "
                 f"its bf16 limit")
    if not used["none"] > used["dots"] > used["full"]:
        fail(f"remat memory not ordered none > dots > full: {used}")
    del grads, params, state
    gc.collect()
    torch.cuda.empty_cache()

    def run(params, state, step, start, n):
        it = data_iterator(data, start_step=start)
        for _ in range(n):
            params, state, _ = step(params, state, next(it))
        return params, state

    t0 = time.monotonic()
    _, p_full, s_full, step, _, _ = train_setup(torch)
    p_full, s_full = run(p_full, s_full, step, 0, 4)
    _, params, state, step, _, _ = train_setup(torch)
    params, state = run(params, state, step, 0, 2)
    directory = ROOT / "build" / "train_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    t1 = time.monotonic()
    ckpt.save(str(directory), 2, {"params": params, "opt_state": state})
    t2 = time.monotonic()
    back = ckpt.restore(str(directory), 2, {"params": params,
                                            "opt_state": state})
    torch.cuda.synchronize()
    t3 = time.monotonic()
    shutil.rmtree(directory, ignore_errors=True)
    del params, state
    params, state = run(back["params"], back["opt_state"], step, 2, 2)
    torch.cuda.synchronize()
    pairs = [(p_full.leaves(), params.leaves()), (s_full.m, state.m),
             (s_full.v, state.v)]
    equal = sum(torch.equal(a[k], b[k]) for a, b in pairs for k in a)
    total = sum(len(a) for a, _ in pairs)
    print(f"  restart: 4 steps straight vs 2 + save ({t2 - t1:.1f} s) + "
          f"restore ({t3 - t2:.1f} s) + 2, {equal} of {total} leaves "
          f"(params, m, v) torch.equal, step {int(state.step)}; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    if equal != total or int(state.step) != 4:
        fail(f"restart: {total - equal} of {total} leaves differ from the "
             f"uninterrupted run")


def full(x):
    """A DTensor's whole value (the identity for a plain tensor)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def same_or_bound(got, want, label) -> bool:
    """True when got is `torch.equal` to want; else held to phase 9's bf16
    bound (`bf16_bound`), which fails beyond it."""
    import torch
    if torch.equal(got, want):
        return True
    bf16_bound(got, want, f"{label} (not bit-equal)")
    return False


def sharded_train(torch, ops, kcounts, mesh, device="cuda"):
    """Phase 15's train half: one step of phase 14's Llama3.2-1B at its
    shape, first outside a mesh, then from the same initial weights as
    DTensors on `mesh` under `train_rules` (params and AdamW state sharded
    by `param_axes` / `opt_state_axes`). Returns (launches, the step times
    in ms, the number of leaves that were not bit-equal)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.params import ModelParams, distribute_params, nested
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import init_state
    cfg, params, state, step, _, data = train_setup(torch)
    init = {k: t.detach().clone() for k, t in params.leaves().items()}
    batch = make_batch(data, 0, device=device)
    times = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        times[label] = (time.monotonic() - t0) * 1e3
        return out
    params, state, met0 = timed(
        "plain", lambda: step(params, state, batch))
    rules = shd.train_rules()
    p1 = distribute_params(ModelParams(nested(init), trainable=True), cfg,
                           mesh, rules)
    del init
    s1 = init_state(p1)
    sizes = shd.axis_sizes(mesh)
    b1 = {k: shd.distribute(t, mesh, shd.placements(
              tuple(t.shape), ("act_batch", None), sizes, rules))
          for k, t in batch.items()}
    ops.reset_counts()
    with shd.use_sharding(mesh, rules):
        p1, s1, met1 = timed("sharded", lambda: step(p1, s1, b1))
    counts = {**ops.counts(), **kcounts.read(["flash_attention_bwd_ref"])}
    print(f"  train step {times['plain']:.1f} ms plain, "
          f"{times['sharded']:.1f} ms sharded (first sharded step: DTensor "
          f"propagates every op's sharding once); loss "
          f"{met0['loss'].item():.6f} / {full(met1['loss']).item():.6f}",
          flush=True)
    launches = path_launches("sharded train step", counts,
                             ("flash_prefill_attention",))
    if counts["flash_attention_bwd_ref"] != cfg.num_layers:
        fail(f"phase 15: the attention backward ran "
             f"{counts['flash_attention_bwd_ref']} times, not "
             f"{cfg.num_layers}")
    want = params.leaves()
    pairs = [("loss", full(met1["loss"]), met0["loss"])]
    for k, t in p1.leaves().items():
        pairs += [(k, full(t.detach()), want[k].detach()),
                  (f"m {k}", full(s1.m[k]), state.m[k]),
                  (f"v {k}", full(s1.v[k]), state.v[k])]
    unequal = [k for k, got, w in pairs if not torch.equal(got, w)]
    print(f"  {len(pairs) - len(unequal)} of {len(pairs)} (loss, every "
          f"parameter, m and v) torch.equal to the unsharded step",
          flush=True)
    for k, got, w in pairs:
        if k in unequal:
            bf16_bound(got, w, f"train {k}")
    # a second step of each, after DTensor's first-call propagation
    batch = make_batch(data, 1, device=device)
    b1 = {k: shd.distribute(t, mesh, shd.placements(
              tuple(t.shape), ("act_batch", None), sizes, rules))
          for k, t in batch.items()}
    timed("plain, step 2", lambda: step(params, state, batch))
    with shd.use_sharding(mesh, rules):
        timed("sharded, step 2", lambda: step(p1, s1, b1))
    print(f"  second step {times['plain, step 2']:.1f} ms plain, "
          f"{times['sharded, step 2']:.1f} ms sharded", flush=True)
    return launches["flash_prefill_attention"], times, len(unequal)


def sharded_serve(torch, np, ops, mesh, n_steps=16, S=4096,
                  device="cuda"):
    """Phase 15's serve half: Llama3-8B at published width in bf16, one
    `prefill` of S tokens and n_steps greedy `decode_step`s, outside a mesh
    and then on `mesh` under `serve_rules` on the same weights (the decode
    cache sequence-sharded over `model`, gathered before each decode
    kernel). Returns (launches by kernel, times, the number of steps whose
    logits were not bit-equal)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.params import distribute_params, init_params
    cfg = get_config("llama3_8b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device, dtype=torch.bfloat16)
    rules = shd.serve_rules()
    sharded = distribute_params(params, cfg, mesh, rules)
    toks = torch.as_tensor(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (1, S)), device=device)
    sizes = shd.axis_sizes(mesh)

    def put(t, on_mesh):
        if not on_mesh:
            return t
        dims = ("act_batch",) + (None,) * (t.dim() - 1)
        return shd.distribute(t, mesh, shd.placements(tuple(t.shape), dims,
                                                      sizes, rules))

    def run(p, on_mesh):
        out = {"logits": [], "tokens": [], "step_ms": []}
        with shd.use_sharding(mesh if on_mesh else None, rules):
            for _ in range(2):                   # the second is timed
                torch.cuda.synchronize()
                t0 = time.monotonic()
                logits, cache = M.prefill(p, cfg, {"tokens": put(toks,
                                                                 on_mesh)},
                                          max_seq=S + n_steps + 1,
                                          cache_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                out["prefill_s"] = time.monotonic() - t0
            out["logits"].append(full(logits))
            for _ in range(n_steps):
                nxt = out["logits"][-1].argmax(-1)
                out["tokens"].append(int(nxt[0]))
                torch.cuda.synchronize()
                t0 = time.monotonic()
                logits, cache = M.decode_step(p, cfg, put(nxt, on_mesh),
                                              cache)
                torch.cuda.synchronize()
                out["step_ms"].append((time.monotonic() - t0) * 1e3)
                out["logits"].append(full(logits))
        out["next"] = (cache, out["logits"][-1].argmax(-1))
        return out
    plain = run(params, False)
    ops.reset_counts()
    got = run(sharded, True)
    counts = ops.counts()
    for label, r, p, on_mesh in (("plain", plain, params, False),
                                 ("sharded", got, sharded, True)):
        cache, nxt = r["next"]
        with shd.use_sharding(mesh if on_mesh else None, rules):
            breakdown(torch, f"  {label} decode_step (position {S + n_steps})",
                      lambda: M.decode_step(p, cfg, put(nxt, on_mesh),
                                            cache))
    med = {k: sorted(r["step_ms"])[n_steps // 2]
           for k, r in (("plain", plain), ("sharded", got))}
    print(f"  prefill {S}: {plain['prefill_s']:.4f} s plain, "
          f"{got['prefill_s']:.4f} s sharded; decode step median "
          f"{med['plain']:.2f} ms plain, {med['sharded']:.2f} ms sharded "
          f"({n_steps} steps)", flush=True)
    print(f"  tokens plain   {plain['tokens']}\n"
          f"  tokens sharded {got['tokens']}", flush=True)
    launches = path_launches("sharded prefill + decode", counts,
                             ("flash_prefill_attention",
                              "flash_decode_attention"))
    want = {"flash_prefill_attention": 2 * cfg.num_layers,
            "flash_decode_attention": n_steps * cfg.num_layers}
    for name, n in want.items():
        if counts[name] != n:
            fail(f"phase 15: {name} launched {counts[name]} times, not {n}")
    unequal = sum(not same_or_bound(g, w, f"serve step {i}")
                  for i, (g, w) in enumerate(zip(got["logits"],
                                                 plain["logits"])))
    if got["tokens"] != plain["tokens"]:
        fail(f"phase 15: sharded tokens {got['tokens']} differ from "
             f"{plain['tokens']}")
    print(f"  {n_steps + 1 - unequal} of {n_steps + 1} logits torch.equal, "
          "tokens equal", flush=True)
    times = {"prefill_s": {"plain": plain["prefill_s"],
                           "sharded": got["prefill_s"]},
             "decode_step_ms": med}
    return launches, times, unequal


def sharded_phase(torch, np, ops, kcounts):
    """Phase 15 (see the module docstring): a 1-rank NCCL group from a
    `FileStore` under build/ and a (data 1, model 1) mesh; the sharded
    train step and the sharded prefill + decode, each against the same run
    outside the mesh. Returns the kernels' launches by path and the
    times."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store = ROOT / "build" / "nccl_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(store), 1), rank=0,
            world_size=1, device_id=torch.device("cuda", 0))
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)                     # NCCL starts here
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - any start failure fails
        fail(f"phase 15: NCCL did not start: {type(exc).__name__}: {exc}")
    print(f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
          f"world {dist.get_world_size()}, mesh {mesh}", flush=True)
    try:
        train_launch, train_ms, train_unequal = sharded_train(
            torch, ops, kcounts, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        serve_launch, serve_times, serve_unequal = sharded_serve(
            torch, np, ops, mesh)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {"flash_prefill_attention": {
                   "sharded train (phase 15)": train_launch,
                   "sharded prefill (phase 15)":
                       serve_launch["flash_prefill_attention"]},
               "flash_decode_attention": {
                   "sharded decode (phase 15)":
                       serve_launch["flash_decode_attention"]}}
    return by_path, {"train_step_ms": train_ms, **serve_times,
                     "train_leaves_not_equal": train_unequal,
                     "serve_steps_not_equal": serve_unequal}


def dryrun_phase() -> None:
    """Phase 16: the port's dry-run in a process of its own (its `fake`
    group cannot share this process with phase 15's NCCL one): llama3_2_1b
    on pod1 (train_4k, prefill_32k, decode_32k; long_500k skipped) and
    train_4k on pod2, at published width, on meta tensors."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    results = ROOT / "results" / "dryrun_torch"
    for extra in (["--mesh", "pod1"], ["--mesh", "pod2", "--shape",
                                       "train_4k"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "llama3_2_1b", "--force", *extra]
        t0 = time.monotonic()
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600, cwd=ROOT)
        print(f"  {' '.join(cmd[3:])}: rc {out.returncode} in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        if out.returncode != 0:
            fail(f"phase 16: the dry-run failed: {out.stdout[-2000:]}"
                 f"{out.stderr[-2000:]}")
    cells = [f"llama3_2_1b__{shape}__pod1.json" for shape in (
        "train_4k", "prefill_32k", "decode_32k", "long_500k")]
    for name in cells + ["llama3_2_1b__train_4k__pod2.json"]:
        path = results / name
        r = json.loads(path.read_text())
        if r["status"] == "error":
            fail(f"phase 16: {path.name}: {r['error']}")
        if r["status"] == "skipped":
            print(f"  {r['shape']} {r['mesh']}: skipped ({r['reason']})")
            continue
        coll = {k: v for k, v in r["collective_bytes_per_device"].items()
                if v}
        print(f"  {r['shape']} {r['mesh']} ({r['devices']} devices): "
              f"per device argument bytes {json.dumps(r['argument_bytes'])}"
              f", FLOPs {r['flops']:.4e}, collective bytes "
              f"{json.dumps(coll)}, traced in {r['wall_s']} s", flush=True)


def sim_phase(profile: dict) -> None:
    """Phase 17: the simulator's H100 against the card: the cost model's
    TTFT of a lone Llama3-8B prompt at phase 4's lengths (chunk 512, as the
    profile's executor runs) beside phase 4's measured TTFT. Prints only."""
    from repro_torch.sim.costmodel import LLAMA3_8B, PrefillCostModel
    from repro_torch.sim.hardware import H100
    model = PrefillCostModel(LLAMA3_8B, H100)
    for n, measured in sorted(profile.items()):
        predicted = model.prefill_time(n, chunk_tokens=512)
        print(f"  {n:>5} tokens: simulated {predicted * 1e3:.2f} ms, "
              f"measured {measured * 1e3:.2f} ms, measured/simulated "
              f"{measured / predicted:.3f}", flush=True)


def load_example(name):
    """`examples/<name>.py` as a module (the directory has no
    `__init__`)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hold_until_crash(inst):
    """Make `inst`'s pool worker wait before its first segment until the
    instance is crashed or the scheduler preempts the task (a worker acks
    at its next operator boundary), so that a crash of this instance
    strands a request with its segment still to run on the instance's
    stream; the segment then runs as a zombie. Without it a prefill can
    finish inside the arrival gap before the crash and leave nothing to
    strand (tests/test_torch_examples.py uses it too)."""
    import threading
    step, released = inst.pool._step, threading.Event()

    def held(task):
        deadline = time.monotonic() + 60.0
        while not released.is_set() and inst.healthy \
                and not inst.pool.signal.check() \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        released.set()
        return step(task)
    inst.pool._step = held


# phase 18's chaos plan: churn's crash (a third into the trace) on prefill
# instance 0, which least-loaded dispatch fills first, and gray's hang (a
# quarter in) moved from a prefill to decode instance 0 and lasting the
# rest of the 40 s trace, so that the example's cap, twice the watchdog
# period, sets its length
CHAOS_18 = (
    dict(time=40.0 / 3, instance=0, kind="crash", duration=40.0 / 3),
    dict(time=10.0, instance=0, kind="hang", duration=30.0,
         target="decode"),
)


def read_counts(ops, kcounts) -> dict:
    """The launch counters since the last reset, the split-KV body's
    included."""
    from repro_torch.kernels.decode_attn import BODY
    return dict(ops.counts(), **kcounts.read([BODY]))


def cluster_run(ops, kcounts, sc, argv, params, watchdog_s, hold=False):
    """One real-mode run of examples/serve_cluster_torch.py with the
    launch counters zeroed just before it: returns the report, the
    requests, each request's first-token logits, the counts and the
    seconds it took."""
    args = sc.parser().parse_args(argv)
    cfg, _, ex, profile = sc.load_model(args, params=params)
    cl = sc.Cluster(args, cfg, params, ex, profile, watchdog_s=watchdog_s)
    if hold:
        hold_until_crash(cl.insts[0])
    try:
        ops.reset_counts()
        t0 = time.monotonic()
        try:
            rep, reqs = sc.serve(args, cl, drain_timeout=180.0)
        except SystemExit as exc:                  # the drain timed out
            fail(f"phase 18: {argv}: {exc}; watchdog log "
                 f"{cl.proxy.watchdog_log}")
        took = time.monotonic() - t0
        counts = read_counts(ops, kcounts)
        logits = cl.prefill_logits(reqs)
        sc.print_real(args, cl, rep)
        decoded = sum(len(d.finished) for d in cl.decs)
        steps = [t * 1e3 for d in cl.decs for t in d.step_samples]
    finally:
        cl.shutdown()
    fires = [(kind, k, round(stall, 3)) for kind, k, stall, _ in
             cl.proxy.watchdog_log]
    print(f"  {took:.1f} s; dispatched by instance "
          f"{rep['dispatched_by_instance']}, decode_migrations "
          f"{rep['decode_migrations']}, retries {rep['retries']}, watchdog "
          f"fires {rep['watchdog_fires']} {fires}, decoded {decoded}; "
          f"decode step ms (synchronised) p50 {statistics.median(steps):.1f} "
          f"max {max(steps):.1f} over {len(steps)} steps", flush=True)
    if rep["stranded_rids"] or rep["n_requests"] != args.requests \
            or decoded + rep["lost_requests"] + rep["shed_requests"] \
            != args.requests:
        fail(f"phase 18: {argv}: not every request terminal: {rep}")
    return rep, reqs, logits, counts, took


def examples_phase(torch, ops, kcounts, device="cuda"):
    """Phase 18: the port's examples at Llama3-8B's published width in
    bf16 (on `device` "cpu", a rehearsal at the examples' tiny config in
    f32, where the launch checks fail). Returns the launch counts by path
    for the kernels' record."""
    import gc
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attn import BODY
    from repro_torch.launch.serve import draw_params
    full = device == "cuda"
    qs = load_example("quickstart_torch")
    cfg = get_config("llama3_8b") if full else qs.config()
    t_phase = time.monotonic()
    params = draw_params(cfg, device, 0)
    by_path = {}

    def launches(label, counts, need):
        c = path_launches(label, counts, need)
        body = counts[BODY]
        if body != counts["flash_decode_attention"] + \
                counts["flash_verify_attention"]:
            fail(f"{label}: {body} launches of the split-KV body for "
                 f"{counts['flash_decode_attention']} decode and "
                 f"{counts['flash_verify_attention']} verify launches")
        by_path[f"{label} (phase 18)"] = dict(
            c, flash_verify_attention=counts["flash_verify_attention"])

    # (a) the quickstart: A preempted, resumed bit-exactly
    t0 = time.monotonic()
    ex, profile, pred = qs.setup(params, cfg)
    ops.reset_counts()
    res = qs.walkthrough(params, cfg, ex, pred)
    counts = read_counts(ops, kcounts)
    op_ms = profile[qs.LONG] / res["segments"] * 1e3
    print(f"(a) quickstart: profile "
          f"{json.dumps({n: round(t, 4) for n, t in profile.items()})} s; "
          f"B after {res['delay']:.3f} s: B TTFT {res['b'].ttft:.4f} s, A "
          f"TTFT {res['a'].ttft:.4f} s, {res['preemptions']} preemption(s), "
          f"blocking mean {res['blocking_mean'] * 1e3:.2f} ms max "
          f"{res['blocking_max'] * 1e3:.2f} ms beside one operator "
          f"{op_ms:.3f} ms (TTFT {qs.LONG} / {res['segments']} segments), "
          f"rounds {res['rounds']}, bit-exact {res['bit_exact']}; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    if res["preemptions"] < 1:
        fail("phase 18 (a): request A was not preempted")
    if not res["bit_exact"]:
        fail("phase 18 (a): A's resumed logits differ from the solo run's")
    launches("quickstart", counts, ("flash_prefill_attention",))
    del ex, res

    # (b) serve_trace: S-EDF and FCFS over the scaled QwenTrace mix
    st = load_example("serve_trace_torch")
    t0 = time.monotonic()
    ex, profile, pred = st.setup(params, cfg)
    print(f"(b) serve_trace: profile "
          f"{json.dumps({n: round(t, 4) for n, t in profile.items()})} s",
          flush=True)
    for policy in ("s-edf", "fcfs"):
        ops.reset_counts()
        rep = st.run(policy, params, cfg, pred, ex, 12)
        counts = read_counts(ops, kcounts)
        st.print_report(policy, rep)
        if rep["decoded"] != rep["n_requests"] or rep["n_requests"] != 12:
            fail(f"phase 18 (b) {policy}: decoded {rep['decoded']} of "
                 f"{rep['n_requests']}")
        launches(f"serve_trace {policy}", counts,
                 ("flash_prefill_attention", "flash_decode_attention"))
    print(f"  (b) took {time.monotonic() - t0:.1f} s", flush=True)
    del ex
    gc.collect()
    torch.cuda.empty_cache()

    # (c) serve_cluster real mode: 4 prefill + 2 decode instances
    sc = load_example("serve_cluster_torch")
    base = ["--real", *(["--full-config"] if full else ["--device", "cpu"]),
            "--instances", "4", "--policy",
            "least-loaded", "--decode-migration", "--decode-max-batch", "4",
            "--requests", "12", "--seed", "3"]
    args = sc.parser().parse_args(base)
    _, _, ex, profile = sc.load_model(args, params=params)
    wd = sc.watchdog_period(args, profile)
    del ex
    print(f"(c) serve_cluster --real: profile "
          f"{json.dumps({n: round(t, 4) for n, t in profile.items()})} s; "
          f"watchdog period {wd:.3f} s", flush=True)
    print("  (c1) fault-free, the watchdog on", flush=True)
    free = cluster_run(ops, kcounts, sc, base, params, wd)
    if free[0]["watchdog_fires"] != 0:
        fail(f"phase 18 (c1): {free[0]['watchdog_fires']} watchdog fires "
             "on a fault-free run")
    if free[0]["retries"] != 0:
        fail(f"phase 18 (c1): {free[0]['retries']} retries without faults")
    launches("cluster fault-free", free[3],
             ("flash_prefill_attention", "flash_decode_attention"))
    from repro_torch.core.faults import FaultEvent, FaultPlan
    plan_path = ROOT / "build" / "chaos_18.json"
    plan_path.parent.mkdir(exist_ok=True)
    plan_path.write_text(FaultPlan(events=tuple(
        FaultEvent(**e) for e in CHAOS_18)).to_json())
    print("  (c2) the same prompts under churn's crash of prefill[0] and "
          "gray's hang moved to decode[0]", flush=True)
    chaos = cluster_run(ops, kcounts, sc, base + ["--chaos", str(plan_path)],
                        params, wd, hold=True)
    rep = chaos[0]
    if rep["lost_requests"] != 0 or rep["retries"] < 1 \
            or rep["watchdog_fires"] < 1:
        fail(f"phase 18 (c2): lost {rep['lost_requests']}, retries "
             f"{rep['retries']}, watchdog fires {rep['watchdog_fires']}")
    launches("cluster chaos", chaos[3],
             ("flash_prefill_attention", "flash_decode_attention"))
    equal = unequal = 0
    for i, (want_rows, got_rows) in enumerate(zip(free[2], chaos[2])):
        want = want_rows[0]
        for got in got_rows:
            if torch.equal(got, want):
                equal += 1
                continue
            unequal += 1
            bf16_bound(got, want, f"request {i}'s first-token logits")
            if int(got.argmax()) != int(want.argmax()):
                fail(f"phase 18 (c2): request {i}'s first token "
                     f"{int(got.argmax())} differs from the fault-free "
                     f"{int(want.argmax())}")
    print(f"  first-token logits: {equal} completions torch.equal to the "
          f"fault-free run's, {unequal} not (held to the bf16 bound); "
          f"every first token equal", flush=True)
    print("  (c3) --spec-decode, 8 requests", flush=True)
    spec = cluster_run(ops, kcounts, sc, base[:-4] + ["--requests", "8", "--seed",
                                                 "3", "--spec-decode"],
                       params, 0.0)
    if spec[0]["spec"]["spec_steps"] <= 0:
        fail("phase 18 (c3): no verify step ran")
    launches("cluster spec", spec[3],
             ("flash_prefill_attention", "flash_decode_attention",
              "flash_verify_attention"))
    del free, chaos, spec, params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) train_quickstart --big: straight against killed and resumed
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-quickstart",
         device],
        env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
        capture_output=True, text=True, timeout=600)
    print(out.stdout, end="", flush=True)
    if out.returncode != 0:
        fail(f"phase 18 (d) (rc {out.returncode}): {out.stderr[-4000:]}")
    print(f"  (d) took {time.monotonic() - t0:.1f} s", flush=True)
    print(f"phase 18 took {time.monotonic() - t_phase:.1f} s", flush=True)
    return by_path


TRAIN_18_STEPS = 40


def train_quickstart(torch, device="cuda") -> None:
    """Phase 18 (d), in a process of its own under deterministic
    algorithms: examples/train_quickstart_torch.py at --big, 40 steps
    straight, against 20 steps + a kill + a rerun that resumes from the
    step-20 checkpoint; every parameter and m, v `torch.equal`."""
    import shutil
    torch.use_deterministic_algorithms(True)
    tq = load_example("train_quickstart_torch")
    cfg = tq.config(big=True)
    n = TRAIN_18_STEPS
    root = ROOT / "build" / "train_quickstart"
    shutil.rmtree(root, ignore_errors=True)

    class Killed(Exception):
        pass

    def kill_at(step):
        def log(msg):
            if msg.startswith(f"step {step}:"):
                raise Killed
        return log

    losses = []

    def keep(msg):
        losses.append(msg)

    try:
        t0 = time.monotonic()
        params = tq.draw(cfg, device)
        n_params = sum(p.numel() for p in params.parameters())
        p_full, s_full, info = tq.train(cfg, params, steps=n,
                                        ckpt_dir=str(root / "straight"),
                                        log=keep)
        t1 = time.monotonic()
        print(f"  (d) {cfg.name} --big: {n_params / 1e6:.1f}M params f32; "
              f"{n} steps straight in {t1 - t0:.1f} s, median step "
              f"{info['median_step_time'] * 1e3:.2f} ms, final loss "
              f"{info['final_loss']:.4f}; {losses[0]} ... {losses[-1]}",
              flush=True)
        run = str(root / "killed")
        try:
            tq.train(cfg, tq.draw(cfg, device), steps=n, ckpt_dir=run,
                     log=kill_at(n // 2))
            fail("phase 18 (d): the run was not killed")
        except Killed:
            pass
        resumed = []
        params, state, _ = tq.train(cfg, tq.draw(cfg, device), steps=n,
                                    ckpt_dir=run, log=resumed.append)
        pairs = [(p_full.leaves(), params.leaves()), (s_full.m, state.m),
                 (s_full.v, state.v)]
        equal = sum(torch.equal(a[k], b[k]) for a, b in pairs for k in a)
        total = sum(len(a) for a, _ in pairs)
        print(f"  (d) killed at step {n // 2}, rerun: {resumed[0]!r}; "
              f"{equal} of {total} leaves (params, m, v) torch.equal, step "
              f"{int(state.step)}; {time.monotonic() - t1:.1f} s",
              flush=True)
        if resumed[0] != f"auto-resumed from checkpoint step {n // 2}":
            fail(f"phase 18 (d): the rerun did not resume: {resumed[0]}")
        if equal != total or int(state.step) != n:
            fail(f"phase 18 (d): {total - equal} of {total} leaves differ "
                 "from the straight run")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def port_request(n):
    from repro_torch.core import Request
    return Request(num_tokens=n, slo=600.0, arrival=time.monotonic())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the model phase (no result line)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v resource usage")
    ap.add_argument("--train-determinism", action="store_true",
                    help=argparse.SUPPRESS)       # phase 14's own process
    ap.add_argument("--train-quickstart", metavar="DEVICE",
                    help=argparse.SUPPRESS)       # phase 18 (d)'s process
    ap.add_argument("--examples-only", action="store_true",
                    help="build, then phase 18 alone (no result line)")
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
        from repro_torch.models import layers as L
        from repro_torch.models.model import decode_step_ragged
        from repro_torch.models.segments import SegmentedPrefill
        from repro_torch.params import init_params
        from repro_torch.serving import decode_instance as port
    except ImportError as exc:
        fail(f"the port is not importable from {ROOT / 'src'}: {exc}")
    if args.train_determinism:
        train_determinism(torch)
        return
    if args.train_quickstart:
        train_quickstart(torch, args.train_quickstart)
        return
    import numpy as np
    import torch.nn.functional as F

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
            if body in ("prefill_tc_kernel", "prefill_mla_kernel",
                        "prefill_mma_kernel"):
                return f"{pre_smem(hd)} bytes"
            if body in ("combine_kernel", "prefill_kernel"):
                return "0 bytes (static only)"
            return " / ".join(str(dec_smem(int(dtype == "bf16"), hd, t))
                              for t in (1, 2)) + " bytes (1 / 2+ query tiles)"
        for name in ("flash_prefill", "decode_attn"):
            ptxas_report(build.LOGS.get(name, ""), smem)
    if args.examples_only:
        phase("18. the examples at Llama3-8B's published width")
        by_path = examples_phase(torch, ops, kcounts)
        print(f"\n--examples-only: launches {json.dumps(by_path)} "
              f"({time.monotonic() - t_start:.1f} s)")
        return

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
        return out, ({256: "mma.sync"}.get(q.shape[-1], "wgmma") if tc
                     else "cuda cores")

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
    print("\nmain-path shapes (H 32, hd 128, T 4096; K 8 for Llama3-8B, "
          "K 4 for Qwen3-30B-A3B's rows marked K4); times in ms, CUDA "
          "events, 20 calls after 3 warm-up calls")
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
        for label, Sq, qoff, kv_len, K in MAIN_PATH_PREFILL:
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
        for label, qoff in MLA_PREFILL if dtype == torch.bfloat16 else ():
            Sq, kv_len = 512, qoff + 512
            q = randn((1, Sq, H, 192), dtype)
            k = randn((1, kv_len, H, 192), dtype)
            v = randn((1, kv_len, H, 128), dtype)
            name = f"flash_prefill_attention mla {label}"
            kcounts.reset()
            got = flash_prefill_attention(q, k, v, qoff, kv_len)
            launched = kcounts.read(["flash_prefill_mla",
                                     "flash_prefill_wgmma",
                                     "chunked_prefill_attention_ref"])
            if launched != {"flash_prefill_mla": 1, "flash_prefill_wgmma": 1,
                            "chunked_prefill_attention_ref": 0}:
                fail(f"{name}: launches {launched}, not the 192/128 body's "
                     "one")
            err = check(f"{name} wgmma", dtype, got,
                        ref.chunked_prefill_attention_ref(
                            q, k, v, q_offset=qoff, kv_len=kv_len))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = torch.arange(kv_len, device=dev)[None, :] <= \
                qoff + torch.arange(Sq, device=dev)[:, None]
            row = dict(
                ms=cuda_ms(torch, lambda: flash_prefill_attention(
                    q, k, v, qoff, kv_len)),
                plain_ms=cuda_ms(torch, lambda: ref.chunked_prefill_attention_ref(
                    q, k, v, q_offset=qoff, kv_len=kv_len), iters=5),
                library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)),
                max_abs_err=err)
            row["bound_ms"], row["bound_by"] = bound(
                *mla_prefill_work(Sq, H, qoff, es))
            record[name] = row
            print(f"  {name}: {json.dumps(row)} share of the bound "
                  f"{row['bound_ms'] / row['ms']:.4f}", flush=True)
        for label, lens, K in MAIN_PATH_DECODE:
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
        S, K = 5, 8
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

    # RecurrentGemma-9B's main-path shapes at head_dim 256, bf16: the prefill
    # of a 4096-token prompt (CUDA-core body, L2-warm like the other prefill
    # rows) and one decode row over the full ring (L2-cold by rotation)
    Hr, Kr, hdr, win = HD256["H"], HD256["K"], HD256["hd"], HD256["window"]
    dtype, es = torch.bfloat16, 2
    print(f"\nRecurrentGemma-9B's shapes (H {Hr}, K {Kr}, hd {hdr}, window "
          f"{win}), bf16")
    q = randn((1, 4096, Hr, hdr), dtype)
    k, v = randn((1, 4096, Kr, hdr), dtype), randn((1, 4096, Kr, hdr), dtype)
    name = f"flash_prefill_attention {MAIN_PREFILL_HD256}"
    got, body = prefill(q, k, v, 0, 4096, local_window=win)
    err = check(f"{name} {body}", dtype, got, ref.chunked_prefill_attention_ref(
        q, k, v, q_offset=0, kv_len=4096, local_window=win))
    pos = torch.arange(4096, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = dict(
        ms=cuda_ms(torch, lambda: flash_prefill_attention(
            q, k, v, 0, 4096, local_window=win)),
        plain_ms=cuda_ms(torch, lambda: ref.chunked_prefill_attention_ref(
            q, k, v, q_offset=0, kv_len=4096, local_window=win), iters=5),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        max_abs_err=err, body=body)
    row["bound_ms"], row["bound_by"] = bound(*prefill_work(
        1, 4096, Hr, Kr, hdr, 0, 4096, es, window=win))
    record[name] = row
    print(f"  {name}: {json.dumps(row)}; share of the bound "
          f"{row['bound_ms'] / row['ms']:.4f}", flush=True)
    q = randn((1, Hr, hdr), dtype)
    k, v = randn((1, win, Kr, hdr), dtype), randn((1, win, Kr, hdr), dtype)
    lens_t = torch.tensor([win], dtype=torch.int32, device=dev)
    name = f"flash_decode_attention {MAIN_DECODE_HD256}"
    err = check(name, dtype, flash_decode_attention(q, k, v, lens_t),
                ref.decode_attention_ref(q, k, v, kv_len=lens_t))
    row = timed(
        name, (1, win, Kr, hdr), decode_work(Hr, Kr, hdr, [win], es),
        kernel=lambda k, v: flash_decode_attention(q, k, v, lens_t),
        plain=lambda k, v: ref.decode_attention_ref(q, k, v, kv_len=lens_t),
        library=lambda k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True))
    row["max_abs_err"] = err
    record[name] = row

    # phase 13's shapes, bf16: prefill rows L2-warm, decode rows L2-cold
    print("\nphase 13's shapes (Whisper, InternVL2, Llama4-Maverick), bf16")
    for label, Sq, T, H, K, hd, qoff, kv_len, causal in PHASE13_PREFILL:
        q = randn((1, Sq, H, hd), dtype)
        k, v = randn((1, T, K, hd), dtype), randn((1, T, K, hd), dtype)
        name = f"flash_prefill_attention {label}"
        got, body = prefill(q, k, v, qoff, kv_len, causal=causal)
        err = check(f"{name} {body}", dtype, got,
                    ref.chunked_prefill_attention_ref(
                        q, k, v, q_offset=qoff, kv_len=kv_len,
                        causal=causal))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pos = torch.arange(T, device=dev)
        mask = (pos[None, :] <= qoff + torch.arange(Sq, device=dev)[:, None]) \
            & (pos[None, :] < kv_len) if causal else None
        row = dict(
            ms=cuda_ms(torch, lambda: flash_prefill_attention(
                q, k, v, qoff, kv_len, causal=causal)),
            plain_ms=cuda_ms(torch, lambda: ref.chunked_prefill_attention_ref(
                q, k, v, q_offset=qoff, kv_len=kv_len, causal=causal),
                iters=5),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            max_abs_err=err, body=body)
        row["bound_ms"], row["bound_by"] = bound(*prefill_work(
            1, Sq, H, K, hd, qoff, kv_len, es, causal=causal))
        record[name] = row
        print(f"  {name}: {json.dumps(row)}; share of the bound "
              f"{row['bound_ms'] / row['ms']:.4f}", flush=True)
    for label, lens, T, H, K, hd in PHASE13_DECODE:
        B = len(lens)
        q = randn((B, H, hd), dtype)
        k, v = randn((B, T, K, hd), dtype), randn((B, T, K, hd), dtype)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        name = f"flash_decode_attention {label}"
        err = check(name, dtype, flash_decode_attention(q, k, v, lens_t),
                    ref.decode_attention_ref(q, k, v, kv_len=lens_t))
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
    del pool_k, pool_v, q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    record.update(moe_kernel_rows(torch, dev, kcounts))

    # --- 3. tiny model, card against CPU -------------------------------------
    phase("3. tiny Llama3-8B, Qwen3-MoE, Mamba2 and RecurrentGemma configs "
          "in f32: card against CPU")

    def tiny_card_vs_cpu(arch):
        """Prefill logits and one ragged decode step of a tiny config on
        the card against the CPU (2e-4); returns the config and weights."""
        cfg = get_tiny_config(arch)
        p_cpu = init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
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
        for name, a, b in zip(("prefill logits", "decode logits",
                               "decode k_new"), out["cpu"], out["cuda"]):
            err = (a - b).abs().max().item()
            print(f"{cfg.name} {name:<16} card vs cpu max_abs_err {err:.3e} "
                  f"tol 2e-4 ({'/'.join(ex.ops)})")
            if not err <= 2e-4:
                fail(f"tiny {cfg.name} {name}: card and CPU differ by {err}")
        return cfg, p_cpu, p_gpu

    # the experts at a capacity that drops pairs: the card must route to
    # the CPU's experts and keep and drop the same pairs
    moe_cfg, m_cpu, m_gpu = tiny_card_vs_cpu("qwen3_30b_a3b")
    x_moe = torch.randn(2, 96, moe_cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
    moe_out = {}
    for where, params in (("cpu", m_cpu), ("cuda", m_gpu)):
        lay = {key: t[1] for key, t in params["layers"].items()}
        x = x_moe.to(params.device)
        k_, E_ = moe_cfg.experts_per_token, moe_cfg.num_experts
        w, idx, _ = L.moe_router(x, lay["router"], k_)
        G, _, cap = L.moe_groups(x.shape[0] * x.shape[1], k_, E_,
                                 moe_cfg.d_ff, capacity_factor=0.5,
                                 min_capacity=4)
        keep = L.moe_queue(idx, G, E_, cap)[1]
        y = L.moe_apply(x, w, idx, lay["wi"], lay["wd"], k=k_,
                        capacity_factor=0.5, min_capacity=4)
        moe_out[where] = [t.cpu() for t in (idx, keep, y)]
    err = (moe_out["cpu"][2] - moe_out["cuda"][2]).abs().max().item()
    same = torch.equal(moe_out["cpu"][0], moe_out["cuda"][0]) and \
        torch.equal(moe_out["cpu"][1], moe_out["cuda"][1])
    dropped = int((~moe_out["cpu"][1]).sum())
    print(f"moe_apply at capacity {cap} of {G} group(s): {dropped} of "
          f"{moe_out['cpu'][1].numel()} pairs dropped; card routes and "
          f"drops as the CPU: {same}; max_abs_err {err:.3e} tol 2e-5")
    if not same or dropped == 0 or not err <= 2e-5:
        fail("the tiny Qwen3-MoE experts on the card differ from the CPU")
    del m_cpu, m_gpu, moe_out
    cfg, p_cpu, p_gpu = tiny_card_vs_cpu("llama3_8b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 72))
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
    for arch in ("mamba2_370m", "recurrentgemma_9b", "whisper_large_v3",
                 "internvl2_76b", "llama4_maverick_400b"):
        tiny_family_card_vs_cpu(torch, np, ops, arch)
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
    profile4 = dict(dep.profile)                 # phase 17 reads it
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
        counts = serve_phase(np, ops, kcounts, dep, cfg, seed=3)

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

    # --- 11. the uniform MoE family at full width ------------------------------
    del dep
    gc.collect()
    torch.cuda.empty_cache()
    phase("11. MoE: Qwen3-30B-A3B, published width, bf16, random weights")
    moe_counts = moe_phase(torch, np, ops, kcounts, build_deployment)

    # --- 12. the recurrent families at full width ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    phase("12. recurrent families: Mamba2-370M and RecurrentGemma-9B, "
          "published width, bf16, random weights")
    t0 = time.monotonic()
    rec_counts = recurrent_phase(torch, np, ops)
    print(f"phase 12 took {time.monotonic() - t0:.1f} s", flush=True)

    # --- 13. the remaining families at full width ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    phase("13. the remaining families: Whisper-large-v3, InternVL2-76B (8 "
          "of 80 layers), Llama4-Maverick (one pair), Llama3.2-1B, "
          "Qwen2-1.5B, Qwen2.5-3B, Minitron-4B; published width, bf16")
    t0 = time.monotonic()
    fam_counts = families_phase(torch, np, ops, port, check)
    print(f"phase 13 took {time.monotonic() - t0:.1f} s", flush=True)

    # --- 14. training at full width ---------------------------------------------
    phase("14. training: Llama3.2-1B, published width, bf16 params, f32 "
          "AdamW state, seq 4096, batch 2, remat full")
    t0 = time.monotonic()
    train_counts, train_row = train_phase(torch, np, ops, kcounts, check)
    print(f"phase 14 took {time.monotonic() - t0:.1f} s", flush=True)

    # --- 15. the sharded path on the card ---------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    phase("15. sharded path: a 1-rank NCCL (data 1, model 1) mesh; "
          "Llama3.2-1B train step under train_rules, Llama3-8B prefill + "
          "16 decode steps under serve_rules")
    t0 = time.monotonic()
    sharded_counts, sharded_times = sharded_phase(torch, np, ops, kcounts)
    print(f"phase 15 took {time.monotonic() - t0:.1f} s: "
          f"{json.dumps(sharded_times)}", flush=True)

    # --- 16. the dry-run -------------------------------------------------------
    phase("16. dry-run: llama3_2_1b, published width, meta tensors, a fake "
          "group of 256 (pod1) and 512 (pod2)")
    t0 = time.monotonic()
    dryrun_phase()
    print(f"phase 16 took {time.monotonic() - t0:.1f} s", flush=True)

    # --- 17. the simulator's H100 against the card ------------------------------
    phase("17. simulator: PrefillCostModel(LLAMA3_8B, H100) against phase "
          "4's measured TTFT")
    sim_phase(profile4)

    # --- 18. the examples ---------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    phase("18. the examples at Llama3-8B's published width: quickstart, "
          "serve_trace, serve_cluster --real (4 prefill + 2 decode "
          "instances, chaos), train_quickstart --big")
    example_counts = examples_phase(torch, ops, kcounts)

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
        by_path["moe serve (phase 11)"] = moe_counts[name]
        for path, c in {**rec_counts, **fam_counts}.items():
            if name in c:
                by_path[path] = c[name]
        if name == "flash_prefill_attention":
            by_path.update(train_counts)
        by_path.update(sharded_counts.get(name, {}))
        for path, c in example_counts.items():
            if c[name]:
                by_path[path] = c[name]
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        entry = {"name": name, "route": route, "source": src,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path, **{k: row[k] for k in keys}}
        if f"{name} {main}{K4}" in record:       # Qwen3-30B-A3B's shape
            k4 = record[f"{name} {main}{K4}"]
            entry["k4"] = {k: k4[k] for k in keys}
        hd256 = {"flash_prefill_attention": MAIN_PREFILL_HD256,
                 "flash_decode_attention": MAIN_DECODE_HD256}.get(name)
        if hd256:                                # RecurrentGemma-9B's shape
            row256 = record[f"{name} {hd256}"]
            entry["hd256"] = {"shape": hd256, **{k: row256[k] for k in keys}}
        if name in PHASE13_ROWS:                 # phase 13's shapes
            entry["phase13"] = {label: {k: record[f"{name} {label}"][k]
                                        for k in keys}
                                for label in PHASE13_ROWS[name]}
        if name == "flash_prefill_attention":    # phase 14's training shape
            entry["train"] = train_row
        kernels.append(entry)
    name = "moe_grouped_ffn"
    by_path = {"moe serve (phase 11)": moe_counts["moe_grouped_gemm"]}
    kernels.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_grouped.cu",
        "replaces": "none: the experts' one-hot einsums "
                    "(src/repro/models/layers.py moe_apply)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **{k: record[f"{name} {MAIN_MOE}"][k] for k in keys},
        "shapes": {label: {k: record[f"{name} {label}"][k] for k in keys}
                   for label, *_ in MOE_SHAPES if label != MAIN_MOE}})
    print(f"\nall phases passed in {time.monotonic() - t_start:.1f} s")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
