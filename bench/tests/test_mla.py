"""The latent-attention architecture (bench/arch/mla.py, bench/reference/
mla.py, the `mla_kv_rows_per_token` reader) on the CPU: the configuration
file against the port's config, the counts against sums written out at a
tiny size, the HANDOFF tensors against the reference's latent, the two
references against each other, the float8 control against the program, and
a tiny cell served end to end (`kanana-tiny.qwentrace-tiny`, its tiny
stand-in registered by bench/conftest.py)."""
import dataclasses
import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, REPO
from harness import check, deploy, files, main
from harness.stats import HBM_BYTES_PER_S, PEAK_BF16_OPS
from repro_torch.configs.base import get_config, get_tiny_config
from repro_torch.models import mla_reference
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.tracing import Span

ARCH = files.arch(BENCH / "arch", "mla")
FORWARD = files._module(BENCH / "reference" / "mla.py", "bench_ref_").forward
SPEC = json.loads((BENCH / "configs" / "kanana-2-30b-a3b.json").read_text())
TINY_SPEC = json.loads((BENCH / "tests" / "data" / "configs" /
                        "kanana-tiny.json").read_text())
CELL = "kanana-tiny.qwentrace-tiny"


def test_the_file_serves_the_ports_config_at_every_width():
    cfg = ARCH.model_config(SPEC)
    port = get_config("kanana_2_30b_a3b")
    assert dataclasses.replace(cfg, name=port.name, source=port.source) \
        == port
    assert cfg.moe_capacity_factor == 22.0
    assert ARCH.model_config(TINY_SPEC) == dataclasses.replace(
        get_tiny_config("kanana_2_30b_a3b"), name="kanana-tiny", source="")


@pytest.mark.parametrize("key,value", [
    ("kv_lora_rank", 256), ("qk_rope_head_dim", 32), ("v_head_dim", 192),
    ("n_shared_experts", 1), ("first_k_dense_replace", 2),
    ("intermediate_size", 4096), ("routed_scaling_factor", 2.5),
    ("q_lora_rank", 1536), ("scoring_func", "softmax"), ("n_group", 8),
    ("qk_head_dim", 128), ("rope_interleave", False)])
def test_a_width_off_or_a_path_the_port_lacks_is_refused(key, value):
    with pytest.raises(ValueError):
        ARCH.model_config(dict(SPEC, **{key: value}))


def test_model_flops_is_the_sum_over_tokens_and_layers():
    cfg = ARCH.model_config(TINY_SPEC)
    d, H, V = cfg.d_model, cfg.num_heads, cfg.vocab_size
    n = 37
    total = 0.0
    for t in range(n):                     # token t sees t + 1 keys
        for l in range(cfg.num_layers):
            total += 2 * (d * H * 24 + d * (32 + 8) + 32 * H * (16 + 16)
                          + H * 16 * d)
            total += 2 * (3 * d * 96 if l == 0 else
                          d * 8 + 3 * 3 * d * 32 + 3 * d * 64)
            total += 2 * H * (24 + 16) * (t + 1)
    total += 2 * d * V
    assert ARCH.model_flops(n, cfg, TINY_SPEC) == pytest.approx(total,
                                                                rel=1e-12)


def test_the_attention_bound_is_the_lesser_form_per_chunk():
    cfg = ARCH.model_config(TINY_SPEC)
    H, es, n, chunk = cfg.num_heads, 2, 150, 64
    want = 0.0
    for lo in range(0, n, chunk):
        Sq = min(chunk, n - lo)
        pairs = sum(lo + i + 1 for i in range(Sq))
        mha = max(2 * H * 40 * pairs / PEAK_BF16_OPS,
                  es * (Sq * H * 40 + (lo + Sq) * H * 40) / HBM_BYTES_PER_S)
        lat = max(2 * H * (32 + 8 + 32) * pairs / PEAK_BF16_OPS,
                  es * (Sq * H * 72 + (lo + Sq) * 40) / HBM_BYTES_PER_S)
        want += min(mha, lat)
    assert ARCH.prompt_attention_bound(n, chunk, cfg, TINY_SPEC, es) == \
        pytest.approx(want * cfg.num_layers, rel=1e-12)
    # at the published width a 512-token chunk over 3584 keys is bound by
    # the up-projected form's operations: 2 * 32 * 320 a pair, 40.7 us
    full = ARCH.model_config(SPEC)
    one = ARCH.prompt_attention_bound(4096, 512, full, SPEC, 2) \
        - ARCH.prompt_attention_bound(3584, 512, full, SPEC, 2)
    pairs = 512 * 3584 + 512 * 513 // 2
    assert one == pytest.approx(48 * 2 * 32 * 320 * pairs / PEAK_BF16_OPS)


def test_the_attention_kernels_are_the_latent_body_alone():
    names = ["void (anonymous namespace)::tc::prefill_mla_kernel<192, 128>"
             "(CUtensorMap, CUtensorMap, CUtensorMap, __nv_bfloat16*, int)",
             "void (anonymous namespace)::tc::prefill_tc_kernel<128>(...)",
             "void (anonymous namespace)::hd256::prefill_mma_kernel(...)",
             "void (anonymous namespace)::prefill_kernel<float, 64>(...)"]
    assert [bool(ARCH.ATTENTION_KERNELS.search(s)) for s in names] == \
        [True, False, False, False]


def _weights(cfg, seed):
    params = deploy.draw_weights(cfg, seed, torch.device("cpu"),
                                 torch.float32)
    return params, deploy.plain_weights(params)


def test_the_handoff_tensors_are_the_references_latent():
    cfg = ARCH.model_config(TINY_SPEC)
    params, weights = _weights(cfg, 3)
    ex = SegmentedPrefill(params, cfg, max_seq=128, chunk_tokens=16)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(3))
    task = ex.start(toks, lens=[40, 29])
    ex.run_all(task)
    logits, kv = FORWARD(weights, TINY_SPEC, [toks[0], toks[1, :29]],
                         kv_layers=(0, 2))
    for i, n in enumerate((40, 29)):
        torch.testing.assert_close(task.logits[i], logits[i], rtol=1e-4,
                                   atol=1e-4)
        for l in (0, 2):
            got = tuple(task.state[key][l, i, :n] for key in ARCH.HANDOFF)
            assert [g.shape for g in got] == [(n, 1, 32), (n, 1, 8)]
            for g, w in zip(got, kv[(i, l)]):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_the_two_references_agree():
    cfg = ARCH.model_config(TINY_SPEC)
    _, weights = _weights(cfg, 4)
    toks = torch.randint(0, cfg.vocab_size, (33,),
                         generator=torch.Generator().manual_seed(4))
    logits, kv = FORWARD(weights, TINY_SPEC, [toks[:20], toks],
                         kv_layers=(1,))
    full, latent = mla_reference.forward(weights, TINY_SPEC, toks)
    torch.testing.assert_close(logits[1], full[-1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kv[(1, 1)][0][:, 0], latent[1][0])
    torch.testing.assert_close(kv[(1, 1)][1][:, 0], latent[1][1])
    short, _ = mla_reference.forward(weights, TINY_SPEC, toks[:20])
    torch.testing.assert_close(logits[0], short[-1], rtol=1e-5, atol=1e-5)


def test_the_float8_control_reads_worse_than_the_program():
    cfg = ARCH.model_config(TINY_SPEC)
    params, weights = _weights(cfg, 5)
    bf = deploy.draw_weights(cfg, 5, torch.device("cpu"), torch.bfloat16)
    ex = SegmentedPrefill(bf, cfg, max_seq=256, chunk_tokens=64,
                          cache_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
               for n in (30, 200, 90)]
    tasks = [ex.start(p[None]) for p in prompts]
    for t in tasks:
        ex.run_all(t)
    layers = check.kv_layers(cfg.num_layers)
    ref, ref_kv = FORWARD(weights, TINY_SPEC, prompts, kv_layers=layers)
    low, low_kv = FORWARD(weights, TINY_SPEC, prompts, kv_layers=layers,
                          fp8=True)
    prog = check.readings(
        ref, ref_kv, [int(t.logits[0].argmax()) for t in tasks],
        [t.logits[0] for t in tasks],
        [{l: tuple(t.state[k][l, 0, :len(p)] for k in ARCH.HANDOFF)
          for l in layers} for t, p in zip(tasks, prompts)])
    ctl = check.readings(ref, ref_kv, low.argmax(-1).tolist(), list(low),
                         [{l: low_kv[(i, l)] for l in layers}
                          for i in range(len(prompts))])
    assert ctl["logit_err"] > 2 * prog["logit_err"]
    assert ctl["kv_first_err"] > 3 * prog["kv_first_err"]


def _span(start, **attrs):
    return Span("segment", start, start + 1e-4, 1, 1, 0, 7, attrs)


def test_kv_rows_per_token_reads_the_latent_attn_spans():
    read = files.reader(BENCH / "metrics", "mla_kv_rows_per_token")
    got = [_span(0, op="attn", kv_rows=512, q_rows=512),
           _span(1, op="attn", kv_rows=1024, q_rows=512),
           _span(2, op="attn", kv_rows=2 * 1124, q_rows=2 * 100),
           _span(3, op="gate"), _span(4, op="attn")]
    assert read(SimpleNamespace(spans=got)) == \
        pytest.approx((512 + 1024 + 2248) / (512 + 512 + 200))
    assert read(SimpleNamespace(spans=got[3:])) is None
    assert read(SimpleNamespace(spans=None)) is None


@pytest.fixture
def mla_root(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "kanana-tiny", "source": "tiny",
                            "file": "bench/configs/kanana-tiny.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": CELL, "config": "kanana-tiny",
                              "traffic": "qwentrace-tiny", "chips": 1,
                              "why": "CPU tests"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


def test_the_real_files_name_the_tiny_stand_in(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    named = {m["name"]: m["workloads"] for m in spec["per_layer"]}
    assert named["mla_kv_rows_per_token"] == [CELL]
    assert CELL in named["prefill_attn_roofline"]
    assert CELL in named["blocking_ms_p95"]      # every run preempts
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    assert real["workloads"][-1]["chips"] == 1


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_is_served_and_correct(mla_root, trace):
    out = main.run(mla_root, CELL, 2 ** 31 + 99, 2.0, trace, "cpu",
                   time.monotonic())
    assert out["correct"] and out["failed"] == 0
    got = out["metrics"]
    if not trace:
        assert set(got) == {"goodput_rps", "setup_s"}
        return
    assert {"mla_kv_rows_per_token", "graphed_segment_share",
            "segment_host_us_p50", "prefill_mfu"} <= set(got)
    # chunks of 64: every prompt's first chunk up-projects its own rows
    assert 1.0 <= got["mla_kv_rows_per_token"]["value"] < 8.0
    assert math.isfinite(got["prefill_mfu"]["value"])
