"""The decoders' architecture module (bench/arch/decoder.py) against the
numbers the harness computed before it held them: on each real
configuration file the same `ModelConfig`, field for field; on a fixed
synthetic run the same readings of `prefill_mfu` and
`prefill_attn_roofline`, to the last bit; the same cache tensors handed to
the check; and a file with one width off the port's still refused."""
import json
import math
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import BENCH
from harness import deploy, files, serve
from harness.trace import Trace

# what deploy.model_config returned for each file before bench/arch/, every
# field of the ModelConfig written out
SERVED = {
    "qwen2.5-3b": dict(
        name="qwen2.5-3b", family="dense", num_layers=36, d_model=2048,
        num_heads=16, num_kv_heads=2, d_ff=11008, vocab_size=151936,
        head_dim=128, qkv_bias=True, rope_theta=1000000.0, norm_eps=1e-06,
        tie_embeddings=True, local_window=0, layer_pattern=(), num_experts=0,
        experts_per_token=0, moe_layer_freq=1, d_ff_dense=0,
        moe_capacity_factor=1.25, moe_min_capacity=4, ssm_state=0,
        ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4, ssm_chunk=256,
        is_encoder_decoder=False, num_encoder_layers=0, encoder_seq=0,
        num_patches=0, lru_width=0, source=""),
    "qwen3-30b-a3b": dict(
        name="qwen3-30b-a3b", family="moe", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=4, d_ff=768, vocab_size=151936,
        head_dim=128, qkv_bias=False, rope_theta=1000000.0, norm_eps=1e-06,
        tie_embeddings=False, local_window=0, layer_pattern=(),
        num_experts=128, experts_per_token=8, moe_layer_freq=1, d_ff_dense=0,
        moe_capacity_factor=16.0, moe_min_capacity=4, ssm_state=0,
        ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4, ssm_chunk=256,
        is_encoder_decoder=False, num_encoder_layers=0, encoder_seq=0,
        num_patches=0, lru_width=0, source=""),
}

# prefill_mfu and prefill_attn_roofline of `_run` before bench/arch/, by
# the formulas harness/stats.py held then
READ = {"qwen2.5-3b": (2.5345230515056456, 19.780036119927647),
        "qwen3-30b-a3b": (3.5516588943594374, 52.74676298647373)}

# device operations of the synthetic trace: three prefill-attention bodies,
# and names the kernel pattern must not find
OPS = [("void (anonymous namespace)::tc::prefill_tc_kernel<128>(Params)",
        0.125),
       ("void (anonymous namespace)::prefill_mma_kernel<__nv_bfloat16, 256>"
        "(P)", 0.0625),
       ("void (anonymous namespace)::prefill_kernel<float, 64>(P)", 0.03125),
       ("void (anonymous namespace)::split_kernel<__nv_bfloat16, 128>(P)",
        0.5),
       ("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_64x3_tn", 2.0),
       ("my_prefill_kernel_v2", 1.0)]


def _spec(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _trace():
    """A Trace holding OPS back to back from t = 0."""
    tr = Trace.__new__(Trace)
    ends = np.cumsum([s for _, s in OPS])
    tr.ops_start = ends - np.array([s for _, s in OPS])
    tr.ops_end = ends
    tr.ops_name = [n for n, _ in OPS]
    return tr


def _run(name):
    spec = _spec(name)
    arch = files.arch(BENCH / "arch", spec["reference"])
    return SimpleNamespace(
        seconds=51.0, cfg=deploy.model_config(spec, arch), config=spec,
        arch=arch, chunk=512, es=2, n=[16, 512, 1000, 4096, 16384, 300, 2047],
        ttft=[0.1, 0.2, math.inf, 1.0, 3.0, 0.05, 0.7],
        busy=[(0.0, 2.5), (3.0, 7.25), (8.0, 8.125)], trace=_trace())


@pytest.mark.parametrize("name", sorted(SERVED))
def test_the_same_model_config_is_served(name):
    spec = _spec(name)
    got = deploy.model_config(spec)
    assert got == deploy.model_config(
        spec, files.arch(BENCH / "arch", "decoder"))
    assert asdict(got) == SERVED[name]


@pytest.mark.parametrize("name", sorted(READ))
def test_the_model_step_and_kernel_readers_read_as_before(name):
    run = _run(name)
    mfu = files.reader(BENCH / "metrics", "prefill_mfu")(run)
    roof = files.reader(BENCH / "metrics", "prefill_attn_roofline")(run)
    assert (mfu, roof) == READ[name]


def test_the_kernel_pattern_finds_the_three_prefill_bodies():
    run = _run("qwen2.5-3b")
    assert run.trace.device_time(run.arch.ATTENTION_KERNELS) == \
        0.125 + 0.0625 + 0.03125


@pytest.mark.parametrize("name", sorted(SERVED))
@pytest.mark.parametrize("key,by", [("num_key_value_heads", 1),
                                    ("hidden_size", 64), ("head_dim", 64),
                                    ("num_hidden_layers", -1)])
def test_a_width_off_the_ports_is_refused(name, key, by):
    spec = _spec(name)
    spec[key] = spec.get(key, 128) + by
    with pytest.raises(ValueError, match="widths differ"):
        deploy.model_config(spec)


def test_the_check_gets_the_handoff_tensors():
    """serve.attach copies, for each sampled row, the first n positions of
    each HANDOFF key of the task's state at the compared layers."""
    arch = files.arch(BENCH / "arch", "decoder")
    L, B, S = 3, 2, 8
    state = {key: torch.randn(L, B, S, 2, 4) for key in arch.HANDOFF}
    state["lens"] = torch.tensor([5, 7])
    task = SimpleNamespace(
        requests=[SimpleNamespace(rid=10), SimpleNamespace(rid=11)],
        prefill_task=SimpleNamespace(state=state,
                                     logits=torch.randn(B, 16)))
    handed = []
    inst = SimpleNamespace(on_prefill_done=handed.append, completed_tasks=[])
    cap = serve.Capture(want={11}, kv_layers=[0, 2], handoff=arch.HANDOFF)
    serve.attach(SimpleNamespace(prefill=inst), cap)
    inst.on_prefill_done(task)
    assert handed == [task] and set(cap.kv) == {11}
    for layer in (0, 2):
        got = cap.kv[11][layer]
        assert len(got) == len(arch.HANDOFF) == 2
        for t, key in zip(got, arch.HANDOFF):
            assert torch.equal(t, state[key][layer, 1, :7])
    assert torch.equal(cap.logits[11], task.prefill_task.logits[1])
