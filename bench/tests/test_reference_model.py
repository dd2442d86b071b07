"""The plain reference against the port at a tiny size, in f32 on the CPU:
the port's segmented prefill and the reference agree on the last
position's logits and on the keys and values the prefill hands off."""
import pytest
import torch

from harness import check, deploy
from reference.decoder import forward
from repro_torch.models.segments import SegmentedPrefill


def _spec(name: str, tiny_root):
    import json
    return json.loads((tiny_root / "bench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", ["qwen2.5-tiny", "qwen3-moe-tiny"])
def test_reference_equals_the_port_in_f32(name, tiny_root):
    spec = _spec(name, tiny_root)
    cfg = deploy.model_config(spec)
    params = deploy.draw_weights(cfg, 3, torch.device("cpu"), torch.float32)
    ex = SegmentedPrefill(params, cfg, max_seq=160, chunk_tokens=64,
                          cache_dtype=torch.float32)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
               for n in (150, 37)]
    layers = check.kv_layers(cfg.num_layers)
    ref_logits, ref_kv = forward(deploy.plain_weights(params), spec, prompts,
                                 kv_layers=layers)
    for p, toks in enumerate(prompts):
        task = ex.start(toks[None].numpy())
        logits = ex.run_all(task)[0]
        n = len(toks)
        torch.testing.assert_close(logits, ref_logits[p], atol=2e-4,
                                   rtol=2e-4)
        for l in layers:
            k, v = ref_kv[(p, l)]
            torch.testing.assert_close(task.state["k_cache"][l, 0, :n], k,
                                       atol=2e-4, rtol=2e-4)
            torch.testing.assert_close(task.state["v_cache"][l, 0, :n], v,
                                       atol=2e-4, rtol=2e-4)


def test_fp8_control_is_coarser_than_bf16():
    from reference.decoder import round_fp8
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    e8 = (round_fp8(x, True) - x).norm() / x.norm()
    e16 = (x.bfloat16().float() - x).norm() / x.norm()
    assert 8 * e16 < e8 < 0.05
