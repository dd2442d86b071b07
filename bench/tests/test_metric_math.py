"""The benchmark's arithmetic against numpy and hand-worked cases: the
architecture-free helpers of harness/stats.py and the counts of
bench/arch/decoder.py."""
import math

import numpy as np
import pytest

from conftest import BENCH
from harness import files, stats
from repro_torch.configs.base import ModelConfig

decoder = files.arch(BENCH / "arch", "decoder")


def _cfg(layers, d, H, K, hd, d_ff=1, vocab=1, experts=0, top_k=0):
    return ModelConfig(name="hand", family="moe" if experts else "dense",
                       num_layers=layers, d_model=d, num_heads=H,
                       num_kv_heads=K, d_ff=d_ff, vocab_size=vocab,
                       head_dim=hd, num_experts=experts,
                       experts_per_token=top_k)


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 99, 100])
def test_percentile_matches_numpy_on_finite_values(q):
    v = np.random.default_rng(q).lognormal(0, 1, 37).tolist()
    assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q),
                                                   rel=1e-12)


def test_percentile_counts_unfinished_as_infinite():
    v = [1.0] * 8 + [math.inf] * 2          # ranks 0..9
    assert stats.percentile(v, 50) == 1.0
    assert stats.percentile(v, 77) == 1.0    # rank 6.93, both neighbours 1
    assert math.isinf(stats.percentile(v, 80))   # rank 7.2 leans on inf
    assert math.isinf(stats.percentile(v, 90))
    assert stats.percentile([3.0, math.inf], 0) == 3.0


def test_union_overlap_and_intersect():
    u = stats.union([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6), (5, 5)])
    assert u == [(0, 2), (3, 4)]
    assert stats.length(u) == 3
    assert stats.overlap(u, [(1, 3.5)]) == pytest.approx(1.5)
    assert stats.intersect([(0, 1), (2, 3)], [(0.5, 2.5)]) == [(0, 0.5),
                                                             (1, 0.5)]


def test_goodput_counts_met_slos_per_second():
    ttft = [0.1, 0.3, math.inf, 0.2]
    slo = [0.25, 0.25, 0.25, 0.2]
    assert stats.goodput(ttft, slo, 2.0) == 1.0    # first and last met


def _loop_work(Sq, q_offset, H, K, hd, es):
    """chip_smoke.py's prefill_work (causal, no window), pair by pair."""
    kv_len = q_offset + Sq
    pairs = sum(min(kv_len, q_offset + i + 1) for i in range(Sq))
    keys = min(kv_len, q_offset + Sq)
    return 4.0 * hd * H * pairs, es * (2 * Sq * H * hd + 2 * keys * K * hd)


@pytest.mark.parametrize("Sq,off", [(1, 0), (512, 0), (512, 3584), (37, 1024)])
def test_attention_work_closed_form_equals_the_pair_loop(Sq, off):
    assert decoder.attention_work(Sq, off, _cfg(1, 4096, 32, 4, 128), None,
                                  2) == _loop_work(Sq, off, 32, 4, 128, 2)


def test_attention_bound_by_hand():
    # one 512-token chunk at offset 0, H 16, K 2, hd 128, bf16, 1 layer:
    # pairs 512*513/2 = 131328 -> 4*128*16*131328 = 1.0758e9 operations
    # (1.0878 us at 989 TFLOP/s); bytes 2*(2*512*16*128 + 2*512*2*128)
    # = 4.719e6 (1.4087 us at 3.35 TB/s): bytes bound it
    b = decoder.prompt_attention_bound(512, 512, _cfg(1, 2048, 16, 2, 128),
                                       None, 2)
    assert b == pytest.approx(4718592 / 3.35e12)
    # two chunks of a 1024-token prompt over 36 layers add up per chunk
    cfg = _cfg(36, 2048, 16, 2, 128)
    two = decoder.prompt_attention_bound(1024, 512, cfg, None, 2)
    o1, b1 = decoder.attention_work(512, 512, cfg, None, 2)
    assert two == pytest.approx(36 * (b + max(o1 / 989e12, b1 / 3.35e12)))


def test_model_flops_by_hand():
    # d 4, H 2, K 1, hd 2, d_ff 3, vocab 5, one layer, n 2:
    # projections 4*(2+2)*2 + 2*2*4 = 48, SwiGLU 3*4*3 = 36 per token;
    # 2*2*84 = 336, pairs 3 -> 4*2*2*3 = 48, head 2*4*5 = 40
    assert decoder.model_flops(2, _cfg(1, 4, 2, 1, 2, d_ff=3, vocab=5),
                               None) == 336 + 48 + 40
    # MoE: router 4*8 = 32 and top-2 of 3*4*3 = 72 instead of 36
    assert decoder.model_flops(2, _cfg(1, 4, 2, 1, 2, d_ff=3, vocab=5,
                                       experts=8, top_k=2), None) == \
        2 * 2 * (48 + 32 + 72) + 48 + 40


def test_ttft_p50_reader_in_ms_and_silent_past_half_unfinished():
    from types import SimpleNamespace

    read = files.reader(BENCH / "metrics", "ttft_median_ms")
    assert read(SimpleNamespace(ttft=[0.1, 0.3, math.inf])) == \
        pytest.approx(300.0)
    assert read(SimpleNamespace(ttft=[0.1, math.inf, math.inf])) is None


def test_logit_outliers_count_prompts_over_the_per_request_limit():
    """A median over prompts hides one prompt far off; the count does not."""
    import torch

    from harness import check
    g = torch.Generator().manual_seed(0)
    ref = torch.randn(5, 64, generator=g)
    sd = (ref - ref.mean(1, keepdim=True)).norm(dim=1, keepdim=True)
    noise = torch.randn(5, 64, generator=g)
    noise = noise / noise.norm(dim=1, keepdim=True) * sd
    err = torch.tensor([0.01, 0.02, 0.5, 0.03, 0.015])[:, None]
    got = ref + err * noise
    kv = torch.ones(4, 2, 8)
    ref_kv = {(p, 0): (kv, kv) for p in range(5)}
    mine = [{0: (kv, kv)} for _ in range(5)]
    tokens = got.argmax(1).tolist()
    r = check.readings(ref, ref_kv, tokens, list(got), mine,
                       each={"logit_err": 0.1})
    assert r["logit_err"] == pytest.approx(0.02, rel=1e-5)
    assert r["logit_outliers"] == 1.0
    assert r["diagnostics"]["logit_err_each"][2] == pytest.approx(0.5)
    assert check.readings(ref, ref_kv, tokens, list(got),
                          mine)["logit_outliers"] is None
    limits = {"logit_err": 0.12, "logit_outliers": 0}
    assert not check.judge(r, limits)
    assert check.judge(dict(r, logit_outliers=0.0), limits)
