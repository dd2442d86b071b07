"""Kanana-2-30B-A3B's latent-attention stack (`MLAConfig`) on the port,
against the plain float32 reference `repro_torch.models.mla_reference`, at
the tiny configuration in f32 on the CPU with seeded random weights (every
leaf drawn, the norm offsets and the router's correction bias included, so
that each of them moves the result).

No JAX: the JAX package has no latent attention. Tolerances: 1e-4 on
logits and latent rows, the port's f32 model tolerance (2e-4 elsewhere in
the suite, held tighter here: both sides run the same f32 arithmetic in
another order, ~3e-6 apart); the plain attention against an f64 softmax at
1e-5.
"""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.base import get_config, get_tiny_config
from repro_torch.core import Request, SchedulerCore, TTFTPredictor
from repro_torch.kernels import counts, ref
from repro_torch.models import layers as L
from repro_torch.models import mla_reference as R
from repro_torch.models import model as M
from repro_torch.models.segments import (DENSE_OPS, MOE_OPS, SegmentedPrefill,
                                         layer_op_names)
from repro_torch.params import ModelParams
from repro_torch.serving import decode_instance as D
from repro_torch.serving.decode_instance import DecodeInstance, DecodeJob
from repro_torch.serving.prefill_instance import PrefillInstance
from repro_torch.serving.proxy import Proxy

CFG = get_tiny_config("kanana_2_30b_a3b")
TOL = dict(rtol=1e-4, atol=1e-4)


def draw(cfg, seed: int) -> ModelParams:
    """Every leaf of `model_shapes` from N(0, s): s = 0.1 for vectors
    stacked per layer (norm offsets, the router's bias), 1/sqrt(d) for the
    embedding and head, 1/sqrt(fan_in) for the matrices."""
    g = torch.Generator().manual_seed(seed)

    def leaf(shape, stacked, key):
        inner = shape[1:] if stacked else shape
        if len(inner) == 1:
            s = 0.1
        elif key in ("embed", "unembed"):
            s = 1 / math.sqrt(cfg.d_model)
        else:
            s = 1 / math.sqrt(inner[-3] if inner[-2] == 2 else inner[-2])
        return torch.randn(shape, generator=g) * s

    tree = {}
    for key, shape in M.model_shapes(cfg).items():
        tree[key] = {k: leaf(s, True, k) for k, s in shape.items()} \
            if isinstance(shape, dict) else leaf(shape, False, key)
    return ModelParams(tree)


def published(cfg) -> dict:
    """The published `config.json` keys the reference reads."""
    return dict(num_attention_heads=cfg.num_heads,
                qk_nope_head_dim=cfg.qk_nope_head_dim,
                qk_rope_head_dim=cfg.qk_rope_head_dim,
                v_head_dim=cfg.v_head_dim, kv_lora_rank=cfg.kv_lora_rank,
                rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
                first_k_dense_replace=cfg.first_k_dense,
                num_hidden_layers=cfg.num_layers,
                num_experts_per_tok=cfg.experts_per_token,
                routed_scaling_factor=cfg.routed_scaling_factor,
                tie_word_embeddings=cfg.tie_embeddings)


def plain(params) -> dict:
    return {"embed": params["embed"].detach(),
            "final_norm": params["final_norm"].detach(),
            "unembed": params["unembed"].detach(),
            "layers": {k: v.detach() for k, v in params["layers"].items()}}


@pytest.fixture(scope="module")
def model():
    params = draw(CFG, 0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG.vocab_size, 45))
    logits, cache = R.forward(plain(params), published(CFG), toks)
    return params, toks, logits, cache


def test_config_at_published_width():
    cfg = get_config("kanana-2-30b-a3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_lora_rank,
            cfg.qk_head_dim, cfg.v_head_dim, cfg.first_k_dense,
            cfg.d_ff_dense, cfg.num_experts, cfg.d_ff, cfg.experts_per_token,
            cfg.d_ff_shared, cfg.vocab_size) == (
        48, 2048, 32, 512, 192, 128, 1, 6144, 128, 768, 6, 1536, 128256)
    # 30.67 B parameters, 61.3 GB in bf16; 576 latent values a token and
    # layer
    assert round(cfg.param_count() / 1e9, 2) == 30.67
    # active: the attention, the dense layer, 6 routed + the shared experts
    # and the router a MoE layer, the embedding and head (3.09 B without)
    assert round(cfg.active_param_count() / 1e9, 2) == 3.61
    assert cfg.latent_dim == 576
    shapes = M.model_shapes(cfg)
    assert set(shapes) == {"embed", "final_norm", "unembed", "layers"}
    n = sum(math.prod(s) for s in shapes["layers"].values()) \
        + sum(math.prod(shapes[k]) for k in ("embed", "final_norm",
                                             "unembed"))
    assert n == cfg.param_count()
    assert layer_op_names(cfg) == [DENSE_OPS] + [MOE_OPS] * 47


def test_forward_logits_match_reference(model):
    params, toks, want, _ = model
    got = M.forward(params, CFG, {"tokens": toks[None]})[0]
    torch.testing.assert_close(got, want, **TOL)


def test_prefill_then_decode_steps_through_the_latent(model):
    params, toks, want, cache = model
    S = 37
    logits, c = M.prefill(params, CFG, {"tokens": toks[None, :S]},
                          max_seq=48, cache_dtype=torch.float32)
    torch.testing.assert_close(logits[0], want[S - 1], **TOL)
    assert c["k"].shape == (CFG.num_layers, 1, 48, 1, CFG.kv_lora_rank)
    assert c["v"].shape == (CFG.num_layers, 1, 48, 1, CFG.qk_rope_head_dim)
    for l, (c_kv, k_pe) in enumerate(cache):
        torch.testing.assert_close(c["k"][l, 0, :S, 0], c_kv[:S], **TOL)
        torch.testing.assert_close(c["v"][l, 0, :S, 0], k_pe[:S], **TOL)
    for t in range(S, S + 8):
        logits, c = M.decode_step(params, CFG, toks[None, t], c)
        torch.testing.assert_close(logits[0], want[t], **TOL)
    assert c["pos"] == S + 8


def test_ragged_decode_step_rows_of_other_lengths(model):
    params, toks, want, _ = model
    lens = [20, 33]
    k = torch.zeros(CFG.num_layers, 2, 40, 1, CFG.kv_lora_rank)
    v = torch.zeros(CFG.num_layers, 2, 40, 1, CFG.qk_rope_head_dim)
    for b, n in enumerate(lens):
        _, c = M.prefill(params, CFG, {"tokens": toks[None, :n]},
                         cache_dtype=torch.float32)
        k[:, b, :n], v[:, b, :n] = c["k"][:, 0], c["v"][:, 0]
    logits, k_new, v_new = M.decode_step_ragged(
        params, CFG, toks[lens], k, v, torch.tensor(lens))
    for b, n in enumerate(lens):
        torch.testing.assert_close(logits[b], want[n], **TOL)
    assert k_new.shape == (CFG.num_layers, 2, 1, CFG.kv_lora_rank)
    torch.testing.assert_close(k_new[:, 1, 0], k[:, 1, 33, 0])


def _run(ex, tokens, other=None, at=()):
    """Step a task of `tokens` to its end; at each step index in `at`, run
    a whole prefill of `other` on the same executor first (a preemption and
    a resume)."""
    task = ex.start(tokens)
    i = 0
    while not task.done:
        if i in at:
            ex.run_all(ex.start(other))
        ex.step(task)
        i += 1
    return task


@pytest.mark.parametrize("granularity", ["op", "layer", "block2"])
# 1 row of 8 tokens a chunk, within the largest bucket (64), over the
# executor's buffers; 9 rows, 72 tokens a chunk, over buffers of the task's
# own
@pytest.mark.parametrize("rows", [1, 9])
def test_segmented_prefill_chunks_preempts_and_hands_off_the_latent(
        model, granularity, rows):
    params, toks, want, cache = model
    ex = SegmentedPrefill(params, CFG, max_seq=64, granularity=granularity,
                          chunk_tokens=8)
    S = 30
    mid = ex.segments_for(S) // 2          # inside chunk 1 or 2
    task = _run(ex, toks[None, :S].expand(rows, -1), toks[None, :11],
                at=(3, mid))
    assert ("buf" in task.state) == (rows * 8 > ex._buckets[-1])
    for b in range(rows):
        torch.testing.assert_close(task.logits[b], want[S - 1], **TOL)
        for l, (c_kv, k_pe) in enumerate(cache):
            torch.testing.assert_close(task.state["k_cache"][l, b, :S, 0],
                                       c_kv[:S], **TOL)
            torch.testing.assert_close(task.state["v_cache"][l, b, :S, 0],
                                       k_pe[:S], **TOL)


def test_operator_set_per_layer_and_span_rows(model):
    params, toks, _, _ = model
    ex = SegmentedPrefill(params, CFG, max_seq=64, granularity="op",
                          chunk_tokens=8)
    assert ex.ops == MOE_OPS
    counts.reset()
    tracing.enable()
    try:
        task = ex.start(toks[None, :20].expand(2, -1))
        ex.run_all(task)
    finally:
        spans = tracing.take()
    seg = [s for s in spans if s.name == "segment" and s.attrs["op"] != "head"]
    ops = [(s.attrs["layer"], s.attrs["op"]) for s in seg]
    assert ops[:5] == [(0, op) for op in DENSE_OPS]
    assert ops[5:10] == [(1, op) for op in MOE_OPS]
    attn = [s for s in seg if s.attrs["op"] == "attn"]
    # chunks of 8, 8 and 4 tokens: 2 rows up-project 8, 16 and 20 latent
    # rows at every layer; no other span carries the rows
    assert [(s.attrs["chunk"], s.attrs["kv_rows"], s.attrs["q_rows"])
            for s in attn] == [(c, 2 * hi, 2 * (hi - lo))
                               for c, (lo, hi) in enumerate(
                                   [(0, 8), (8, 16), (16, 20)])
                               for _ in range(CFG.num_layers)]
    assert all("kv_rows" not in s.attrs for s in seg if s not in attn)
    assert counts.read(["mla_kv_rows"])["mla_kv_rows"] == \
        CFG.num_layers * 2 * (8 + 16 + 20)


def test_sigmoid_router_bias_picks_and_does_not_weigh():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 16, generator=g)
    w_r = torch.randn(16, 8, generator=g) / 4
    bias = torch.zeros(8)
    bias[7] = 5.0                          # expert 7 always chosen
    w, idx, scores = L.moe_router_sigmoid(x, w_r, bias, 3, 2.448)
    torch.testing.assert_close(scores, torch.sigmoid(x @ w_r))
    assert (idx == 7).any(-1).all()
    torch.testing.assert_close(idx, torch.topk(scores + bias, 3).indices)
    chosen = scores.gather(-1, idx)        # the bias weighs nothing
    torch.testing.assert_close(w, chosen / chosen.sum(-1, keepdim=True)
                               * 2.448)
    torch.testing.assert_close(w.sum(-1), torch.full((2, 5), 2.448))
    got = L.moe_router_sigmoid(x, w_r, torch.zeros(8), 3, 1.0)[1]
    assert not (got == 7).any(-1).all()    # without the bias it is not


def test_shared_experts_and_dense_first_layer(model):
    params, _, _, _ = model
    x = torch.randn(1, 9, CFG.d_model, generator=torch.Generator()
                    .manual_seed(4))
    p0, p1 = M.layer_params(params, 0), M.layer_params(params, 1)
    assert "router" not in p0 and p0["wi"].shape == (CFG.d_model, 2,
                                                     CFG.d_ff_dense)
    w0 = R.layer(plain(params), 0, CFG.first_k_dense)
    h = x + R.rms_norm(x, w0["ln2"], CFG.norm_eps)    # any input
    torch.testing.assert_close(
        M.ffn_block(CFG, p0, h)[0],
        h[0] + R.swiglu(R.rms_norm(h[0], w0["ln2"], CFG.norm_eps),
                        w0["wi"], w0["wd"]), **TOL)
    w1 = R.layer(plain(params), 1, CFG.first_k_dense)
    xn = R.rms_norm(h[0], w1["ln2"], CFG.norm_eps)
    want = h[0] + R.moe(xn, w1, CFG.experts_per_token,
                        CFG.routed_scaling_factor)
    torch.testing.assert_close(M.ffn_block(CFG, p1, h)[0], want, **TOL)
    # the shared experts are in it: without them it differs
    shared = R.swiglu(xn, w1["wi_shared"], w1["wd_shared"])
    assert (M.ffn_block(CFG, p1, h)[0] - (want - shared)).abs().max() > 1e-2


@pytest.mark.parametrize("n", [1, 17, 512, 4096, 6 * 512 + 7])
def test_no_pair_dropped_at_the_served_capacity(n):
    cfg = get_config("kanana_2_30b_a3b")
    E, k = cfg.num_experts, cfg.experts_per_token
    G, g, cap = L.moe_groups(n, k, E, cfg.d_ff,
                             capacity_factor=cfg.moe_capacity_factor,
                             min_capacity=cfg.moe_min_capacity)
    # an expert can take every token of its group, with room: the product
    # g * k * cf / E is 1.03 g before the clamp, where E / k = 21.33 would
    # put an inexact product at g itself
    assert cap == g
    assert g * k * cfg.moe_capacity_factor / E >= 1.03 * g


def test_no_pair_dropped_in_the_tiny_moe(model):
    params, toks, _, _ = model
    p = M.layer_params(params, 1)
    x = torch.randn(1, 24, CFG.d_model)
    w, idx, _ = L.moe_router_sigmoid(x, p["router"], p["router_bias"],
                                     CFG.experts_per_token, 1.0)
    G, g, cap = L.moe_groups(24, CFG.experts_per_token, CFG.num_experts,
                             CFG.d_ff, capacity_factor=CFG.moe_capacity_factor,
                             min_capacity=CFG.moe_min_capacity)
    _, keep = L.moe_queue(idx.reshape(G, -1), G, CFG.num_experts, cap)
    assert keep.all()


def test_rotary_deinterleave_is_the_published_form():
    """`apply_rotary_pos_emb_interleave` of modeling_deepseek_v3 written
    out: the rotary dims viewed as (r/2, 2) pairs, transposed, then q * cos
    + rotate_half(q) * sin with cos/sin of cat(freqs, freqs)."""
    r, theta = 8, 1e6
    x = torch.randn(5, 3, r, generator=torch.Generator().manual_seed(5))
    pos = torch.arange(5) + 11
    inv = 1.0 / theta ** (torch.arange(0, r, 2).float() / r)
    emb = torch.cat([pos[:, None] * inv] * 2, dim=-1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    xd = x.view(5, 3, r // 2, 2).transpose(3, 2).reshape(5, 3, r)
    rot = torch.cat([-xd[..., r // 2:], xd[..., :r // 2]], dim=-1)
    want = xd * cos + rot * sin
    c, s = L.rope_tables(pos, r, theta)
    got = M._mla_rope(CFG, x, c[:, None], s[:, None])
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(R.rope(R.deinterleave(x), pos, theta), want)


@pytest.mark.parametrize("q_offset,kv_len", [(0, None), (40, 56), (13, 30)])
def test_plain_attention_192_128_against_f64_softmax(q_offset, kv_len):
    g = torch.Generator().manual_seed(6)
    B, Sq, T, H = 2, 16, 56, 3
    q = torch.randn(B, Sq, H, 192, generator=g)
    k = torch.randn(B, T, H, 192, generator=g)
    v = torch.randn(B, T, H, 128, generator=g)
    got = ref.chunked_prefill_attention_ref(q, k, v, q_offset=q_offset,
                                            kv_len=kv_len)
    assert got.shape == (B, Sq, H, 128)
    s = torch.einsum("bshd,bthd->bhst", q.double(), k.double()) \
        / math.sqrt(192)
    qpos = q_offset + torch.arange(Sq)[:, None]
    kpos = torch.arange(T)[None, :]
    hide = (kpos > qpos) | (kpos >= (kv_len or T))
    p = torch.softmax(s.masked_fill(hide, float("-inf")), dim=-1)
    want = torch.einsum("bhst,bthd->bshd", p, v.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_served_through_the_proxy_and_decoded_from_the_latent_pool(
        model, monkeypatch):
    """Proxy -> PrefillInstance -> SegmentedPrefill (chunks of 8) -> the
    handoff -> a DecodeInstance whose paged pool holds the latent; each
    request's first-token logits and 6 decode steps' logits against the
    reference's forward over its prompt and its decoded tokens."""
    params, toks, _, _ = model
    steps = {}
    step = D.decode_step_ragged

    def recording(params_, cfg, tokens, k, v, kv_lens):
        out = step(params_, cfg, tokens, k, v, kv_lens)
        steps[int(kv_lens[0])] = out[0][0].clone()
        return out
    monkeypatch.setattr(D, "decode_step_ragged", recording)
    ex = SegmentedPrefill(params, CFG, max_seq=64, granularity="op",
                          chunk_tokens=8)
    core = SchedulerCore(predictor=TTFTPredictor(coeffs=np.array([1e-4, 0.0]),
                                                 floor=0.0),
                         policy="s-edf", enable_batching=False)
    first = {}

    inst = PrefillInstance(params, CFG, core, max_seq=64, executor=ex)
    dec = DecodeInstance(params, CFG, decode_tokens=6, decode_max_batch=4)
    proxy = Proxy([inst], [dec])
    handoff = inst.on_prefill_done

    def done(task):
        for i, req in enumerate(task.requests):
            first[req.rid] = task.prefill_task.logits[i].clone()
        handoff(task)
    inst.on_prefill_done = done
    try:
        for n in (21, 30):
            steps.clear()
            req = Request(num_tokens=n, slo=10.0)
            proxy.submit(req, toks[:n].numpy())
            deadline = time.monotonic() + 60
            while len(dec.outputs.get(req.rid, ())) < 7 and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            out = dec.outputs[req.rid]
            assert len(out) == 7
            seq = torch.cat([toks[:n], torch.tensor(out[:-1])])
            want, _ = R.forward(plain(params), published(CFG), seq)
            torch.testing.assert_close(first[req.rid], want[n - 1], **TOL)
            assert out[0] == int(want[n - 1].argmax())
            for t in range(n, n + 6):
                torch.testing.assert_close(steps[t], want[t], **TOL)
    finally:
        proxy.shutdown()
    assert dec.kv.k_pool.shape[-2:] == (1, CFG.kv_lora_rank)
    assert dec.kv.v_pool.shape[-2:] == (1, CFG.qk_rope_head_dim)


def test_the_reference_replays_a_choice_of_experts(model, monkeypatch):
    """`mla_reference.forward(..., experts=)`: the reference's own choice
    replayed gives its logits bit for bit; another expert at one layer's
    first slot moves them (the replay is what the MoE layers run)."""
    params, toks, want, _ = model
    own = []
    route = R.route

    def recording(*args):
        out = route(*args)
        own.append(out[1].clone())
        return out
    monkeypatch.setattr(R, "route", recording)
    got, _ = R.forward(plain(params), published(CFG), toks)
    monkeypatch.setattr(R, "route", route)
    assert len(own) == CFG.num_moe_layers and torch.equal(got, want)
    got, _ = R.forward(plain(params), published(CFG), toks, experts=own)
    assert torch.equal(got, want)
    e = own[-1]
    unused = torch.ones(e.shape[0], CFG.num_experts).scatter(1, e, 0.0)
    other = own[:-1] + [torch.cat([unused.argmax(1, keepdim=True), e[:, 1:]],
                                  dim=1)]
    got, _ = R.forward(plain(params), published(CFG), toks, experts=other)
    assert (got - want).abs().max() > 1e-3


def test_reference_reads_every_leaf(model):
    """Each leaf of the tiny stack moves the reference's logits, so none is
    read in the wrong place or left out."""
    params, toks, want, _ = model
    w = plain(params)
    for key in w["layers"]:
        moved = dict(w, layers=dict(w["layers"]))
        moved["layers"][key] = w["layers"][key] * 1.5
        got, _ = R.forward(moved, published(CFG), toks[:12])
        assert (got - want[:12]).abs().max() > 1e-4, key
