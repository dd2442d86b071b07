"""Kanana-2-30B-A3B's latent attention on the card: the prefill kernel's
q/k 192, v 128 body against its plain version, and the served path
(Proxy -> PrefillInstance -> SegmentedPrefill -> the latent handoff ->
DecodeInstance's latent pool) at the published widths, 8 layers (the
dense layer and 7 MoE layers), against the plain float32 reference. This
file imports no JAX; each test skips without a card inside its fixture:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_mla_cuda.py -q -s

Tolerances: the kernel per element as tests/test_torch_cuda.py holds every
bf16 body (atol 1e-5, rtol 1.6e-2: one bf16 rounding of the output).

The served path at bf16 weights is held to the reference replaying the
program's own choice of routed experts (`mla_reference.forward(...,
experts=)`): a bf16 program swaps an expert wherever two sigmoid scores
lie within its rounding, and one of 6 experts weighs ~0.4, so without the
replay a prompt decorrelates from the f32 reference past the first MoE
layers and only a loose limit would hold. With it, every compared number
is the bf16 arithmetic's distance from f32's, at every layer:

- LOGIT_ERR: each first-token and decode-step logit vector's relative RMS
  error (the error's RMS over the reference's spread about its mean);
- LATENT_ERR: each layer's handed-off c_kv and k_pe, the error's norm over
  the reference's; LATENT_FIRST_ERR the same at the first layer, which no
  earlier layer's rounding reaches;
- the router on the program's own inputs (each MoE layer's normed input
  as the program recorded it) against f64: the same experts wherever the
  6th and 7th scores lie ROUTER_GAP apart, and the weights within
  ROUTER_ATOL there.

Each limit lies between the program's reading and that of the program
with one of its f32 steps done in bf16 (SLIPS), and each slip must fail
one of them (PERF.md gives both readings). The up-projected keys
and values have no f32 step to slip: they are the kernel's bf16 operands.
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import Request, SchedulerCore, TTFTPredictor
from repro_torch.kernels import counts, ref
from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.models import layers as L
from repro_torch.models import mla_reference as R
from repro_torch.models import model as M
from repro_torch.models import segments as S
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.params import ModelParams
from repro_torch.serving import decode_instance as D
from repro_torch.serving.decode_instance import DecodeInstance
from repro_torch.serving.prefill_instance import PrefillInstance
from repro_torch.serving.proxy import Proxy

pytestmark = pytest.mark.cuda

BF16 = dict(rtol=1.6e-2, atol=1e-5)
# the dense layer and 7 MoE layers
LAYERS = 8
# the served path against the reference replaying its experts, each limit
# between the program's reading on the H100 and a slip's (PERF.md):
# logits 0.0255 (every vector 0.019-0.025) / rotary angles in bf16 0.617;
# latent 0.0216 at the 8th layer / 0.666; first layer's latent 0.00287 /
# the latent's norm in bf16 0.00420
LOGIT_ERR = 0.035
LATENT_ERR = 0.03
LATENT_FIRST_ERR = 0.0035
# f32 sums of 2048 bf16 products: scores to ~1e-7, far inside this gap;
# the weights then to f32's rounding of a sum over 6
ROUTER_GAP = 1e-5
ROUTER_ATOL = 1e-5

MLA_CASES = [
    # B, Sq, T, H, q_offset, kv_len, causal
    (1, 512, 4096, 32, 3584, None, True),      # chunk512@3584 at H 32
    (1, 512, 512, 32, 0, None, True),          # a prompt's first chunk
    (2, 200, 700, 8, 450, 650, True),          # kv_len < T, off the grids
    (1, 1, 300, 4, 299, None, True),           # one query row
    (1, 130, 300, 4, 0, None, False),          # no mask
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", MLA_CASES)
def test_mla_body_against_the_plain_version(card, case):
    B, Sq, T, H, off, kv_len, causal = case
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=card)
               .to(torch.bfloat16) for shape in
               ((B, Sq, H, 192), (B, T, H, 192), (B, T, H, 128)))
    counts.reset()
    got = flash_prefill_attention(q, k, v, off, kv_len, causal=causal)
    out = torch.empty_like(got)
    flash_prefill_attention(q, k, v, off, kv_len, causal=causal, out=out)
    torch.cuda.synchronize()
    assert counts.read(["flash_prefill_mla", "flash_prefill_wgmma",
                        "chunked_prefill_attention_ref"]) == {
        "flash_prefill_mla": 2, "flash_prefill_wgmma": 2,
        "chunked_prefill_attention_ref": 0}
    want = ref.chunked_prefill_attention_ref(q.float(), k.float(), v.float(),
                                             q_offset=off, kv_len=kv_len,
                                             causal=causal)
    assert got.shape == (B, Sq, H, 128)
    torch.testing.assert_close(got.float(), want, **BF16)
    assert torch.equal(got, out)
    with pytest.raises(ValueError):           # f32 has no 192/128 body
        flash_prefill_attention(q.float(), k.float(), v.float(), off)


def _draw(cfg, device, seed):
    """The benchmark's draw (bench/harness/deploy.py): 0.1 for vectors,
    1/sqrt(d) for the embedding and head, 1/sqrt(fan_in) else, in bf16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = {}
    for key, shape in M.model_shapes(cfg).items():
        group = shape if isinstance(shape, dict) else {key: shape}
        made = {}
        for k, s in group.items():
            inner = s[1:] if isinstance(shape, dict) else s
            std = 0.1 if len(inner) == 1 else \
                cfg.d_model ** -0.5 if k in ("embed", "unembed") else \
                (inner[-3] if inner[-2] == 2 else inner[-2]) ** -0.5
            t = torch.empty(s, dtype=torch.bfloat16, device=device)
            for part in (t if isinstance(shape, dict) else [t]):
                part.normal_(0.0, std, generator=gen)
            made[k] = t
        tree[key] = made if isinstance(shape, dict) else made[key]
    return ModelParams(tree)


def _published(cfg):
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


def _rel(got, want):
    return float((got.float() - want).norm() / (want - want.mean()).norm())


def _norm_rel(got, want):
    return float((got.float() - want).norm() / want.norm())


def _serve(params, cfg, prompts, monkeypatch):
    """Each prompt through the served path in turn. Returns, per prompt,
    its first-token logits, its decode steps' logits, its tokens, the
    handed-off latent (c_kv (L, n, rank), k_pe (L, n, dr)) and the
    program's routing: {(layer, first position): (x, weights, experts)}
    for each MoE layer's prefill chunks and decode steps."""
    steps, routes, local = {}, {}, threading.local()
    step, apply = D.decode_step_ragged, L.moe_apply
    experts = SegmentedPrefill._experts

    def recording(params_, cfg_, tokens, k, v, kv_lens):
        local.pos, local.layer = int(kv_lens[0]), cfg.first_k_dense
        try:
            out = step(params_, cfg_, tokens, k, v, kv_lens)
        finally:
            local.pos = None
        steps[int(kv_lens[0])] = out[0][0].float().clone()
        return out

    def decode_apply(x, w, idx, *args, **kw):
        if getattr(local, "pos", None) is not None:     # row 0 is ours
            routes[local.layer, local.pos] = (x[0].clone(), w[0].clone(),
                                              idx[0].clone())
            local.layer += 1
        return apply(x, w, idx, *args, **kw)

    def prefill_experts(self, task, l, off, B, Sc):
        assert B == 1
        routes[l, off] = tuple(self._buf[key][:Sc].clone()
                               for key in ("x", "w", "idx"))
        return experts(self, task, l, off, B, Sc)
    monkeypatch.setattr(D, "decode_step_ragged", recording)
    monkeypatch.setattr(L, "moe_apply", decode_apply)
    monkeypatch.setattr(SegmentedPrefill, "_experts", prefill_experts)
    ex = SegmentedPrefill(params, cfg, max_seq=8192, granularity="op",
                          chunk_tokens=512, cache_dtype=torch.bfloat16)
    core = SchedulerCore(predictor=TTFTPredictor(
        coeffs=np.array([1e-4, 0.0]), floor=0.0), policy="s-edf")
    inst = PrefillInstance(params, cfg, core, max_seq=8192, executor=ex)
    dec = DecodeInstance(params, cfg, decode_tokens=8, decode_max_batch=4)
    proxy = Proxy([inst], [dec])
    first, latent = {}, {}
    handoff = inst.on_prefill_done

    def done(task):
        st = task.prefill_task.state
        for i, req in enumerate(task.requests):
            n = req.num_tokens
            first[req.rid] = task.prefill_task.logits[i].float().clone()
            latent[req.rid] = (st["k_cache"][:, i, :n, 0].float().clone(),
                               st["v_cache"][:, i, :n, 0].float().clone())
        handoff(task)
        inst.completed_tasks.clear()
    inst.on_prefill_done = done
    out = []
    try:
        for toks in prompts:
            steps.clear()
            routes.clear()
            req = Request(num_tokens=len(toks), slo=60.0)
            proxy.submit(req, toks)
            deadline = time.monotonic() + 120
            while len(dec.outputs.get(req.rid, ())) < 9 and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            n = len(toks)
            out.append((first[req.rid], [steps[t] for t in range(n, n + 8)],
                        dec.outputs[req.rid], latent[req.rid], dict(routes)))
    finally:
        proxy.shutdown()
    assert dec.kv.k_pool.shape[-2:] == (1, cfg.kv_lora_rank)
    assert dec.kv.v_pool.shape[-2:] == (1, cfg.qk_rope_head_dim)
    return out


def _routing(cfg, routes, n):
    """Per MoE layer, the program's (x, weights, experts) over positions
    [0, n) in order; fails unless the records tile them."""
    out = []
    for l in range(cfg.first_k_dense, cfg.num_layers):
        starts = sorted(t for m, t in routes if m == l)
        parts = [routes[l, t] for t in starts]
        ends = np.cumsum([p[0].shape[0] for p in parts])
        assert starts == [0] + ends[:-1].tolist() and ends[-1] == n, \
            f"layer {l}: routing recorded at {starts}"
        out.append(tuple(torch.cat([p[i] for p in parts]) for i in range(3)))
    return out


def _router_readings(params, cfg, routing):
    """The program's routing on its own inputs against f64: (choices that
    differ where the 6th and 7th scores lie ROUTER_GAP apart, the widest
    weight error there, the share of such clear choices)."""
    k, lw = cfg.experts_per_token, params["layers"]
    off, err, clear_n, total = 0, 0.0, 0, 0
    for j, (x, w, idx) in enumerate(routing):
        s64 = torch.sigmoid(x.double() @ lw["router"][j].double())
        top = torch.topk(s64 + lw["router_bias"][j].double(), k + 1, dim=-1)
        clear = (top.values[:, k - 1] - top.values[:, k]) > ROUTER_GAP
        want = top.indices[:, :k].sort(-1).values
        got, order = idx.long().sort(-1)
        same = (got == want).all(-1)
        off += int((clear & ~same).sum())
        w64 = s64.gather(-1, want)
        w64 = w64 / w64.sum(-1, keepdim=True) * cfg.routed_scaling_factor
        ok = clear & same
        if ok.any():
            err = max(err, float((w.double().gather(-1, order) - w64)
                                 .abs()[ok].max()))
        clear_n, total = clear_n + int(clear.sum()), total + clear.numel()
    return off, err, clear_n / total


def _readings(params, cfg, prompts, served):
    """The compared numbers (the module's docstring) over every prompt."""
    weights = {"embed": params["embed"], "final_norm": params["final_norm"],
               "unembed": params["unembed"],
               "layers": dict(params["layers"].items())}
    logit, latent, router = [], [], []
    for toks, (first, steps, tokens, (c_kv, k_pe), routes) in zip(
            prompts, served):
        n = len(toks)
        seq = torch.cat([torch.as_tensor(toks), torch.tensor(tokens[:-1])])
        routing = _routing(cfg, routes, n + 8)
        want, cache = R.forward(weights, _published(cfg), seq,
                                experts=[idx for _, _, idx in routing])
        logit.append([_rel(first, want[n - 1])] +
                     [_rel(s, want[t]) for t, s in zip(range(n, n + 8),
                                                       steps)])
        latent.append([max(_norm_rel(c_kv[l], cache[l][0][:n]),
                           _norm_rel(k_pe[l], cache[l][1][:n]))
                       for l in range(cfg.num_layers)])
        router.append(_router_readings(params, cfg, routing))
    return {"logit_err": float(np.max(logit)),
            "latent_err": float(np.max(latent)),
            "latent_first_err": float(np.max(np.asarray(latent)[:, 0])),
            "router_off": sum(r[0] for r in router),
            "router_weight_err": max(r[1] for r in router),
            "router_clear": min(r[2] for r in router),
            "logit_err_each": np.round(logit, 5).tolist(),
            "latent_err_by_layer": np.round(np.max(latent, 0), 5).tolist()}


def _failed(got):
    """The limits a reading exceeds."""
    limits = {"logit_err": LOGIT_ERR, "latent_err": LATENT_ERR,
              "latent_first_err": LATENT_FIRST_ERR, "router_off": 0,
              "router_weight_err": ROUTER_ATOL}
    return sorted(key for key, lim in limits.items() if got[key] > lim)


def _model(card):
    cfg = dataclasses.replace(get_config("kanana_2_30b_a3b"),
                              num_layers=LAYERS)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (590, 2300, 5200)]
    return cfg, _draw(cfg, card, 7), prompts


def test_served_path_and_latent_decode_against_the_reference(card,
                                                             monkeypatch):
    """QwenTrace-like prompt lengths (a text, a search and a file prompt,
    each over several 512-token chunks but the first) prefilled through
    the served path, handed to the decode instance, 8 tokens decoded
    through its latent pool: the module docstring's numbers within their
    limits, the kernel's launches the 192/128 body's."""
    cfg, params, prompts = _model(card)
    counts.reset()
    got = _readings(params, cfg, prompts,
                    _serve(params, cfg, prompts, monkeypatch))
    launches = counts.read(["flash_prefill_mla", "flash_prefill_attention",
                            "chunked_prefill_attention_ref", "mla_kv_rows"])
    print("program", json.dumps(got), launches)
    chunks = [(n + 511) // 512 for n in (590, 2300, 5200)]
    assert launches["flash_prefill_mla"] == \
        launches["flash_prefill_attention"] == cfg.num_layers * sum(chunks)
    assert launches["chunked_prefill_attention_ref"] == 0
    assert got["router_clear"] > 0.99
    assert _failed(got) == []


def _router_bf16(x, w_router, bias, k, scale):
    """`moe_router_sigmoid` with its products and sigmoid in bf16."""
    scores = torch.sigmoid(x.bfloat16() @ w_router.bfloat16()).float()
    idx = torch.topk(scores + bias.float(), k, dim=-1).indices
    w = scores.gather(-1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scale, idx, scores


def _rope_tables_bf16(positions, head_dim, theta):
    """`rope_tables` with the rotary angles in bf16."""
    freqs = L.rope_freqs(head_dim, theta, positions.device)
    angles = positions.bfloat16()[..., None] * freqs.bfloat16()
    return torch.cos(angles.float()), torch.sin(angles.float())


def _mla_project_norm_bf16(cfg, p, x, cos, sin):
    """`mla_project` with the latent's RMS norm in bf16 arithmetic."""
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = (x @ p["wq"]).unflatten(-1, (cfg.num_heads, -1))
    ckv = x @ p["wkv_a"]
    c = ckv[..., :r]
    c = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + cfg.norm_eps) \
        * (1 + p["kv_norm"])
    q_pe = M._mla_rope(cfg, q[..., dn:], cos[..., None, :], sin[..., None, :])
    return (torch.cat([q[..., :dn], q_pe], dim=-1), c,
            M._mla_rope(cfg, ckv[..., r:], cos, sin))


SLIPS = {
    "router_bf16": [(L, "moe_router_sigmoid", _router_bf16)],
    "rope_bf16": [(L, "rope_tables", _rope_tables_bf16)],
    "latent_norm_bf16": [(M, "mla_project", _mla_project_norm_bf16),
                         (S, "mla_project", _mla_project_norm_bf16)],
}


@pytest.mark.parametrize("slip", sorted(SLIPS))
def test_a_precision_slip_fails_the_served_limits(card, monkeypatch, slip):
    """The served path with one f32 step done in bf16 fails at least one
    of the limits the program meets (the module's docstring)."""
    for module, name, fn in SLIPS[slip]:
        monkeypatch.setattr(module, name, fn)
    cfg, params, prompts = _model(card)
    got = _readings(params, cfg, prompts,
                    _serve(params, cfg, prompts, monkeypatch))
    print(slip, json.dumps(got), "fails", _failed(got))
    assert _failed(got)


def _route(x, w_router, bias, bf16_products=False):
    if bf16_products:
        scores = torch.sigmoid((x @ w_router).float())
        idx = torch.topk(scores + bias, 6, dim=-1).indices
        w = scores.gather(-1, idx)
        return w / w.sum(-1, keepdim=True) * 2.448, idx
    return L.moe_router_sigmoid(x, w_router, bias, 6, 2.448)[:2]


def test_router_choice_and_weights_are_f32s(card):
    """The sigmoid router on the card (bf16 inputs, f32 products) against
    f64 on the same inputs: the same experts and weights wherever the
    choice is not a near-tie; a router whose products round to bf16 picks
    other experts at ties far wider than f32's error."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(8192, 2048, generator=g, device=card).bfloat16()
    w_r = (torch.randn(2048, 128, generator=g, device=card)
           / 2048 ** 0.5).bfloat16()
    bias = 0.1 * torch.randn(128, generator=g, device=card)
    s64 = torch.sigmoid(x.double().cpu() @ w_r.double().cpu())
    top = torch.topk(s64 + bias.double().cpu(), 7, dim=-1)
    clear = (top.values[:, 5] - top.values[:, 6]) > ROUTER_GAP
    idx64 = top.indices[:, :6]
    w64 = s64.gather(-1, idx64)
    w64 = w64 / w64.sum(-1, keepdim=True) * 2.448
    w, idx = _route(x, w_r, bias)
    assert clear.float().mean() > 0.99
    assert torch.equal(idx.cpu()[clear], idx64[clear])
    torch.testing.assert_close(w.double().cpu()[clear], w64[clear],
                               rtol=0, atol=1e-5)
    _, slip = _route(x, w_r, bias, bf16_products=True)
    assert not torch.equal(slip.cpu()[clear].sort(-1).values,
                           idx64[clear].sort(-1).values)
