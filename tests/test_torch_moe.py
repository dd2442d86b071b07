"""The port's uniform MoE family against the JAX package, on the tiny
Qwen3-MoE (top-2 of 8 experts) and Granite-MoE (top-4 of 8, tied
embeddings) configs in f32, with weights bridged from the JAX `init_params`
pytree.

- (a) `moe_router` and `moe_apply` at 2e-5 (the reference's f32 kernel
  tolerance): drop-free, at capacities that drop (the same dropped pairs as
  the reference's queue rule, and some pairs are dropped), in the
  multi-group path, the one-group fallback and an explicit `group_size`.
- (b) `SegmentedPrefill` over `MOE_OPS` against the JAX fused `prefill` and
  the JAX `SegmentedPrefill` at 2e-4 (tests/test_segments.py), chunked
  against JAX chunked at the same `chunk_tokens` (per-chunk groups, also
  where pairs drop), and suspend/resume bit-exact at stop fractions and at
  a `gate` and an `experts` boundary.
- (c) `decode_step_ragged` and `decode_verify_ragged` against JAX on ragged
  rows, drop-free and, for verify, where the B * S tokens drop.
- (d) `init_params`: the reference's `model_shapes` and fan-in scales;
  every other family still refused.
- (e) a tiny MoE `build` + `serve_trace` whose tokens equal a greedy run of
  the JAX reference functions, and two S-EDF preemptions forced at a
  `gate` and an `experts` boundary through the threaded runtime.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.segments import SegmentedPrefill as JaxSegmentedPrefill
from repro_torch.configs.base import ModelConfig, get_tiny_config
from repro_torch.core import Request
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.segments import (DENSE_OPS, MOE_OPS,
                                         SegmentedPrefill, op_names)
from repro_torch.params import from_jax_params, init_params

ARCHS = ["qwen3_30b_a3b", "granite_moe_3b"]
F32 = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 48


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    """(JAX config, JAX params, port config, port params) of one arch."""
    arch = request.param
    jcfg = jax_tiny_config(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_tiny_config(arch), tparams


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _with_cf(jcfg, cfg, cf):
    """Both configs at capacity factor `cf` (None keeps the drop-free one)."""
    if cf is None:
        return jcfg, cfg
    return (dataclasses.replace(jcfg, moe_capacity_factor=cf),
            dataclasses.replace(cfg, moe_capacity_factor=cf))


def _reference_keep(idx, n_groups, n_experts, cap):
    """The reference's queue rule (src/repro/models/layers.py:338-343) on
    its own indices: which (token, slot) pairs keep their slot."""
    ig = jnp.asarray(idx).reshape(n_groups, -1)
    flat = jax.nn.one_hot(ig, n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - 1) * flat, axis=-1)
    return np.asarray(pos < cap)


# --- (a) router and experts ---------------------------------------------------

# name, B, S, capacity factor (None: the config's drop-free E/k), group_size,
# expected groups, whether pairs drop
APPLY_CASES = [
    ("drop_free", 2, 48, None, 0, 1, False),
    ("drops_cf1", 2, 48, 1.0, 0, 1, True),
    ("drops_cf05", 3, 40, 0.5, 0, 1, True),
    ("multi_group", 2, 512, 1.0, 0, 2, True),
    ("one_group_fallback", 2, 300, 1.0, 0, 1, True),
    ("group_size", 2, 48, 1.0, 16, 6, True),
]


@pytest.mark.parametrize("case", APPLY_CASES, ids=[c[0] for c in APPLY_CASES])
def test_router_and_apply_match_jax(moe, case):
    _, Bc, Sc, cf, group_size, want_groups, drops = case
    jcfg, jparams, cfg, tparams = moe
    cf = cf or cfg.moe_capacity_factor
    k, E = cfg.experts_per_token, cfg.num_experts
    rng = np.random.default_rng(7)
    x = rng.standard_normal((Bc, Sc, cfg.d_model)).astype(np.float32)
    lay = jax.tree.map(lambda a: a[1], jparams["layers"])
    tl = {key: t[1] for key, t in tparams["layers"].items()}

    jw, jidx, jlogits = JL.moe_router(jnp.asarray(x), lay["router"], k)
    tw, tidx, tlogits = TL.moe_router(torch.from_numpy(x), tl["router"], k)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32)

    G, g, cap = TL.moe_groups(Bc * Sc, k, E, cfg.d_ff, capacity_factor=cf,
                              min_capacity=cfg.moe_min_capacity,
                              group_size=group_size)
    assert G == want_groups and G * g == Bc * Sc
    _, keep = TL.moe_queue(tidx, G, E, cap)
    want_keep = _reference_keep(jidx, G, E, cap)
    assert np.array_equal(keep.numpy(), want_keep)
    assert (not want_keep.all()) == drops

    kw = dict(k=k, capacity_factor=cf, min_capacity=cfg.moe_min_capacity,
              group_size=group_size)
    want = JL.moe_apply(jnp.asarray(x), jw, jidx, lay["wi"], lay["wd"], **kw)
    got = TL.moe_apply(torch.from_numpy(x), tw, tidx, tl["wi"], tl["wd"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    ffn = TL.moe_ffn(torch.from_numpy(x), tl["router"], tl["wi"], tl["wd"],
                     **kw)
    assert torch.equal(ffn, got)


def test_dropped_pair_adds_nothing(moe):
    """A token whose every pair is dropped comes out as exactly 0, so the
    residual alone carries it."""
    _, _, cfg, tparams = moe
    k, E = cfg.experts_per_token, cfg.num_experts
    tl = {key: t[0] for key, t in tparams["layers"].items()}
    x = torch.randn(1, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    # every token routes to the same k experts: cap = min_capacity = 4
    idx = torch.arange(k).expand(1, 12, k).contiguous()
    w = torch.full((1, 12, k), 1.0 / k)
    y = TL.moe_apply(x, w, idx, tl["wi"], tl["wd"], k=k, capacity_factor=0.5,
                     min_capacity=4)
    assert TL.moe_groups(12, k, E, cfg.d_ff, capacity_factor=0.5,
                         min_capacity=4)[2] == 4
    assert torch.count_nonzero(y[0, 4:]) == 0
    assert torch.count_nonzero(y[0, :4]) > 0


# --- (b) segmented prefill ----------------------------------------------------


def test_segmented_matches_fused_and_jax_segmented(moe):
    jcfg, jparams, cfg, tparams = moe
    tokens = _tokens(cfg, (B, S))
    ex = SegmentedPrefill(tparams, cfg, max_seq=S, granularity="op")
    assert ex.ops == MOE_OPS
    task = ex.start(tokens)
    assert task.total_segments == cfg.num_layers * len(MOE_OPS) + 1
    got = ex.run_all(task)
    fused, _ = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                          max_seq=S, cache_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), **TOL)
    jex = JaxSegmentedPrefill(jparams, jcfg, max_seq=S, granularity="op")
    jtask = jex.start(jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.run_all(jtask)),
                               **TOL)
    for key in ("k_cache", "v_cache"):
        np.testing.assert_allclose(task.state[key].numpy(),
                                   np.asarray(jtask.state[key]), **TOL)


@pytest.mark.parametrize("cf", [None, 1.0], ids=["drop_free", "drops"])
def test_chunked_matches_jax_chunked(moe, cf):
    """Each chunk's B * 16 tokens are its MoE groups, as in the reference:
    at a dropping capacity the chunked logits follow JAX's chunked ones."""
    jcfg, jparams, cfg, tparams = moe
    jcfg, cfg = _with_cf(jcfg, cfg, cf)
    tokens = _tokens(cfg, (B, S), seed=2)
    jex = JaxSegmentedPrefill(jparams, jcfg, max_seq=S, chunk_tokens=16)
    jtask = jex.start(jnp.asarray(tokens))
    want = jex.run_all(jtask)
    ex = SegmentedPrefill(tparams, cfg, max_seq=S, chunk_tokens=16)
    task = ex.start(tokens)
    got = ex.run_all(task)
    assert task.total_segments == jtask.total_segments
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("k_cache", "v_cache"):
        np.testing.assert_allclose(task.state[key].numpy(),
                                   np.asarray(jtask.state[key]), **TOL)


def _op_before(ex, cursor):
    """The operator whose segment ends at boundary `cursor` (op granularity,
    the head excluded)."""
    within = (cursor - 1) % ex._segments_per_chunk
    return ex.ops[within % len(ex._segments)]


def _suspend_resume(ex, tokens, stop_at):
    want = ex.run_all(ex.start(tokens))
    t = ex.start(tokens)
    while t.cursor < stop_at:
        ex.step(t)
    ex.run_all(ex.start(tokens[:1, :20]))      # another task runs meanwhile
    return ex.run_all(t), want


@pytest.mark.parametrize("stop", [0.2, 0.5, 0.8, "gate", "experts"])
def test_suspend_resume_bit_exact(moe, stop):
    """Suspending at an operator boundary (a fraction of the segments, or
    right after the second chunk's first `gate` or `experts`) and resuming
    after another prefill is bit-identical to an uninterrupted run."""
    _, _, cfg, tparams = moe
    ex = SegmentedPrefill(tparams, cfg, max_seq=S, chunk_tokens=16)
    tokens = _tokens(cfg, (B, S))
    total = ex.segments_for(S)
    if isinstance(stop, float):
        stop_at = int(total * stop)
    else:
        stop_at = next(c for c in range(ex._segments_per_chunk + 1, total)
                       if _op_before(ex, c) == stop)
        assert _op_before(ex, stop_at) == stop
    got, want = _suspend_resume(ex, tokens, stop_at)
    assert torch.equal(got, want)


# --- (c) decode and verify ----------------------------------------------------


def test_decode_step_ragged_matches_jax(moe):
    jcfg, jparams, cfg, tparams = moe
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(2)
    Bd, T = 3, 64
    kg = rng.standard_normal((L, Bd, T, K, hd)).astype(np.float32)
    vg = rng.standard_normal((L, Bd, T, K, hd)).astype(np.float32)
    lens = np.asarray([1, 17, 40], np.int32)
    tok = np.asarray([5, 9, 11])
    want = JM.decode_step_ragged(jparams, jcfg, jnp.asarray(tok),
                                 jnp.asarray(kg), jnp.asarray(vg),
                                 jnp.asarray(lens))
    got = TM.decode_step_ragged(tparams, cfg, torch.from_numpy(tok),
                                torch.from_numpy(kg.copy()),
                                torch.from_numpy(vg.copy()),
                                torch.from_numpy(lens))
    assert TM.supports_ragged_decode(cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("cf", [None, 1.25], ids=["drop_free", "drops"])
def test_decode_verify_ragged_matches_jax(moe, cf, monkeypatch):
    """One verify pass of S = 5 positions over 3 ragged rows (one at
    position 0) against the JAX function with the Pallas verify kernel in
    interpret mode. At capacity factor 1.25 the 15 tokens form one group
    whose capacity (4 for top-2, 9 for top-4 of 8) is below 15, and pairs
    drop."""
    jcfg, jparams, cfg, tparams = moe
    jcfg, cfg = _with_cf(jcfg, cfg, cf)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(0)
    Bv, Sv, T = 3, 5, 64
    tokens = rng.integers(0, cfg.vocab_size, (Bv, Sv))
    kv_lens = np.asarray([0, 17, 40])
    kg = rng.standard_normal((L, Bv, T, K, hd)).astype(np.float32)
    vg = rng.standard_normal((L, Bv, T, K, hd)).astype(np.float32)
    if cf is not None:
        assert TL.moe_groups(Bv * Sv, cfg.experts_per_token, cfg.num_experts,
                             cfg.d_ff, capacity_factor=cf,
                             min_capacity=cfg.moe_min_capacity)[2] < Bv * Sv
    want = JM.decode_verify_ragged(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                                   jnp.asarray(kg), jnp.asarray(vg),
                                   jnp.asarray(kv_lens, jnp.int32),
                                   attn_impl="pallas_interpret")
    dropped, queue = [], TL.moe_queue

    def counting_queue(*args):
        pos, keep = queue(*args)
        dropped.append(int((~keep).sum()))
        return pos, keep
    monkeypatch.setattr(TL, "moe_queue", counting_queue)
    got = TM.decode_verify_ragged(tparams, cfg, torch.from_numpy(tokens),
                                  torch.from_numpy(kg.copy()),
                                  torch.from_numpy(vg.copy()),
                                  torch.from_numpy(kv_lens))
    assert len(dropped) == cfg.num_layers
    assert (sum(dropped) > 0) == (cf is not None)
    assert tuple(got[0].shape) == (Bv, Sv, cfg.vocab_size)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# --- (d) parameters and the families still refused --------------------------


def test_params_shapes_and_fan_in(moe):
    jcfg, jparams, cfg, tparams = moe
    shapes = TM.model_shapes(cfg)
    assert shapes == JM.model_shapes(jcfg)
    assert shapes["layers"]["wi"] == (cfg.num_layers, cfg.num_experts,
                                      cfg.d_model, 2 * cfg.d_ff)
    assert set(tparams["layers"].keys()) == set(jparams["layers"])
    assert ("unembed" in shapes) == (not cfg.tie_embeddings)
    gen = torch.Generator(device="cpu").manual_seed(0)
    tp = init_params(cfg, gen, device="cpu")
    for key, shape in shapes["layers"].items():
        assert tuple(tp["layers"][key].shape) == shape, key
    # N(0, 1/fan_in): D for the router and an expert's gate|up, F for its
    # down projection (the reference's second-to-last axis)
    for key, fan_in in (("router", cfg.d_model), ("wi", cfg.d_model),
                        ("wd", cfg.d_ff), ("wq", cfg.d_model)):
        leaf = tp["layers"][key]
        tol = 5 / (2 * leaf.numel()) ** 0.5          # five standard errors
        assert abs(leaf.std().item() * fan_in ** 0.5 - 1.0) < tol, key


@pytest.mark.parametrize("arch", ["llama4_maverick_400b", "mamba2_370m",
                                  "recurrentgemma_9b", "whisper_large_v3",
                                  "internvl2_76b"])
def test_other_families_are_refused(arch):
    """Every family is ported as model functions, with the reference's
    shapes; like the reference's segmented executor
    (src/repro/models/segments.py `op_names`), the port refuses an operator
    set to interleaved MoE pairs, ssm, the recurrent hybrid and audio, and
    gives vlm the dense set."""
    jcfg = jax_tiny_config(arch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert TM.model_shapes(cfg) == JM.model_shapes(jcfg)
    if cfg.family == "vlm":
        assert op_names(cfg) == DENSE_OPS
        return
    with pytest.raises(NotImplementedError):
        op_names(cfg)


# --- (e) the deployment on the tiny config ------------------------------------

MAX_SEQ, CHUNK, N_DEC = 512, 64, 4


@pytest.fixture(scope="module")
def qwen_bridged():
    jcfg = jax_tiny_config("qwen3_30b_a3b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _bridged_build(monkeypatch, tree, **kw):
    """`build` on the CPU with the JAX weights in place of its random draw."""
    monkeypatch.setattr(serve_mod, "init_params",
                        lambda cfg, gen, device, dtype: from_jax_params(
                            tree, device=device, dtype=dtype))
    return serve_mod.build(arch="qwen3_30b_a3b", device="cpu",
                           max_seq=MAX_SEQ, chunk=CHUNK,
                           decode_tokens=N_DEC, decode_max_batch=4, **kw)


def _recording(proxy):
    """Record every (request, prompt) the proxy is given."""
    seen = []
    submit = proxy.submit

    def rec(req, tokens):
        seen.append((req, np.asarray(tokens)))
        return submit(req, tokens)
    proxy.submit = rec
    return seen


def _jax_greedy(jcfg, jparams, prompt):
    """The JAX reference: chunked segmented prefill, then N_DEC greedy
    `decode_step_ragged` steps over the prefill's cache (wide enough for
    the decoded tokens of a MAX_SEQ-token prompt)."""
    jex = JaxSegmentedPrefill(jparams, jcfg, max_seq=MAX_SEQ + N_DEC,
                              chunk_tokens=CHUNK)
    task = jex.start(jnp.asarray(prompt[None]))
    tok = jnp.argmax(jex.run_all(task), -1)
    kc, vc = task.state["k_cache"], task.state["v_cache"]
    out, pos = [int(tok[0])], len(prompt)
    for _ in range(N_DEC):
        logits, k_new, v_new = JM.decode_step_ragged(
            jparams, jcfg, tok, kc, vc, jnp.asarray([pos], jnp.int32))
        kc = kc.at[:, 0, pos].set(k_new[:, 0])
        vc = vc.at[:, 0, pos].set(v_new[:, 0])
        tok = jnp.argmax(logits, -1)
        out.append(int(tok[0]))
        pos += 1
    return out


def _wait_decoded(dep, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while len(dep.decode.finished) < n and time.monotonic() < deadline:
        time.sleep(0.01)


def test_tiny_moe_serve_matches_jax_greedy(monkeypatch, qwen_bridged):
    """`build` + `serve_trace` on the tiny Qwen3-MoE: every request
    decodes, through MoE operators, and each one's tokens equal a greedy
    run of the JAX reference functions on its prompt. The port batches
    prefills and decode rows where the reference runs one row, so f32
    sums round differently; trace seed 7 keeps every step's top-2 logit
    gap above 0.045 (seed 0 meets a gap of 3e-5, where either token is
    right), and draws a prompt of each length of the mix."""
    jcfg, jparams, tree = qwen_bridged
    dep = _bridged_build(monkeypatch, tree)
    seen = _recording(dep.proxy)
    try:
        assert dep.executor.ops == MOE_OPS
        rep = serve_mod.serve_trace(dep, requests=5, seed=7,
                                    arrival_mean_s=0.01)
        _wait_decoded(dep, len(seen))
        got = [dep.decode.outputs[r.rid] for r, _ in seen]
    finally:
        dep.shutdown()
    assert rep["decoded"] == rep["n_requests"] == len(seen) == 5
    assert got == [_jax_greedy(jcfg, jparams, p) for _, p in seen]


def test_forced_preemptions_land_at_gate_and_experts(monkeypatch,
                                                     qwen_bridged):
    """S-EDF preemption through the threaded runtime with a stubbed operator
    schedule: a long request's prefill holds at its first `gate` boundary
    until a short, more urgent request has signalled preemption, and after
    it resumes, likewise at its next `experts` boundary. Both suspensions
    land there, and every request's tokens equal the JAX greedy run."""
    jcfg, jparams, tree = qwen_bridged
    dep = _bridged_build(monkeypatch, tree)
    seen = _recording(dep.proxy)
    ex, pool = dep.executor, dep.prefill.pool
    rng = np.random.default_rng(21)
    long_prompt = rng.integers(0, jcfg.vocab_size, MAX_SEQ)
    shorts = [rng.integers(0, jcfg.vocab_size, 64) for _ in range(2)]
    plan = ["gate", "experts"]          # where the long task holds next
    suspended, errors = [], []
    step = ex.step
    preempt_current = pool.preempt_current

    def stub_step(task):
        done = step(task)
        if plan and task.prompt_len == MAX_SEQ and not done \
                and task.cursor < task.total_segments - 1 \
                and _op_before(ex, task.cursor) == plan[0]:
            short = Request(num_tokens=64, slo=30.0, arrival=time.monotonic())
            prompt = shorts[2 - len(plan)]
            plan.pop(0)
            threading.Thread(target=dep.proxy.submit,
                             args=(short, prompt)).start()
            deadline = time.monotonic() + 30.0
            while not pool.signal.check() and time.monotonic() < deadline:
                time.sleep(0.001)
            if not pool.signal.check():
                errors.append(f"no preemption signal at {task.cursor}")
        return done

    def recording_preempt(timeout=10.0):
        out = preempt_current(timeout)
        if out is not None:
            suspended.append(out.prefill_task.cursor)
        return out

    ex.step = stub_step
    pool.preempt_current = recording_preempt
    try:
        A = Request(num_tokens=MAX_SEQ, slo=60.0, arrival=time.monotonic(),
                    task_type="file")
        dep.proxy.submit(A, long_prompt)
        assert dep.proxy.drain(120.0)
        _wait_decoded(dep, 3)
        got = {r.rid: dep.decode.outputs.get(r.rid) for r, _ in seen}
    finally:
        dep.shutdown()
    assert errors == [] and plan == []
    assert [_op_before(ex, c) for c in suspended] == ["gate", "experts"]
    assert len(seen) == 3
    for r, prompt in seen:
        assert got[r.rid] == _jax_greedy(jcfg, jparams, prompt), r.rid


# --- the plain twin of the card's routing (`moe_route_ref`) -------------------

# (id, tokens, k, experts, capacity factor, group_size, (e0, n_local), skew)
ROUTE_CASES = [
    ("one_token", 1, 8, 128, 16.0, 0, None, None),
    ("n37_drop_free", 37, 8, 128, 16.0, 0, None, None),
    ("n330_drops", 330, 8, 128, 1.25, 0, None, None),
    ("n512_k6_drop_free", 512, 6, 128, 128 / 6, 0, None, None),
    ("n512_k6_drops", 512, 6, 128, 1.25, 0, None, None),
    ("groups_8x64_drops", 512, 8, 128, 1.25, 64, None, None),
    ("groups_4x32_drop_free", 128, 4, 16, 4.0, 32, None, None),
    ("one_expert_takes_all", 200, 8, 128, 16.0, 0, None, "one"),
    ("one_expert_takes_all_drops", 200, 8, 128, 1.25, 0, None, "one"),
    ("idle_experts", 300, 8, 128, 1.25, 0, None, "few"),
    ("expert_range", 256, 8, 128, 16.0, 64, (32, 48), None),
    ("expert_range_drops", 256, 8, 128, 1.0, 0, (100, 28), "few"),
]


def _route_idx(n, k, E, skew, seed):
    """(n, k) distinct experts per token: uniform, or every token's slot 0
    on expert 5 ("one"), or all drawn from 12 experts ("few")."""
    rng = np.random.default_rng(seed)
    pool = np.arange(E) if skew != "few" else rng.choice(E, 12, replace=False)
    idx = np.stack([rng.choice(pool, k, replace=False) for _ in range(n)])
    if skew == "one":
        idx[idx == 5] = idx[:, :1][(idx == 5).any(1)].ravel()
        idx[:, 0] = 5
    return torch.as_tensor(idx, dtype=torch.int64)


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_twin_rows_follow_the_slot_table(case):
    """`moe_route_ref`, the routing the card's grouped kernel computes:
    the kept pairs are `moe_queue`'s (pos < cap) within the expert range;
    local expert el owns rows [row_off, row_off + counts) in the slot
    table's column order (group, then queue position), every row taken
    once; its M tiles of 128 rows start at the exclusive scan of ceil(counts
    / 128) and cover those rows exactly."""
    _, n, k, E, cf, gs, rng_, skew = case
    idx = _route_idx(n, k, E, skew, seed=n + k)
    e0, El = rng_ or (0, E)
    G, g, cap = TL.moe_groups(n, k, E, 768, capacity_factor=cf,
                              min_capacity=4, group_size=gs)
    r = TL.moe_route_ref(idx, G, E, cap, e0=e0, n_local=El if rng_ else 0)
    pos, keep = TL.moe_queue(idx.reshape(G, -1), G, E, cap)
    ig = idx.reshape(G, -1)
    in_range = (ig >= e0) & (ig < e0 + El)
    assert torch.equal(r["pos"], pos)
    assert torch.equal(r["keep"], keep & in_range)
    if cf < E / k and skew == "one":
        assert not keep.all()                      # the case drops pairs
    rows = r["rows"].reshape(G, -1)
    assert torch.equal(rows >= 0, r["keep"])
    kept = rows[r["keep"]]
    assert torch.equal(kept.sort().values, torch.arange(len(kept)))
    # walking the rows in order visits (expert, group, position) in order
    grp = torch.arange(G)[:, None].expand_as(ig)
    key = ((ig - e0) * G + grp) * (g * k) + pos
    order = kept.argsort()
    assert bool((key[r["keep"]][order].diff() > 0).all())
    counts = torch.bincount((ig - e0)[r["keep"]], minlength=El)
    assert torch.equal(r["counts"], counts)
    assert torch.equal(r["row_off"], counts.cumsum(0) - counts)
    n_tiles = (counts + 127) // 128
    assert torch.equal(r["tile_off"], n_tiles.cumsum(0) - n_tiles)
    tiles = r["tiles"]
    assert len(tiles) == int(n_tiles.sum()) <= (n * k + 127) // 128 + El
    assert bool((tiles[:, 2] > tiles[:, 1]).all())
    covered = torch.zeros(len(kept), dtype=torch.int64)
    for e, lo, hi in tiles.tolist():
        hi = min(hi, lo + 128)
        assert r["row_off"][e] <= lo < hi <= r["row_off"][e] + counts[e]
        covered[lo:hi] += 1
    assert bool((covered == 1).all())


@pytest.mark.parametrize("case", ROUTE_CASES[1:6] + ROUTE_CASES[9:],
                         ids=[c[0] for c in ROUTE_CASES[1:6]
                              + ROUTE_CASES[9:]])
def test_experts_over_the_twin_rows_equal_the_plain_version(case):
    """The experts computed the kernel's way over the twin's rows (each
    kept pair's token row gathered to its row, one product per expert over
    its own rows, each token's k rows times their weights summed in f32)
    equal `moe_apply_ref`'s slot table and all-expert `bmm` in f32, at
    small widths (D 32, F 16)."""
    _, n, k, E, cf, gs, rng_, skew = case
    D, Fd = 32, 16
    gen = torch.Generator().manual_seed(n)
    idx = _route_idx(n, k, E, skew, seed=n + 1)
    e0, El = rng_ or (0, E)
    x = torch.randn(1, n, D, generator=gen)
    w = torch.softmax(torch.randn(1, n, k, generator=gen), -1)
    wi = torch.randn(El, D, 2 * Fd, generator=gen) / D ** 0.5
    wd = torch.randn(El, Fd, D, generator=gen) / Fd ** 0.5
    kw = dict(k=k, capacity_factor=cf, min_capacity=4, group_size=gs,
              e0=e0, n_experts=E if rng_ else 0)
    want = TL.moe_apply_ref(x, w, idx[None], wi, wd, **kw)
    G, _, cap = TL.moe_groups(n, k, E, Fd, capacity_factor=cf,
                              min_capacity=4, group_size=gs)
    r = TL.moe_route_ref(idx, G, E, cap, e0=e0, n_local=El if rng_ else 0)
    rows = r["rows"]
    kept = rows >= 0
    xg = torch.zeros(int(kept.sum()), D)
    xg[rows[kept]] = x[0].repeat_interleave(k, 0)[kept]
    ye = torch.zeros_like(xg)
    for e in range(El):
        lo, hi = int(r["row_off"][e]), int(r["row_off"][e] + r["counts"][e])
        gate, up = (xg[lo:hi] @ wi[e]).chunk(2, -1)
        ye[lo:hi] = (torch.nn.functional.silu(gate) * up) @ wd[e]
    yk = torch.where(kept[:, None], ye[rows.clamp(min=0)], 0.0)
    got = (yk * w.reshape(-1, 1)).reshape(n, k, D).sum(1)
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-6)
