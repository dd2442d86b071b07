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
