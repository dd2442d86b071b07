"""`SegmentedPrefill`'s buffers, over which every task runs, on the CPU.
The CPU captures no graph; where a test needs replays (padded buckets and
their counts), the module's `_graphable` is made to answer True and its
`_capture` to hand back the operator itself, so each "replay" is a direct
call over the executor's buffers at its bucket's padded row count, as on
the card.

- the logits and KV replayed against uncaptured at 1e-5, and against the
  JAX `SegmentedPrefill` at 2e-4 (the bound of tests/test_torch_segments.py
  and tests/test_torch_moe.py), dense and MoE, at token counts on and
  between bucket edges (the graphs captured and replayed counted), over a
  cached prefix and with a vlm's patch embeddings;
- tasks interleaved at every operator boundary (the buffers spilled and
  loaded at each), and tasks stepped from several threads on one
  executor, each `torch.equal` to its uninterrupted run;
- a chunk above the largest bucket runs over buffers of its own: no
  replay, the executor's buffers never claimed;
- the per-chunk RoPE tables rotate as `layers.apply_rope` does;
- the `segment` spans' `graphed` attribute and the three counters.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.models.segments import SegmentedPrefill as JaxSegmentedPrefill
from repro_torch import tracing
from repro_torch.configs.base import get_tiny_config
from repro_torch.kernels import counts
from repro_torch.models import layers as L
from repro_torch.models import segments
from repro_torch.models.segments import (GRAPH_COUNTS, GRAPHED_OPS,
                                         SegmentedPrefill, token_buckets)
from repro_torch.params import from_jax_params, init_params

TOL = dict(rtol=2e-4, atol=2e-4)
# replayed at a padded bucket against the same bodies at the chunk's rows
NEAR = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["llama3_8b", "qwen3_30b_a3b"]
CHUNK = 16


@pytest.fixture
def graphed(monkeypatch):
    """Builds executors whose per-token operators "replay" (the plain
    `SegmentedPrefill` captures nothing on the CPU)."""
    monkeypatch.setattr(segments, "_capture", lambda fn, stream, pool: fn)

    def build(*args, **kw):
        with monkeypatch.context() as m:
            m.setattr(segments, "_graphable", lambda device: True)
            return SegmentedPrefill(*args, **kw)
    return build


def _bridged(arch, max_seq):
    """(port config, port params, JAX `SegmentedPrefill` at `max_seq` in
    chunks of CHUNK) of one tiny arch, the port's weights bridged from the
    JAX `init_params`. One JAX executor serves a module's tests, so each
    shape compiles once."""
    jcfg = jax_tiny_config(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return get_tiny_config(arch), params, JaxSegmentedPrefill(
        jparams, jcfg, max_seq=max_seq, chunk_tokens=CHUNK)


def _jax(model, toks, **kw):
    """The JAX executor's logits and task for `toks`; `kw` goes to its
    `start`."""
    jtask = model[2].start(jnp.asarray(toks), **kw)
    return np.asarray(model[2].run_all(jtask)), jtask


def _close_to_jax(task, logits, want, jtask):
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    for key in ("k_cache", "v_cache"):
        np.testing.assert_allclose(task.state[key].numpy(),
                                   np.asarray(jtask.state[key]), **TOL)


def _near(task, logits, want_task, keys=("k_cache", "v_cache", "h_full")):
    """`task` (replayed) against `want_task` (uncaptured) at NEAR."""
    np.testing.assert_allclose(logits.numpy(), want_task.logits.numpy(),
                               **NEAR)
    for key in keys:
        np.testing.assert_allclose(task.state[key].numpy(),
                                   want_task.state[key].numpy(), **NEAR)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _bridged(request.param, 48)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _count():
    return counts.read(GRAPH_COUNTS)


def test_token_buckets_pad_at_most_2x_below_1024_and_1_5x_above():
    got = token_buckets(4096)
    assert got == [16, 32, 64, 128, 256, 512, 1024, 1536, 2048, 3072, 4096]
    assert token_buckets(16) == [16] and token_buckets(100)[-1] == 128
    for n in range(16, 4097):
        b = next(b for b in got if b >= n)
        assert b <= 2 * n if n < 1024 else b <= 1.5 * n, n


# (B, S): per chunk of 16, N = 16 (on an edge), 16 then 8, 32 then 16 then
# 16 (edges), 48 (between 32 and 64) then 24 (between 16 and 32)
@pytest.mark.parametrize("B,S", [(1, 16), (1, 24), (2, 40), (3, 24)])
def test_graphed_path_matches_the_eager_path(graphed, model, B, S):
    """Replayed at each chunk's bucket (its rows padded), the logits, KV and
    final hidden state against the same bodies called uncaptured at the
    chunk's rows (the CPU's path) at 1e-5, and against the JAX
    `SegmentedPrefill` at 2e-4."""
    cfg, params, _ = model
    toks = _tokens(cfg, B, S)
    want, jtask = _jax(model, toks)
    plain = SegmentedPrefill(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    want_task = plain.start(toks)
    plain.run_all(want_task)
    counts.reset()
    ex = graphed(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    per_layer = sum(op in GRAPHED_OPS for op in ex.ops)
    # every bucket (16 to 8 chunks, 128), every layer, at build
    assert ex._buckets == [16, 32, 64, 128]
    assert _count()["segment_graph_capture"] == 4 * cfg.num_layers * per_layer
    task = ex.start(toks)
    assert "buf" not in task.state
    got = ex.run_all(task)
    _near(task, got, want_task)
    _close_to_jax(task, got, want, jtask)
    np.testing.assert_allclose(task.state["h_full"].numpy(),
                               np.asarray(jtask.state["h_full"]), **TOL)
    c = _count()
    n_chunks = (S + CHUNK - 1) // CHUNK
    assert c["segment_graph_replay"] == n_chunks * cfg.num_layers * per_layer
    assert c["segment_eager"] == task.total_segments - c[
        "segment_graph_replay"]


def test_graphed_path_over_a_cached_prefix(graphed, model):
    """Resumed at operator offset P over a seeded prefix: replayed against
    uncaptured at 1e-5, and uncaptured against the JAX executor over the
    same prefix (logits and the whole KV cache) at 2e-4."""
    cfg, params, _ = model
    toks = _tokens(cfg, 2, 40, seed=3)
    plain = SegmentedPrefill(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    ex = graphed(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    full = plain.start(toks)
    plain.run_all(full)
    P = 21
    pk = full.state["k_cache"][:, :, :P].numpy()
    pv = full.state["v_cache"][:, :, :P].numpy()
    want, jtask = _jax(model, toks, prefix_len=P,
                       prefix_k=jnp.asarray(pk), prefix_v=jnp.asarray(pv))
    kw = dict(prefix_len=P, prefix_k=torch.from_numpy(pk),
              prefix_v=torch.from_numpy(pv))
    want_task, task = plain.start(toks, **kw), ex.start(toks, **kw)
    _close_to_jax(want_task, plain.run_all(want_task), want, jtask)
    _near(task, ex.run_all(task), want_task, keys=("k_cache",))


def test_graphed_path_with_patch_embeddings(graphed):
    vlm = _bridged("internvl2_76b", 40)
    cfg, params = vlm[:2]
    toks = _tokens(cfg, 2, 40, seed=4)
    ve = torch.randn((2, 6, cfg.d_model),
                     generator=torch.Generator().manual_seed(5))
    want, jtask = _jax(vlm, toks, vision_embeds=jnp.asarray(ve.numpy()))
    plain = SegmentedPrefill(params, cfg, max_seq=40, chunk_tokens=CHUNK)
    ex = graphed(params, cfg, max_seq=40, chunk_tokens=CHUNK)
    want_task = plain.start(toks, vision_embeds=ve)
    _close_to_jax(want_task, plain.run_all(want_task), want, jtask)
    task = ex.start(toks, vision_embeds=ve)
    _near(task, ex.run_all(task), want_task, keys=())


@pytest.mark.parametrize("granularity", ["op", "layer"])
def test_interleaved_at_every_boundary_is_bit_exact(model, granularity):
    """Two tasks stepped in turn, one segment each, so the buffers change
    hands at every operator boundary: each task's logits and KV are
    `torch.equal` to its own uninterrupted run."""
    cfg, params, _ = model
    ex = SegmentedPrefill(params, cfg, max_seq=48, chunk_tokens=CHUNK,
                          granularity=granularity)
    a_toks, b_toks = _tokens(cfg, 2, 40, seed=6), _tokens(cfg, 1, 30, seed=7)
    want = []
    for toks in (a_toks, b_toks):
        t = ex.start(toks)
        ex.run_all(t)
        want.append(t)
    a, b = ex.start(a_toks), ex.start(b_toks)
    spilled = 0
    while not (a.done and b.done):
        for t in (a, b):
            if not t.done:
                ex.step(t)
                spilled += "spill" in a.state or "spill" in b.state
    assert spilled > 0
    for got, ref in zip((a, b), want):
        assert torch.equal(got.logits, ref.logits)
        assert torch.equal(got.state["k_cache"], ref.state["k_cache"])
        assert torch.equal(got.state["v_cache"], ref.state["v_cache"])


def test_threads_sharing_one_executor_are_bit_exact(model):
    """Four threads each run their own task on one executor, as prefill
    instances sharing it do, with a short switch interval: each logits
    `torch.equal` to the task run alone."""
    cfg, params, _ = model
    ex = SegmentedPrefill(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    prompts = [_tokens(cfg, 1 + i % 2, 20 + 7 * i, seed=10 + i)
               for i in range(4)]
    want = [ex.run_all(ex.start(p)) for p in prompts]
    got = [None] * 4

    def run(i):
        got[i] = ex.run_all(ex.start(prompts[i]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_chunk_above_the_largest_bucket_runs_eagerly(graphed, model):
    """9 x 16 = 144 tokens a chunk, above the largest bucket (128): the
    task runs over buffers of its own at 144 rows, replays no graph and
    never claims the executor's buffers; its logits are `torch.equal` to
    an executor that captured nothing, and its logits and KV the JAX
    executor's within 2e-4."""
    cfg, params, _ = model
    ex = graphed(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    assert ex._buckets[-1] == 8 * CHUNK
    toks = _tokens(cfg, 9, 20)
    task = ex.start(toks)
    assert task.state["buf"]["h"].shape[0] == 9 * CHUNK
    counts.reset()
    got = ex.run_all(task)
    assert _count() == {"segment_graph_replay": 0,
                        "segment_eager": task.total_segments,
                        "segment_graph_capture": 0}
    assert ex._resident is None and ex._last is None
    plain = SegmentedPrefill(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    assert torch.equal(got, plain.run_all(plain.start(toks)))
    _close_to_jax(task, got, *_jax(model, toks))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [0, 16, 1000])
def test_per_chunk_rope_tables_rotate_as_apply_rope(dtype, off):
    """The tables built once at a chunk's start, one row per flattened
    token, rotate q as `apply_rope` over the chunk's positions does."""
    B, Sc, H, hd, theta = 3, 16, 4, 32, 1e6
    x = torch.randn((B, Sc, H, hd),
                    generator=torch.Generator().manual_seed(off)).to(dtype)
    positions = off + torch.arange(Sc)
    want = L.apply_rope(x, positions[None, :], theta)
    cos, sin = L.rope_tables(positions, hd, theta)
    rows = torch.empty((B * Sc, hd // 2))
    rows.view(B, Sc, -1).copy_(cos)
    cos_rows = rows.clone()
    rows.view(B, Sc, -1).copy_(sin)
    out = torch.empty((B * Sc, H * hd), dtype=dtype)
    L.rope_rotate(x.reshape(B * Sc, H, hd), cos_rows[:, None], rows[:, None],
                  out=out.view(B * Sc, H, hd))
    assert torch.equal(out.view(B, Sc, H, hd), want)


def test_the_executor_keeps_the_chunk_tables():
    cfg = get_tiny_config("llama3_8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ex = SegmentedPrefill(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    task = ex.start(_tokens(cfg, 2, 40))
    for _ in range(ex._segments_per_chunk + 1):      # into chunk 1
        ex.step(task)
    cos, sin = L.rope_tables(16 + torch.arange(16), cfg.resolved_head_dim,
                             cfg.rope_theta)
    assert torch.equal(ex._buf["cos"][:32], cos.repeat(2, 1))
    assert torch.equal(ex._buf["sin"][:32], sin.repeat(2, 1))


def test_segment_spans_carry_graphed_and_the_counters_agree(graphed, model):
    """Uncaptured (the CPU's own executor) no span is `graphed`; replayed,
    exactly the per-token operators' spans are."""
    cfg, params, _ = model
    toks = _tokens(cfg, 2, 40)
    plain = SegmentedPrefill(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    assert plain._graphs == {}
    ex = graphed(params, cfg, max_seq=48, chunk_tokens=CHUNK)
    for executor, want_graphed in ((plain, False), (ex, True)):
        counts.reset()
        tracing.enable()
        try:
            task = executor.start(toks)
            executor.run_all(task)
        finally:
            got = [s for s in tracing.take() if s.name == "segment"]
        assert len(got) == task.total_segments
        for s in got:
            assert s.attrs["graphed"] == (want_graphed
                                          and s.attrs["op"] in GRAPHED_OPS)
        n_graphed = sum(s.attrs["graphed"] for s in got)
        assert _count() == {"segment_graph_replay": n_graphed,
                            "segment_eager": len(got) - n_graphed,
                            "segment_graph_capture": 0}
