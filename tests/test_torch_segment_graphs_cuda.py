"""`SegmentedPrefill`'s per-token operators replayed from CUDA graphs on the
card, against the same operators called uncaptured over the same buffers
(the module's `_graphable` made to answer False while the executor is
built). This file imports no JAX; each test skips without a card inside
its fixture:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_segment_graphs_cuda.py -q

Tolerances: in f32 the port's model tolerance on the card, 2e-4
(tests/test_torch_cuda.py); in bf16 the repository's bound on the card's
bf16 logits, 4 * 2**-7 * max|logit| (chip_smoke.py), since a bucket pads
the chunk's rows and cuBLAS may then sum a product in another order.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_tiny_config
from repro_torch.kernels import counts, ops
from repro_torch.models import segments
from repro_torch.models.segments import (GRAPH_COUNTS, GRAPHED_OPS,
                                         SegmentedPrefill)
from repro_torch.params import init_params

pytestmark = pytest.mark.cuda

ARCHS = ["llama3_8b", "qwen3_30b_a3b"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(arch, card, dtype):
    cfg = get_tiny_config(arch)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, p.to(card).to(dtype)


def _uncaptured(monkeypatch, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(segments, "_graphable", lambda device: False)
        return SegmentedPrefill(*args, **kw)


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        bound = 4 * 2 ** -7 * want.abs().max().item()
        assert (got - want).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
# 32 tokens a chunk of 32 (a bucket's edge); 3 x 32 = 96 then 3 x 8 = 24
# (between edges, the first captured on first use)
@pytest.mark.parametrize("B,S", [(1, 64), (3, 40)])
def test_graphed_matches_eager_on_the_card(card, monkeypatch, arch, dtype,
                                           B, S):
    cfg, params = _params(arch, card, dtype)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    plain = _uncaptured(monkeypatch, params, cfg, max_seq=64,
                        chunk_tokens=32, cache_dtype=dtype)
    want_task = plain.start(toks)
    want = plain.run_all(want_task)
    counts.reset()
    ex = SegmentedPrefill(params, cfg, max_seq=64, chunk_tokens=32,
                          cache_dtype=dtype)
    task = ex.start(toks)
    assert ex._graphs and not plain._graphs
    got = ex.run_all(task)
    torch.cuda.synchronize()
    _close(got, want, dtype)
    for key in ("k_cache", "v_cache"):
        _close(task.state[key], want_task.state[key], dtype)
    c = counts.read(GRAPH_COUNTS)
    per_layer = sum(op in GRAPHED_OPS for op in ex.ops)
    n_chunks = (S + 31) // 32
    assert c["segment_graph_replay"] == n_chunks * cfg.num_layers * per_layer
    assert c["segment_eager"] == task.total_segments - c[
        "segment_graph_replay"]
    assert ops.counts()["chunked_prefill_attention_ref"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_interleaved_suspend_resume_on_the_card_is_bit_exact(card, arch,
                                                             dtype):
    """Two tasks on two streams of one executor (as two instances sharing
    it), stepped in turn so the static buffers change hands, with a spill
    and a load, at every operator boundary: each task's logits and KV
    `torch.equal` to its uninterrupted run."""
    cfg, params = _params(arch, card, dtype)
    ex = SegmentedPrefill(params, cfg, max_seq=64, chunk_tokens=32,
                          cache_dtype=dtype)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (2, 56)),
               rng.integers(0, cfg.vocab_size, (1, 40))]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    want = []
    for toks in prompts:
        t = ex.start(toks)
        ex.run_all(t)
        want.append(t)
    with torch.cuda.stream(streams[0]):
        a = ex.start(prompts[0])
    with torch.cuda.stream(streams[1]):
        b = ex.start(prompts[1])
    while not (a.done and b.done):
        for t, s in ((a, streams[0]), (b, streams[1])):
            if not t.done:
                with torch.cuda.stream(s):
                    ex.step(t)
    torch.cuda.synchronize()
    for got, ref in zip((a, b), want):
        assert torch.equal(got.logits, ref.logits)
        assert torch.equal(got.state["k_cache"], ref.state["k_cache"])
        assert torch.equal(got.state["v_cache"], ref.state["v_cache"])


def test_graphs_captured_by_a_second_thread_while_another_stream_launches(
        card):
    """An executor built (its graphs captured, in the thread-local mode) on
    a worker thread while the main thread keeps launching products on
    another stream, as a prefill instance is built beside a serving decode
    instance: neither thread fails, and its logits over a batched chunk
    are `torch.equal` to those of an executor built alone."""
    cfg, params = _params("llama3_8b", card, torch.bfloat16)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 128))
    built, errors = {}, []
    done = threading.Event()

    def worker():
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                built["ex"] = SegmentedPrefill(
                    params, cfg, max_seq=128, chunk_tokens=64,
                    cache_dtype=torch.bfloat16)
                built["logits"] = built["ex"].run_all(
                    built["ex"].start(toks))
                torch.cuda.current_stream().synchronize()
        except Exception as exc:                 # reported by the main thread
            errors.append(exc)
        finally:
            done.set()

    x0 = torch.randn((256, 256), device=card) / 16
    side = torch.cuda.Stream()
    t = threading.Thread(target=worker)
    with torch.cuda.stream(side):
        x, launched = x0.clone(), 0
        t.start()
        while not done.is_set():
            x = torch.tanh(x @ x0)
            launched += 1
    t.join(120)
    torch.cuda.synchronize()
    assert not t.is_alive() and not errors, errors
    assert launched > 0 and torch.isfinite(x).all()
    per_layer = sum(op in GRAPHED_OPS for op in built["ex"].ops)
    assert len(built["ex"]._graphs) == \
        len(built["ex"]._buckets) * cfg.num_layers * per_layer
    alone = SegmentedPrefill(params, cfg, max_seq=128, chunk_tokens=64,
                             cache_dtype=torch.bfloat16)
    want = alone.run_all(alone.start(toks))
    torch.cuda.synchronize()
    assert torch.equal(built["logits"], want)
