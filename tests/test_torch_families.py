"""The families the port added last, against the JAX package on the CPU, in
f32, with inputs from numpy and weights bridged from the JAX `init_params`
pytree: Whisper (audio: encoder, decoder self- and cross-attention),
InternVL2 (vlm: patch embeddings over the leading positions) and
Llama4-Maverick (interleaved (dense, MoE) pairs), each at its tiny config.

Layers (`layer_norm`, `sinusoidal_positions`, `gelu_mlp`) at 1e-5;
`forward` logits, `prefill` logits and every cache leaf, and 3
`decode_step`s (logits and every cache leaf) at 2e-4 (the tolerances of
tests/test_torch_recurrent.py); `model_shapes` equal to the reference's for
all 12 archs, tiny and full; the vlm's segmented prefill with patch
embeddings against the JAX `SegmentedPrefill` at 2e-4, and its
suspend/resume bit-equal; the launcher serving the tiny vlm.

The reference's `init_params` zeroes every 1-D leaf, and its LayerNorm
scales by w (not 1 + w), so a Whisper drawn by it outputs exactly zero:
every Whisper tree here has its LayerNorm weights redrawn as 1 + 0.1 N(0,1)
and its biases as 0.1 N(0,1) (`repro_torch.params.redraw_norms`, copied
back into the JAX tree), and the tests assert that the logits are not about
zero.

    PYTHONPATH=src python -m pytest tests/test_torch_families.py -q
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jax_config
from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import prefill as jax_prefill
from repro.models.segments import SegmentedPrefill as JaxSegmentedPrefill
from repro_torch.configs.base import get_config, get_tiny_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.segments import DENSE_OPS, SegmentedPrefill
from repro_torch.params import from_jax_params, redraw_norms

LAYER = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ["whisper_large_v3", "internvl2_76b", "llama4_maverick_400b"]
B, S, N_DEC = 2, 20, 3


def _tree_of(params):
    """The port's parameters as the reference's nested dict of numpy
    leaves."""
    tree = {}
    for name, t in params.named_parameters():
        *path, key = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = t.detach().numpy().copy()
    return tree


def make_batch(cfg, seed, S=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _bridge(arch):
    """(port config, JAX config, JAX params, port params) of a tiny arch on
    the same weights."""
    jcfg = jax_tiny_config(arch)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tparams = from_jax_params(tree, device="cpu")
    if jcfg.family == "audio":
        tree = _tree_of(redraw_norms(tparams, 7))
    return (get_tiny_config(arch), jcfg, jax.tree.map(jnp.asarray, tree),
            tparams)


@pytest.fixture(params=FAMILIES)
def bridged(request):
    return _bridge(request.param)


def _not_zero(cfg, logits):
    """Whisper's logits must not be about zero (a zero model would pass)."""
    if cfg.family == "audio":
        assert float(np.std(np.asarray(logits))) > 1e-3


# --- layers -------------------------------------------------------------------


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((2, 7, 24))).astype(np.float32)
    w, b = (rng.standard_normal(24).astype(np.float32) for _ in range(2))
    got = TL.layer_norm(*map(torch.from_numpy, (x, w, b)))
    want = JL.layer_norm(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("seq,dim", [(1, 64), (37, 24), (64, 1280)])
def test_sinusoidal_positions_match_jax(seq, dim):
    got = TL.sinusoidal_positions(seq, dim)
    want = JL.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and got.shape == (seq, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_sinusoidal_positions_at_whisper_width():
    """At Whisper's 1500 encoder positions both packages compute sin and
    cos of an f32 angle pos * div, whose rounding alone moves the result
    by up to pos * 2^-24: the port is held to the f64 values within one
    f32 step of the angle (1e-6 + pos * 2^-23), as JAX's values are."""
    seq, dim = 1500, 1280
    pos = np.arange(seq, dtype=np.float64)[:, None]
    ang = pos * np.exp(np.arange(0, dim, 2) * (-np.log(1e4) / (dim // 2)))
    exact = np.zeros((seq, dim))
    exact[:, 0::2], exact[:, 1::2] = np.sin(ang), np.cos(ang)
    limit = 1e-6 + pos * 2.0 ** -23
    for pe in (TL.sinusoidal_positions(seq, dim).numpy(),
               np.asarray(JL.sinusoidal_positions(seq, dim))):
        assert (np.abs(pe - exact) <= limit).all()


def test_gelu_mlp_matches_jax_tanh_form():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wi, bi = rng.standard_normal((16, 40)), rng.standard_normal(40)
    wd, bd = rng.standard_normal((40, 16)) / 6, rng.standard_normal(16)
    args = [a.astype(np.float32) for a in (x, wi, bi, wd, bd)]
    got = TL.gelu_mlp(*map(torch.from_numpy, args))
    want = JL.gelu_mlp(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    # the erf form differs: the port must use the tanh form, as JAX does
    xt = torch.from_numpy(args[0]) @ torch.from_numpy(args[1]) \
        + torch.from_numpy(args[2])
    erf = torch.nn.functional.gelu(xt) @ torch.from_numpy(args[3]) \
        + torch.from_numpy(args[4])
    assert not np.allclose(erf.numpy(), np.asarray(want), **LAYER)


# --- shapes -------------------------------------------------------------------


def test_redraw_norms_reaches_every_layer_norm_and_bias():
    """`redraw_norms` draws each LayerNorm weight (a leaf with a `_b`
    sibling) about 1 and each bias about 0, leaves every other leaf as it
    was, and makes the tiny Whisper compute something."""
    from repro_torch.params import init_params
    cfg = get_tiny_config("whisper_large_v3")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {n: t.clone() for n, t in params.named_parameters()}
    redraw_norms(params, 3)
    n_norms = n_biases = 0
    for name, t in params.named_parameters():
        key = name.rsplit(".", 1)[-1]
        if name + "_b" in before:
            n_norms += 1
            assert abs(t.mean().item() - 1.0) < 0.1 and t.std() > 0.05, name
        elif key.endswith("_b") or key in ("bi", "bd"):
            n_biases += 1
            assert abs(t.mean().item()) < 0.1 and t.std() > 0.05, name
        else:
            assert torch.equal(t, before[name]), name
    # ln1, ln2, ln_x and final_norm of the decoder; ln1, ln2 and
    # enc_final_norm of the encoder; their biases and the MLP's bi, bd
    assert (n_norms, n_biases) == (7, 11)
    batch = make_batch(cfg, 0)
    _not_zero(cfg, TM.forward(params, cfg, _tb(batch)))


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_shapes_match_reference(arch, size):
    if size == "tiny":
        cfg, jcfg = get_tiny_config(arch), jax_tiny_config(arch)
    else:
        cfg, jcfg = get_config(arch), jax_config(arch)
    assert TM.model_shapes(cfg) == JM.model_shapes(jcfg)
    want = JM.cache_shapes(jcfg, 2, 64)
    got = TM.cache_shapes(cfg, 2, 64)
    assert set(got) == set(want) - {"pos"}
    for key, (shape, _) in got.items():
        assert shape == want[key][0], key


# --- forward, prefill, decode against JAX ---------------------------------------


def test_forward_matches_jax(bridged):
    cfg, jcfg, jparams, tparams = bridged
    batch = make_batch(cfg, 1)
    want = jax_forward(jparams, jcfg, _jb(batch))
    got = TM.forward(tparams, cfg, _tb(batch))
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    _not_zero(cfg, want)


def _assert_cache(got, want):
    assert set(got) == set(want)
    assert int(got["pos"]) == int(want["pos"])
    for key in set(want) - {"pos"}:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **MODEL)


def test_prefill_and_decode_match_jax(bridged):
    """`prefill` (logits and every cache leaf) and 3 greedy `decode_step`s
    (logits and every cache leaf after each), tokens from the JAX run. The
    port's cache is written in place, so it is compared after each step
    before the next one."""
    cfg, jcfg, jparams, tparams = bridged
    batch = make_batch(cfg, 2)
    max_seq = S + N_DEC
    jl, jc = jax_prefill(jparams, jcfg, _jb(batch), max_seq=max_seq,
                         cache_dtype=jnp.float32)
    tl, tc = TM.prefill(tparams, cfg, _tb(batch), max_seq=max_seq,
                        cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    _assert_cache(tc, jc)
    if cfg.family == "audio":
        # the reference's audio prefill returns zero logits: start at BOS
        assert int(tc["pos"]) == 0 and not tl.any()
        tok = np.zeros(B, np.int64)
    else:
        tok = np.asarray(jnp.argmax(jl, -1))
    for i in range(N_DEC):
        jl, jc = jax_decode_step(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                 jc)
        tl, tc = TM.decode_step(tparams, cfg, torch.tensor(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **MODEL)
        _assert_cache(tc, jc)
        _not_zero(cfg, jl)
        tok = np.asarray(jnp.argmax(jl, -1))


def test_pairs_write_their_own_cache_slices():
    """Llama4's decode writes the dense and the MoE half of each pair into
    its own slice of the (L/2, 2, ...) cache, at position pos alone."""
    cfg, _, _, tparams = _bridge("llama4_maverick_400b")
    batch = make_batch(cfg, 3)
    _, cache = TM.prefill(tparams, cfg, _tb(batch), max_seq=S + 2,
                          cache_dtype=torch.float32)
    assert cache["k"].shape[:2] == (cfg.num_layers // 2, 2)
    before = cache["k"].clone()
    _, cache = TM.decode_step(tparams, cfg, torch.zeros(B, dtype=torch.long),
                              cache)
    changed = (cache["k"] != before).flatten(4).any(-1)   # (L/2, 2, B, T)
    assert changed[..., S].all() and not changed[..., :S].any() \
        and not changed[..., S + 1:].any()
    assert not torch.equal(cache["k"][:, 0, :, S], cache["k"][:, 1, :, S])


def test_audio_decode_adds_the_position_0_sinusoid():
    """The reference's Whisper decode adds the position-0 sinusoid at every
    step, where its forward adds positions 0..S-1: decode matches forward
    at step 0 only."""
    cfg, _, _, tparams = _bridge("whisper_large_v3")
    batch = _tb(make_batch(cfg, 4, S=4))
    full = TM.forward(tparams, cfg, batch)
    _, cache = TM.prefill(tparams, cfg, batch, max_seq=4,
                          cache_dtype=torch.float32)
    steps = []
    for i in range(4):
        lg, cache = TM.decode_step(tparams, cfg, batch["tokens"][:, i], cache)
        steps.append(lg)
    np.testing.assert_allclose(steps[0].numpy(), full[:, 0].numpy(),
                               rtol=2e-3, atol=2e-3)
    assert not np.allclose(steps[1].numpy(), full[:, 1].numpy(),
                           rtol=2e-3, atol=2e-3)


# --- vlm through the segmented serving path ---------------------------------------


@pytest.fixture(scope="module")
def vlm():
    jcfg = jax_tiny_config("internvl2_76b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (B, 40))
    ve = rng.standard_normal((B, jcfg.num_patches, jcfg.d_model)
                             ).astype(np.float32)
    return get_tiny_config("internvl2_76b"), jcfg, jparams, tparams, \
        tokens, ve


@pytest.mark.parametrize("chunk", [16, 20])
def test_vlm_segmented_prefill_matches_jax(vlm, chunk):
    """Patch embeddings merged in chunk 0 of 3 (16 + 16 + 8) or 2 (20 +
    20): logits and the whole KV cache against the JAX SegmentedPrefill's
    `start(..., vision_embeds=)`, and the logits against the JAX fused
    `prefill`."""
    cfg, jcfg, jparams, tparams, tokens, ve = vlm
    jex = JaxSegmentedPrefill(jparams, jcfg, max_seq=40, chunk_tokens=chunk)
    jtask = jex.start(jnp.asarray(tokens), vision_embeds=jnp.asarray(ve))
    jlogits = jex.run_all(jtask)
    ex = SegmentedPrefill(tparams, cfg, max_seq=40, chunk_tokens=chunk)
    assert ex.ops == DENSE_OPS
    task = ex.start(tokens, vision_embeds=torch.from_numpy(ve))
    logits = ex.run_all(task)
    assert task.total_segments == jtask.total_segments
    assert task.n_chunks == -(-40 // chunk)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL)
    for key in ("k_cache", "v_cache"):
        np.testing.assert_allclose(task.state[key].numpy(),
                                   np.asarray(jtask.state[key]), **MODEL)
    fused, _ = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens),
                                           "vision_embeds": jnp.asarray(ve)},
                           cache_dtype=jnp.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(fused), **MODEL)


def test_vlm_segmented_suspend_resume_bit_exact(vlm):
    """Suspended at every operator boundary of chunk 0 (where the patch
    embeddings go in) with another prefill in between, the resumed logits
    are bit-equal to an uninterrupted run; the patch embeddings matter."""
    cfg, _, _, tparams, tokens, ve = vlm
    ex = SegmentedPrefill(tparams, cfg, max_seq=40, chunk_tokens=16)
    ve_t = torch.from_numpy(ve)
    want = ex.run_all(ex.start(tokens, vision_embeds=ve_t))
    task = ex.start(tokens, vision_embeds=ve_t)
    for stop in range(1, ex._segments_per_chunk + 1):
        while task.cursor < stop:
            ex.step(task)
        ex.run_all(ex.start(tokens[:1, :12]))       # another prefill meanwhile
    assert torch.equal(ex.run_all(task), want)
    # the first num_patches tokens are replaced: other tokens there give
    # the same logits, other patch embeddings do not
    other = tokens.copy()
    other[:, :cfg.num_patches] = (other[:, :cfg.num_patches] + 1) \
        % cfg.vocab_size
    assert torch.equal(ex.run_all(ex.start(other, vision_embeds=ve_t)), want)
    assert not torch.equal(ex.run_all(ex.start(tokens)), want)


def test_vlm_segmented_start_refuses_what_the_reference_does(vlm):
    cfg, _, _, tparams, tokens, ve = vlm
    ex = SegmentedPrefill(tparams, cfg, max_seq=40, chunk_tokens=16)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    prefix = torch.zeros((cfg.num_layers, B, 16, K, hd))
    with pytest.raises(ValueError, match="vision"):
        ex.start(tokens, prefix_len=16, prefix_k=prefix, prefix_v=prefix,
                 vision_embeds=torch.from_numpy(ve))
    small = SegmentedPrefill(tparams, cfg, max_seq=40, chunk_tokens=4)
    with pytest.raises(ValueError, match="first chunk"):
        small.start(tokens, vision_embeds=torch.from_numpy(ve))


def test_launcher_serves_the_tiny_vlm():
    """`build(arch="internvl2_76b")` on the CPU: the proxy, the S-EDF
    prefill instance on the dense operators, the ragged decode instance;
    every request decodes."""
    dep = serve_mod.build(arch="internvl2_76b", device="cpu", max_seq=256,
                          chunk=64, decode_tokens=3, decode_max_batch=4)
    try:
        assert dep.cfg.family == "vlm" and dep.executor.ops == DENSE_OPS
        rep = serve_mod.serve_trace(dep, requests=5, seed=3,
                                    arrival_mean_s=0.01)
        deadline = time.monotonic() + 60.0
        while len(dep.decode.finished) < rep["n_requests"] \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        dep.shutdown()
    assert rep["n_requests"] == 5 and len(dep.decode.finished) == 5
    for toks in dep.decode.outputs.values():
        assert len(toks) == 4
        assert all(0 <= t < dep.cfg.vocab_size for t in toks)
