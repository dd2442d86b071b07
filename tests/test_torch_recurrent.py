"""The recurrent families of the port (ssm: Mamba2; the recurrent hybrid:
RecurrentGemma) against the JAX package on the CPU, in f32, with inputs
from numpy and weights bridged from the JAX `init_params` pytree.

Layers (`causal_conv1d`, `rglru`, `rglru_step`, `ssd_chunked`, `ssd_step`)
at 1e-5; `prefill` logits and every cache leaf, and 8 `decode_step` logits,
at 2e-4 (tests/test_segments.py's model tolerance); the decode logits also
against JAX `forward` teacher-forced at 2e-3 (tests/test_arch_smoke.py:114).
The hybrid runs at S below its window of 32 (the decode crosses the ring's
wrap at position 32) and above it (the prefill rolls the ring), and with a
tail of rglru layers. The ring decode's key set is checked against the
reference's masked attention over ring positions.

    PYTHONPATH=src python -m pytest tests/test_torch_recurrent.py -q
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import prefill as jax_prefill
from repro_torch.configs.base import ModelConfig, get_config, get_tiny_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.params import ModelParams, from_jax_params, init_params

LAYER = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=2e-4, atol=2e-4)
FORWARD = dict(rtol=2e-3, atol=2e-3)     # tests/test_arch_smoke.py:114
N_DEC = 8


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# --- layers -------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(0)
    B, S, C, W = 2, 37, 24, 4
    x, w, b, st = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, C), (C, W), (C,), (B, W - 1, C)))
    st = st if with_state else None
    ty, ts = TL.causal_conv1d(*_t(x, w, b, st))
    jy, js = JL.causal_conv1d(*_j(x, w, b, st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER)
    # a decode step is the same call at S = 1
    t1, s1 = TL.causal_conv1d(*_t(x[:, :1], w, b, np.array(js)))
    window = np.concatenate([np.asarray(js), x[:, :1]], axis=1)
    np.testing.assert_allclose(
        t1[:, 0].numpy(), np.einsum("bwc,cw->bc", window, w) + b, **LAYER)
    np.testing.assert_array_equal(s1.numpy(), window[:, 1:])


def _rglru_inputs(seed, S):
    rng = np.random.default_rng(seed)
    B, C = 2, 24
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    a_param = (0.7 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    w_rg, w_ig = (rng.standard_normal((C, C)).astype(np.float32) / 5
                  for _ in range(2))
    h0 = rng.standard_normal((B, C)).astype(np.float32)
    return x, a_param, w_rg, w_ig, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_matches_jax(with_h0):
    """S = 37, not a power of two, so the doubling scan's last pass covers
    a partial span."""
    x, a_param, w_rg, w_ig, h0 = _rglru_inputs(1, 37)
    h0 = h0 if with_h0 else None
    ty, th = TL.rglru(*_t(x, a_param, w_rg, w_ig, h0))
    jy, jh = JL.rglru(*_j(x, a_param, w_rg, w_ig, h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LAYER)


def test_rglru_step_matches_jax_and_the_scan():
    x, a_param, w_rg, w_ig, h0 = _rglru_inputs(2, 5)
    ty, th = TL.rglru_step(*_t(x[:, 0], a_param, w_rg, w_ig, h0))
    jy, jh = JL.rglru_step(*_j(x[:, 0], a_param, w_rg, w_ig, h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LAYER)
    # stepping through the sequence gives the scan's states
    tx, ta, trg, tig, th0 = _t(x, a_param, w_rg, w_ig, h0)
    h = th0
    for s in range(x.shape[1]):
        _, h = TL.rglru_step(tx[:, s], ta, trg, tig, h)
    _, h_scan = TL.rglru(tx, ta, trg, tig, th0)
    np.testing.assert_allclose(h.numpy(), h_scan.numpy(), **LAYER)


def _ssd_inputs(seed, S):
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 3, 8, 5
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    # small steps, so that h0 and earlier chunks still matter at the end
    dt = (0.05 * np.log1p(np.exp(rng.standard_normal((B, S, H))))
          ).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [32, 37])
def test_ssd_chunked_matches_jax(S, with_h0):
    """S a multiple of the chunk (8) and not (zero-padded)."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(3, S)
    h0 = h0 if with_h0 else None
    ty, th = TL.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=8, h0=_t(h0)[0])
    jy, jh = JL.ssd_chunked(*_j(x, dt, A, Bm, Cm), chunk=8, h0=_j(h0)[0])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LAYER)


def test_ssd_step_matches_jax_and_the_chunked_form():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(4, 12)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0)
    ty, th = TL.ssd_step(*_t(*args))
    jy, jh = JL.ssd_step(*_j(*args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LAYER)
    tx, tdt, tA, tB, tC, th0 = _t(x, dt, A, Bm, Cm, h0)
    h, ys = th0, []
    for s in range(x.shape[1]):
        y, h = TL.ssd_step(tx[:, s], tdt[:, s], tA, tB[:, s], tC[:, s], h)
        ys.append(y)
    y_chunked, h_chunked = TL.ssd_chunked(tx, tdt, tA, tB, tC, chunk=4,
                                          h0=th0)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               y_chunked.numpy(), **LAYER)
    np.testing.assert_allclose(h.numpy(), h_chunked.numpy(), **LAYER)


# --- parameters ---------------------------------------------------------------


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b"])
def test_model_shapes_equal_the_reference(arch, size):
    get_j, get_t = ((jax_tiny_config, get_tiny_config) if size == "tiny"
                    else (jax_config, get_config))
    shapes = TM.model_shapes(get_t(arch))
    assert shapes == JM.model_shapes(get_j(arch))
    if arch == "recurrentgemma_9b" and size == "full":
        # 38 layers = 12 (rglru, rglru, attn) triples + 2 rglru
        assert shapes["blocks"]["attn"]["wq"] == (12, 4096, 16 * 256)
        assert shapes["tail"]["w_rg"] == (2, 4096, 4096)


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b"])
def test_init_params_family_values(arch):
    """The reference's family inits: A_log = log(1..nh), dt_bias 0.5, Dp 1
    (ssm); a_param 0.7 in every RG-LRU group (hybrid), equal to the JAX
    init's leaves; every group nested as the reference's pytree."""
    cfg = dataclasses.replace(get_tiny_config(arch), num_layers=5)
    jcfg = dataclasses.replace(jax_tiny_config(arch), num_layers=5)
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    if cfg.family == "ssm":
        groups = [("layers",)]
    else:
        groups = [("blocks", "r1"), ("blocks", "r2"), ("tail",)]
        assert set(tp["blocks"].keys()) == {"r1", "r2", "attn"}
    for path in groups:
        tg, jg = tp, jp
        for key in path:
            tg, jg = tg[key], jg[key]
        fixed = (("A_log", "dt_bias", "Dp") if cfg.family == "ssm"
                 else ("a_param",))
        for key in fixed:       # log(1..nh) by torch and by jnp: 1e-7 apart
            np.testing.assert_allclose(tg[key].numpy(), jg[key], rtol=1e-6)
        assert set(tg.keys()) == set(jg)
    if cfg.family == "ssm":
        nh = cfg.ssm_heads
        np.testing.assert_allclose(tp["layers"]["A_log"][0].numpy(),
                                   np.log(np.arange(1, nh + 1)), rtol=1e-6)


@pytest.fixture(scope="module", params=["mamba2_370m", "recurrentgemma_9b",
                                        "recurrentgemma_9b+tail"])
def bridged(request):
    """(torch cfg, JAX cfg, JAX params, port params); "+tail" is the tiny
    hybrid at 5 layers, one triple and a tail of two rglru layers."""
    arch = request.param.split("+")[0]
    cfg, jcfg = get_tiny_config(arch), jax_tiny_config(arch)
    if request.param.endswith("+tail"):
        cfg = dataclasses.replace(cfg, num_layers=5)
        jcfg = dataclasses.replace(jcfg, num_layers=5)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, from_jax_params(tree, device="cpu")


def test_from_jax_params_carries_nested_trees(bridged):
    cfg, _, jparams, tp = bridged
    assert isinstance(tp, ModelParams)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(list(tp.parameters())) == len(flat)
    assert not any(p.requires_grad for p in tp.parameters())


# S 28 < window 32: the decode crosses the ring's wrap (positions 28..35);
# S 45 > window: the prefill rolls the ring and the decode wraps it again
CASES = {"mamba2_370m": (37,), "recurrentgemma_9b": (28, 45),
         "recurrentgemma_9b+tail": (45,)}


def _tokens(cfg, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, S + N_DEC)).astype(np.int32)


def _runs(bridged, S):
    """JAX prefill, decode steps and forward; the port's prefill and decode
    steps, on the same tokens (f32 caches)."""
    cfg, jcfg, jparams, tp = bridged
    toks = _tokens(cfg, S)
    max_seq = S + N_DEC
    jl, jc = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                         max_seq=max_seq, cache_dtype=jnp.float32)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        max_seq=max_seq, cache_dtype=torch.float32)
    # the decode steps update the port's cache in place: keep a copy
    snapshot = {k: v.clone() if torch.is_tensor(v) else v
                for k, v in tc.items()}
    out = {"prefill": (jl, jc, tl, snapshot), "jax": [], "port": []}
    for i in range(N_DEC):
        jl, jc = jax_decode_step(jparams, jcfg, jnp.asarray(toks[:, S + i]),
                                 jc)
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(toks[:, S + i]),
                                tc)
        out["jax"].append(np.asarray(jl))
        out["port"].append(tl.numpy())
    out["forward"] = np.asarray(jax_forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks)}))[:, S:]
    out["caches"] = (jc, tc)
    return out


@pytest.fixture(scope="module")
def runs(bridged):
    name = "recurrentgemma_9b" if bridged[0].family == "hybrid" else \
        "mamba2_370m"
    if bridged[0].num_layers == 5:
        name += "+tail"
    return {S: _runs(bridged, S) for S in CASES[name]}


def test_prefill_logits_and_caches_match_jax(runs):
    for S, out in runs.items():
        jl, jc, tl, tc = out["prefill"]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        assert set(tc) == set(jc)
        assert tc["pos"] == int(jc["pos"]) == S
        for key, leaf in jc.items():
            if key == "pos":
                continue
            assert tc[key].dtype == torch.float32
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(leaf),
                                       err_msg=f"S {S} cache[{key!r}]",
                                       **MODEL)


def test_decode_steps_match_jax_decode(runs):
    for S, out in runs.items():
        for i, (t, j) in enumerate(zip(out["port"], out["jax"])):
            np.testing.assert_allclose(t, j, err_msg=f"S {S} step {i}",
                                       **MODEL)
        jc, tc = out["caches"]
        assert tc["pos"] == int(jc["pos"]) == S + N_DEC
        for key, leaf in jc.items():
            if key != "pos":
                np.testing.assert_allclose(tc[key].numpy(), np.asarray(leaf),
                                           err_msg=f"S {S} cache[{key!r}]",
                                           **MODEL)


def test_decode_steps_match_jax_forward(runs):
    """Teacher forcing: step i's logits are the full forward's at S + i."""
    for S, out in runs.items():
        for i, t in enumerate(out["port"]):
            np.testing.assert_allclose(t, out["forward"][:, i],
                                       err_msg=f"S {S} step {i}", **FORWARD)


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_30b_a3b"])
def test_prefill_of_dense_and_moe_stacks_matches_jax(arch):
    """`prefill` covers every family the port admits: the dense and uniform
    MoE stacks against the JAX prefill (logits and the padded K/V cache)."""
    cfg, jcfg = get_tiny_config(arch), jax_tiny_config(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = _tokens(cfg, 20)[:, :20]
    jl, jc = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                         max_seq=32, cache_dtype=jnp.float32)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                        max_seq=32, cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **MODEL)
    assert tc["pos"] == 20


# --- the ring decode's key set ------------------------------------------------


@pytest.mark.parametrize("pos", [0, 5, 31, 32, 77])
def test_ring_decode_equals_masked_attention_over_ring_positions(pos):
    """`decode_attention` over a ring of win slots with kv_len = min(pos +
    1, win) (what the hybrid's decode step runs) equals the reference's
    `naive_attention` with the ring's absolute positions, the window and
    the causal mask (unwritten slots at negative positions), in the port
    and in JAX."""
    B, win, H, K, hd = 2, 32, 4, 1, 16
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, win, K, hd)).astype(np.float32)
            for _ in range(2))
    k_pos = pos - ((pos - np.arange(win)) % win)
    tq, tk, tv = _t(q, k, v)
    got = ops.decode_attention(tq, tk, tv, torch.full((B,), min(pos + 1, win),
                                                      dtype=torch.int32))
    want = ref.naive_attention(tq[:, None], tk, tv, causal=True, q_offset=pos,
                               local_window=win,
                               k_positions=torch.from_numpy(k_pos))[:, 0]
    jwant = JL.naive_attention(*_j(q[:, None], k, v), causal=True,
                               q_offset=pos, local_window=win,
                               k_positions=jnp.asarray(k_pos))[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LAYER)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **LAYER)


def test_families_without_a_serving_path_are_refused():
    """As in the reference, ssm and the hybrid have no segmented operators
    and no ragged decode step."""
    from repro_torch.models.segments import op_names
    for arch in ("mamba2_370m", "recurrentgemma_9b"):
        cfg = get_tiny_config(arch)
        assert isinstance(cfg, ModelConfig)
        with pytest.raises(NotImplementedError):
            op_names(cfg)
        assert not TM.supports_ragged_decode(cfg)
