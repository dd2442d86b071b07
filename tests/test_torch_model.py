"""The port's dense model against the JAX package on the tiny Llama3-8B
config, with weights bridged from the JAX `init_params` pytree: parameter
round trip, RMSNorm and RoPE, and both decode steps (logits and new K/V at
2e-4, the tolerance of tests/test_segments.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.base import get_tiny_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.params import ModelParams, from_jax_params, init_params

TOL = dict(rtol=2e-4, atol=2e-4)
CFG = get_tiny_config("llama3_8b")


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_tiny_config("llama3_8b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tree, from_jax_params(tree, device="cpu")


def test_from_jax_params_round_trip(bridged):
    jcfg, _, tree, tp = bridged
    assert isinstance(tp, ModelParams)
    assert set(tree) == {"embed", "final_norm", "unembed", "layers"}
    assert set(tp["layers"].keys()) == set(tree["layers"])
    for key in ("embed", "final_norm", "unembed"):
        assert np.array_equal(tp[key].numpy(), tree[key]), key
    for key, arr in tree["layers"].items():
        assert tp["layers"][key].shape[0] == CFG.num_layers
        assert np.array_equal(tp["layers"][key].numpy(), arr), key
    assert not any(p.requires_grad for p in tp.parameters())
    assert TM.model_shapes(CFG) == JM.model_shapes(jcfg)


def test_torch_init_params_shapes_and_scaling():
    gen = torch.Generator(device="cpu").manual_seed(0)
    tp = init_params(CFG, gen, device="cpu")
    shapes = TM.model_shapes(CFG)
    assert tuple(tp["embed"].shape) == shapes["embed"]
    for key, shape in shapes["layers"].items():
        assert tuple(tp["layers"][key].shape) == shape, key
    # the reference's rule: 1-D leaves are zeros, every other leaf is
    # N(0, 1/fan_in) with fan_in the second-to-last axis (d for the (d, 2, F)
    # gate|up) — so the stacked (L, d) norm weights are drawn at 1/sqrt(L)
    assert torch.count_nonzero(tp["final_norm"]) == 0
    for key, fan_in in (("wq", CFG.d_model), ("wi", CFG.d_model),
                        ("wd", CFG.d_ff), ("ln1", CFG.num_layers)):
        std = tp["layers"][key].std().item()
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, key


def test_default_device_raises_without_a_card():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(CFG, torch.Generator())


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    pos = np.stack([np.arange(7), np.arange(40, 47)]).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                      CFG.rope_theta).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 CFG.rope_theta)),
        rtol=1e-5, atol=1e-5)
    wi = rng.standard_normal((32, 2, 48)).astype(np.float32) * 0.2
    wo = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    xs = x[:, :, 0]
    np.testing.assert_allclose(
        TL.swiglu(torch.from_numpy(xs), torch.from_numpy(wi),
                  torch.from_numpy(wo)).numpy(),
        np.asarray(JL.swiglu(jnp.asarray(xs), jnp.asarray(wi),
                             jnp.asarray(wo))), **TOL)


def test_decode_step_matches_jax(bridged):
    jcfg, jparams, _, tp = bridged
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 20))
    _, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                           max_seq=32, cache_dtype=jnp.float32)
    tok = np.asarray([3, 7])
    jlogits, jnew = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
    cache = {"k": torch.from_numpy(np.array(jcache["k"])),
             "v": torch.from_numpy(np.array(jcache["v"])),
             "pos": int(jcache["pos"])}
    logits, new = TM.decode_step(tp, CFG, torch.from_numpy(tok), cache)
    assert new["pos"] == int(jnew["pos"]) == 21
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(new["k"].numpy(), np.asarray(jnew["k"]), **TOL)
    np.testing.assert_allclose(new["v"].numpy(), np.asarray(jnew["v"]), **TOL)


def test_decode_step_ragged_matches_jax(bridged):
    jcfg, jparams, _, tp = bridged
    L, K, hd = CFG.num_layers, CFG.num_kv_heads, CFG.resolved_head_dim
    rng = np.random.default_rng(2)
    B, T = 3, 64
    kg = rng.standard_normal((L, B, T, K, hd)).astype(np.float32)
    vg = rng.standard_normal((L, B, T, K, hd)).astype(np.float32)
    lens = np.asarray([1, 17, 40], np.int32)
    tok = np.asarray([5, 9, 11])
    jl, jk, jv = JM.decode_step_ragged(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(kg), jnp.asarray(vg),
        jnp.asarray(lens))
    tl, tk, tv = TM.decode_step_ragged(
        tp, CFG, torch.from_numpy(tok), torch.from_numpy(kg.copy()),
        torch.from_numpy(vg.copy()), torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    assert TM.supports_ragged_decode(CFG)
