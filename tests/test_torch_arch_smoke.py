"""The port's counterpart of tests/test_arch_smoke.py: every arch of
`ARCH_IDS` at its tiny config, on the CPU, with weights drawn by the port's
own `init_params`: one `forward` (shapes, finite), one `prefill` → 3
`decode_step` roundtrip, and decode against `forward` teacher-forced at the
reference's 2e-3 (its `test_decode_matches_forward`). As there, Whisper's
decode is not held to its forward: its `prefill` is the encoder pass and
starts the decoder empty, and its decode adds the position-0 sinusoid at
every step (tests/test_torch_families.py holds it at step 0).

The reference's train step (tests/test_arch_smoke.py:44) on every arch:
finite loss, a non-zero gradient norm, and a lower loss after one SGD step
on the same batch. Then the port's gradient against `jax.grad` of the same
loss on the same weights (bridged from the JAX `init_params` tree), leaf by
leaf, and the remat policies against each other.

    PYTHONPATH=src python -m pytest tests/test_torch_arch_smoke.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro_torch.configs.base import ARCH_IDS, get_tiny_config
from repro_torch.models.model import REMAT_POLICIES, decode_step, forward, \
    prefill
from repro_torch.params import from_jax_params, init_params, redraw_norms
from repro_torch.training.train import cross_entropy_loss, grads_of

B, S = 2, 24


def make_batch(cfg, seed, S=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, S)))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (B, S)))
    return batch


def _setup(arch):
    cfg = get_tiny_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, make_batch(cfg, 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_finite(arch):
    cfg, params, batch = _setup(arch)
    logits = forward(params, cfg, batch)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all(), f"{arch}: non-finite logits"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_roundtrip(arch):
    cfg, params, batch = _setup(arch)
    logits, cache = prefill(params, cfg, batch, max_seq=S + 8,
                            cache_dtype=torch.float32)
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    for _ in range(3):
        logits, cache = decode_step(params, cfg, tok, cache)
        assert logits.shape == (B, cfg.vocab_size)
        assert torch.isfinite(logits).all(), \
            f"{arch}: non-finite decode logits"
        tok = logits.argmax(-1)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "whisper_large_v3"])
def test_decode_matches_forward(arch):
    """Prefill + iterative decode logits match one full forward pass
    (teacher forcing): the cache of every family is right."""
    cfg, params, batch = _setup(arch)
    n_extra = 4
    extra = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, n_extra))
    full_tokens = torch.cat([batch["tokens"], torch.from_numpy(extra)], 1)
    all_logits = forward(params, cfg, dict(batch, tokens=full_tokens))
    _, cache = prefill(params, cfg, batch, max_seq=S + n_extra,
                       cache_dtype=torch.float32)
    for i in range(n_extra):
        step_logits, cache = decode_step(params, cfg, full_tokens[:, S + i],
                                         cache)
        np.testing.assert_allclose(
            step_logits.numpy(), all_logits[:, S + i].numpy(),
            rtol=2e-3, atol=2e-3,
            err_msg=f"{arch}: decode step {i} diverges from forward")


def test_full_config_param_counts():
    """Analytic parameter counts of the full configs, the reference's
    ranges: the copied configs transcribe the published architectures."""
    from repro_torch.configs.base import get_config
    expected = {
        "internvl2_76b": (60e9, 90e9),
        "recurrentgemma_9b": (7e9, 12e9),
        "llama4_maverick_400b": (350e9, 450e9),
        "granite_moe_3b": (2e9, 4.5e9),
        "llama3_2_1b": (1e9, 1.8e9),
        "qwen2_5_3b": (2.5e9, 4e9),
        "qwen2_1_5b": (1.2e9, 2e9),
        "minitron_4b": (3.5e9, 6e9),
        "mamba2_370m": (0.25e9, 0.5e9),
        "whisper_large_v3": (1.2e9, 2.2e9),
    }
    for arch, (lo, hi) in expected.items():
        n = get_config(arch).param_count()
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B outside range"


def _loss(params, cfg, batch, remat="none"):
    return cross_entropy_loss(forward(params, cfg, batch, remat=remat),
                              batch["labels"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_decreases_loss(arch):
    cfg = get_tiny_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", trainable=True)
    batch = make_batch(cfg, 1)
    loss = _loss(params, cfg, batch)
    grads = grads_of(loss, params)
    assert torch.isfinite(loss), f"{arch}: non-finite loss"
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    assert torch.isfinite(gnorm) and gnorm > 0
    # one SGD step reduces the loss on the same batch
    with torch.no_grad():
        for key, p in params.leaves().items():
            p -= 0.5 * grads[key]
        assert _loss(params, cfg, batch) < loss, \
            f"{arch}: loss did not decrease"


# the per-leaf gradient limit, as a share of the leaf's largest JAX
# gradient: f32 sums in another order for the attention, MoE, vlm and audio
# stacks; ssm and the hybrid scan their recurrences in another order than
# the reference (a doubling scan, a chunk loop), which moves their forward
# by up to 1e-3 (tests/test_torch_recurrent.py) and their gradients alike
GRAD_RTOL = {"ssm": 1e-3, "hybrid": 1e-3}


def _tree_of(params):
    tree = {}
    for path, t in params.leaves().items():
        *groups, key = path.split("/")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[key] = jnp.asarray(t.detach().numpy())
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradients_match_jax(arch):
    """d loss / d leaf of the port (FlashAttention's blockwise backward,
    autograd) against `jax.grad` of the same mean NLL on the same weights
    and batch: max |g_port - g_jax| <= rtol * max |g_jax| per leaf, rtol
    1e-4 (GRAD_RTOL for ssm and the hybrid). Whisper's LayerNorms are
    redrawn first (the reference's init makes it output exactly 0)."""
    jcfg, cfg = jax_tiny_config(arch), get_tiny_config(arch)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    params = from_jax_params(tree, device="cpu", trainable=True)
    if cfg.family == "audio":
        redraw_norms(params, 7)
    batch = make_batch(cfg, 1)
    grads = grads_of(_loss(params, cfg, batch), params)

    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def jloss(p):
        logp = jax.nn.log_softmax(jax_forward(p, jcfg, jbatch), axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jbatch["labels"][..., None], axis=-1))

    jgrads = jax.jit(jax.grad(jloss))(_tree_of(params))
    rtol = GRAD_RTOL.get(cfg.family, 1e-4)
    for path, g in grads.items():
        want = np.asarray(_at_path(jgrads, path))
        scale = np.abs(want).max()
        err = np.abs(g.numpy() - want).max()
        assert err <= rtol * scale, f"{arch} {path}: {err} > {rtol} * {scale}"


def _at_path(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_policies_give_equal_gradients(arch):
    """Recompute replays the same ops in the same order, so on the CPU the
    gradients at remat none, full and dots are equal bit for bit."""
    cfg = get_tiny_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", trainable=True)
    batch = make_batch(cfg, 2)
    grads = {r: grads_of(_loss(params, cfg, batch, r), params)
             for r in REMAT_POLICIES}
    for remat in ("full", "dots"):
        for path, g in grads["none"].items():
            assert torch.equal(grads[remat][path], g), (remat, path)
    with pytest.raises(ValueError, match="remat"):
        forward(params, cfg, batch, remat="some")
