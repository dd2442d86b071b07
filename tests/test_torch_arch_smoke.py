"""The port's counterpart of tests/test_arch_smoke.py: every arch of
`ARCH_IDS` at its tiny config, on the CPU, with weights drawn by the port's
own `init_params`: one `forward` (shapes, finite), one `prefill` → 3
`decode_step` roundtrip, and decode against `forward` teacher-forced at the
reference's 2e-3 (its `test_decode_matches_forward`). As there, Whisper's
decode is not held to its forward: its `prefill` is the encoder pass and
starts the decoder empty, and its decode adds the position-0 sinusoid at
every step (tests/test_torch_families.py holds it at step 0). The train
step of the reference's file needs the backward pass, which the port does
not have yet.

    PYTHONPATH=src python -m pytest tests/test_torch_arch_smoke.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, get_tiny_config
from repro_torch.models.model import decode_step, forward, prefill
from repro_torch.params import init_params

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
