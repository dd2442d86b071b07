"""The port's training substrate (`repro_torch.training`, the launcher) on
the CPU: the reference's tests/test_training.py cases on the port (loss
falls, a restart is bit-equal to an uninterrupted run, atomic `keep`,
restore onto another device and dtype, data determinism and host
sharding, the straggler watchdog, the int8 round trip, compressed training
converges), and the port against the JAX package: batches and int8 codes
bit-equal, one AdamW update within 1e-6 relative, five train steps of the
tiny Llama3.2-1B in f32 within 1e-4 relative, checkpoints that each
package wrote restored by the other.

    PYTHONPATH=src python -m pytest tests/test_torch_training.py -q
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.training import checkpoint as jax_ckpt
from repro.training import compression as jax_comp
from repro.training import data as jax_data
from repro.training import optimizer as jax_opt
from repro.training.train import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_tiny_config
from repro_torch.launch import train as launcher
from repro_torch.params import from_jax_params, init_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.compression import (ErrorFeedbackCompressor,
                                              dequantize_int8, quantize_int8)
from repro_torch.training.data import DataConfig, data_iterator, make_batch
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            apply_updates, init_state,
                                            lr_schedule)
from repro_torch.training.train import (LoopConfig, grads_of, loss_fn,
                                        make_train_step, train_loop)

CFG = get_tiny_config("llama3_2_1b")
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=40, weight_decay=0.0)
DATA = DataConfig(seq_len=32, global_batch=4, vocab_size=CFG.vocab_size,
                  seed=0)
CPU = dict(device="cpu")


def setup():
    params = init_params(CFG, torch.Generator().manual_seed(0), **CPU,
                         trainable=True)
    return params, init_state(params), make_train_step(CFG, OPT,
                                                       remat="none")


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --- the reference's cases on the port ----------------------------------------


def test_loss_decreases():
    params, opt_state, step = setup()
    it = data_iterator(DATA, **CPU)
    losses = []
    for _ in range(20):
        params, opt_state, m = step(params, opt_state, next(it))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.1, losses


def test_checkpoint_restart_equivalence(tmp_path):
    """Crash/restart reproduces the uninterrupted run bit for bit: the
    parameters and the optimizer's m, v and step."""
    d = str(tmp_path / "ck")
    params, opt_state, step = setup()
    loop = LoopConfig(total_steps=12, checkpoint_every=6, checkpoint_dir=d,
                      log_every=100)
    p_full, s_full, _ = train_loop(CFG, params, opt_state, step,
                                   data_iterator(DATA, **CPU), loop,
                                   log=lambda *_: None)

    params2, opt_state2, _ = setup()
    assert ckpt.latest_step(d) == 12
    mid = ckpt.restore(d, 6, {"params": params2, "opt_state": opt_state2})
    assert all(p.requires_grad for p in mid["params"].parameters())
    p_res, s_res, _ = train_loop(CFG, mid["params"], mid["opt_state"], step,
                                 data_iterator(DATA, start_step=6, **CPU),
                                 loop, start_step=6, log=lambda *_: None)
    assert _leaves_equal(p_full.leaves().values(), p_res.leaves().values())
    assert _leaves_equal(s_full.m.values(), s_res.m.values())
    assert _leaves_equal(s_full.v.values(), s_res.v.values())
    assert int(s_full.step) == int(s_res.step) == 12


def test_checkpoint_atomic_keep(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.arange(10), "nested": {"y": torch.ones((3, 3))}}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.list_steps(d) == [4, 5]
    assert not [n for n in (tmp_path / "ck").iterdir()
                if n.name.startswith(".tmp_")]
    back = ckpt.restore(d, 5, tree)
    assert torch.equal(back["x"], torch.arange(10))


def test_async_write_lands(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, {"w": torch.full((4,), 2.0)}, async_write=True)
    for _ in range(200):
        if ckpt.latest_step(d) == 3:
            break
        time.sleep(0.01)
    back = ckpt.restore(d, 3, {"w": torch.zeros(4)})
    assert torch.equal(back["w"], torch.full((4,), 2.0))


def test_restore_onto_another_device_and_dtype(tmp_path):
    """The elastic case: saved from f32 parameters, restored into bf16
    ones on the device `restore` is given; bf16 leaves are stored in f32,
    so a bf16 model round-trips exactly."""
    d = str(tmp_path / "ck")
    params, opt_state, _ = setup()
    ckpt.save(d, 1, {"params": params, "opt_state": opt_state})
    like = init_params(CFG, torch.Generator().manual_seed(1), **CPU,
                       dtype=torch.bfloat16, trainable=True)
    back = ckpt.restore(d, 1, {"params": like,
                               "opt_state": init_state(like)},
                        device=torch.device("cpu"))
    for key, p in back["params"].leaves().items():
        assert p.dtype == torch.bfloat16 and p.device.type == "cpu"
        assert torch.equal(p, params.leaves()[key].to(torch.bfloat16))
    ckpt.save(d, 2, {"params": back["params"]})
    again = ckpt.restore(d, 2, {"params": like})["params"]
    assert _leaves_equal(again.leaves().values(),
                         back["params"].leaves().values())
    with pytest.raises(ValueError, match="saved"):
        ckpt.restore(d, 2, {"params": init_params(
            get_tiny_config("qwen2_1_5b"), torch.Generator().manual_seed(0),
            **CPU)})


def test_data_determinism_and_host_sharding():
    b1, b2 = make_batch(DATA, step=7, **CPU), make_batch(DATA, step=7, **CPU)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    h0 = make_batch(DataConfig(**{**DATA.__dict__, "num_hosts": 2,
                                  "host_id": 0}), step=7, **CPU)
    h1 = make_batch(DataConfig(**{**DATA.__dict__, "num_hosts": 2,
                                  "host_id": 1}), step=7, **CPU)
    assert torch.equal(h0["tokens"], b1["tokens"][:2])
    assert torch.equal(h1["tokens"], b1["tokens"][2:])


def test_straggler_watchdog(tmp_path):
    """One step made slower than 3x the median: the watchdog counts it and
    calls `on_straggler`. The eager step's time depends on the host's load,
    so the slow step sleeps 5x the slowest step before it after the first
    (0.5 s at least)."""
    params, opt_state, step = setup()
    seen, step_times = [], []

    def slow_step(p, s, b):
        t0 = time.monotonic()
        out = step(p, s, b)
        out[2]["loss"].item()
        if len(step_times) == 8:             # one artificially slow step
            time.sleep(max(0.5, 5 * max(step_times[1:])))
        step_times.append(time.monotonic() - t0)
        return out

    loop = LoopConfig(total_steps=12, checkpoint_every=100,
                      checkpoint_dir=str(tmp_path / "ck"), log_every=100,
                      watchdog_factor=3.0,
                      on_straggler=lambda st, dt, med: seen.append(st))
    _, _, info = train_loop(CFG, params, opt_state, slow_step,
                            data_iterator(DATA, **CPU), loop,
                            log=lambda *_: None)
    assert info["stragglers"] >= 1
    assert seen


def test_int8_quantization_roundtrip():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3.0
    q, s = quantize_int8(x, block=128)
    back = dequantize_int8(q, s, x.shape, x.numel())
    assert (back - x).abs().max() <= x.abs().max() / 127.0 + 1e-6


def test_compressed_training_still_converges():
    params, opt_state, _ = setup()
    comp = ErrorFeedbackCompressor(block=128)
    state = {"residual": comp.init(params.leaves())}

    def compressed_step(p, s, batch):
        loss = loss_fn(p, CFG, batch, remat="none")
        cg, state["residual"] = comp.transform(grads_of(loss, p),
                                               state["residual"])
        p2, s2, m = apply_updates(OPT, p, cg, s)
        return p2, s2, dict(m, loss=loss.detach())

    it = data_iterator(DATA, **CPU)
    losses = []
    for _ in range(15):
        params, opt_state, m = compressed_step(params, opt_state, next(it))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.1, losses


def test_launcher_trains_and_auto_resumes(tmp_path, capsys):
    argv = ["--arch", "llama3_2_1b", "--device", "cpu", "--seq", "32",
            "--batch", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    info = launcher.main(argv + ["--steps", "8"])
    assert np.isfinite(info["final_loss"])
    assert ckpt.list_steps(str(tmp_path)) == [4, 8]
    launcher.main(argv + ["--steps", "10", "--remat", "full"])
    assert "auto-resumed from step 8" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 10


# --- against the JAX package ---------------------------------------------------


def _jax_data(cfg, **kw):
    return jax_data.DataConfig(**{**DATA.__dict__, "vocab_size":
                                  cfg.vocab_size, **kw})


@pytest.mark.parametrize("arch", ["llama3_2_1b", "internvl2_76b",
                                  "whisper_large_v3"])
@pytest.mark.parametrize("hosts", [1, 2])
def test_make_batch_bit_equal_to_reference(arch, hosts):
    cfg, jcfg = get_tiny_config(arch), jax_tiny_config(arch)
    kw = dict(num_hosts=hosts, host_id=hosts - 1)
    got = make_batch(DataConfig(**{**DATA.__dict__, "vocab_size":
                                   cfg.vocab_size, **kw}), 5, cfg, **CPU)
    want = jax_data.make_batch(_jax_data(jcfg, **kw), 5, jcfg)
    assert sorted(got) == sorted(want)
    for key, x in want.items():
        assert got[key].dtype == {np.dtype("int32"): torch.int32,
                                  np.dtype("float32"): torch.float32}[x.dtype]
        assert np.array_equal(got[key].numpy(), np.asarray(x)), key


@pytest.mark.parametrize("n,block,scale", [(1000, 128, 3.0), (777, 256, 1e-3),
                                           (4096, 256, 50.0)])
def test_quantize_int8_bit_equal_to_reference(n, block, scale):
    """The same codes and scales, ties at .5 included: the first block is
    exact halves whose max is 127, so every code is a tie rounded to
    even on both sides."""
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(
        np.float32)
    x[:block] = np.arange(block, dtype=np.float32) - 0.5
    x[block - 1] = 127.0
    q, s = quantize_int8(torch.from_numpy(x), block)
    jq, js = jax_comp.quantize_int8(jnp.asarray(x), block)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    back = dequantize_int8(q, s, x.shape, n)
    jback = jax_comp.dequantize_int8(jq, js, x.shape, n)
    assert np.array_equal(back.numpy(), np.asarray(jback))


def test_apply_updates_matches_reference():
    """One AdamW update at step 3 with clipping and weight decay, from the
    same f32 params, grads and state, within 1e-6 relative; the schedule
    at steps 0, 1, the end of the warmup and the end."""
    cfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=50,
                      weight_decay=0.1, grad_clip=0.5)
    jcfg = jax_opt.AdamWConfig(**cfg.__dict__)
    for step in (0, 1, 5, 50):
        np.testing.assert_allclose(float(lr_schedule(cfg, step)),
                                   float(jax_opt.lr_schedule(
                                       jcfg, jnp.asarray(step))), rtol=1e-6)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_tiny_config("llama3_2_1b"), jax.random.PRNGKey(3)))
    params = from_jax_params(tree, **CPU, trainable=True)
    keys = list(params.leaves())
    draw = {k: rng.standard_normal(p.shape).astype(np.float32)
            for k, p in params.leaves().items()}
    m = {k: rng.standard_normal(p.shape).astype(np.float32) * 0.1
         for k, p in params.leaves().items()}
    v = {k: np.abs(rng.standard_normal(p.shape)).astype(np.float32) * 0.01
         for k, p in params.leaves().items()}

    def nest(flat):
        out = {}
        for k, x in flat.items():
            *g, name = k.split("/")
            node = out
            for part in g:
                node = node.setdefault(part, {})
            node[name] = jnp.asarray(x)
        return out

    jstate = jax_opt.AdamWState(step=jnp.asarray(3, jnp.int32), m=nest(m),
                                v=nest(v))
    jp, js, jmet = jax_opt.apply_updates(
        jcfg, jax.tree.map(jnp.asarray, tree), nest(draw), jstate)
    state = AdamWState(step=torch.tensor(3, dtype=torch.int32),
                       m={k: torch.from_numpy(m[k].copy()) for k in keys},
                       v={k: torch.from_numpy(v[k].copy()) for k in keys})
    p2, s2, met = apply_updates(cfg, params, {k: torch.from_numpy(draw[k])
                                              for k in keys}, state)
    assert int(s2.step) == 4
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   rtol=1e-6)
    flat = {"p": jax_ckpt._flatten(jp), "m": jax_ckpt._flatten(js.m),
            "v": jax_ckpt._flatten(js.v)}
    for k in keys:
        for name, got in (("p", p2.leaves()[k]), ("m", s2.m[k]),
                          ("v", s2.v[k])):
            np.testing.assert_allclose(got.detach().numpy(), flat[name][k],
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{name} {k}")


def test_five_train_steps_match_jax():
    """Five steps of the tiny Llama3.2-1B in f32 from the same weights and
    batches: each step's loss within 1e-4 relative of the JAX
    `make_train_step`'s, and every parameter leaf within 1e-4 of its
    largest magnitude."""
    jcfg = jax_tiny_config("llama3_2_1b")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    params = from_jax_params(tree, **CPU, trainable=True)
    state = init_state(params)
    step = make_train_step(CFG, OPT, remat="none")
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jax_opt.init_state(jparams)
    jstep = jax.jit(jax_make_train_step(
        jcfg, jax_opt.AdamWConfig(**OPT.__dict__), remat="none"))
    for i in range(5):
        params, state, met = step(params, state, make_batch(DATA, i, **CPU))
        jparams, jstate, jmet = jstep(jparams, jstate,
                                      jax_data.make_batch(_jax_data(jcfg), i))
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"loss, step {i}")
    want = jax_ckpt._flatten(jparams)
    for key, p in params.leaves().items():
        err = np.abs(p.detach().numpy() - want[key]).max()
        assert err <= 1e-4 * np.abs(want[key]).max(), (key, err)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint that `repro.training.checkpoint.save` wrote from the
    JAX `init_params` tree restores into the port equal to
    `from_jax_params` of that tree; one the port wrote (params and AdamW
    state, keys ``opt_state/.m/...``) restores into the JAX structures."""
    jcfg = jax_tiny_config("llama3_2_1b")
    jtree = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jax_ckpt.save(str(tmp_path / "jax"), 1, jtree)
    want = from_jax_params(jax.tree.map(np.asarray, jtree), **CPU)
    like = init_params(CFG, torch.Generator().manual_seed(5), **CPU)
    got = ckpt.restore(str(tmp_path / "jax"), 1, like)
    assert _leaves_equal(got.leaves().values(), want.leaves().values())

    params, opt_state, step = setup()
    params, opt_state, _ = step(params, opt_state, make_batch(DATA, 0, **CPU))
    ckpt.save(str(tmp_path / "port"), 1, {"params": params,
                                          "opt_state": opt_state})
    jlike = {"params": jtree, "opt_state": jax_opt.init_state(jtree)}
    back = jax_ckpt.restore(str(tmp_path / "port"), 1, jlike)
    assert int(back["opt_state"].step) == 1
    flat = jax_ckpt._flatten(back)
    for key, p in params.leaves().items():
        assert np.array_equal(flat["params/" + key], p.detach().numpy())
        assert np.array_equal(flat["opt_state/.m/" + key],
                              opt_state.m[key].numpy())
